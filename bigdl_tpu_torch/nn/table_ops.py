"""Table layers of the flagship (counterpart of ``CAddTable`` in
``bigdl_tpu/nn/table_ops.py``)."""

from __future__ import annotations

from ..utils.table import Table
from .module import AbstractModule


class CAddTable(AbstractModule):
    """Elementwise sum of a ``Table`` (ResNet's shortcut add), left to right.
    ``inplace`` is accepted and ignored."""

    def __init__(self, inplace: bool = False, device=None):
        super().__init__(device)

    def _apply_params(self, params, state, x, training, rng):
        xs = x.to_list() if isinstance(x, Table) else list(x) if isinstance(x, (list, tuple)) else [x]
        out = xs[0]
        for xi in xs[1:]:
            out = out + xi
        return out, state
