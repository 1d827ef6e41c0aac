"""Table layers and multi-branch containers (counterpart of ``CAddTable``,
``Concat`` and ``check_concat_specs`` in ``bigdl_tpu/nn/table_ops.py``).
Dims are 1-based (Torch convention)."""

from __future__ import annotations

from typing import Any, Dict

import torch

from ..utils.table import Table
from .module import AbstractModule, Container


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


def check_concat_specs(module, shapes, axis: int, names) -> None:
    """Merge-point contract check: every branch must agree on rank and on all
    non-concat dims; reports the first offending pair with both shapes."""
    ref = tuple(shapes[0])
    if not 0 <= axis < len(ref):
        raise ValueError(
            f"{module.name()}: concat dim {axis + 1} (1-based) out of range "
            f"for rank-{len(ref)} inputs (first branch shape {ref})"
        )
    for name, s in zip(names[1:], shapes[1:]):
        cur = tuple(s)
        if len(cur) != len(ref) or any(
            i != axis and a != b for i, (a, b) in enumerate(zip(ref, cur))
        ):
            raise ValueError(
                f"{module.name()}: cannot concatenate along dim {axis + 1} "
                f"(1-based): {names[0]} outputs {ref} but {name} outputs {cur}"
            )


class Concat(Container):
    """Apply each branch to the SAME input and concatenate the outputs along
    ``dimension`` (1-based), in the branches' promoted dtype (Inception's
    modules). Reference: $DL/nn/Concat.scala."""

    def __init__(self, dimension: int = 2, device=None):
        super().__init__(device=device)
        self.dimension = dimension

    def build(self, generator: torch.Generator, sample) -> None:
        """Build the branches from ``sample`` and check that their outputs
        concatenate."""
        if self._built:
            raise RuntimeError(f"{self.name()} is already built")
        with torch.no_grad():
            ys = [self._build_child(m, generator, sample) for m in self._layers]
        check_concat_specs(self, [y.shape for y in ys], self.dimension - 1,
                           [m.name() for m in self._layers])
        self._built = True

    def _apply_params(self, params, state, x, training, rng):
        new_state: Dict[str, Any] = {}
        ys = []
        for m in self._layers:
            y, new_state[m.name()] = m._apply_params(params[m.name()], state[m.name()], x,
                                                     training, rng)
            ys.append(y)
        return torch.cat(ys, dim=self.dimension - 1), new_state
