"""``LookupTable`` (counterpart of ``LookupTable`` in
``bigdl_tpu/nn/embedding.py``; reference: ``LookupTable.scala``): maps
indices to rows of an (n_index, n_output) table.

The JAX package's semantics:

* indices are 0-based unless ``one_based_input=True``; float indices are
  truncated; an index outside the table is clipped to its nearest row, not
  raised on (the JAX lookup runs under jit, where it cannot raise);
* ``padding_value`` zeroes that row at initialisation and masks the output
  of every lookup of it (the row's gradient is then zero);
* ``max_norm`` / ``norm_type`` renormalise only the gathered rows to a
  ``norm_type``-norm of at most ``max_norm``, and never write the table;
* ``should_scale_grad_by_freq`` divides each row's gradient by how often the
  row was looked up in the batch;
* the output is the table's dtype, fp32, under every precision policy.

``LookupTableSparse`` and the other layers of the JAX file wait for a later
slice of the port.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .initialization import InitializationMethod, RandomNormal
from .module import AbstractModule


class LookupTable(AbstractModule):
    def __init__(self, n_index: int, n_output: int, padding_value: Optional[int] = None,
                 max_norm: Optional[float] = None, norm_type: float = 2.0,
                 should_scale_grad_by_freq: bool = False, one_based_input: bool = False,
                 w_regularizer=None, device=None):
        super().__init__(device)
        if w_regularizer is not None:
            raise NotImplementedError("LookupTable(w_regularizer=...) is not ported yet")
        self.n_index = n_index
        self.n_output = n_output
        self.padding_value = padding_value
        self.max_norm = max_norm
        self.norm_type = norm_type
        self.scale_grad_by_freq = should_scale_grad_by_freq
        self.one_based_input = one_based_input
        self.weight_init: InitializationMethod = RandomNormal(0.0, 1.0)

    def _pad_row(self) -> int:
        return self.padding_value - (1 if self.one_based_input else 0)

    def _build(self, generator, sample):
        if sample.is_complex() or sample.dtype == torch.bool:
            raise ValueError(f"{self.name()}: index input must be numeric, got {sample.dtype}")
        w = self.weight_init(generator, (self.n_index, self.n_output), self.n_index,
                             self.n_output)
        if self.padding_value is not None:
            w[self._pad_row()] = 0.0
        return {"weight": w}, {}

    def _renorm_rows(self, rows: torch.Tensor) -> torch.Tensor:
        if self.max_norm is None:
            return rows
        p = self.norm_type
        norms = torch.sum(torch.abs(rows) ** p, dim=-1, keepdim=True) ** (1.0 / p)
        return rows * torch.clamp(self.max_norm / torch.clamp(norms, min=1e-7), max=1.0)

    def _apply_params(self, params, state, x, training, rng):
        idx = torch.as_tensor(x).to(torch.int32).long()
        if self.one_based_input:
            idx = idx - 1
        safe = torch.clamp(idx, 0, self.n_index - 1)
        y = F.embedding(safe, params["weight"], scale_grad_by_freq=self.scale_grad_by_freq)
        y = self._renorm_rows(y)
        if self.padding_value is not None:
            y = y * (idx != self._pad_row()).unsqueeze(-1).to(y.dtype)
        return y, state
