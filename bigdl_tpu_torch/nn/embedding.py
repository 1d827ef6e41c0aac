"""Embedding layers (counterpart of ``bigdl_tpu/nn/embedding.py``).
``LookupTable`` (reference: ``LookupTable.scala``) maps indices to rows of
an (n_index, n_output) table, with the JAX package's semantics:

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

The sparse layers over a ``SparseTensor`` (reference:
``LookupTableSparse.scala``, ``DenseToSparse.scala``,
``SparseJoinTable.scala``), with the JAX package's semantics:

* ``LookupTableSparse`` embeds the feature ids held in the VALUES of a
  ``SparseTensor`` and combines each row's embeddings by ``sum``, ``mean``
  or ``sqrtn``. Ids are 1-based; id 0 marks an absent entry, which adds
  nothing and is left out of the mean and sqrtn counts (a row with none
  divides by 1). ``max_norm`` renormalises each gathered row to an L2
  norm of at most ``max_norm``;
* ``DenseToSparse`` turns an (n, m) matrix into a ``SparseTensor`` of
  fixed capacity n * m, zero values kept (they are absent ids);
* ``SparseJoinTable`` concatenates a ``Table`` of ``SparseTensor`` s
  along the feature dim (``sparse_join``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..tensor.sparse import SparseTensor, sparse_join
from .initialization import InitializationMethod, RandomNormal
from .module import AbstractModule, spec


class LookupTable(AbstractModule):

    def infer_shape(self, in_spec):
        if in_spec.is_complex() or in_spec.dtype == torch.bool:
            raise ValueError(f"{self.name()}: index input must be numeric, got {in_spec.dtype}")
        return spec(tuple(in_spec.shape) + (self.n_output,), torch.float32)
    def __init__(self, n_index: int, n_output: int, padding_value: Optional[int] = None,
                 max_norm: Optional[float] = None, norm_type: float = 2.0,
                 should_scale_grad_by_freq: bool = False, one_based_input: bool = False,
                 w_regularizer=None, device=None):
        super().__init__(device)
        self.w_regularizer = w_regularizer
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

    def regularization_loss(self, params):
        if self.w_regularizer is None:
            return 0.0
        return self.w_regularizer(params["weight"])


class LookupTableSparse(AbstractModule):

    def infer_shape(self, in_spec):
        if not isinstance(in_spec, SparseTensor):
            raise ValueError(f"{self.name()}: expects a SparseTensor of feature ids, got "
                             f"{type(in_spec).__name__}")
        return spec((in_spec.shape[0], self.n_output), torch.float32)
    def __init__(self, n_index: int, n_output: int, combiner: str = "sum",
                 max_norm: Optional[float] = None, device=None):
        super().__init__(device)
        if combiner not in ("sum", "mean", "sqrtn"):
            raise ValueError(f"unknown combiner {combiner!r}")
        self.n_index = n_index
        self.n_output = n_output
        self.combiner = combiner
        self.max_norm = max_norm
        self.weight_init: InitializationMethod = RandomNormal(0.0, 1.0)

    def _build(self, generator, sample):
        if not isinstance(sample, SparseTensor):
            raise ValueError(f"{self.name()}: expects a SparseTensor of feature ids, got "
                             f"{type(sample).__name__}")
        return {"weight": self.weight_init(generator, (self.n_index, self.n_output),
                                           self.n_index, self.n_output)}, {}

    def _apply_params(self, params, state, x, training, rng):
        if not isinstance(x, SparseTensor):
            raise TypeError(f"{self.name()} expects a SparseTensor input")
        w = params["weight"]
        ids = x.values.to(torch.int32).long()  # 1-based; 0 = absent
        present = (ids > 0).to(w.dtype)
        rows = w[torch.clamp(ids - 1, 0, self.n_index - 1)]
        if self.max_norm is not None:
            norms = torch.linalg.vector_norm(rows, dim=-1, keepdim=True)
            rows = rows * torch.clamp(self.max_norm / torch.clamp(norms, min=1e-7), max=1.0)
        rows = rows * present[:, None]
        seg = x.row_indices.long()
        summed = rows.new_zeros((x.shape[0], self.n_output)).index_add_(0, seg, rows)
        if self.combiner == "sum":
            return summed, state
        counts = present.new_zeros(x.shape[0]).index_add_(0, seg, present)[:, None]
        counts = torch.clamp(counts, min=1.0)
        if self.combiner == "mean":
            return summed / counts, state
        return summed / torch.sqrt(counts), state


class DenseToSparse(AbstractModule):

    infer_shape = AbstractModule._infer_shape_via_apply  # parameter-less
    def _apply_params(self, params, state, x, training, rng):
        n, m = x.shape
        rows = torch.arange(n, dtype=torch.int32, device=x.device).repeat_interleave(m)
        cols = torch.arange(m, dtype=torch.int32, device=x.device).repeat(n)
        return SparseTensor(rows, cols, x.reshape(-1), (n, m)), state


class SparseJoinTable(AbstractModule):

    infer_shape = AbstractModule._infer_shape_via_apply  # parameter-less
    def __init__(self, dimension: int = 2, device=None):
        super().__init__(device)
        if dimension != 2:
            raise ValueError("SparseJoinTable supports dimension=2 (feature dim)")
        self.dimension = dimension

    def _apply_params(self, params, state, x, training, rng):
        return sparse_join(list(x)), state
