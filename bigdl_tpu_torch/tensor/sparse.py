"""``SparseTensor`` — a 2-D COO sparse tensor (counterpart of
``bigdl_tpu/tensor/sparse.py``; reference: ``$DL/tensor/SparseTensor.scala``),
the input of wide&deep's ``SparseLinear``, ``LookupTableSparse`` and
``SparseJoinTable``.

A plain object holding three tensors, ``row_indices`` and ``col_indices``
(int32; cast to int64 where torch indexes with them) and ``values``, plus
the static ``shape``. Entries may repeat a (row, col) pair (they add up)
and may hold zeros: the fixed-capacity batches of ``LocalTableDataSet``
pad with (row 0, col 0, value 0) entries, which add nothing. Products are
a gather and a per-row scatter-add (``index_select``, ``index_add_``);
on the card the scatter-add uses atomics, so its float sums may differ
in the last bits from run to run.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch


def _index(a) -> torch.Tensor:
    return (a if isinstance(a, torch.Tensor) else torch.from_numpy(np.array(a))).to(torch.int32)


def _values(a) -> torch.Tensor:
    """Values as a tensor; float64 becomes float32, as the JAX package's
    arrays are without 64-bit mode."""
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.array(a))
    return t.to(torch.float32) if t.dtype == torch.float64 else t


class SparseTensor:
    """2-D COO sparse tensor; ``shape`` is static, the three arrays are tensors."""

    def __init__(self, row_indices, col_indices, values, shape: Tuple[int, int]):
        self.row_indices = row_indices
        self.col_indices = col_indices
        self.values = values
        self.shape = tuple(shape)

    @staticmethod
    def from_dense(dense) -> "SparseTensor":
        dense = np.asarray(dense)
        rows, cols = np.nonzero(dense)
        return SparseTensor(_index(rows), _index(cols), _values(dense[rows, cols]), dense.shape)

    @staticmethod
    def from_coo(rows, cols, values, shape) -> "SparseTensor":
        return SparseTensor(_index(rows), _index(cols), _values(values), tuple(shape))

    @property
    def device(self) -> torch.device:
        return self.values.device

    def to(self, device) -> "SparseTensor":
        """The same entries with all three tensors on ``device``."""
        return SparseTensor(self.row_indices.to(device), self.col_indices.to(device),
                            self.values.to(device), self.shape)

    def to_dense(self) -> torch.Tensor:
        out = torch.zeros(self.shape, dtype=self.values.dtype, device=self.device)
        return out.index_put_((self.row_indices.long(), self.col_indices.long()), self.values,
                              accumulate=True)

    def dot_dense(self, w: torch.Tensor) -> torch.Tensor:
        """``self @ w`` for a dense (self.shape[1], k) ``w``: w's rows at the
        column ids, scaled by the values, summed per row."""
        contrib = w.index_select(0, self.col_indices.long()) * self.values[:, None]
        out = contrib.new_zeros((self.shape[0], contrib.shape[1]))
        return out.index_add_(0, self.row_indices.long(), contrib)

    @property
    def nnz(self) -> int:
        return int(self.values.shape[0])

    def __repr__(self):
        return f"SparseTensor(shape={self.shape}, nnz={self.nnz})"


def sparse_join(tensors: Sequence[SparseTensor]) -> SparseTensor:
    """Concatenate along dim 1 (reference: ``$DL/nn/SparseJoinTable.scala``)."""
    offs = np.cumsum([0] + [t.shape[1] for t in tensors[:-1]])
    rows = torch.cat([t.row_indices for t in tensors])
    cols = torch.cat([t.col_indices + int(o) for t, o in zip(tensors, offs)])
    vals = torch.cat([t.values for t in tensors])
    n_cols = int(sum(t.shape[1] for t in tensors))
    return SparseTensor(rows, cols, vals, (tensors[0].shape[0], n_cols))
