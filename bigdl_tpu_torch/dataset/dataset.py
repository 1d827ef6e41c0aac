"""In-memory training data (counterpart of the array and ``Table`` parts of
``bigdl_tpu/dataset/dataset.py``).

Batches are assembled on the host; the optimizer moves each to the card
(:func:`to_device`, which maps over a ``Table`` and moves a
``SparseTensor`` whole). ``LocalArrayDataSet`` gathers rows of dense
arrays; ``LocalTableDataSet`` gathers a ``Table`` of feature columns, any
of which may be a ``SparseTensor`` (wide&deep's input). The epoch order is
the JAX package's formula, ``np.random.default_rng((seed,
epoch)).permutation(n)``, so both packages visit the records in the same
order for the same seed. ``pad_minibatch`` pads a short batch back to a
step's row count by repeating row 0 (the ragged-tail seam of training and
evaluation). A batch holding a ``SparseTensor`` is never row-padded (its
entries are not rows): a ragged evaluation tail of one runs at its own row
count and a ragged train batch of one is dropped. (The JAX package's
``pad_minibatch`` pads any leaf whose length equals the row count, so a
sparse column with one entry a row gets its entries repeated while its
shape keeps the old row count; the port does not copy that.) Transformer
chains wait for a later slice of the port.
"""

from __future__ import annotations

from typing import Iterator, Optional

import numpy as np
import torch

from ..tensor.sparse import SparseTensor
from ..utils.random import RandomGenerator
from ..utils.table import T, Table


class MiniBatch:
    """Batched features and labels."""

    def __init__(self, input, target=None):
        self.input = input
        self.target = target

    def size(self) -> int:
        return rows_of(self.input)

    def get_input(self):
        return self.input

    def get_target(self):
        return self.target


def rows_of(x) -> int:
    """A batch's rows: the leading dim of its first leaf (a ``Table``'s or a
    list's first entry, walked down; a ``SparseTensor``'s ``shape[0]``)."""
    while isinstance(x, (Table, list, tuple)):
        x = next(iter(x))
    return int(x.shape[0] if hasattr(x, "shape") else np.shape(x)[0])


def to_device(x, device: Optional[torch.device] = None):
    """A numpy array or tensor as a tensor on ``device`` (None: where it
    is, the host for an array); a host tensor goes to the card from pinned
    memory without blocking (a pageable copy would wait for the queued step).
    A ``Table`` is moved entry by entry, a ``SparseTensor`` as its three
    tensors."""
    if isinstance(x, Table):
        return Table({k: to_device(v, device) for k, v in x.items()})
    if isinstance(x, SparseTensor):
        return SparseTensor(to_device(x.row_indices, device), to_device(x.col_indices, device),
                            to_device(x.values, device), x.shape)
    t = torch.from_numpy(np.ascontiguousarray(x)) if isinstance(x, np.ndarray) else torch.as_tensor(x)
    if device is None or t.device == device:
        return t
    if device.type == "cuda" and t.device.type == "cpu":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def pad_rows(tree, n: int, total: int):
    """Each leaf's leading dim padded from ``n`` to ``total`` rows by
    repeating row 0 (numpy on the host, torch where the tensor is), or None
    when a leaf is not batched on its leading dim or is a ``SparseTensor``."""
    if isinstance(tree, SparseTensor):
        return None
    if isinstance(tree, Table):
        out = {k: pad_rows(v, n, total) for k, v in tree.items()}
        return None if any(v is None for v in out.values()) else Table(out)
    if isinstance(tree, (list, tuple)):
        out = [pad_rows(v, n, total) for v in tree]
        return None if any(v is None for v in out) else type(tree)(out)
    shape = getattr(tree, "shape", None)
    if not shape or shape[0] != n:
        return None
    if isinstance(tree, torch.Tensor):
        return torch.cat([tree, tree[:1].expand((total - n,) + tuple(shape[1:]))])
    a = np.asarray(tree)
    return np.concatenate([a, np.broadcast_to(a[:1], (total - n,) + a.shape[1:])])


def pad_minibatch(batch: "MiniBatch", total: int):
    """Pad a short MiniBatch to ``total`` rows by repeating row 0: returns
    ``(padded_batch, n_real)``, or None when a leaf of the input or target
    is not a dense array batched on its leading dim (a scalar target
    cannot be row-padded, nor can a ``SparseTensor``). On the host, before
    the copy to the card."""
    n = batch.size()
    if n >= total:
        return batch, n
    x = pad_rows(batch.get_input(), n, total)
    if x is None:
        return None
    t = batch.get_target()
    if t is not None:
        t = pad_rows(t, n, total)
        if t is None:
            return None
    return MiniBatch(x, t), n


def _epoch_order(n: int, epoch: Optional[int]) -> np.ndarray:
    """Deterministic per-epoch permutation seeded by (global seed, epoch); with
    ``epoch=None``, a draw from the global numpy stream."""
    if epoch is None:
        order = np.arange(n)
        RandomGenerator.numpy_rng().shuffle(order)
        return order
    return np.random.default_rng((RandomGenerator.get_seed(), int(epoch))).permutation(n)


class AbstractDataSet:
    def size(self) -> int:
        raise NotImplementedError

    def shuffle(self, epoch: Optional[int] = None) -> None:
        pass

    def data(self, train: bool) -> Iterator[MiniBatch]:
        """Finite iterator over one epoch of MiniBatches."""
        raise NotImplementedError


class LocalArrayDataSet(AbstractDataSet):
    """Dataset over (features, labels) arrays; each batch is one fancy-index
    gather in epoch order. Training drops the ragged last batch (reference
    semantics); evaluation keeps it."""

    def __init__(self, features, labels=None, batch_size: int = 32):
        self.features = np.asarray(features)
        self.labels = None if labels is None else np.asarray(labels)
        if self.labels is not None and len(self.labels) != len(self.features):
            raise ValueError(f"{len(self.labels)} labels for {len(self.features)} records")
        self.batch_size = batch_size
        self._order = np.arange(len(self.features))

    def size(self) -> int:
        return len(self.features)

    def shuffle(self, epoch: Optional[int] = None) -> None:
        self._order = _epoch_order(len(self.features), epoch)

    def data(self, train: bool) -> Iterator[MiniBatch]:
        bs = self.batch_size
        for start in range(0, len(self._order), bs):
            idx = self._order[start:start + bs]
            if train and len(idx) < bs:
                break
            yield MiniBatch(self.features[idx],
                            None if self.labels is None else self.labels[idx])


class LocalTableDataSet(AbstractDataSet):
    """Dataset over a ``Table`` of feature columns (counterpart of the JAX
    package's; reference: ``SparseMiniBatch``, feeding wide&deep). Dense
    columns are gathered like ``LocalArrayDataSet``'s. A ``SparseTensor``
    column is sorted by row once (host-side CSR: each record's entries are
    one slice); each batch's copy of it has a FIXED nnz capacity, batch size
    times the most entries a record has, its unused entries (row 0, col 0,
    value 0), as in the JAX package, so every full batch has one shape.
    Training drops the ragged last batch; evaluation keeps it."""

    def __init__(self, features, labels=None, batch_size: int = 32):
        if not isinstance(features, Table):
            raise TypeError("LocalTableDataSet needs a Table of feature columns")
        self._cols = list(features)
        self.labels = None if labels is None else np.asarray(labels)
        self.batch_size = batch_size
        ns = {c.shape[0] for c in self._cols}
        if len(ns) != 1:
            raise ValueError(f"feature columns disagree on row count: {ns}")
        self.n = ns.pop()
        self._order = np.arange(self.n)
        self._sparse = {}  # column -> (cols, values, row starts, most entries a row)
        for j, c in enumerate(self._cols):
            if isinstance(c, SparseTensor):
                rows, cols, vals = (t.cpu().numpy() for t in (c.row_indices, c.col_indices,
                                                              c.values))
                order = np.argsort(rows, kind="stable")
                counts = np.bincount(rows, minlength=self.n)
                starts = np.concatenate([[0], np.cumsum(counts)])
                self._sparse[j] = (cols[order], vals[order], starts, int(counts.max()))
            else:
                self._cols[j] = np.asarray(c)

    def size(self) -> int:
        return self.n

    def shuffle(self, epoch: Optional[int] = None) -> None:
        self._order = _epoch_order(self.n, epoch)

    def _slice_sparse(self, j: int, idx: np.ndarray, n_cols: int) -> SparseTensor:
        """Records ``idx``'s entries of sparse column j, renumbered to rows
        0..len(idx)-1 in that order, at the batch's fixed capacity."""
        cols, vals, starts, per_row = self._sparse[j]
        lens = starts[idx + 1] - starts[idx]
        k = int(lens.sum())
        src = np.repeat(starts[idx] - (np.cumsum(lens) - lens), lens) + np.arange(k)
        cap = len(idx) * per_row
        out_r, out_c = np.zeros(cap, np.int32), np.zeros(cap, np.int32)
        out_v = np.zeros(cap, vals.dtype)
        out_r[:k] = np.repeat(np.arange(len(idx), dtype=np.int32), lens)
        out_c[:k], out_v[:k] = cols[src], vals[src]
        return SparseTensor(torch.from_numpy(out_r), torch.from_numpy(out_c),
                            torch.from_numpy(out_v), (len(idx), n_cols))

    def data(self, train: bool) -> Iterator[MiniBatch]:
        bs = self.batch_size
        for start in range(0, self.n, bs):
            idx = self._order[start:start + bs]
            if train and len(idx) < bs:
                break
            cols = [self._slice_sparse(j, idx, c.shape[1]) if j in self._sparse else c[idx]
                    for j, c in enumerate(self._cols)]
            yield MiniBatch(T(*cols), None if self.labels is None else self.labels[idx])


class DataSet:
    """Factory facade (reference: ``object DataSet``)."""

    @staticmethod
    def array(features, labels=None, batch_size: int = 32, transformer=None) -> AbstractDataSet:
        """A ``LocalTableDataSet`` for a ``Table`` of feature columns, else a
        ``LocalArrayDataSet``."""
        if transformer is not None:
            raise NotImplementedError(
                "transformer chains are not ported yet; pass arrays of batched records")
        if isinstance(features, Table):
            return LocalTableDataSet(features, labels, batch_size)
        return LocalArrayDataSet(features, labels, batch_size)
