"""Training data core (counterpart of ``bigdl_tpu/dataset/dataset.py``;
reference: ``DataSet.scala``, ``Sample.scala``, ``MiniBatch.scala``,
``Transformer.scala``).

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
shape keeps the old row count; the port does not copy that.)

``Transformer`` chains (composed with ``//`` or ``and_then``) turn the
``Sample`` stream of ``LocalArrayDataSet.samples`` into ``MiniBatch`` es
(``SampleToMiniBatch``, with ``padding_value`` for variable-length
features); without a chain ``LocalArrayDataSet`` gathers each batch with
one ``native.gather_rows`` (the host library's threaded copy for float32
batches of 1 MiB or more). ``BucketedTextDataSet`` batches token sequences
by length bucket; ``DistributedDataSet`` keeps the batches whose rows
divide into ``n_devices`` (host-side: the port trains on one card). The
``DataSet`` facade builds each of them, a ``DataPipeline``, an image
folder and record shards. Every batch stream here is the JAX package's,
byte for byte, for the same seed.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator, List, Optional

import numpy as np
import torch

from ..tensor.sparse import SparseTensor
from ..utils.random import RandomGenerator
from ..utils.table import T, Table


class Sample:
    """One record: a feature and a label (reference: ``Sample``/``ArraySample``)."""

    __slots__ = ("feature", "label")

    def __init__(self, feature, label=None):
        self.feature = feature
        self.label = label

    def __repr__(self):
        f = np.shape(self.feature)
        return f"Sample(feature{f}, label={self.label!r})"


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

    def slice(self, offset: int, length: int) -> "MiniBatch":
        """Rows ``[offset, offset + length)`` of every leaf."""
        return self.take(slice(offset, offset + length))

    def take(self, rows) -> "MiniBatch":
        """Every leaf indexed by ``rows`` (a slice or an index array)."""
        return MiniBatch(map_batch(lambda a: a[rows], self.input),
                         map_batch(lambda a: a[rows], self.target))


def map_batch(fn, tree):
    """``tree`` (nested ``Table`` s, dicts, lists and tuples) with ``fn``
    applied to each leaf."""
    if isinstance(tree, Table):
        return Table({k: map_batch(fn, v) for k, v in tree.items()})
    if isinstance(tree, dict):
        return {k: map_batch(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_batch(fn, v) for v in tree)
    return None if tree is None else fn(tree)


def batch_leaves(tree, path: str = "input"):
    """``(path, leaf)`` for every leaf of a batch tree, in the JAX package's
    pytree order (a ``Table`` 's and a list's in order, a dict's by sorted
    key); a ``SparseTensor`` is one leaf."""
    if isinstance(tree, Table):
        for k, v in tree.items():
            yield from batch_leaves(v, f"{path}[{k!r}]")
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from batch_leaves(tree[k], f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from batch_leaves(v, f"{path}[{i}]")
    elif tree is not None:
        yield path, tree


def rows_of(x) -> int:
    """A batch's rows: the leading dim of its first leaf (a ``Table``'s or a
    list's first entry, walked down; a ``SparseTensor``'s ``shape[0]``)."""
    while isinstance(x, (Table, list, tuple)):
        x = next(iter(x))
    return int(x.shape[0] if hasattr(x, "shape") else np.shape(x)[0])


def to_device(x, device: Optional[torch.device] = None, pinned: Optional[list] = None):
    """A numpy array or tensor as a tensor on ``device`` (None: where it
    is, the host for an array); a host tensor goes to the card from pinned
    memory without blocking (a pageable copy would wait for the queued step)
    on the current stream; ``pinned``, when given, collects the pinned host
    copies so that a caller can keep them alive past the copy. A ``Table``
    is moved entry by entry, a ``SparseTensor`` as its three tensors."""
    if isinstance(x, Table):
        return Table({k: to_device(v, device, pinned) for k, v in x.items()})
    if isinstance(x, SparseTensor):
        return SparseTensor(to_device(x.row_indices, device, pinned),
                            to_device(x.col_indices, device, pinned),
                            to_device(x.values, device, pinned), x.shape)
    t = torch.from_numpy(np.ascontiguousarray(x)) if isinstance(x, np.ndarray) else torch.as_tensor(x)
    if device is None or t.device == device:
        return t
    if device.type == "cuda" and t.device.type == "cpu":
        host = t.pin_memory()
        if pinned is not None:
            pinned.append(host)
        return host.to(device, non_blocking=True)
    return t.to(device)


def device_tensors(x):
    """Every tensor of a batch leaf tree (a ``Table``'s entries, a
    ``SparseTensor``'s three tensors), in order."""
    if isinstance(x, Table):
        for _, v in x.items():
            yield from device_tensors(v)
    elif isinstance(x, SparseTensor):
        yield from (x.row_indices, x.col_indices, x.values)
    elif isinstance(x, torch.Tensor):
        yield x


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


class Transformer:
    """Iterator -> iterator stage; compose with ``//`` or ``.and_then`` (the
    reference composes with ``->``, which Python cannot overload)."""

    def apply(self, it: Iterator) -> Iterator:
        raise NotImplementedError

    def __call__(self, it):
        return self.apply(iter(it))

    def and_then(self, other: "Transformer") -> "Transformer":
        return _Chained(self, other)

    def __floordiv__(self, other: "Transformer") -> "Transformer":
        return self.and_then(other)


class _Chained(Transformer):
    def __init__(self, first: Transformer, second: Transformer):
        self.first, self.second = first, second

    def apply(self, it):
        return self.second.apply(self.first.apply(it))


class Lambda(Transformer):
    """``fn`` applied to every item."""

    def __init__(self, fn: Callable[[Any], Any]):
        self.fn = fn

    def apply(self, it):
        return (self.fn(x) for x in it)


class SampleToMiniBatch(Transformer):
    """Group Samples into MiniBatches (reference: ``SampleToMiniBatch`` with
    an optional ``PaddingParam``: with ``padding_value``, each feature is
    padded on its first axis to the longest of its batch)."""

    def __init__(self, batch_size: int, padding_value: Optional[float] = None,
                 drop_remainder: bool = False):
        self.batch_size = batch_size
        self.padding_value = padding_value
        self.drop_remainder = drop_remainder

    def _stack(self, items: List[np.ndarray]) -> np.ndarray:
        if self.padding_value is not None:
            max_len = max(np.shape(i)[0] for i in items)
            items = [np.pad(np.asarray(i),
                            [(0, max_len - np.shape(i)[0])] + [(0, 0)] * (np.ndim(i) - 1),
                            constant_values=self.padding_value)
                     for i in items]
        return np.stack([np.asarray(i) for i in items])

    def apply(self, it):
        buf: List[Sample] = []
        for s in it:
            buf.append(s)
            if len(buf) == self.batch_size:
                yield self._to_batch(buf)
                buf = []
        if buf and not self.drop_remainder:
            yield self._to_batch(buf)

    def _to_batch(self, buf: List[Sample]) -> MiniBatch:
        feats = self._stack([s.feature for s in buf])
        labels = None
        if buf[0].label is not None:
            labels = np.stack([np.asarray(s.label) for s in buf])
        return MiniBatch(feats, labels)


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
    """Dataset over (features, labels) arrays (reference: ``DataSet.array``).
    Without a ``transformer`` each batch is one ``native.gather_rows`` in
    epoch order; with one, the chain runs over the epoch's ``Sample`` s and
    yields what it makes (end it with a ``SampleToMiniBatch``). Training
    drops the ragged last batch (reference semantics); evaluation keeps it."""

    def __init__(self, features, labels=None, transformer: Optional[Transformer] = None,
                 batch_size: int = 32):
        self.features = np.asarray(features)
        self.labels = None if labels is None else np.asarray(labels)
        if self.labels is not None and len(self.labels) != len(self.features):
            raise ValueError(f"{len(self.labels)} labels for {len(self.features)} records")
        self.transformer = transformer
        self.batch_size = batch_size
        self._order = np.arange(len(self.features))

    def size(self) -> int:
        return len(self.features)

    def shuffle(self, epoch: Optional[int] = None) -> None:
        self._order = _epoch_order(len(self.features), epoch)

    def _samples(self) -> Iterator[Sample]:
        for i in self._order:
            yield Sample(self.features[i], None if self.labels is None else self.labels[i])

    def samples(self, train: bool) -> Iterator[Sample]:
        """The record stream in epoch order: the ``DataPipeline`` source seam."""
        return self._samples()

    def data(self, train: bool) -> Iterator[MiniBatch]:
        if self.transformer is None:
            from ..native import gather_rows

            bs = self.batch_size
            for start in range(0, len(self._order), bs):
                idx = self._order[start:start + bs]
                if train and len(idx) < bs:
                    break
                yield MiniBatch(gather_rows(self.features, idx),
                                None if self.labels is None else self.labels[idx])
            return
        yield from self.transformer.apply(self._samples())


class BucketedTextDataSet(AbstractDataSet):
    """Variable-length token sequences batched by length bucket (the JAX
    package's; TF's ``bucket_by_sequence_length``): each sequence joins the
    smallest boundary that holds it, each bucket's batches are padded
    (``pad_id``, trailing) to its boundary, longer sequences are cut to the
    last boundary (counted in ``truncated_count``), and a training epoch's
    batches are shuffled across buckets from ``(seed, epoch)``. Ragged
    training batches are dropped."""

    def __init__(self, sequences, labels=None, boundaries=(64, 128, 256),
                 batch_size: int = 32, pad_id: int = 0):
        if not boundaries or list(boundaries) != sorted(set(boundaries)):
            raise ValueError(f"boundaries must be ascending and unique, got {boundaries}")
        self.boundaries = tuple(int(b) for b in boundaries)
        self.batch_size = batch_size
        self.pad_id = pad_id
        if pad_id != 0:
            import warnings

            warnings.warn(f"pad_id={pad_id}: the framework's lengths/pad masking assumes pad "
                          "id 0; nonzero pads are NOT masked by Transformer(pad_masking=...)",
                          stacklevel=3)
        self.labels = None if labels is None else np.asarray(labels)
        self._buckets = {b: [] for b in self.boundaries}  # boundary -> [idx]
        self.truncated_count = 0
        self._seqs = []
        for i, s in enumerate(sequences):
            s = np.asarray(s)
            if s.ndim != 1:
                raise ValueError(f"sequence {i} has shape {s.shape}; expected 1-D ids")
            if len(s) > self.boundaries[-1]:
                s = s[: self.boundaries[-1]]
                self.truncated_count += 1
            self._seqs.append(s)
            for b in self.boundaries:
                if len(s) <= b:
                    self._buckets[b].append(i)
                    break
        if self.labels is not None and len(self.labels) != len(self._seqs):
            raise ValueError(f"{len(self.labels)} labels for {len(self._seqs)} sequences")
        # one dtype for every batch
        self._dtype = np.result_type(*self._seqs) if self._seqs else np.dtype(np.int32)
        self._epoch = 0

    def size(self) -> int:
        return len(self._seqs)

    def shuffle(self, epoch: Optional[int] = None) -> None:
        self._epoch = epoch if epoch is not None else self._epoch + 1

    def _batches_of(self, b: int, rng) -> list:
        idx = np.asarray(self._buckets[b], dtype=np.int64)
        if rng is not None:
            idx = idx[rng.permutation(len(idx))]
        return [(b, idx[s:s + self.batch_size]) for s in range(0, len(idx), self.batch_size)]

    def data(self, train: bool) -> Iterator[MiniBatch]:
        rng = np.random.default_rng((RandomGenerator.get_seed(), self._epoch))
        batches = []
        for b in self.boundaries:
            batches.extend(self._batches_of(b, rng if train else None))
        if train:
            batches = [batches[i] for i in rng.permutation(len(batches))]
        for b, idx in batches:
            if train and len(idx) < self.batch_size:
                continue
            x = np.full((len(idx), b), self.pad_id, self._dtype)
            for row, i in enumerate(idx):
                s = self._seqs[i]
                x[row, : len(s)] = s
            yield MiniBatch(x, None if self.labels is None else self.labels[idx])


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


class DistributedDataSet(AbstractDataSet):
    """The batches of ``base`` whose rows divide into ``n_devices`` (a ragged
    training batch that does not is dropped; evaluation keeps every batch):
    the JAX package's partition <-> device wrapper, on the host only."""

    def __init__(self, base: AbstractDataSet, n_devices: int):
        self.base = base
        self.n_devices = n_devices

    def size(self) -> int:
        return self.base.size()

    @property
    def supports_skip_positions(self) -> bool:
        """Forwarded from the base dataset (a ``DataPipeline`` takes
        ``skip_positions`` at its source)."""
        return bool(getattr(self.base, "supports_skip_positions", False))

    def shuffle(self, epoch: Optional[int] = None) -> None:
        self.base.shuffle(epoch)

    def data(self, train: bool, skip_positions=None) -> Iterator[MiniBatch]:
        if skip_positions is not None and self.supports_skip_positions:
            inner = self.base.data(train, skip_positions=skip_positions)
        else:
            inner = self.base.data(train)
        return _DivisibleStream(inner, self.n_devices, train)


class _DivisibleStream:
    """``DistributedDataSet``'s filter as a stream that keeps the base
    stream's ``qsize`` and ``close``."""

    def __init__(self, inner, n_devices: int, train: bool):
        self._inner = iter(inner)
        self._raw = inner
        self._n = n_devices
        self._train = train

    def __iter__(self) -> "_DivisibleStream":
        return self

    def __next__(self) -> MiniBatch:
        while True:
            batch = next(self._inner)
            if batch.size() % self._n == 0 or not self._train:
                return batch

    def qsize(self) -> int:
        q = getattr(self._raw, "qsize", None)
        return q() if q is not None else 0

    def close(self) -> None:
        c = getattr(self._raw, "close", None)
        if c is not None:
            c()


class DataSet:
    """Factory facade (reference: ``object DataSet``)."""

    @staticmethod
    def array(features, labels=None, batch_size: int = 32,
              transformer: Optional[Transformer] = None) -> AbstractDataSet:
        """A ``LocalTableDataSet`` for a ``Table`` of feature columns, else a
        ``LocalArrayDataSet``."""
        if isinstance(features, Table):
            if transformer is not None:
                raise ValueError("transformer chains are not supported on Table features")
            return LocalTableDataSet(features, labels, batch_size)
        return LocalArrayDataSet(features, labels, transformer, batch_size)

    @staticmethod
    def distributed(base: AbstractDataSet, n_devices: int) -> DistributedDataSet:
        return DistributedDataSet(base, n_devices)

    @staticmethod
    def bucket_by_length(sequences, labels=None, boundaries=(64, 128, 256),
                         batch_size: int = 32, pad_id: int = 0) -> BucketedTextDataSet:
        """Length-bucketed batches of token sequences (:class:`BucketedTextDataSet`)."""
        return BucketedTextDataSet(sequences, labels, boundaries, batch_size, pad_id)

    @staticmethod
    def pipeline(source: AbstractDataSet, transformer: Optional[Transformer] = None,
                 num_workers: int = 4, **kw):
        """A worker pool's transform and batch assembly over a record source,
        byte-identical for any worker count (:class:`.pipeline.DataPipeline`)."""
        from .pipeline import DataPipeline

        return DataPipeline(source, transformer, num_workers=num_workers, **kw)

    @staticmethod
    def image_folder(path: str, batch_size: int = 32, **kw):
        """A class-per-subdirectory image tree (reference: ``DataSet.ImageFolder``)."""
        from .files import ImageFolderDataSet

        return ImageFolderDataSet(path, batch_size=batch_size, **kw)

    @staticmethod
    def record_shards(shard_paths, decode, batch_size: int = 32, **kw):
        """Record shard files (reference: ``DataSet.SeqFileFolder``)."""
        from .files import ShardedRecordDataSet

        return ShardedRecordDataSet(shard_paths, decode, batch_size=batch_size, **kw)
