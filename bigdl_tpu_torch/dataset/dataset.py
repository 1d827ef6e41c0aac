"""In-memory training data (counterpart of the array part of
``bigdl_tpu/dataset/dataset.py``).

Batches are numpy arrays assembled on the host; the optimizer moves each to
the card (:func:`to_device`). The epoch order is the JAX package's formula,
``np.random.default_rng((seed, epoch)).permutation(n)``, so both packages
visit the records in the same order for the same seed. ``pad_minibatch``
pads a short batch back to a step's row count by repeating row 0 (the
ragged-tail seam of training and evaluation). Transformer chains and
``Table`` features wait for a later slice of the port.
"""

from __future__ import annotations

from typing import Iterator, Optional

import numpy as np
import torch

from ..utils.random import RandomGenerator


class MiniBatch:
    """Batched features and labels."""

    def __init__(self, input, target=None):
        self.input = input
        self.target = target

    def size(self) -> int:
        return int(np.shape(self.input)[0])

    def get_input(self):
        return self.input

    def get_target(self):
        return self.target


def to_device(x, device: Optional[torch.device] = None) -> torch.Tensor:
    """A numpy array or tensor as a tensor on ``device`` (None: where it
    is, the host for an array); a host tensor goes to the card from pinned
    memory without blocking (a pageable copy would wait for the queued step)."""
    t = torch.from_numpy(np.ascontiguousarray(x)) if isinstance(x, np.ndarray) else torch.as_tensor(x)
    if device is None or t.device == device:
        return t
    if device.type == "cuda" and t.device.type == "cpu":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def _pad_tree(tree, n: int, total: int):
    """Each leaf's leading dim padded from ``n`` to ``total`` rows by
    repeating row 0, or None when a leaf is not batched on its leading dim."""
    if isinstance(tree, (list, tuple)):
        out = [_pad_tree(v, n, total) for v in tree]
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
    cannot be row-padded). On the host, before the copy to the card."""
    n = batch.size()
    if n >= total:
        return batch, n
    x = _pad_tree(batch.get_input(), n, total)
    if x is None:
        return None
    t = batch.get_target()
    if t is not None:
        t = _pad_tree(t, n, total)
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


class DataSet:
    """Factory facade (reference: ``object DataSet``)."""

    @staticmethod
    def array(features, labels=None, batch_size: int = 32,
              transformer=None) -> LocalArrayDataSet:
        if transformer is not None:
            raise NotImplementedError(
                "transformer chains are not ported yet; pass arrays of batched records")
        return LocalArrayDataSet(features, labels, batch_size)
