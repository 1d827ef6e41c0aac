"""File-backed datasets: record shards and an image folder (counterpart of
``bigdl_tpu/dataset/files.py``; reference: ``DataSet.SeqFileFolder``,
``DataSet.ImageFolder``).

``write_record_shards`` writes ``(payload, label)`` records into
``BDLSHRD1`` shard files (magic, uint32 count, then per record int64 label,
uint32 length and the bytes), the SequenceFile analog;
``ShardedRecordDataSet`` reads them and ``ImageFolderDataSet`` reads a
class-per-subdirectory image tree. A pool of decode worker threads (numpy
and PIL release the GIL for the heavy parts) decodes "units" (a shard, or
a run of files) concurrently and reassembles them in unit order: eval in
ascending order, training in the epoch's seeded unit permutation with a
seeded shuffle inside each unit, so the sample stream is a pure function
of (seed, epoch) for any worker count -- what ``DataPipeline``'s
byte-identical contract and a resume's data position stand on. The
files are the JAX package's: each package reads shards the other wrote.

``shard(index, count)`` restricts a dataset to its modulo slice of the
units, taken before the epoch permutation, so a record's owner never moves
between epochs and the union over owners covers every record once.
"""

from __future__ import annotations

import logging
import os
import queue
import struct
import threading
from typing import Callable, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ..utils.random import RandomGenerator
from .dataset import AbstractDataSet, MiniBatch, Sample, SampleToMiniBatch, Transformer

_log = logging.getLogger("bigdl_tpu_torch.dataset")

_MAGIC = b"BDLSHRD1"


def write_record_shards(
    records,
    directory: str,
    records_per_shard: int = 1024,
    prefix: str = "part",
) -> List[str]:
    """Write (payload: bytes, label: int) pairs into numbered shard files.

    The offline analog of building SequenceFiles for ``DataSet.SeqFileFolder``
    (BigDL ships an ImageNet "seq file generator" tool); format per shard:
    magic, uint32 count, then per record uint64 label + uint32 length + bytes.
    """
    os.makedirs(directory, exist_ok=True)
    paths: List[str] = []
    buf: List[Tuple[bytes, int]] = []

    def flush():
        if not buf:
            return
        path = os.path.join(directory, f"{prefix}-{len(paths):05d}.bin")
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(_MAGIC)
            f.write(struct.pack("<I", len(buf)))
            for payload, label in buf:
                f.write(struct.pack("<qI", int(label), len(payload)))
                f.write(payload)
        os.replace(tmp, path)
        paths.append(path)
        buf.clear()

    for payload, label in records:
        buf.append((bytes(payload), label))
        if len(buf) == records_per_shard:
            flush()
    flush()
    return paths


def read_record_shard(path: str) -> List[Tuple[bytes, int]]:
    """Read every (payload, label) record of one shard."""
    with open(path, "rb") as f:
        if f.read(len(_MAGIC)) != _MAGIC:
            raise ValueError(f"{path}: not a record shard (bad magic)")
        (count,) = struct.unpack("<I", f.read(4))
        out = []
        for _ in range(count):
            label, length = struct.unpack("<qI", f.read(12))
            out.append((f.read(length), label))
        return out


def record_shard_count(path: str) -> int:
    with open(path, "rb") as f:
        if f.read(len(_MAGIC)) != _MAGIC:
            raise ValueError(f"{path}: not a record shard (bad magic)")
        return struct.unpack("<I", f.read(4))[0]


class _ShardedDataSet(AbstractDataSet):
    """Common machinery: per-epoch seeded permutation, worker-threaded decode
    of "units" (shards or file chunks), deterministic unit-order reassembly,
    per-host modulo sharding, transformer chain, batch assembly."""

    def __init__(self, batch_size: int, n_workers: int,
                 transformer: Optional[Transformer]):
        self.batch_size = batch_size
        self.n_workers = max(1, n_workers)
        self.transformer = transformer
        self._epoch = 0
        self._shard_index = 0
        self._shard_count = 1

    # subclass surface -----------------------------------------------------
    def _n_units(self) -> int:
        raise NotImplementedError

    def _decode_unit(self, unit_index: int, epoch_rng: np.random.Generator
                     ) -> List[Sample]:
        raise NotImplementedError

    # ----------------------------------------------------------------------
    def shard(self, index: int, count: int) -> "_ShardedDataSet":
        """Restrict this dataset to host ``index``'s modulo slice of the
        shard units (``unit % count == index``) — the per-host partition
        seam for multi-host training. Stable across epochs: the slice is taken
        BEFORE the epoch permutation, so a record's owning host never moves
        and the union over hosts covers every record exactly once."""
        count = int(count)
        index = int(index)
        if count < 1 or not 0 <= index < count:
            raise ValueError(
                f"shard(index={index}, count={count}): need 0 <= index < count"
            )
        self._shard_index, self._shard_count = index, count
        return self

    def _owned_units(self) -> range:
        return range(self._shard_index, self._n_units(), self._shard_count)

    def shuffle(self, epoch: Optional[int] = None) -> None:
        self._epoch = self._epoch + 1 if epoch is None else epoch

    def _unit_order(self, train: bool) -> List[int]:
        units = list(self._owned_units())
        if not train:
            return units
        seed = (RandomGenerator.get_seed() or 0) * 1_000_003 + self._epoch
        perm = np.random.default_rng(seed).permutation(len(units))
        return [units[i] for i in perm]

    def _samples(self, train: bool) -> Iterator[Sample]:
        from .pipeline import RING_CLOSED, _OrderedStaging

        order = self._unit_order(train)
        seed = (RandomGenerator.get_seed() or 0) * 7_368_787 + self._epoch
        in_q: "queue.Queue" = queue.Queue(maxsize=max(1, len(order)))
        for pos, unit in enumerate(order):
            in_q.put((pos, unit))
        # bounded submission-order reassembly + event-aware close:
        # at most depth decoded units are in flight, so a slow unit at the
        # front of the permutation cannot let the pool decode the rest of
        # the epoch into host memory; close() wakes blocked workers
        # immediately, so an abandoned epoch releases decoded units promptly
        ring = _OrderedStaging(self.n_workers * 2)

        def worker():
            while True:
                # reserve BEFORE pulling a unit: a worker blocked on
                # backpressure holds no unit, so the lowest outstanding
                # position is always already being decoded (no deadlock)
                if not ring.reserve():
                    return  # consumer abandoned the epoch
                try:
                    pos, unit = in_q.get_nowait()
                except queue.Empty:
                    ring.release()
                    return
                try:
                    rng = np.random.default_rng(seed * 65_537 + unit)
                    samples = self._decode_unit(unit, rng)
                    if train:  # intra-unit shuffle (seeded per unit)
                        samples = [samples[i] for i in rng.permutation(len(samples))]
                    item = samples
                except BaseException as e:  # surface in the consumer
                    item = e
                ring.deliver(pos, item)

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(self.n_workers)]
        for t in threads:
            t.start()
        try:
            # deterministic reassembly in unit order — units decode
            # concurrently (interleaved across shard files) but the sample
            # stream is a pure function of (seed, epoch); train order varies
            # through the seeded unit permutation + intra-unit shuffle
            for _ in range(len(order)):
                item = ring.next_item()
                if item is RING_CLOSED:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield from item
        finally:
            ring.close()

    def samples(self, train: bool) -> Iterator[Sample]:
        """Record-level sample stream (decoded by the worker pool, unit-order
        deterministic) — the DataPipeline source seam."""
        return self._samples(train)

    def data(self, train: bool) -> Iterator[MiniBatch]:
        stream: Iterator = self._samples(train)
        if self.transformer is not None:
            stream = self.transformer.apply(stream)
        batcher = SampleToMiniBatch(self.batch_size, drop_remainder=train)
        return batcher.apply(stream)


class ShardedRecordDataSet(_ShardedDataSet):
    """Reader over ``write_record_shards`` output (the SeqFileFolder analog).

    ``decode(payload, label) -> Sample`` runs inside worker threads; shard
    order and intra-shard order reshuffle every epoch from the global seed.
    """

    def __init__(self, shard_paths: Sequence[str], decode: Callable,
                 batch_size: int = 32, n_workers: int = 4,
                 transformer: Optional[Transformer] = None):
        super().__init__(batch_size, n_workers, transformer)
        self.shard_paths = sorted(shard_paths)
        if not self.shard_paths:
            raise ValueError("no shard paths given")
        self.decode = decode
        self._counts = [record_shard_count(p) for p in self.shard_paths]

    def size(self) -> int:
        # this host's slice under shard(); the full set when unsharded
        return sum(self._counts[u] for u in self._owned_units())

    def _n_units(self) -> int:
        return len(self.shard_paths)

    def _decode_unit(self, unit_index, epoch_rng):
        return [
            self.decode(payload, label)
            for payload, label in read_record_shard(self.shard_paths[unit_index])
        ]


class ImageFolderDataSet(_ShardedDataSet):
    """Class-per-subdirectory image tree reader (reference:
    ``DataSet.ImageFolder`` / ``LocalImageFiles``), decoding lazily in worker
    threads per epoch — unlike ``ImageFrame.read`` it never holds the whole
    tree decoded in memory.

    Labels are 0-based indices of the sorted class directory names. Each
    image runs ``feature_transformer`` (a vision ``FeatureTransformer``
    chain; default MatToTensor→sample) to produce the CHW float sample.
    """

    IMAGE_EXTS = {".jpg", ".jpeg", ".png", ".bmp", ".ppm", ".gif"}

    def __init__(self, path: str, batch_size: int = 32,
                 feature_transformer=None, n_workers: int = 4,
                 files_per_unit: int = 64,
                 transformer: Optional[Transformer] = None):
        super().__init__(batch_size, n_workers, transformer)
        classes = sorted(
            d for d in os.listdir(path)
            if os.path.isdir(os.path.join(path, d))
        )
        if not classes:
            raise ValueError(f"{path}: no class subdirectories")
        self.class_names = classes
        self._files: List[Tuple[str, int]] = []
        for idx, cls in enumerate(classes):
            cdir = os.path.join(path, cls)
            for name in sorted(os.listdir(cdir)):
                if os.path.splitext(name)[1].lower() in self.IMAGE_EXTS:
                    self._files.append((os.path.join(cdir, name), idx))
        if not self._files:
            raise ValueError(f"{path}: no image files")
        self.files_per_unit = files_per_unit
        if feature_transformer is None:
            from ..transform.vision.image import ImageFrameToSample, MatToTensor

            feature_transformer = MatToTensor() >> ImageFrameToSample()
        self.feature_transformer = feature_transformer

    def size(self) -> int:
        # this host's slice under shard(); the full tree when unsharded
        n, fpu = len(self._files), self.files_per_unit
        return sum(min(fpu, n - u * fpu) for u in self._owned_units())

    def _n_units(self) -> int:
        return (len(self._files) + self.files_per_unit - 1) // self.files_per_unit

    def _decode_unit(self, unit_index, epoch_rng):
        from ..transform.vision.image import ImageFeature

        lo = unit_index * self.files_per_unit
        samples = []
        for fpath, label in self._files[lo : lo + self.files_per_unit]:
            feature = ImageFeature.from_file(fpath, label)
            try:
                feature.decode()
            except Exception:
                # corrupt file: log-mark-and-continue failure model
                _log.warning("skipping undecodable image %s", fpath)
                continue
            feature = self.feature_transformer(feature)
            if not feature.is_valid() or feature.sample() is None:
                _log.warning("skipping image %s (transform marked invalid "
                             "or produced no sample)", fpath)
                continue
            x, t = feature.sample()
            samples.append(Sample(np.asarray(x, np.float32), t))
        return samples
