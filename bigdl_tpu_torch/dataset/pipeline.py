"""Deterministic multi-worker host input pipeline (counterpart of
``bigdl_tpu/dataset/pipeline.py``).

:class:`DataPipeline` fans fixed-size record chunks (one chunk = one
batch's worth of samples) out to a pool of worker threads running a
``Transformer`` chain, then reassembles the results in submission order
through a bounded staging ring. The contract, the JAX package's:

* **Byte-identical for any worker count.** The batch stream of
  ``DataPipeline(..., num_workers=N)`` equals the serial one
  (``num_workers=0``, fully inline) byte for byte for every N, ragged tails
  and shuffled epochs included: a chunk's RNG is seeded from ``(global
  seed, epoch, chunk_index)`` -- never from a worker's identity or timing --
  through ``RandomGenerator.scoped_numpy_rng``, which the vision
  augmentations draw from; reassembly is strictly in submission order.
* **Sample-preserving transforms.** A chunk of ``batch_size`` records must
  transform to exactly one batch: the chain maps samples 1:1 or emits
  exactly one ``MiniBatch`` a chunk. Filtering or expanding chains raise.
* **Skips at the source.** ``data(train, skip_positions={(epoch, iter),
  ...})`` never transforms, batches or yields the chunks at those
  positions of the current epoch; the rest of the stream is a clean run's
  minus those batches.

``StagingRing`` is the bounded, event-aware hand-off this module and the
optimizer's prefetch seam share: ``close()`` wakes every blocked ``put``
and ``get`` at once, so an abandoned epoch frees its batches promptly.
Each chunk runs under a ``pipeline_transform`` span (``_process_traced``)
with a causal trace context keyed on (epoch, chunk): the same trace for a
chunk on every run and for any worker count. The context travels with the
batch (the stream's ``last_context``), so the optimizer's prefetch and
dispatch spans chain onto it; pool workers record into the consumer's span
collector.
"""

from __future__ import annotations

import collections
import threading
from typing import Iterator, List, Optional, Set

import numpy as np

from ..obs import trace as obs_trace
from ..utils.random import RandomGenerator
from .dataset import AbstractDataSet, MiniBatch, Sample, SampleToMiniBatch, Transformer

__all__ = ["DataPipeline", "StagingRing", "RING_CLOSED"]

#: returned by :meth:`StagingRing.get` / ordered staging when the ring was
#: closed by the other side (consumer abandoned the epoch, or shutdown)
RING_CLOSED = object()

_END = object()      # end-of-stream marker (producer side)
_SKIPPED = object()  # quarantined/dropped chunk hole (ordered staging)
_NO_MORE = object()  # per-worker "no more input" sentinel


class StagingRing:
    """Bounded FIFO hand-off between producer thread(s) and a consumer.

    Condition-variable based and **event-aware**: a ``close()`` from either
    side wakes every blocked ``put``/``get`` immediately — there is no
    timeout-poll tick between "consumer went away" and "producer notices".
    ``close()`` also drops buffered items so anything pinned by them (device
    batches in the optimizer's prefetch ring) frees right away.
    """

    def __init__(self, depth: int):
        self._depth = max(1, int(depth))
        # bound is enforced by the condition below; maxlen is belt-and-braces
        self._buf: collections.deque = collections.deque(maxlen=self._depth)
        self._cond = threading.Condition()
        self._closed = False

    def put(self, item) -> bool:
        """Block while full; ``False`` once the ring is closed."""
        with self._cond:
            while len(self._buf) >= self._depth and not self._closed:
                self._cond.wait()
            if self._closed:
                return False
            self._buf.append(item)
            self._cond.notify_all()
            return True

    def get(self):
        """Block while empty; :data:`RING_CLOSED` once closed."""
        with self._cond:
            while not self._buf and not self._closed:
                self._cond.wait()
            if not self._buf:
                return RING_CLOSED
            item = self._buf.popleft()
            self._cond.notify_all()
            return item

    def qsize(self) -> int:
        with self._cond:
            return len(self._buf)

    @property
    def closed(self) -> bool:
        return self._closed

    def close(self) -> None:
        """Wake every waiter and drop buffered items (they may pin memory)."""
        with self._cond:
            self._closed = True
            self._buf.clear()
            self._cond.notify_all()


class _OrderedStaging:
    """Submission-order reassembly ring for the chunk worker pool.

    Chunks complete out of order; the consumer reads them strictly in
    submission order. At most ``depth`` chunks are in flight at once —
    :meth:`reserve` is the feeder's backpressure seam. Event-aware like
    :class:`StagingRing`: ``close()`` wakes everything immediately.
    """

    def __init__(self, depth: int):
        self._depth = max(1, int(depth))
        self._cond = threading.Condition()
        self._done: dict = {}  # pos -> (item, reserved)
        self._next = 0
        self._inflight = 0
        self._closed = False

    def reserve(self) -> bool:
        """Feeder: block until an in-flight slot frees; False once closed."""
        with self._cond:
            while self._inflight >= self._depth and not self._closed:
                self._cond.wait()
            if self._closed:
                return False
            self._inflight += 1
            return True

    def release(self) -> None:
        """Give a reservation back without delivering (producer found no
        work after reserving — the reserve-before-pull idiom)."""
        with self._cond:
            self._inflight -= 1
            self._cond.notify_all()

    def deliver(self, pos: int, item, reserved: bool = True) -> None:
        with self._cond:
            if self._closed:
                return
            self._done[pos] = (item, reserved)
            self._cond.notify_all()

    def next_item(self):
        """Consumer: the item at the next submission position (in order)."""
        with self._cond:
            while self._next not in self._done and not self._closed:
                self._cond.wait()
            if self._closed:
                return RING_CLOSED
            item, reserved = self._done.pop(self._next)
            self._next += 1
            if reserved:
                self._inflight -= 1
            self._cond.notify_all()
            return item

    def ready_count(self) -> int:
        """Completed-but-unconsumed chunks — the staging-depth gauge the
        telemetry ``input_qdepth`` field reports."""
        with self._cond:
            return len(self._done)

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._done.clear()
            self._cond.notify_all()


class _PipelineStream:
    """Iterator over one epoch of pipeline batches, with ``qsize()`` (the
    staging ring's depth, the optimizer's input gauge), ``last_context``
    (the causal trace context of the batch just yielded) and ``close()`` for
    early abandonment."""

    def __init__(self, gen, ring: Optional[_OrderedStaging],
                 in_q: Optional[StagingRing]):
        self._gen = gen
        self._ring = ring
        self._in_q = in_q
        self.last_context = None

    def __iter__(self) -> "_PipelineStream":
        return self

    def __next__(self):
        batch, self.last_context = next(self._gen)
        return batch

    def qsize(self) -> int:
        return self._ring.ready_count() if self._ring is not None else 0

    def close(self) -> None:
        """Abandon the stream: thread-safe and event-aware. Closing the
        rings FIRST wakes a consumer possibly blocked inside ``__next__`` on
        another thread (it sees RING_CLOSED and finishes), so the pool tears
        down without waiting on anyone; the generator close is best-effort —
        if it is mid-``next`` elsewhere it completes on its own."""
        if self._ring is not None:
            self._ring.close()
        if self._in_q is not None:
            self._in_q.close()
        try:
            self._gen.close()
        except ValueError:
            pass  # generator executing on another thread; rings already closed

    def __del__(self):
        try:
            self.close()
        except Exception:  # GC-time close must never raise
            pass


class DataPipeline(AbstractDataSet):
    """Deterministic multi-worker transform + batch-assembly pipeline.

    Args:
        source: the record provider — any dataset exposing
            ``samples(train) -> Iterator[Sample]`` (``LocalArrayDataSet``,
            ``ShardedRecordDataSet``, ``TFRecordDataSet``,
            ``ImageFolderDataSet``). The source's own batching/transformer
            are bypassed; it only supplies the deterministic sample stream.
        transformer: per-sample ``Transformer`` chain run inside the worker
            pool (defaults to ``source.transformer`` when the source carries
            one). Must be sample-preserving (1:1) or emit exactly one
            ``MiniBatch`` per chunk — see the module docstring.
        num_workers: transform worker threads. ``0`` = fully inline serial
            execution (the reference stream every worker count must match).
        depth: staging-ring bound — max chunks in flight (submitted but not
            yet consumed). Defaults to ``max(2, 2 * num_workers)``.
        batch_size: records per chunk == rows per emitted batch (defaults to
            ``source.batch_size``).
        padding_value: forwarded to the ``SampleToMiniBatch`` assembly for
            variable-length features.
        drop_remainder: drop the final ragged chunk. ``None`` (default)
            mirrors the serial iterators: drop for ``train=True``, keep for
            eval. Pass ``False`` to stream the ragged tail into the
            optimizer's pad/mask seam.
    """

    #: the driver loop may pass ``skip_positions=`` to :meth:`data`
    supports_skip_positions = True

    def __init__(self, source: AbstractDataSet,
                 transformer: Optional[Transformer] = None,
                 num_workers: int = 4, depth: Optional[int] = None,
                 batch_size: Optional[int] = None,
                 padding_value: Optional[float] = None,
                 drop_remainder: Optional[bool] = None):
        if not hasattr(source, "samples"):
            raise TypeError(
                f"{type(source).__name__} exposes no samples(train) stream; "
                "DataPipeline sources are record providers "
                "(LocalArrayDataSet, ShardedRecordDataSet, TFRecordDataSet, "
                "ImageFolderDataSet)"
            )
        self.source = source
        self.transformer = (
            transformer if transformer is not None
            else getattr(source, "transformer", None)
        )
        self.num_workers = max(0, int(num_workers))
        self.depth = (
            max(1, int(depth)) if depth is not None
            else max(2, 2 * self.num_workers)
        )
        bs = batch_size if batch_size is not None else getattr(
            source, "batch_size", None
        )
        if not bs or int(bs) < 1:
            raise ValueError(
                "DataPipeline needs a batch_size (or a source that has one)"
            )
        self.batch_size = int(bs)
        self.drop_remainder = drop_remainder
        self._assemble = SampleToMiniBatch(
            self.batch_size, padding_value=padding_value
        )
        self._epoch = 0

    # --------------------------------------------------------------- dataset
    def size(self) -> int:
        return self.source.size()

    def shuffle(self, epoch: Optional[int] = None) -> None:
        self._epoch = self._epoch + 1 if epoch is None else int(epoch)
        self.source.shuffle(epoch)

    # ------------------------------------------------------------- internals
    def _chunk_rng(self, chunk_index: int) -> np.random.Generator:
        """Per-chunk RNG seeded from (global seed, epoch, chunk_index) —
        NEVER from worker identity, so randomized transforms draw the same
        stream no matter which worker (or the inline path) runs the chunk."""
        return np.random.default_rng(
            (RandomGenerator.get_seed() or 0, int(self._epoch),
             int(chunk_index), 0x9E3779B9)
        )

    def _chunks(self, train: bool) -> Iterator[List[Sample]]:
        buf: List[Sample] = []
        for s in self.source.samples(train):
            buf.append(s)
            if len(buf) == self.batch_size:
                yield buf
                buf = []
        if buf:
            yield buf

    def _process(self, chunk_index: int, records: List[Sample]) -> MiniBatch:
        """Transform one chunk under its seeded RNG and assemble the batch —
        the unit of work the pool parallelizes; also the entire serial path."""
        with RandomGenerator.scoped_numpy_rng(self._chunk_rng(chunk_index)):
            if self.transformer is not None:
                out = list(self.transformer.apply(iter(records)))
            else:
                out = records
        if out and isinstance(out[0], MiniBatch):
            if len(out) != 1:
                raise ValueError(
                    f"transformer chain emitted {len(out)} MiniBatches for "
                    f"one {len(records)}-record chunk; a batching chain must "
                    "produce exactly one batch per chunk (size its "
                    "SampleToMiniBatch to the pipeline batch_size)"
                )
            return out[0]
        if len(out) != len(records):
            raise ValueError(
                f"transformer chain is not sample-preserving: chunk "
                f"{chunk_index} went {len(records)} -> {len(out)} samples. "
                "The pipeline's chunk==batch determinism contract needs 1:1 "
                "transforms; run filtering chains on "
                "the serial dataset path instead"
            )
        return self._assemble._to_batch(out)

    def _process_traced(self, chunk_index: int, records: List[Sample]):
        """:meth:`_process` under the chunk's causal trace: a root context
        keyed on ``(epoch, chunk_index)`` and a ``pipeline_transform`` span;
        returns ``(batch, context)``."""
        ctx = obs_trace.new_context(key=("pipeline", int(self._epoch), int(chunk_index)))
        with obs_trace.context_scope(ctx), obs_trace.span("pipeline_transform"):
            out = self._process(chunk_index, records)
        return out, ctx

    # ------------------------------------------------------------------ data
    def data(self, train: bool, skip_positions=None) -> _PipelineStream:
        """One epoch of MiniBatches. ``skip_positions`` is the
        ``FailurePolicy.skip_positions`` set of quarantined
        ``(epoch, iter_in_epoch)`` slots; slots of the CURRENT epoch are
        holes — never transformed, batched, or yielded."""
        skips: Set[int] = {
            int(i) for (e, i) in (skip_positions or ())
            if int(e) == self._epoch
        }
        drop = train if self.drop_remainder is None else bool(
            self.drop_remainder
        )
        if self.num_workers == 0:
            return _PipelineStream(self._serial(train, skips, drop), None, None)
        ring = _OrderedStaging(self.depth)
        in_q = StagingRing(max(2, self.num_workers * 2))
        return _PipelineStream(
            self._parallel(train, skips, drop, ring, in_q), ring, in_q
        )

    def _keep(self, records: List[Sample], chunk_index: int,
              skips: Set[int], drop: bool) -> bool:
        if chunk_index in skips:
            return False  # quarantined: never parsed further/transformed
        if drop and len(records) < self.batch_size:
            return False  # ragged tail under reference drop semantics
        return True

    def _serial(self, train: bool, skips: Set[int], drop: bool):
        for index, records in enumerate(self._chunks(train)):
            if self._keep(records, index, skips, drop):
                yield self._process_traced(index, records)

    def _parallel(self, train: bool, skips: Set[int], drop: bool,
                  ring: _OrderedStaging, in_q: StagingRing):
        def feeder():
            pos = 0
            try:
                for index, records in enumerate(self._chunks(train)):
                    pos = index + 1
                    if not ring.reserve():
                        return  # consumer abandoned the epoch
                    if not self._keep(records, index, skips, drop):
                        ring.deliver(index, _SKIPPED)
                        continue
                    if not in_q.put((index, records)):
                        return
                ring.deliver(pos, _END, reserved=False)
            except BaseException as e:  # source fault -> surface in order
                ring.deliver(pos, e, reserved=False)
            finally:
                # workers drain remaining chunks, then exit on their sentinel
                for _ in range(self.num_workers):
                    if not in_q.put(_NO_MORE):
                        return

        # the consumer's span collector, bound on each pool worker
        col = obs_trace.current_collector()

        def worker():
            obs_trace.bind_collector(col)
            while True:
                item = in_q.get()
                if item is RING_CLOSED or item is _NO_MORE:
                    return
                index, records = item
                try:
                    out = self._process_traced(index, records)
                except BaseException as e:  # propagate at this position
                    out = e
                ring.deliver(index, out)

        threads = [threading.Thread(target=feeder, name="bigdl-pipe-feed",
                                    daemon=True)]
        threads += [
            threading.Thread(target=worker, name=f"bigdl-pipe-w{i}",
                             daemon=True)
            for i in range(self.num_workers)
        ]
        for t in threads:
            t.start()
        try:
            while True:
                item = ring.next_item()
                if item is RING_CLOSED or item is _END:
                    return
                if item is _SKIPPED:
                    continue
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            # abandonment or normal end: event-aware shutdown — everything
            # blocked on either ring wakes NOW, no poll tick
            ring.close()
            in_q.close()
