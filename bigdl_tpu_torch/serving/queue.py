"""Request futures and the request queue (counterpart of
``bigdl_tpu/serving/queue.py``).

The batching thread admits, pads, stacks and dispatches; it never waits on
the device. Each future is resolved with a row VIEW of the batch output,
still on the device, and :meth:`ServeFuture.result` copies that row to the
host (``.cpu()``) on the thread that asked for it: each caller pays only for
its own row, and a slow caller cannot stall the batch pipeline.

Every future carries its request's timeline (enqueue → batch → assembled →
dispatched → materialized, :meth:`ServeFuture.spans`), an optional deadline
(typed :class:`~bigdl_tpu_torch.resilience.errors.DeadlineExceeded`, never a
caller blocked past it) and the model version that served it.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional

import numpy as np

from ..obs.trace import fault_point
from ..resilience.errors import DeadlineExceeded

__all__ = ["AdmissionRejected", "ServingStopped", "ServerClosed", "WorkerCrashed",
           "ServeFuture", "ServeRequest", "RequestQueue"]


class ServingStopped(RuntimeError):
    """The server/batcher was stopped before this request could be served."""


class ServerClosed(ServingStopped):
    """``ModelServer.close()`` / ``ContinuousBatcher.stop()`` ran while this
    request was still pending; every such future is failed with this error
    rather than left waiting."""


class WorkerCrashed(ServingStopped):
    """The model's batching thread died (or wedged past its heartbeat bound)
    with this request still pending. Set by the dying worker itself and by
    the :class:`~bigdl_tpu_torch.serving.resilience.ServingSupervisor`;
    re-submit after the restart."""


class AdmissionRejected(RuntimeError):
    """The model's queue is at ``max_pending``: the request was rejected at
    submit time on the caller's thread; the batcher's ``rejected`` counter
    rides the next serve record."""


class ServeFuture:
    """One request's pending result.

    Resolved by the batching thread with a device row view and the model
    version that produced it (first resolution wins: the batcher, a deadline
    sweep, a shutdown path and the caller's own deadline may race, and
    exactly one succeeds). :meth:`result` copies the row to the host on the
    calling thread and fires the completion callback once.
    """

    __slots__ = ("_event", "_lock", "_value", "_error", "_version", "_on_done",
                 "_on_resolve", "_resolved", "_done_fired", "deadline_s", "probe", "trace",
                 "t_enqueue", "t_batch", "t_assembled", "t_dispatch", "t_materialize")

    def __init__(self):
        self._event = threading.Event()
        self._lock = threading.Lock()
        self._value = None
        self._error: Optional[BaseException] = None
        self._version: Optional[int] = None
        self._on_done: Optional[Callable] = None  # completion hook (batcher-set)
        # resolution hook (batcher accounting): fires once, on whichever
        # thread wins the resolution race
        self._on_resolve: Optional[Callable] = None
        self._resolved = False
        self._done_fired = False
        self.deadline_s: Optional[float] = None  # absolute perf_counter deadline
        self.probe = False  # a circuit breaker's half-open probe (batcher-stamped)
        # the request's causal trace context (obs.trace.TraceContext), stamped
        # at submit: it carries the trace across caller -> batcher -> caller
        self.trace = None
        self.t_enqueue = time.perf_counter()
        self.t_batch: Optional[float] = None
        self.t_assembled: Optional[float] = None
        self.t_dispatch: Optional[float] = None
        self.t_materialize: Optional[float] = None

    # ------------------------------------------------------- batcher side
    def set_result(self, value, version: Optional[int] = None) -> bool:
        """Resolve with a (device) value; False if already resolved."""
        with self._lock:
            if self._resolved:
                return False
            self._resolved = True
            self._value = value
            self._version = version
            cb = self._on_resolve
        self._event.set()
        if cb is not None:
            cb(self)
        return True

    def set_exception(self, exc: BaseException, version: Optional[int] = None) -> bool:
        """Fail the future; False if already resolved."""
        with self._lock:
            if self._resolved:
                return False
            self._resolved = True
            self._error = exc
            self._version = version
            cb = self._on_resolve
        self._event.set()
        if cb is not None:
            cb(self)
        return True

    # -------------------------------------------------------- caller side
    def done(self) -> bool:
        return self._event.is_set()

    def error(self) -> Optional[BaseException]:
        """The resolving exception (None while pending or on success)."""
        with self._lock:
            return self._error

    @property
    def version(self) -> Optional[int]:
        """Model version that produced this result; every row of one
        dispatched batch shares it."""
        return self._version

    def expired(self, now: Optional[float] = None) -> bool:
        """Deadline check (False when no deadline is set)."""
        if self.deadline_s is None:
            return False
        return (time.perf_counter() if now is None else now) >= self.deadline_s

    def _deadline_error(self, stage: str) -> DeadlineExceeded:
        now = time.perf_counter()
        return DeadlineExceeded(None, deadline_ms=(self.deadline_s - self.t_enqueue) * 1e3,
                                waited_ms=(now - self.t_enqueue) * 1e3, stage=stage)

    def _wait(self, timeout: Optional[float]) -> None:
        """Wait for resolution, bounded by the caller's ``timeout`` and the
        request deadline: at the deadline the future is failed (first wins)
        with ``DeadlineExceeded``."""
        if self._event.is_set():
            return
        end = None if timeout is None else time.perf_counter() + timeout
        while True:
            now = time.perf_counter()
            bounds = [b for b in (end, self.deadline_s) if b is not None]
            if not bounds:
                self._event.wait()
                return
            if self._event.wait(max(min(bounds) - now, 0.0)):
                return
            now = time.perf_counter()
            if self.deadline_s is not None and now >= self.deadline_s:
                # losing this race means the batcher served us just in time
                self.set_exception(self._deadline_error("result"))
                return
            if end is not None and now >= end:
                raise TimeoutError(f"request not served within {timeout}s")

    def result(self, timeout: Optional[float] = None):
        """Block for this request's result and copy it to the host (a CPU
        tensor); raises ``TimeoutError`` after ``timeout`` seconds and
        ``DeadlineExceeded`` at the request's deadline."""
        self._wait(timeout)
        fault_point("serve_materialize")  # chaos seam (caller thread)
        fire = False
        with self._lock:
            if self._error is not None:
                try:
                    raise self._error
                finally:
                    # the stored error's traceback holds this frame: without
                    # ``self`` in it, future -> error -> traceback -> frame is
                    # no cycle (as concurrent.futures does). A caller that
                    # keeps the future after catching the error holds its own
                    # frame the same way, and drops the future to free it.
                    self = None  # noqa: F841
            if self.t_materialize is None:
                self._value = self._value.cpu()
                self.t_materialize = time.perf_counter()
                fire = not self._done_fired
                self._done_fired = True
        if fire and self._on_done is not None:
            self._on_done(self)
        return self._value

    def spans(self) -> Dict[str, float]:
        """The request's critical path as durations (seconds): ``queue_s``
        (enqueue → popped into a batch), ``assembly_s`` (pad/stack),
        ``dispatch_s`` (the forward's launch), ``materialize_s`` (the row's
        copy to the host, which waits for the forward) and ``total_s``
        (enqueue → materialized). Only completed stages appear; they
        telescope, so they sum to ``total_s``."""
        out: Dict[str, float] = {}
        if self.t_batch is not None:
            out["queue_s"] = self.t_batch - self.t_enqueue
            t_prev = self.t_batch
            if self.t_assembled is not None:
                out["assembly_s"] = self.t_assembled - t_prev
                t_prev = self.t_assembled
            if self.t_dispatch is not None:
                out["dispatch_s"] = self.t_dispatch - t_prev
                if self.t_materialize is not None:
                    out["materialize_s"] = self.t_materialize - self.t_dispatch
        if self.t_materialize is not None:
            out["total_s"] = self.t_materialize - self.t_enqueue
        return out


class ServeRequest:
    """One admitted record: a host feature array, its shape bucket (None for
    fixed-shape models) and its future. ``deadline_ms`` (from enqueue) arms
    the request deadline; without it the batcher applies its model default."""

    __slots__ = ("feature", "bucket", "future")

    def __init__(self, feature, bucket: Optional[int] = None,
                 deadline_ms: Optional[float] = None):
        self.feature = np.asarray(feature)
        self.bucket = bucket
        self.future = ServeFuture()
        if deadline_ms is not None:
            if deadline_ms <= 0:
                raise ValueError(f"deadline_ms must be positive, got {deadline_ms}")
            self.future.deadline_s = self.future.t_enqueue + deadline_ms / 1e3


class _Group:
    """Pending-state view of one bucket group (the flush-trigger input)."""

    __slots__ = ("bucket", "count", "oldest_t")

    def __init__(self, bucket, count, oldest_t):
        self.bucket = bucket
        self.count = count
        self.oldest_t = oldest_t


class RequestQueue:
    """Thread-safe FIFO of :class:`ServeRequest` with bucket-group views.

    ``max_pending`` arms admission control: a ``put`` that would grow the
    queue past it raises :class:`AdmissionRejected` on the caller's thread
    (``None``: unbounded)."""

    def __init__(self, max_pending: Optional[int] = None):
        if max_pending is not None and int(max_pending) < 1:
            raise ValueError(f"max_pending must be >= 1, got {max_pending}")
        self.max_pending = None if max_pending is None else int(max_pending)
        self._lock = threading.Lock()  # hot-lock: every put/pop/sweep serializes here
        self._cond = threading.Condition(self._lock)
        self._items: List[ServeRequest] = []
        self._puts = 0  # monotone arrival counter (lost-wakeup guard)
        self._closed = False

    def put(self, req: ServeRequest) -> int:
        with self._cond:
            if self._closed:
                raise ServingStopped("request queue is closed")
            if self.max_pending is not None and len(self._items) >= self.max_pending:
                raise AdmissionRejected(f"request rejected: {len(self._items)} pending >= "
                                        f"max_pending {self.max_pending}")
            self._items.append(req)
            self._puts += 1
            self._cond.notify_all()
            return len(self._items)

    def puts(self) -> int:
        """Arrival counter: snapshot it BEFORE reading state and pass it to
        :meth:`wait`, so an arrival in between wakes the sleeper at once."""
        with self._lock:
            return self._puts

    def depth(self) -> int:
        with self._lock:
            return len(self._items)

    def groups(self) -> List[_Group]:
        """Per-bucket pending summaries, oldest group first."""
        with self._lock:
            seen: Dict[object, _Group] = {}
            for r in self._items:
                g = seen.get(r.bucket)
                if g is None:
                    seen[r.bucket] = _Group(r.bucket, 1, r.future.t_enqueue)
                else:
                    g.count += 1
        return sorted(seen.values(), key=lambda g: g.oldest_t)

    def pop(self, bucket, n: int) -> List[ServeRequest]:
        """Up to ``n`` oldest requests of ``bucket``, FIFO order preserved."""
        out: List[ServeRequest] = []
        with self._lock:
            keep: List[ServeRequest] = []
            for r in self._items:
                if r.bucket == bucket and len(out) < n:
                    out.append(r)
                else:
                    keep.append(r)
            self._items = keep
        return out

    def pop_all(self) -> List[ServeRequest]:
        with self._lock:
            out, self._items = self._items, []
        return out

    def sweep_expired(self, now: Optional[float] = None) -> List[ServeRequest]:
        """Remove and return every request past its deadline or already
        resolved (its caller's deadline won the race). The batcher runs this
        before trigger evaluation and assembly, so an expired request never
        pads a batch or holds its group at the head of the order."""
        if now is None:
            now = time.perf_counter()
        with self._lock:
            keep: List[ServeRequest] = []
            out: List[ServeRequest] = []
            for r in self._items:
                (out if r.future.done() or r.future.expired(now) else keep).append(r)
            if out:
                self._items = keep
        return out

    def wait(self, timeout: float, seen: Optional[int] = None) -> None:
        """Sleep until a request arrives, the queue closes or ``timeout``
        elapses; returns at once if anything arrived since ``seen``."""
        with self._cond:
            if self._closed or (seen is not None and self._puts != seen):
                return
            # a timed single-shot wait, not a while-predicate loop: this is
            # the batcher's trigger-poll tick, a spurious wakeup only re-runs
            # trigger evaluation (callers re-check through the monotone
            # `seen`/_puts counter) and the timeout bounds the sleep
            self._cond.wait(timeout)  # lint: disable=BDL018

    def wake(self) -> None:
        with self._cond:
            self._cond.notify_all()

    def close(self) -> None:
        """Reject later puts and wake every waiter."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()
