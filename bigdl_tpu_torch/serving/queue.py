"""Request futures and the request queue (counterpart of
``bigdl_tpu/serving/queue.py``).

The batching thread admits, pads, stacks and dispatches; it never waits on
the device. Each future is resolved with a row VIEW of the batch output,
still on the device, and :meth:`ServeFuture.result` copies that row to the
host (``.cpu()``) on the thread that asked for it: each caller pays only for
its own row, and a slow caller cannot stall the batch pipeline.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

import numpy as np

__all__ = ["ServingStopped", "ServerClosed", "ServeFuture", "ServeRequest",
           "RequestQueue"]


class ServingStopped(RuntimeError):
    """The server/batcher was stopped before this request could be served."""


class ServerClosed(ServingStopped):
    """``ModelServer.close()`` / ``ContinuousBatcher.stop()`` ran while this
    request was still pending; every such future is failed with this error
    rather than left waiting."""


class ServeFuture:
    """One request's pending result (first resolution wins)."""

    __slots__ = ("_event", "_lock", "_value", "_error", "_resolved",
                 "_materialized", "t_enqueue", "t_materialize")

    def __init__(self):
        self._event = threading.Event()
        self._lock = threading.Lock()
        self._value = None
        self._error: Optional[BaseException] = None
        self._resolved = False
        self._materialized = False
        self.t_enqueue = time.perf_counter()
        self.t_materialize: Optional[float] = None

    # ------------------------------------------------------- batcher side
    def set_result(self, value) -> bool:
        """Resolve with a (device) value; False if already resolved."""
        with self._lock:
            if self._resolved:
                return False
            self._resolved = True
            self._value = value
        self._event.set()
        return True

    def set_exception(self, exc: BaseException) -> bool:
        """Fail the future; False if already resolved."""
        with self._lock:
            if self._resolved:
                return False
            self._resolved = True
            self._error = exc
        self._event.set()
        return True

    # -------------------------------------------------------- caller side
    def result(self, timeout: Optional[float] = None):
        """Block for this request's result and copy it to the host (a CPU
        tensor); raises ``TimeoutError`` after ``timeout`` seconds."""
        if not self._event.wait(timeout):
            raise TimeoutError(f"request not served within {timeout}s")
        with self._lock:
            if self._error is not None:
                raise self._error
            if not self._materialized:
                self._value = self._value.cpu()
                self._materialized = True
                self.t_materialize = time.perf_counter()
            return self._value


class ServeRequest:
    """One admitted record: a host feature array, its shape bucket (None for
    fixed-shape models) and its future."""

    __slots__ = ("feature", "bucket", "future")

    def __init__(self, feature, bucket: Optional[int] = None):
        self.feature = np.asarray(feature)
        self.bucket = bucket
        self.future = ServeFuture()


class _Group:
    """Pending-state view of one bucket group (the flush-trigger input)."""

    __slots__ = ("bucket", "count", "oldest_t")

    def __init__(self, bucket, count, oldest_t):
        self.bucket = bucket
        self.count = count
        self.oldest_t = oldest_t


class RequestQueue:
    """Thread-safe FIFO of :class:`ServeRequest` with bucket-group views."""

    def __init__(self):
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._items: List[ServeRequest] = []
        self._puts = 0  # monotone arrival counter (lost-wakeup guard)
        self._closed = False

    def put(self, req: ServeRequest) -> int:
        with self._cond:
            if self._closed:
                raise ServingStopped("request queue is closed")
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

    def wait(self, timeout: float, seen: Optional[int] = None) -> None:
        """Sleep until a request arrives, the queue closes or ``timeout``
        elapses; returns at once if anything arrived since ``seen``."""
        with self._cond:
            if self._closed or (seen is not None and self._puts != seen):
                return
            self._cond.wait(timeout)

    def wake(self) -> None:
        with self._cond:
            self._cond.notify_all()

    def close(self) -> None:
        """Reject later puts and wake every waiter."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()
