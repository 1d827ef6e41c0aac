"""Continuous batching over one :class:`~bigdl_tpu_torch.optim.predictor.Predictor`
(counterpart of ``bigdl_tpu/serving/batcher.py``).

One batching thread per hosted model runs the admit→flush loop: requests
wait in a :class:`~bigdl_tpu_torch.serving.queue.RequestQueue` grouped by
shape bucket; a group flushes when
``Trigger.or_(Trigger.pending_at_least(max_batch), Trigger.waited_ms(max_delay_ms))``
fires (oldest group first). A flush pads each record to its bucket, stacks,
dispatches through ``Predictor.forward_batch`` and resolves each request's
future with its own row of the output, still on the device. The batching
thread never copies a result to the host: each caller does that for its own
row in ``ServeFuture.result``.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import List, Optional

import numpy as np
import torch

from ..optim.trigger import Trigger
from .queue import RequestQueue, ServeFuture, ServeRequest, ServerClosed, ServingStopped

log = logging.getLogger("bigdl_tpu_torch.serving")

__all__ = ["ContinuousBatcher"]


class ContinuousBatcher:
    """The per-model batching engine (used via ``ModelServer``)."""

    def __init__(self, predictor, *, name: str = "model",
                 max_batch: Optional[int] = None, max_delay_ms: float = 10.0):
        self.predictor = predictor
        self.name = name
        self.max_batch = int(max_batch or predictor.batch_size)
        if not 0 < self.max_batch <= predictor.batch_size:
            raise ValueError(f"max_batch {max_batch} outside (0, batch_size="
                             f"{predictor.batch_size}]")
        self.max_delay_ms = max_delay_ms
        self.flush_trigger = Trigger.or_(Trigger.pending_at_least(self.max_batch),
                                         Trigger.waited_ms(max_delay_ms))
        self.queue = RequestQueue()
        self.flushes = 0  # dispatched batches (read by tests and the smoke run)
        self._lock = threading.Lock()
        self._pending: set = set()  # admitted, not yet resolved futures
        self._stop = threading.Event()
        self._drain = True
        self._thread: Optional[threading.Thread] = None

    # ----------------------------------------------------------- lifecycle
    def start(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=f"bigdl-serve-{self.name}")
        self._thread.start()

    def stop(self, drain: bool = True, timeout: float = 30.0) -> None:
        """Stop the batching thread; ``drain=True`` serves queued requests
        first. Every future still unresolved when the join window closes is
        failed with :class:`ServerClosed`, never left waiting."""
        self._drain = drain
        self._stop.set()
        self.queue.wake()
        t = self._thread
        if t is not None and t.is_alive():
            t.join(timeout)
        self.queue.close()
        self._fail_pending(ServerClosed(f"model {self.name!r} stopped"))

    def _fail_pending(self, exc: BaseException) -> None:
        for r in self.queue.pop_all():
            r.future.set_exception(exc)
        with self._lock:
            futs, self._pending = list(self._pending), set()
        for f in futs:
            f.set_exception(exc)

    # -------------------------------------------------------------- admit
    def submit(self, request: ServeRequest) -> ServeFuture:
        """Admit one request (caller thread)."""
        if self._stop.is_set():
            raise ServingStopped(f"model {self.name!r} is stopping")
        with self._lock:
            self._pending.add(request.future)
        try:
            self.queue.put(request)
        except ServingStopped:
            with self._lock:
                self._pending.discard(request.future)
            raise
        return request.future

    # ----------------------------------------------------- the flush loop
    def _run(self) -> None:
        try:
            self._loop()
        except Exception:
            log.exception("batching thread for model %r crashed", self.name)
        finally:
            self._fail_pending(ServerClosed(f"model {self.name!r} stopped"))

    def _loop(self) -> None:
        while True:
            draining = self._stop.is_set()
            if draining and not self._drain:
                return
            seen = self.queue.puts()  # arrival snapshot BEFORE the read
            now = time.perf_counter()
            groups = self.queue.groups()
            if not groups:
                if draining:
                    return
                self.queue.wait(0.05, seen)
                continue
            fired = None
            for g in groups:  # oldest group first
                if draining or self.flush_trigger(
                        {"pending": g.count, "waited_ms": (now - g.oldest_t) * 1e3}):
                    fired = g
                    break
            if fired is None:
                # sleep until the oldest group's delay bound could fire; an
                # arrival since `seen` wakes it at once
                remain = self.max_delay_ms / 1e3 - (now - groups[0].oldest_t)
                self.queue.wait(min(0.05, max(remain, 0.0005)), seen)
                continue
            reqs = self.queue.pop(fired.bucket, self.max_batch)
            if reqs:
                self._flush(fired.bucket, reqs)

    def _flush(self, bucket, reqs: List[ServeRequest]) -> None:
        try:
            # assembly and dispatch fail on THESE requests, never the thread
            pad = self.predictor.pad_record
            x = np.stack([r.feature if bucket is None else pad(r.feature, bucket)
                          for r in reqs])
            y = self.predictor.forward_batch(x)
        except Exception as e:
            for r in reqs:
                r.future.set_exception(e)
        else:
            with torch.inference_mode():
                for i, r in enumerate(reqs):
                    r.future.set_result(y[i])  # device row view
        with self._lock:
            for r in reqs:
                self._pending.discard(r.future)
        self.flushes += 1
