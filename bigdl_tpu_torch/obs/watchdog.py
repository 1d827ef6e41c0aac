"""Stall watchdog and the poll-loop chassis of the port's monitors
(counterpart of ``bigdl_tpu/obs/watchdog.py``; the port's own copy).

A silent hang (a wedged collective, a prefetch thread blocked on a dying
filesystem) looks like a very slow step from the driver. :class:`StallWatchdog`
keeps a rolling estimate of the step time and, when no step completes
within ``k x`` that estimate, logs a warning and calls its callbacks once
(the telemetry's ``stall`` record, a ``FailurePolicy`` 's escalation). It
never ends the run itself.

:class:`MonitorBase` is the chassis: a daemon thread calls ``check()``
every ``poll_interval_s`` until stopped. ``check()`` is a pure function of
an injected clock and the recorded state, so tests drive it directly with
a fake clock and never need the thread.
"""

from __future__ import annotations

import collections
import logging
import statistics
import threading
import time
from typing import Callable, Dict, List, Optional

log = logging.getLogger("bigdl_tpu_torch.obs")

__all__ = ["MonitorBase", "StallWatchdog"]


class MonitorBase:
    """Shared poll loop of the port's monitors (:class:`StallWatchdog`, the
    :class:`~bigdl_tpu_torch.obs.perf.PerfMonitor` and the serving tier's
    :class:`~bigdl_tpu_torch.serving.resilience.ServingSupervisor`)."""

    def __init__(self, poll_interval_s: float):
        self.poll_interval_s = float(poll_interval_s)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def check(self):
        raise NotImplementedError

    def start(self, name: Optional[str] = None) -> "MonitorBase":
        """Start the daemon poll thread (idempotent while it is alive)."""
        self._spawn(name or f"bigdl-{type(self).__name__.lower()}")
        return self

    def _spawn(self, name: str) -> None:
        """(Re)start the daemon poll thread; idempotent while it is alive."""
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(target=self._poll, name=name, daemon=True)
            self._thread.start()

    def _poll(self) -> None:
        while not self._stop.wait(self.poll_interval_s):
            self.check()

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None and t.is_alive():
            t.join(timeout=2 * self.poll_interval_s + 1.0)
        self._thread = None


class StallWatchdog(MonitorBase):
    """Flags missing step completions.

    Args:
        k: the stall threshold as a multiple of the rolling step-time
           estimate (the median of the last ``window`` steps).
        min_timeout_s: floor of the stall deadline.
        window: the estimate's window.
        poll_interval_s: how often the thread checks.
        on_stall: a callback ``fn(info)`` called once a stall (re-armed by
           the next step); more through :meth:`add_callback`.
        first_step_timeout_s: the deadline of the first step after
           :meth:`start` (a hung build); None disarms the watchdog until the
           first step completes.
        clock: injectable monotonic clock.
    """

    def __init__(self, k: float = 10.0, min_timeout_s: float = 5.0, window: int = 32,
                 poll_interval_s: float = 1.0,
                 on_stall: Optional[Callable[[Dict], None]] = None,
                 first_step_timeout_s: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic):
        if k <= 0:
            raise ValueError(f"k must be positive, got {k}")
        super().__init__(poll_interval_s)
        self.k = float(k)
        self.min_timeout_s = float(min_timeout_s)
        self.first_step_timeout_s = first_step_timeout_s
        self._clock = clock
        self._durations: collections.deque = collections.deque(maxlen=window)
        self._callbacks: List[Callable[[Dict], None]] = []  # guarded-by: _lock
        if on_stall is not None:
            self._callbacks.append(on_stall)
        self._lock = threading.RLock()  # check() reads estimate_s() under it
        self._last_step_at: Optional[float] = None
        self._started_at: Optional[float] = None
        self._steps = 0
        self._stalled = False
        self.stall_count = 0

    def notify_step(self, duration_s: float) -> None:
        """One step completed; re-arms a flagged stall."""
        with self._lock:
            self._durations.append(float(duration_s))
            self._last_step_at = self._clock()
            self._steps += 1
            self._stalled = False

    def add_callback(self, fn: Callable[[Dict], None]) -> "StallWatchdog":
        with self._lock:
            self._callbacks.append(fn)
        return self

    def remove_callback(self, fn: Callable[[Dict], None]) -> "StallWatchdog":
        """Detach a callback (no-op if absent)."""
        with self._lock:
            try:
                self._callbacks.remove(fn)
            except ValueError:
                pass
        return self

    def estimate_s(self) -> Optional[float]:
        """The rolling step-time estimate (the median)."""
        with self._lock:
            if not self._durations:
                return None
            return statistics.median(self._durations)

    def deadline_s(self) -> Optional[float]:
        """The current stall deadline, or None while disarmed."""
        est = self.estimate_s()
        if est is None:
            return self.first_step_timeout_s
        return max(self.k * est, self.min_timeout_s)

    def check(self) -> Optional[Dict]:
        """The stall test against the injected clock: the stall's info the
        first time a stall is seen, else None."""
        with self._lock:
            ref = self._last_step_at if self._last_step_at is not None else self._started_at
            already = self._stalled
        if ref is None or already:
            return None
        deadline = self.deadline_s()
        if deadline is None:
            return None
        waited = self._clock() - ref
        if waited <= deadline:
            return None
        with self._lock:
            if self._stalled:
                return None
            self._stalled = True
            self.stall_count += 1
            info = {"waited_s": round(waited, 6), "deadline_s": round(deadline, 6),
                    "step_estimate_s": self.estimate_s(), "steps_completed": self._steps}
        log.warning("stall watchdog: no step completed for %.1fs (deadline %.1fs = max(%g x "
                    "%.4gs median step, %.1fs floor)); the run may be wedged",
                    info["waited_s"], info["deadline_s"], self.k,
                    info["step_estimate_s"] or float("nan"), self.min_timeout_s)
        with self._lock:
            callbacks = list(self._callbacks)
        for cb in callbacks:  # outside the lock: hooks run arbitrary code
            try:
                cb(info)
            except Exception:
                log.exception("stall watchdog callback failed")
        return info

    def start(self) -> "StallWatchdog":
        """Start (or restart) the poll thread for a new run, resetting the
        run's state: the last run's last step and step times are forgotten,
        so the gap between runs is no stall."""
        with self._lock:
            self._started_at = self._clock()
            self._last_step_at = None
            self._durations.clear()
            self._stalled = False
        self._spawn("bigdl-stall-watchdog")
        return self
