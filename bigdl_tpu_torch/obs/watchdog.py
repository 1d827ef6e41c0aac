"""The poll-loop chassis of watchdog-style monitors (counterpart of
``bigdl_tpu/obs/watchdog.py``'s ``MonitorBase``; ``StallWatchdog``, a
training monitor, is not ported yet).

A daemon thread calls ``check()`` every ``poll_interval_s`` until stopped.
The contract that keeps every subclass testable: ``check()`` is a pure
function of an injected clock and the recorded state, so tests drive it
directly with a fake clock and never need the thread.
"""

from __future__ import annotations

import threading
from typing import Optional

__all__ = ["MonitorBase"]


class MonitorBase:
    """Shared poll loop of the port's monitors (the serving tier's
    :class:`~bigdl_tpu_torch.serving.resilience.ServingSupervisor`)."""

    def __init__(self, poll_interval_s: float):
        self.poll_interval_s = float(poll_interval_s)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def check(self):
        raise NotImplementedError

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
