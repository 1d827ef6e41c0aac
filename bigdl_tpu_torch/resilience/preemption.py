"""Preemption guard: turn SIGTERM/SIGINT into a resumable clean shutdown
(counterpart of ``bigdl_tpu/resilience/preemption.py``; the port's own copy).

A preempting scheduler delivers SIGTERM with a grace window. Without a handler the process dies mid-step and the run loses
everything since the last periodic checkpoint; with the guard installed the
driver loop notices the pending signal at the next step boundary, writes an
EMERGENCY checkpoint (same verified-manifest format as periodic ones), emits
a ``preempt_checkpoint`` telemetry record, and raises
:class:`~bigdl_tpu_torch.resilience.errors.TrainingPreempted` (``exit_code == 0``)
so the caller exits clean and the rescheduled run resumes exactly where it
stopped via ``Optimizer.resume()``.

The handler itself only sets a flag — everything heavy happens on the driver
thread at a step boundary, so the checkpoint is always consistent (params,
slots, RNG position and data position all describe the same step).

Signal handlers can only be installed from the main thread; elsewhere
(notebooks driving from worker threads, test runners) :meth:`install`
degrades to a warning and the run proceeds unguarded.
"""

from __future__ import annotations

import logging
import signal as _signal
import threading
from typing import Dict, Optional, Sequence

log = logging.getLogger("bigdl_tpu_torch.resilience")

__all__ = ["PreemptionGuard"]


class PreemptionGuard:
    """Install/uninstall scope for preemption signal handling.

    Args:
        signals: signal numbers to catch. Default ``(SIGTERM,)`` — SIGINT is
            deliberately NOT included by default so Ctrl-C keeps raising
            ``KeyboardInterrupt``; pass
            ``signals=(signal.SIGTERM, signal.SIGINT)`` to claim both.
    """

    def __init__(self, signals: Optional[Sequence[int]] = None):
        self.signals = tuple(signals) if signals else (_signal.SIGTERM,)
        self._pending: Optional[int] = None
        self._prev: Dict[int, object] = {}
        self._installed = False

    # ---------------------------------------------------------------- handler
    def _handler(self, signum, frame) -> None:
        # flag only — the driver loop does the checkpoint at a step boundary
        self._pending = signum
        log.warning(
            "preemption guard: received signal %d; emergency checkpoint at "
            "the next step boundary", signum,
        )

    def pending(self) -> Optional[int]:
        """The caught signal number, or None."""
        return self._pending

    def clear(self) -> None:
        self._pending = None

    # ---------------------------------------------------------------- install
    def install(self) -> "PreemptionGuard":
        if self._installed:
            return self
        if threading.current_thread() is not threading.main_thread():
            log.warning(
                "preemption guard: not on the main thread; signal handlers "
                "not installed (run proceeds unguarded)"
            )
            return self
        for s in self.signals:
            self._prev[s] = _signal.signal(s, self._handler)
        self._installed = True
        return self

    def uninstall(self) -> None:
        if not self._installed:
            return
        for s, prev in self._prev.items():
            try:
                _signal.signal(s, prev)
            except (ValueError, TypeError):  # interpreter shutting down
                pass
        self._prev.clear()
        self._installed = False

    def __enter__(self) -> "PreemptionGuard":
        return self.install()

    def __exit__(self, *exc_info) -> None:
        self.uninstall()
