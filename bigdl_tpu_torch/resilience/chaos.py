"""Deterministic fault injection at the observability span seams
(counterpart of ``bigdl_tpu/resilience/chaos.py``; the port's own copy).

A :class:`FaultPlan` arms named failure points at the seams the span
instrumentation (:mod:`bigdl_tpu_torch.obs.trace`) already names — ``prefetch``, ``pad_mask``, ``dispatch``,
``checkpoint``, ``checkpoint_load``, ``validation``, ``place_batch``, … —
and fires on the k-th hit of a seam: raise a :class:`FaultInjected`, delay
(stall simulation), or run a caller-supplied callback (e.g. corrupt a
checkpoint file on disk). Hits are counted globally across retry attempts,
so "fail once at the 5th prefetch" composes deterministically with the
replay the retry machinery performs.

The hook rides :func:`bigdl_tpu_torch.obs.trace.span` (and the bare
``fault_point`` markers, e.g. the train-step dispatch): when no plan is
installed the cost is one module-global ``None`` check per seam — nothing
else. Install is process-global and explicitly scoped::

    plan = (FaultPlan()
            .arm("prefetch", kind="raise", at_hit=5)
            .arm("checkpoint", kind="raise", at_hit=2))
    with plan:                       # installs + uninstalls the hook
        optimizer.optimize()         # survives via its FailurePolicy
    assert plan.events               # what fired, in order

Every firing appends to ``plan.events`` and, when a
:class:`~bigdl_tpu_torch.obs.telemetry.Telemetry` sink is attached
(``FaultPlan(telemetry=...)``), emits a ``type="fault_injected"`` record so
chaos runs are self-describing in the JSONL stream.

The serving runtime has its own seams (``SERVING_SEAMS``), at the JAX
package's places:
``serve_admission`` fires on the caller's thread inside
``ContinuousBatcher.submit``, ``serve_assembly`` / ``serve_dispatch`` on the
batching thread around pad/stack and ``Predictor.forward_batch``,
``serve_materialize`` on the caller's thread inside ``ServeFuture.result``,
and ``serve_worker`` at the top of the batching loop itself (a ``raise``
there kills the worker thread — the seam the ``ServingSupervisor``
kill→restart coverage arms). The elastic fleet's ``FLEET_SEAMS``, in
host-loss order: ``hb_write`` inside every heartbeat file write
(``obs/fleet.py``: arming it is a host whose heartbeats stop),
``coordinate`` before the emergency fleet checkpoint, ``reshard`` and
``rejoin`` inside ``Optimizer._apply_remesh``.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Dict, List, Optional

from .errors import FaultInjected

log = logging.getLogger("bigdl_tpu_torch.resilience")

__all__ = ["FaultPlan", "FaultSpec", "FLEET_SEAMS", "SERVING_SEAMS"]

# the serving tier's chaos seams, in request order (docs/resilience.md):
# admission (caller thread) -> assembly + dispatch (batching thread) ->
# materialization (caller thread); serve_worker marks the batching loop
# itself so a plan can kill/wedge the worker the supervisor must recover
SERVING_SEAMS = (
    "serve_admission",
    "serve_assembly",
    "serve_dispatch",
    "serve_materialize",
    "serve_worker",
)

# the elastic fleet's seams, in host-loss order (the module docstring)
FLEET_SEAMS = ("hb_write", "coordinate", "reshard", "rejoin")

class FaultSpec:
    """One armed failure point: fire ``times`` times starting at the
    ``at_hit``-th hit of ``seam`` (both 1-based)."""

    __slots__ = ("seam", "kind", "at_hit", "times", "delay_s", "exc", "callback")

    def __init__(self, seam: str, kind: str = "raise", at_hit: int = 1,
                 times: int = 1, delay_s: float = 0.0,
                 exc: Optional[Callable[[], BaseException]] = None,
                 callback: Optional[Callable[[int], None]] = None):
        if kind not in ("raise", "delay", "callback"):
            raise ValueError(f"unknown fault kind {kind!r}")
        if kind == "callback" and callback is None:
            raise ValueError("kind='callback' needs a callback")
        if at_hit < 1 or times < 1:
            raise ValueError("at_hit and times are 1-based and positive")
        self.seam = seam
        self.kind = kind
        self.at_hit = int(at_hit)
        self.times = int(times)
        self.delay_s = float(delay_s)
        self.exc = exc
        self.callback = callback

    def window(self, hit: int) -> bool:
        return self.at_hit <= hit < self.at_hit + self.times


class FaultPlan:
    """Deterministic, seam-addressed fault injection plan (see module doc)."""

    def __init__(self, telemetry=None):
        self.telemetry = telemetry
        self._specs: Dict[str, List[FaultSpec]] = {}
        self._hits: Dict[str, int] = {}
        self._lock = threading.Lock()  # seams fire from prefetch threads too
        self.events: List[dict] = []
        self._installed = False

    # ------------------------------------------------------------------- arm
    def arm(self, seam: str, kind: str = "raise", at_hit: int = 1,
            times: int = 1, delay_s: float = 0.0,
            exc: Optional[Callable[[], BaseException]] = None,
            callback: Optional[Callable[[int], None]] = None) -> "FaultPlan":
        self._specs.setdefault(seam, []).append(
            FaultSpec(seam, kind, at_hit, times, delay_s, exc, callback)
        )
        return self

    # ------------------------------------------------------------------ fire
    def fire(self, seam: str) -> None:
        """Called by the trace hook at every seam entry. Cheap no-op for
        seams with nothing armed."""
        specs = self._specs.get(seam)
        if not specs:
            return
        with self._lock:
            hit = self._hits.get(seam, 0) + 1
            self._hits[seam] = hit
            live = [s for s in specs if s.window(hit)]
            if not live:
                return
            events = [
                {"seam": seam, "kind": s.kind, "hit": hit} for s in live
            ]
            self.events.extend(events)
        tel = self.telemetry
        if tel is not None:
            for ev in events:
                tel.fault_injected_event(**ev)
        for s in live:
            log.warning("chaos: firing %s at seam %r (hit %d)",
                        s.kind, seam, hit)
            if s.kind == "delay":
                time.sleep(s.delay_s)
            elif s.kind == "callback":
                s.callback(hit)
            else:
                raise (s.exc() if s.exc is not None
                       else FaultInjected(seam, hit, s.kind))

    def hits(self, seam: str) -> int:
        with self._lock:
            return self._hits.get(seam, 0)

    # --------------------------------------------------------------- install
    def install(self) -> "FaultPlan":
        from ..obs import trace as _trace

        if _trace.fault_hook() not in (None, self.fire):
            raise RuntimeError("another FaultPlan is already installed")
        _trace.set_fault_hook(self.fire)
        self._installed = True
        return self

    def uninstall(self) -> None:
        from ..obs import trace as _trace

        if self._installed:
            _trace.set_fault_hook(None)
            self._installed = False

    def __enter__(self) -> "FaultPlan":
        return self.install()

    def __exit__(self, *exc_info) -> None:
        self.uninstall()
