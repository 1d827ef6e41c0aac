"""Fleet identity, heartbeat files and the fleet monitor (counterpart of
``bigdl_tpu/obs/fleet.py``).

* :func:`process_identity` resolves this process's ``(process_index,
  process_count, host)``: the ``BIGDL_PROCESS_INDEX`` /
  ``BIGDL_PROCESS_COUNT`` / ``BIGDL_HOST_TAG`` overrides win; otherwise the
  rank and world size of the ``torch.distributed`` group that
  ``Engine.init_distributed`` joined (the whole group's, also while an
  elastic run trains on a part of it); otherwise ``0/1``. Every
  :class:`~bigdl_tpu_torch.obs.telemetry.Telemetry` record carries it.
* :func:`write_heartbeat` atomically replaces ``<run_dir>/fleet/p<k>.hb``
  (JSON: step, epoch, wall, the last record's summary) at the telemetry
  emission seam; :func:`read_heartbeats` reads them all back. The file
  format is the JAX package's, so either package reads the other's.
* :class:`FleetMonitor` reads those files and flags a process whose step
  lags the fleet's median by more than ``lag_factor`` times
  (``straggler``), whose heartbeat is older than ``stale_after_s``
  (``host_lost``) or that wrote the ``leaving`` sentinel (``host_left``):
  one ``warn`` record and the callbacks once an episode, re-armed on
  recovery. :meth:`FleetMonitor.check` is a pure function of its wall
  clock and the files, so the JAX monitor and this one raise the same
  events over the same files.

File-based and device-free throughout.
"""

from __future__ import annotations

import json
import logging
import os
import socket
import statistics
import threading
import time
from typing import Callable, Dict, List, Optional

from .watchdog import MonitorBase

log = logging.getLogger("bigdl_tpu_torch.obs")

__all__ = ["FleetMonitor", "fleet_dir", "heartbeat_path", "process_identity",
           "read_heartbeats", "write_heartbeat"]


def process_identity() -> Dict[str, object]:
    """This process's fleet identity ``{"process_index", "process_count",
    "host"}`` (see the module docstring)."""
    idx, count = 0, 1
    try:
        from ..utils.engine import Engine

        sl = Engine.process_slice()
        if sl is not None:
            idx, count = int(sl[0]), int(sl[1])
    except Exception:  # an identity probe must never stop a run
        log.debug("process identity: process group probe failed", exc_info=True)
    for name in ("BIGDL_PROCESS_INDEX", "BIGDL_PROCESS_COUNT"):
        env = os.environ.get(name)
        if env is None:
            continue
        try:
            value = int(env)
        except ValueError:
            log.warning("ignoring malformed %s=%r (not an int)", name, env)
            continue
        if name == "BIGDL_PROCESS_INDEX":
            idx = value
        else:
            count = value
    host = os.environ.get("BIGDL_HOST_TAG") or socket.gethostname()
    return {"process_index": idx, "process_count": count, "host": host}


def fleet_dir(run_dir: str) -> str:
    return os.path.join(run_dir, "fleet")


def heartbeat_path(run_dir: str, process_index: int) -> str:
    return os.path.join(fleet_dir(run_dir), f"p{int(process_index)}.hb")


def write_heartbeat(run_dir: str, *, identity: Dict[str, object], step: Optional[int] = None,
                    epoch: Optional[int] = None, wall_s: Optional[float] = None,
                    summary: Optional[Dict] = None, leaving: bool = False,
                    clock: Callable[[], float] = time.time) -> str:
    """Atomically write this process's heartbeat file (temp file +
    ``os.replace``: a reader never sees a torn object). ``ts`` is the wall
    clock (heartbeats are compared across hosts). ``leaving=True`` marks a
    clean shutdown (``Telemetry.close``)."""
    from .trace import fault_point

    fault_point("hb_write")
    path = heartbeat_path(run_dir, int(identity["process_index"]))
    os.makedirs(os.path.dirname(path), exist_ok=True)
    rec = {
        "ts": clock(),
        "step": None if step is None else int(step),
        "epoch": None if epoch is None else int(epoch),
        "wall_s": None if wall_s is None else round(float(wall_s), 6),
        "summary": summary,
    }
    if leaving:
        rec["leaving"] = True
    rec.update(identity)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w", encoding="utf-8") as fh:
        fh.write(json.dumps(rec, default=float))
    os.replace(tmp, path)
    return path


def read_heartbeats(run_dir: str) -> Dict[int, Dict]:
    """Every parseable ``p<k>.hb`` under ``<run_dir>/fleet/``, keyed by
    process index; a torn or foreign file is skipped."""
    d = fleet_dir(run_dir)
    out: Dict[int, Dict] = {}
    try:
        names = sorted(os.listdir(d))
    except OSError:
        return out
    for name in names:
        if not (name.startswith("p") and name.endswith(".hb")):
            continue
        try:
            k = int(name[1:-3])
        except ValueError:
            continue
        try:
            with open(os.path.join(d, name), encoding="utf-8") as fh:
                rec = json.load(fh)
        except (OSError, ValueError):
            continue
        if isinstance(rec, dict):
            out[k] = rec
    return out


class FleetMonitor(MonitorBase):
    """Flags stragglers, lost hosts and departed hosts from the fleet's
    heartbeat files (the JAX package's monitor).

    With the fleet's median heartbeat step at ``M``, process ``k`` is a
    straggler while ``step_k * lag_factor < M``, once ``M`` reaches
    ``min_fleet_steps``; a heartbeat older than ``stale_after_s`` by the
    injected ``wall_clock`` is ``host_lost`` instead (a silent host is not
    judged on progress); a ``leaving`` heartbeat is ``host_left``. Each
    warns once an episode (a ``warn`` record through ``telemetry`` with
    ``path="fleet"``, then the callbacks, outside the lock) and re-arms on
    recovery. :meth:`check` returns the events of its pass."""

    def __init__(self, run_dir: str, telemetry=None, *, lag_factor: float = 2.0,
                 stale_after_s: float = 60.0, min_fleet_steps: int = 8,
                 poll_interval_s: float = 5.0,
                 on_event: Optional[Callable[[Dict], None]] = None,
                 wall_clock: Callable[[], float] = time.time):
        if lag_factor <= 1.0:
            raise ValueError(f"lag_factor must be > 1, got {lag_factor}")
        if stale_after_s <= 0:
            raise ValueError(f"stale_after_s must be positive, got {stale_after_s}")
        super().__init__(poll_interval_s)
        self.run_dir = run_dir
        self.telemetry = telemetry
        self.lag_factor = float(lag_factor)
        self.stale_after_s = float(stale_after_s)
        self.min_fleet_steps = int(min_fleet_steps)
        self._wall_clock = wall_clock
        self._lock = threading.Lock()  # callbacks register on another thread
        self._callbacks: List[Callable[[Dict], None]] = []  # guarded-by: _lock
        if on_event is not None:
            self._callbacks.append(on_event)
        self._lagging: set = set()  # the open episodes
        self._lost: set = set()
        self._left: set = set()
        self.event_count = 0

    def add_callback(self, fn: Callable[[Dict], None]) -> "FleetMonitor":
        with self._lock:
            self._callbacks.append(fn)
        return self

    def check(self) -> List[Dict]:
        """One pass over the heartbeat files; the events raised by it."""
        beats = read_heartbeats(self.run_dir)
        if not beats:
            return []
        now = self._wall_clock()
        events: List[Dict] = []
        fresh: Dict[int, Dict] = {}
        for k, hb in beats.items():
            if hb.get("leaving"):  # announced: never host_lost
                if k not in self._left:
                    self._left.add(k)
                    events.append({"reason": "host_left", "process_index": k,
                                   "host": hb.get("host"), "step": hb.get("step")})
                self._lost.discard(k)
                continue
            self._left.discard(k)  # beating again: rejoined
            ts = hb.get("ts")
            age = None if not isinstance(ts, (int, float)) else now - ts
            if age is not None and age > self.stale_after_s:
                if k not in self._lost:
                    self._lost.add(k)
                    events.append({"reason": "host_lost", "process_index": k,
                                   "host": hb.get("host"), "step": hb.get("step"),
                                   "stale_s": round(age, 3)})
                continue
            self._lost.discard(k)  # the heartbeat resumed: re-armed
            fresh[k] = hb
        steps = {k: int(hb["step"]) for k, hb in fresh.items()
                 if isinstance(hb.get("step"), (int, float))}
        if len(steps) >= 2:
            median = statistics.median(steps.values())
            if median >= self.min_fleet_steps:
                for k, step in steps.items():
                    if step * self.lag_factor < median:
                        if k not in self._lagging:
                            self._lagging.add(k)
                            events.append({"reason": "straggler", "process_index": k,
                                           "host": fresh[k].get("host"), "step": step,
                                           "median_step": median,
                                           "lag_factor": self.lag_factor})
                    else:
                        self._lagging.discard(k)  # caught up: re-armed
        for ev in events:
            self.event_count += 1
            log.warning("fleet monitor: %s p%s (host=%s, step=%s%s)", ev["reason"],
                        ev["process_index"], ev.get("host"), ev.get("step"),
                        f", fleet median {ev['median_step']}" if "median_step" in ev else
                        f", stale {ev['stale_s']}s" if "stale_s" in ev else "")
            if self.telemetry is not None:
                self.telemetry.warn(path="fleet", **ev)
            with self._lock:
                callbacks = list(self._callbacks)
            for cb in callbacks:
                try:
                    cb(ev)
                except Exception:  # a broken hook must not stop the monitoring
                    log.exception("fleet monitor callback failed")
        return events

    def snapshot(self) -> Dict[str, object]:
        """The heartbeats and the open episodes (file reads only)."""
        return {"heartbeats": read_heartbeats(self.run_dir), "stragglers": sorted(self._lagging),
                "lost": sorted(self._lost), "left": sorted(self._left),
                "events": self.event_count}

    def start(self) -> "FleetMonitor":
        super().start("bigdl-fleet-monitor")
        return self
