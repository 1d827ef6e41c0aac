"""Fleet identity and heartbeat files (counterpart of the first half of
``bigdl_tpu/obs/fleet.py``; its ``FleetMonitor`` comes with the elastic
runtime, ROADMAP Queue 1 item 9).

* :func:`process_identity` resolves this process's ``(process_index,
  process_count, host)``: the ``BIGDL_PROCESS_INDEX`` /
  ``BIGDL_PROCESS_COUNT`` / ``BIGDL_HOST_TAG`` overrides win; otherwise the
  rank and world size of the ``torch.distributed`` group that
  ``Engine.init_distributed`` joined; otherwise ``0/1``. Every
  :class:`~bigdl_tpu_torch.obs.telemetry.Telemetry` record carries it.
* :func:`write_heartbeat` atomically replaces ``<run_dir>/fleet/p<k>.hb``
  (JSON: step, epoch, wall, the last record's summary) at the telemetry
  emission seam; :func:`read_heartbeats` reads them all back. The file
  format is the JAX package's, so either package reads the other's.

File-based and device-free throughout.
"""

from __future__ import annotations

import json
import logging
import os
import socket
import time
from typing import Callable, Dict, Optional

log = logging.getLogger("bigdl_tpu_torch.obs")

__all__ = ["fleet_dir", "heartbeat_path", "process_identity", "read_heartbeats",
           "write_heartbeat"]


def process_identity() -> Dict[str, object]:
    """This process's fleet identity ``{"process_index", "process_count",
    "host"}`` (see the module docstring)."""
    idx, count = 0, 1
    try:
        from ..parallel import _comm

        if _comm.world() > 1:
            idx, count = int(_comm.rank()), int(_comm.world())
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
