"""The telemetry event stream, the part serving writes (counterpart of
``bigdl_tpu/obs/telemetry.py``; the port's own copy).

A :class:`Telemetry` sink fans each record (one JSON-able dict) out through
its exporters: a :class:`RingBufferExporter` is always attached as
``.ring`` (tests and REPLs read it), a :class:`JsonlExporter` appends to a
``*.jsonl`` file. The record types and field names are the JAX package's:
``meta`` (``run_start`` / ``run_end``), ``serve`` (one per batcher flush),
``warn`` and ``warmup``. Every field is a host-side value its caller
already holds: the stream never waits on the card.

Not ported (the JAX package's fields with no counterpart here): the step,
perf, health, compile and resilience-event records of training, the fleet
run directory with its heartbeat files, the scrape endpoint, the flight
recorder and causal spans. The heartbeat at the emission seam is
:meth:`Telemetry._heartbeat`, an explicit no-op: it writes the fleet run
directory's heartbeat file, which needs the run directory and the step-stall
watchdog the port does not have yet.
"""

from __future__ import annotations

import collections
import json
import logging
import os
import socket
import threading
import time
from typing import Dict, List, Optional, Sequence

log = logging.getLogger("bigdl_tpu_torch.obs")

__all__ = ["Telemetry", "TelemetryExporter", "JsonlExporter", "RingBufferExporter"]


class TelemetryExporter:
    """Exporter interface: ``emit`` one record dict; ``flush``/``close`` are
    optional. Exporters tolerate any record ``type``."""

    def emit(self, record: Dict) -> None:
        raise NotImplementedError

    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass


class JsonlExporter(TelemetryExporter):
    """One JSON object per line; parent directories are created.
    ``append=False`` truncates on first write."""

    def __init__(self, path: str, append: bool = True):
        self.path = path
        self.append = append
        self._fh = None

    def _file(self):
        if self._fh is None:
            os.makedirs(os.path.dirname(os.path.abspath(self.path)), exist_ok=True)
            self._fh = open(self.path, "a" if self.append else "w", encoding="utf-8")
        return self._fh

    def emit(self, record: Dict) -> None:
        self._file().write(json.dumps(record, default=float) + "\n")

    def flush(self) -> None:
        if self._fh is not None:
            self._fh.flush()

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None


class RingBufferExporter(TelemetryExporter):
    """Bounded in-memory record buffer."""

    def __init__(self, capacity: int = 4096):
        self._buf: collections.deque = collections.deque(maxlen=capacity)

    def emit(self, record: Dict) -> None:
        self._buf.append(record)

    @property
    def records(self) -> List[Dict]:
        return list(self._buf)



class Telemetry:
    """Telemetry sink: stamps and fans out records to ``exporters`` and to
    the built-in ring buffer ``.ring`` (the last 4096 records)."""

    def __init__(self, exporters: Optional[Sequence[TelemetryExporter]] = None):
        # the JAX package's fleet identity; one process here
        self.identity = {"process_index": 0, "process_count": 1,
                         "host": socket.gethostname()}
        self.ring = RingBufferExporter()
        self.exporters: List[TelemetryExporter] = [self.ring, *(exporters or ())]
        self._lock = threading.RLock()

    # ------------------------------------------------------------------ emit
    def emit(self, record: Dict) -> None:
        """Stamp ``ts`` and the process identity (setdefault) and fan out; a
        failing exporter drops the record there only."""
        record.setdefault("ts", time.time())
        for k, v in self.identity.items():
            record.setdefault(k, v)
        with self._lock:
            for ex in self.exporters:
                try:
                    ex.emit(record)
                except Exception:
                    log.exception("telemetry exporter %s failed; record dropped there",
                                  type(ex).__name__)

    # ------------------------------------------------------------ run bounds
    def run_started(self, path: str, **extra) -> None:
        """Mark a run start: a ``meta`` record with the devices the process
        sees and the fused-kernel switch."""
        import torch

        from ..utils.engine import Engine

        if torch.cuda.is_available():
            devices = [{"platform": "gpu", "kind": torch.cuda.get_device_name(i)}
                       for i in range(torch.cuda.device_count())]
        else:
            devices = [{"platform": "cpu", "kind": ""}]
        rec = {"type": "meta", "event": "run_start", "path": path, "devices": devices,
               "fused_kernels": Engine.fused_kernels()}
        rec.update(extra)
        self.emit(rec)
        self.flush()
        self._heartbeat(rec)

    def run_ended(self, path: str, **extra) -> None:
        rec = {"type": "meta", "event": "run_end", "path": path}
        rec.update(extra)
        self.emit(rec)
        self._heartbeat(rec)
        self.flush()

    # ----------------------------------------------------------------- serve
    def serve(self, *, model: str, iteration: int, records: int, batch_fill: float,
              queue_depth: int, path: str = "serve", bucket: Optional[int] = None,
              version: Optional[int] = None, trigger: Optional[str] = None,
              wall_s: Optional[float] = None, queue_wait_ms: Optional[float] = None,
              p50_ms: Optional[float] = None, p99_ms: Optional[float] = None,
              rps: Optional[float] = None, deadline_missed: Optional[int] = None,
              swept_expired: Optional[int] = None, shed: Optional[int] = None,
              breaker_state: Optional[str] = None, **fields) -> None:
        """One record per continuous-batcher flush: the model and version
        that dispatched, ``batch_fill`` (real records / max_batch), the queue
        depth left behind, the trigger that fired (``"max_batch"`` /
        ``"max_delay"`` / ``"custom"`` / ``"drain"``), the rolling latency
        percentiles and requests/s over completed requests, and the
        cumulative resilience counters (``deadline_missed``,
        ``swept_expired``, ``shed``) with the breaker's state."""
        rec = {
            "type": "serve", "path": path, "model": model, "iteration": int(iteration),
            "records": int(records), "batch_fill": batch_fill,
            "queue_depth": int(queue_depth),
            "bucket": None if bucket is None else int(bucket),
            "version": None if version is None else int(version),
            "trigger": trigger,
            "wall_s": None if wall_s is None else round(wall_s, 6),
            "queue_wait_ms": None if queue_wait_ms is None else round(queue_wait_ms, 3),
            "p50_ms": None if p50_ms is None else round(p50_ms, 3),
            "p99_ms": None if p99_ms is None else round(p99_ms, 3),
            "rps": None if rps is None else round(rps, 3),
        }
        for key, val in (("deadline_missed", deadline_missed),
                         ("swept_expired", swept_expired), ("shed", shed)):
            if val is not None:
                rec[key] = int(val)
        if breaker_state is not None:
            rec["breaker_state"] = breaker_state
        rec.update(fields)
        self.emit(rec)
        self._heartbeat(rec)

    # ------------------------------------------------------------------ warn
    def warn(self, *, reason: str, path: str = "train", iteration: Optional[int] = None,
             **fields) -> None:
        """One advisory ``warn`` record; flushed at once."""
        rec = {"type": "warn", "path": path, "reason": reason,
               "iteration": None if iteration is None else int(iteration)}
        rec.update(fields)
        self.emit(rec)
        self.flush()

    # ---------------------------------------------------------------- warmup
    def warmup(self, *, model: str, seconds: float, compiles: int,
               fresh_compiles: Optional[int], warm_start: bool, path: str = "serve",
               **fields) -> None:
        """One record per model warmup. The port compiles no per-shape
        program, so ``compiles`` counts the loads of the kernel library
        (``ops/_build.py``) that the warmup triggered and ``fresh_compiles``
        the builds of it (nvcc runs) among them: 0 or 1 each, 0 when the
        library was already loaded or the model runs on the CPU.
        ``warm_start`` is False (no artifact bundles in the port)."""
        rec = {"type": "warmup", "path": path, "model": model,
               "seconds": round(float(seconds), 6), "compiles": int(compiles),
               "fresh_compiles": None if fresh_compiles is None else int(fresh_compiles),
               "warm_start": bool(warm_start)}
        rec.update(fields)
        self.emit(rec)
        self.flush()

    # ------------------------------------------------------------- heartbeat
    def _heartbeat(self, rec: Dict) -> None:
        """No-op: the JAX package writes the fleet heartbeat file of its run
        directory here, which the port has not ported (no run directory, no
        step-stall watchdog)."""

    # ----------------------------------------------------------- maintenance
    def flush(self) -> None:
        with self._lock:
            for ex in self.exporters:
                try:
                    ex.flush()
                except Exception:
                    log.exception("telemetry exporter flush failed")

    def close(self) -> None:
        with self._lock:
            for ex in self.exporters:
                try:
                    ex.close()
                except Exception:
                    log.exception("telemetry exporter close failed")
