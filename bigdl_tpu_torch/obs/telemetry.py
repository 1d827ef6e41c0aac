"""The per-step telemetry event stream (counterpart of
``bigdl_tpu/obs/telemetry.py``; the port's own copy).

A :class:`Telemetry` sink attached to an optimizer (``set_telemetry``) or a
``ModelServer`` produces one JSON-able record per step (or flush) and fans
it out through its exporters:

* :class:`JsonlExporter`: an append-only ``*.jsonl`` file (the
  ``tools/obs_report.py`` input);
* :class:`SummaryExporter`: step records into a
  :class:`~bigdl_tpu_torch.visualization.TrainSummary` (the ``Loss`` /
  ``LearningRate`` / ``Throughput`` tags of ``set_train_summary``);
* :class:`RingBufferExporter`: a bounded in-memory buffer, always attached
  as ``.ring``;
* the process-global flight recorder (:mod:`.blackbox`), armed by every
  sink.

While ``Engine.set_metrics_port`` has a port set, every sink's ring is
also served by the process's scrape endpoint (:mod:`.export`) until the
sink closes.

The record types and field names are the JAX package's: ``meta``
(``run_start`` / ``run_end``), ``step``, ``compile``, ``perf``, ``health``,
``serve``, ``warn``, ``warmup``, ``stall``, ``span`` and the resilience
events (``retry``, ``rollback``, ``preempt_checkpoint``,
``fault_injected``). Every field is a host-side value the caller already
holds: the stream never waits on the card. ``memory`` is
:func:`device_memory_stats`, the caching allocator's counters (a host-side
read), None on the CPU.

The port compiles no per-shape program, so it has no counterpart of a JIT
compile. Its ``compile`` records stand for the kernel library's build and
load (``ops/_build.py``): one record at the step whose dispatch loaded the
library, ``count`` the libraries loaded, ``cache_hit`` True when the
library was loaded from an existing build and False when ``nvcc`` built
it. A run on the CPU, or one whose library was loaded before it, has none.

``Metrics`` is the host-side step-time averager of ``$DL/optim/Metrics``
(``bigdl_tpu_torch.optim.metrics`` re-exports it).
"""

from __future__ import annotations

import collections
import contextlib
import json
import logging
import os
import threading
import time
from typing import Dict, List, Optional, Sequence

from . import fleet as _fleet
from . import trace as _trace
from .watchdog import StallWatchdog

log = logging.getLogger("bigdl_tpu_torch.obs")

__all__ = ["Metrics", "Telemetry", "TelemetryExporter", "JsonlExporter",
           "RingBufferExporter", "SummaryExporter", "device_memory_stats"]


class Metrics:
    """Host-side named averager (``$DL/optim/Metrics.scala``'s counters;
    one process, nothing to accumulate across executors)."""

    def __init__(self):
        self._sums: Dict[str, float] = {}
        self._counts: Dict[str, int] = {}

    def add(self, name: str, value: float) -> None:
        self._sums[name] = self._sums.get(name, 0.0) + value
        self._counts[name] = self._counts.get(name, 0) + 1

    @contextlib.contextmanager
    def time(self, name: str):
        """Time the block (recorded also when it raises)."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(name, time.perf_counter() - t0)

    def average(self, name: str) -> float:
        c = self._counts.get(name, 0)
        return self._sums.get(name, 0.0) / c if c else 0.0

    def summary(self) -> Dict[str, float]:
        return {k: self.average(k) for k in sorted(self._sums)}

    def reset(self) -> None:
        self._sums.clear()
        self._counts.clear()

    def __repr__(self):
        parts = ", ".join(f"{k}: {v * 1e3:.1f}ms" for k, v in self.summary().items())
        return f"Metrics({parts})"


def device_memory_stats() -> Optional[Dict[str, Dict[str, int]]]:
    """``{"gpu:<i>": {"bytes_in_use", "peak_bytes_in_use",
    "bytes_reserved", "peak_bytes_reserved"}}`` for every CUDA device whose
    caching allocator has been used, from ``torch.cuda.memory_stats`` (the
    allocator's host-side counters, never a sync); None when there is none
    (the CPU, as the JAX package returns there)."""
    import torch

    if not torch.cuda.is_available() or not torch.cuda.is_initialized():
        return None
    out: Dict[str, Dict[str, int]] = {}
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        if not stats:
            continue
        out[f"gpu:{i}"] = {
            "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0)),
            "bytes_reserved": int(stats.get("reserved_bytes.all.current", 0)),
            "peak_bytes_reserved": int(stats.get("reserved_bytes.all.peak", 0)),
        }
    return out or None


def observe_jit_compiles(jit_fn, seen: int, telemetry: "Telemetry", *, iteration: int,
                         seconds: float, path: str, cache_watch=None) -> int:
    """The JAX package's compile observer for any callable that counts its
    compiled variants (``_cache_size()``): growth across a dispatch is one
    ``compile`` record; returns the new count. The port's own steps compile
    nothing: their observer is :func:`observe_kernel_builds`."""
    if jit_fn is None:
        return seen
    try:
        csize = jit_fn._cache_size()
    except Exception:
        return seen
    if csize > seen:
        cache_hit = None if cache_watch is None else cache_watch.observe()
        telemetry.compile_event(iteration=iteration, seconds=seconds, count=csize - seen,
                                path=path, cache_hit=cache_hit)
        return csize
    return seen


def observe_kernel_builds(seen, telemetry: "Telemetry", *, iteration: int, seconds: float,
                          path: str):
    """Report the kernel library's loads (and builds) since ``seen`` (a
    ``(loads, builds)`` pair of ``ops/_build.py``'s counters) as one
    ``compile`` record, attributing the dispatch's wall ``seconds``;
    returns the counters now. See the module docstring."""
    from ..ops import _build

    now = (_build.loads, _build.builds)
    if now[0] > seen[0]:
        telemetry.compile_event(iteration=iteration, seconds=seconds, count=now[0] - seen[0],
                                path=path, cache_hit=now[1] == seen[1])
    return now


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
    ``append=False`` truncates on first write (the run-directory default, so
    a re-run does not stack two streams in one file)."""

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

    def steps(self) -> List[Dict]:
        return [r for r in self._buf if r.get("type") == "step"]

    def clear(self) -> None:
        self._buf.clear()


class SummaryExporter(TelemetryExporter):
    """Step records into a TrainSummary-like writer (``add_scalar(tag,
    value, step)``) under the tags ``set_train_summary`` writes."""

    _STEP_TAGS = (("Loss", "loss"), ("LearningRate", "lr"), ("Throughput", "records_per_sec"))

    def __init__(self, summary):
        self.summary = summary

    def emit(self, record: Dict) -> None:
        if record.get("type") != "step":
            return
        step = record["iteration"]
        for tag, field in self._STEP_TAGS:
            v = record.get(field)
            if v is not None:
                self.summary.add_scalar(tag, float(v), step)

    def flush(self) -> None:
        self.summary.flush()

    def close(self) -> None:
        self.summary.close()


class Telemetry:
    """The telemetry sink.

    Args:
        exporters: exporters fanned out to on every record. A
            :class:`RingBufferExporter` is always attached as ``.ring``; with
            no exporter given and a run directory set
            (``Engine.set_run_dir`` / ``BIGDL_RUN_DIR``), a
            :class:`JsonlExporter` at ``<run_dir>/telemetry/p<k>.jsonl`` is
            added (``k`` the fleet process index).
        watchdog: an optional :class:`StallWatchdog`, started and stopped
            with the run, fed every step's wall time; its stalls are
            ``stall`` records.
        ring_capacity: bound of the ring.
        heartbeat_interval_s: the floor between heartbeat writes
            (``<run_dir>/fleet/p<k>.hb``, at the emission seam when a run
            directory is set); None disables them.
    """

    def __init__(self, exporters: Optional[Sequence[TelemetryExporter]] = None,
                 watchdog: Optional[StallWatchdog] = None, ring_capacity: int = 4096,
                 heartbeat_interval_s: Optional[float] = 1.0):
        from ..utils.engine import Engine

        self.identity = _fleet.process_identity()
        self.ring = RingBufferExporter(ring_capacity)
        self.exporters: List[TelemetryExporter] = [self.ring]
        if exporters:
            self.exporters.extend(exporters)
        else:
            run_dir = Engine.run_dir()
            if run_dir:
                self.exporters.append(JsonlExporter(
                    os.path.join(run_dir, "telemetry",
                                 f"p{self.identity['process_index']}.jsonl"),
                    append=False))
        try:  # the flight recorder (obs/blackbox.py); BIGDL_BLACKBOX=0 opts out
            from . import blackbox as _blackbox

            rec = _blackbox.ensure_armed()
            if rec is not None:
                self.exporters.append(rec)
        except Exception:  # arming is best-effort; the sink must construct
            log.debug("flight recorder arming failed", exc_info=True)
        self.heartbeat_interval_s = heartbeat_interval_s
        # the process's scrape endpoint (Engine.set_metrics_port) reads this
        # sink's ring; a bind failure must not stop the run
        self._endpoint = None
        port = Engine.metrics_port()
        if port is not None:
            from . import export as _export

            try:
                self._endpoint = _export.default_endpoint() or _export.ensure_default(port)
            except OSError as e:
                log.warning("obs endpoint re-bind on port %s failed (%s); this telemetry "
                            "sink is not scrapeable", port, e)
            else:
                self._endpoint.attach_telemetry(self)
        self._hb_next = 0.0
        self._hb_disabled = False
        self._hb_last_step: Optional[int] = None
        self._hb_last_epoch: Optional[int] = None
        self.watchdog = watchdog
        if watchdog is not None:
            watchdog.add_callback(self._on_stall)
        self._lock = threading.RLock()
        self.compile_count = 0
        self.compile_seconds = 0.0
        self.hbm_peak_bytes: Optional[int] = None
        self._runs = 0
        # the run's span sink, bound to its threads (driver and prefetch)
        self.collector = _trace.SpanCollector()
        self.collector.on_span = self.span_record
        self._prev_binding = None

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

    def span_record(self, rec: Dict) -> None:
        """One id-bearing causal span as a ``span`` record."""
        out = {"type": "span"}
        out.update(rec)
        self.emit(out)

    # ------------------------------------------------------------ run bounds
    def run_started(self, path: str, **extra) -> None:
        """Mark a run start (one per ``optimize()`` attempt or server): a
        ``meta`` record with the devices the process sees, the run
        directory and the fused-kernel switch; binds the span collector to
        this thread and starts the watchdog."""
        import torch

        from ..utils.engine import Engine

        self._prev_binding = _trace.bind_collector(self.collector)
        self._runs += 1
        if torch.cuda.is_available():
            devices = [{"platform": "gpu", "kind": torch.cuda.get_device_name(i)}
                       for i in range(torch.cuda.device_count())]
        else:
            devices = [{"platform": "cpu", "kind": ""}]
        rec = {"type": "meta", "event": "run_start", "path": path, "devices": devices,
               "run_dir": Engine.run_dir(), "fused_kernels": Engine.fused_kernels()}
        rec.update(extra)
        self.emit(rec)
        self.flush()
        self._hb_next = 0.0
        self._heartbeat(rec)
        if self.watchdog is not None:
            self.watchdog.start()

    def run_ended(self, path: str, **extra) -> None:
        rec = {"type": "meta", "event": "run_end", "path": path,
               "compile_count": self.compile_count,
               "compile_seconds": round(self.compile_seconds, 6),
               "hbm_peak_bytes": self.hbm_peak_bytes,
               # the spans after the last step record (the final flush, an
               # end-of-run checkpoint) attribute to this run
               "spans": self.collector.drain()}
        rec.update(extra)
        self.emit(rec)
        if self.watchdog is not None:
            self.watchdog.stop()
        if _trace.current_collector() is self.collector:
            _trace.bind_collector(self._prev_binding)
        self._prev_binding = None
        self._hb_next = 0.0
        self._heartbeat(rec)
        self.flush()

    # ------------------------------------------------------------------ step
    def step(self, *, iteration: int, records: int, wall_s: float, path: str = "train",
             epoch: Optional[int] = None, loss: Optional[float] = None,
             lr: Optional[float] = None, records_per_sec: Optional[float] = None,
             dispatch_s: Optional[float] = None, input_wait_s: Optional[float] = None,
             input_qdepth: Optional[int] = None, **extra) -> Dict:
        """One per-step record from host-side values; ``input_wait_s`` /
        ``input_qdepth`` are the prefetch seam's wait for this step's batch
        and the pipeline's staging depth after the pull."""
        mem = device_memory_stats()
        if mem:
            peak = max(s.get("peak_bytes_in_use", s.get("bytes_in_use", 0))
                       for s in mem.values())
            with self._lock:
                self.hbm_peak_bytes = max(self.hbm_peak_bytes or 0, peak)
        rec = {
            "type": "step", "path": path, "iteration": int(iteration),
            "epoch": None if epoch is None else int(epoch),
            "loss": loss, "lr": lr, "records": int(records),
            "wall_s": round(float(wall_s), 6),
            "records_per_sec": None if records_per_sec is None else round(records_per_sec, 3),
            "dispatch_s": None if dispatch_s is None else round(dispatch_s, 6),
            "input_wait_s": None if input_wait_s is None else round(float(input_wait_s), 6),
            "input_qdepth": None if input_qdepth is None else int(input_qdepth),
            "compile_count": self.compile_count,
            "compile_s": round(self.compile_seconds, 6),
            "spans": self.collector.drain(),
            "memory": mem,
            "hbm_peak_bytes": self.hbm_peak_bytes,
        }
        rec.update(extra)
        self.emit(rec)
        self._heartbeat(rec)
        if self.watchdog is not None:
            self.watchdog.notify_step(wall_s)
        return rec

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

    # ------------------------------------------------------------------ perf
    def perf(self, *, iteration: int, window: int, breakdown: Dict, path: str = "train",
             epoch: Optional[int] = None, **fields) -> None:
        """One performance-accounting record every N steps (obs/perf.py):
        the windowed compute/comms/input/host decomposition and the cost
        join, from host clocks and the once-counted step cost."""
        rec = {"type": "perf", "path": path, "iteration": int(iteration),
               "epoch": None if epoch is None else int(epoch), "window": int(window),
               "breakdown": breakdown}
        rec.update(fields)
        self.emit(rec)

    # ---------------------------------------------------------------- health
    def health(self, *, iteration: int, path: str = "train", epoch: Optional[int] = None,
               **fields) -> None:
        """One model-health record (obs/health.py): per-layer norms and
        counters computed on the device by the step and read in the same
        one-step-late transfer as the loss."""
        rec = {"type": "health", "path": path, "iteration": int(iteration),
               "epoch": None if epoch is None else int(epoch)}
        rec.update(fields)
        self.emit(rec)

    # ------------------------------------------------------------------ warn
    def warn(self, *, reason: str, path: str = "train", iteration: Optional[int] = None,
             **fields) -> None:
        """One advisory ``warn`` record; flushed at once."""
        rec = {"type": "warn", "path": path, "reason": reason,
               "iteration": None if iteration is None else int(iteration)}
        rec.update(fields)
        self.emit(rec)
        self.flush()

    # --------------------------------------------------------------- compile
    def compile_event(self, *, iteration: int, seconds: float, count: int = 1,
                      path: str = "train", cache_hit: Optional[bool] = None) -> None:
        """One ``compile`` record (the kernel library's load, see the module
        docstring); flushed at once."""
        with self._lock:
            self.compile_count += count
            self.compile_seconds += seconds
        self.emit({"type": "compile", "path": path, "iteration": int(iteration),
                   "count": int(count), "seconds": round(seconds, 6),
                   "total_compiles": self.compile_count, "cache_hit": cache_hit})
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
        ``warm_start`` is True when an artifact bundle covered the warmed
        geometries (``utils/aot.py``: a seeded library loads with 0
        builds)."""
        rec = {"type": "warmup", "path": path, "model": model,
               "seconds": round(float(seconds), 6), "compiles": int(compiles),
               "fresh_compiles": None if fresh_compiles is None else int(fresh_compiles),
               "warm_start": bool(warm_start)}
        rec.update(fields)
        self.emit(rec)
        self.flush()

    # ------------------------------------------------------------ resilience
    def retry_event(self, *, attempt: int, fault_class: str, backoff_s: float = 0.0,
                    path: str = "train", error: Optional[str] = None,
                    action: str = "resume", skip_position=None) -> None:
        """A failure the policy retries: its class, the attempt count, the
        backoff, and the data position it skips (if any)."""
        self.emit({"type": "retry", "path": path, "attempt": int(attempt),
                   "fault_class": fault_class, "backoff_s": round(float(backoff_s), 6),
                   "error": error, "action": action, "skip_position": skip_position})
        self.flush()

    def rollback_event(self, *, reason: str, restored_step: Optional[int],
                       iteration: Optional[int] = None, lr_scale: Optional[float] = None,
                       path: str = "train", layer: Optional[str] = None,
                       source: Optional[str] = None, shard: Optional[str] = None) -> None:
        """The divergence guard rolled the run back: why, to which verified
        checkpoint step (None: the step-0 entry snapshot), the LR scale now
        in force, and (with health) the first non-finite layer and source."""
        self.emit({"type": "rollback", "path": path, "reason": reason,
                   "restored_step": None if restored_step is None else int(restored_step),
                   "iteration": None if iteration is None else int(iteration),
                   "lr_scale": None if lr_scale is None else float(lr_scale),
                   "layer": layer, "source": source, "shard": shard})
        self.flush()

    def preempt_event(self, *, signal: int, step: int, path: str = "train",
                      checkpoint_dir: Optional[str] = None) -> None:
        """A preemption signal was handled (the emergency checkpoint, with a
        path configured, is on disk)."""
        self.emit({"type": "preempt_checkpoint", "path": path, "signal": int(signal),
                   "step": int(step), "checkpoint_dir": checkpoint_dir})
        self.flush()

    def fault_injected_event(self, *, seam: str, kind: str, hit: int) -> None:
        """A chaos ``FaultPlan`` fired at an armed seam."""
        self.emit({"type": "fault_injected", "seam": seam, "kind": kind, "hit": int(hit)})
        self.flush()

    # ------------------------------------------------------------- heartbeat
    def _heartbeat(self, rec: Dict) -> None:
        """The fleet heartbeat at the emission seam (``obs/fleet.py``): an
        atomic write of ``<run_dir>/fleet/p<k>.hb`` with the latest step and
        record summary, at most once per ``heartbeat_interval_s``. A write
        failure disables heartbeats for this sink with one warning."""
        if self._hb_disabled or self.heartbeat_interval_s is None:
            return
        now = time.perf_counter()
        if now < self._hb_next:
            return
        from ..utils.engine import Engine

        run_dir = Engine.run_dir()
        if not run_dir:
            return
        self._hb_next = now + self.heartbeat_interval_s
        step = rec.get("iteration")
        if step is None:
            step = self._hb_last_step
        else:
            self._hb_last_step = step
        epoch = rec.get("epoch")
        if epoch is None:
            epoch = self._hb_last_epoch
        else:
            self._hb_last_epoch = epoch
        summary = {"type": rec.get("type")}
        for key in ("loss", "records_per_sec", "path", "model", "queue_depth", "event"):
            if rec.get(key) is not None:
                summary[key] = rec[key]
        try:
            _fleet.write_heartbeat(run_dir, identity=self.identity, step=step, epoch=epoch,
                                   wall_s=rec.get("wall_s"), summary=summary)
        except OSError:
            self._hb_disabled = True
            log.warning("fleet heartbeat write under %s failed; heartbeats disabled for this "
                        "telemetry sink", run_dir, exc_info=True)

    def beat(self, step: Optional[int] = None) -> None:
        """A heartbeat with no record behind it (a rank that waits outside
        an elastic run's membership), throttled as the others."""
        self._heartbeat({"type": "beat", "iteration": step})

    # ----------------------------------------------------------------- stall
    def _on_stall(self, info: Dict) -> None:
        rec = {"type": "stall"}
        rec.update(info)
        self.emit(rec)
        self.flush()  # the run may be wedged: run_ended may never come
        try:
            from . import blackbox as _blackbox

            _blackbox.dump_postmortem("stall_declared", telemetry=self,
                                      extra={"stall": info})
        except Exception:  # the stall is declared; a dump fault must not mask it
            log.debug("stall postmortem failed", exc_info=True)

    # ----------------------------------------------------------- maintenance
    def flush(self) -> None:
        with self._lock:
            for ex in self.exporters:
                try:
                    ex.flush()
                except Exception:
                    log.exception("telemetry exporter flush failed")

    def close(self) -> None:
        if self._endpoint is not None:  # a closed sink's gauges are not scraped
            self._endpoint.detach_telemetry(self)
            self._endpoint = None
        if self.watchdog is not None:
            self.watchdog.stop()
        if not self._hb_disabled and self.heartbeat_interval_s is not None:
            from ..utils.engine import Engine

            run_dir = Engine.run_dir()
            if run_dir:  # the clean-shutdown sentinel
                try:
                    _fleet.write_heartbeat(run_dir, identity=self.identity,
                                           step=self._hb_last_step,
                                           epoch=self._hb_last_epoch, leaving=True)
                except OSError:
                    log.warning("leaving-sentinel heartbeat under %s failed", run_dir,
                                exc_info=True)
        with self._lock:
            for ex in self.exporters:
                try:
                    ex.close()
                except Exception:
                    log.exception("telemetry exporter close failed")
