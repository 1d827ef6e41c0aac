"""Performance observability: MFU accounting, the step-time decomposition
and anomaly-triggered profiler capture (counterpart of
``bigdl_tpu/obs/perf.py``; the port's own copy, the same records).

* **Cost model.** The JAX package reads a step's FLOPs from XLA's cost
  analysis of the compiled program. The port has no compiled program, and
  ``torch.utils.flop_counter.FlopCounterMode`` sees ATen operations only:
  the port's kernels are ``ctypes`` launches inside ``autograd.Function`` s,
  which it would count as nothing. So :func:`program_cost` counts one
  training step (forward, loss, backward) once, on the meta device, with
  the parameters as meta tensors: ``FlopCounterMode`` counts the ATen
  products, and every kernel wrapper on the step's path reports its own
  analytic FLOPs through :func:`kernel_flops` instead of running (the meta
  step takes the routes the card would take, :func:`cost_routes_like`).
  Convention: model FLOPs, 2 per multiply-add; a backward counts its two
  products and no recompute; causal attention counts only the visible
  (query, key) pairs, ``4 d`` a pair forward and ``8 d`` backward. Nothing
  runs on the card and nothing is read from it.
* **Accounting.** :class:`PerfAccountant` joins that cost with each step's
  wall at the one-step-late flush: every ``step`` record gains
  ``model_flops`` / ``achieved_flops_s`` / ``mfu`` (None where the card
  has no row in :data:`DEVICE_PEAKS`, and on the CPU), and every
  ``every_n_steps`` steps a ``perf`` record carries the windowed
  compute / comms / input / host decomposition.
* **Monitoring.** :class:`PerfMonitor` (on the ``MonitorBase`` chassis,
  driven directly) freezes a baseline of step walls and MFU and raises one
  ``warn reason=perf_regression`` a breach episode, naming the component
  that grew, and one bounded ``torch.profiler`` capture into
  ``<run_dir>/profile/``.
* **Capture seam.** :func:`start_capture` / :func:`stop_capture` own the
  one ``torch.profiler`` session of the process, so a ``set_profile``
  window and a breach capture never interleave; a trace is written as
  ``trace.json`` (Chrome format) into its directory, every thread's ranges
  included where the installed PyTorch offers it.
"""

from __future__ import annotations

import collections
import contextlib
import logging
import os
import statistics
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

from .watchdog import MonitorBase

log = logging.getLogger("bigdl_tpu_torch.obs")

__all__ = [
    "PerfConfig",
    "PerfAccountant",
    "PerfMonitor",
    "StepCost",
    "DevicePeaks",
    "DEVICE_PEAKS",
    "device_peaks",
    "pipeline_bubble_fraction",
    "program_cost",
    "predictor_bucket_costs",
    "kernel_flops",
    "cost_routes_like",
    "achieved_flops_s",
    "mfu",
    "classify_roofline",
    "start_capture",
    "stop_capture",
    "capture_active",
]

COMPONENTS = ("compute_s", "comms_s", "input_s", "host_s")


# --------------------------------------------------------------------------
# peaks
# --------------------------------------------------------------------------

class DevicePeaks:
    """One card's peak rates: dense bf16 FLOP/s, memory bytes/s and the
    interconnect's bytes/s (None where not stated)."""

    def __init__(self, kind: str, flops: Optional[float], hbm_bytes_s: Optional[float],
                 ici_bytes_s: Optional[float] = None):
        self.kind = kind
        self.flops = flops
        self.hbm_bytes_s = hbm_bytes_s
        self.ici_bytes_s = ici_bytes_s

    def __repr__(self):
        return (f"DevicePeaks({self.kind!r}, flops={self.flops!r}, "
                f"hbm={self.hbm_bytes_s!r}, ici={self.ici_bytes_s!r})")


# The cards the port was measured on, by torch.cuda.get_device_name: dense
# bf16 TFLOP/s and memory GB/s from NVIDIA's H100 SXM data sheet, which
# assume the card's full 700 W power limit. The H100 the port is measured on
# reports "NVIDIA H100 80GB HBM3, 700.00 W" (nvidia-smi
# --query-gpu=name,power.limit). Any other card, and the CPU, has no row:
# mfu is None there.
DEVICE_PEAKS = {
    "NVIDIA H100 80GB HBM3": (989.0, 3350.0),
}


def device_peaks(device_kind: Optional[str] = None) -> Optional[DevicePeaks]:
    """The :class:`DevicePeaks` of ``device_kind`` (default: CUDA device 0's
    name), or None for a card without a row and for the CPU."""
    if device_kind is None:
        import torch

        if not torch.cuda.is_available():
            return None
        device_kind = torch.cuda.get_device_name(0)
    row = DEVICE_PEAKS.get(str(device_kind))
    if row is None:
        return None
    return DevicePeaks(str(device_kind), flops=row[0] * 1e12, hbm_bytes_s=row[1] * 1e9)


# --------------------------------------------------------------------------
# the capture seam
# --------------------------------------------------------------------------

_capture_lock = threading.Lock()
_capture: Dict[str, object] = {"dir": None, "prof": None}


def _profiler_config():
    """Record every thread's ranges (the prefetch thread's seams) where the
    installed PyTorch has the option."""
    try:
        from torch._C._profiler import _ExperimentalConfig

        return _ExperimentalConfig(profile_all_threads=True)
    except (ImportError, TypeError):
        return None


def start_capture(trace_dir: str) -> bool:
    """Start the process's one ``torch.profiler`` capture into
    ``trace_dir``; False when one is running or the profiler refuses (a
    capture is advisory: the run goes on)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with _capture_lock:
        if _capture["dir"] is not None:
            return False
        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        try:
            cfg = _profiler_config()
            prof = (profile(activities=activities, experimental_config=cfg)
                    if cfg is not None else profile(activities=activities))
            prof.start()
        except Exception as e:
            log.warning("profiler capture into %s failed to start: %s", trace_dir, e)
            return False
        _capture.update(dir=trace_dir, prof=prof)
        return True


def stop_capture() -> Optional[str]:
    """Stop the running capture and write ``<dir>/trace.json``; returns the
    directory, or None when none was running."""
    with _capture_lock:
        d, prof = _capture["dir"], _capture["prof"]
        _capture.update(dir=None, prof=None)
        if d is None:
            return None
        try:
            prof.stop()
            os.makedirs(d, exist_ok=True)
            prof.export_chrome_trace(os.path.join(d, "trace.json"))
        except Exception as e:
            log.warning("profiler capture stop into %s raised: %s", d, e)
        return d


def capture_active() -> bool:
    with _capture_lock:
        return _capture["dir"] is not None


# --------------------------------------------------------------------------
# the cost model
# --------------------------------------------------------------------------

@dataclass
class StepCost:
    """One step's counted cost (host metadata). ``flops`` from
    :func:`program_cost`; the byte fields stay None (no cost analysis)."""

    flops: Optional[float] = None
    bytes_accessed: Optional[float] = None
    arithmetic_intensity: Optional[float] = None
    collective_bytes: Optional[int] = None
    grad_exchange_bytes: Optional[int] = None
    all_to_all_bytes: Optional[int] = None
    ppermute_bytes: Optional[int] = None

    def fields(self) -> Dict:
        return {"model_flops": self.flops, "hbm_bytes_accessed": self.bytes_accessed,
                "arithmetic_intensity": self.arithmetic_intensity,
                "collective_bytes": self.collective_bytes}


_cost_tls = threading.local()


def kernel_flops(flops: float) -> None:
    """Called by a kernel wrapper's meta stand-in inside a
    :func:`program_cost` count: adds its analytic ``flops`` to the count."""
    _cost_tls.box[0] += float(flops)


def cost_routes_like() -> Optional[str]:
    """The device type whose routes a running :func:`program_cost` count
    takes on meta tensors (None when no count runs)."""
    return getattr(_cost_tls, "routes", None)


@contextlib.contextmanager
def _counting(routes: str):
    from torch.utils.flop_counter import FlopCounterMode

    box = [0.0]
    _cost_tls.box, _cost_tls.routes = box, routes
    counter = FlopCounterMode(display=False)
    try:
        with counter:
            yield box, counter
    finally:
        _cost_tls.box = _cost_tls.routes = None


def program_cost(optimizer, x, t, routes: Optional[str] = None) -> Optional[StepCost]:
    """The FLOPs of one training step of ``optimizer`` on a batch shaped as
    ``x`` / ``t`` (tensors or specs), counted on the meta device as the
    module docstring says; ``routes`` is the device type whose routes the
    step takes (default: the model's). None when the step cannot run on
    meta tensors."""
    import torch

    from ..analysis.shape_prop import to_spec
    from ..nn.module import _map_tree, _meta_like, import_torch_dynamo

    model = optimizer.model
    routes = routes or model.device.type
    import_torch_dynamo()
    try:
        params = _map_tree(lambda p: _meta_like(p).requires_grad_(p.is_floating_point()),
                           model.get_parameters())
        state = _map_tree(_meta_like, model.get_state())
        xs, ts = to_spec(x), to_spec(t)
        with _counting(routes) as (box, counter):
            loss, _ = optimizer._loss(state, xs, ts, torch.Generator(), None, params=params)
            leaves = [p for p in _flat_leaves(params) if p.requires_grad]
            torch.autograd.grad(loss, leaves, allow_unused=True)
        flops = float(counter.get_total_flops()) + box[0]
    except Exception as e:  # an exotic step: accounting degrades, the run goes on
        log.warning("perf cost model: the meta step failed (%s); MFU accounting is off", e)
        return None
    return StepCost(flops=flops or None)


def predictor_bucket_costs(predictor, sample, shape_buckets=None) -> Dict:
    """Per-bucket forward cost of a :class:`~bigdl_tpu_torch.optim.Predictor`
    batch: ``{bucket: {"flops", "flops_per_record", "peak_flops_total"}}``
    (``bucket`` None for the fixed shape), the eval forward counted on the
    meta device as :func:`program_cost` counts a step; {} when the model
    cannot be counted. ``sample`` is one record."""
    import numpy as np
    import torch

    from ..nn.module import _map_tree, _meta_like, import_torch_dynamo

    model, bs = predictor.model, int(predictor.batch_size)
    sample = np.asarray(sample)
    peaks = device_peaks()
    peak_total = peaks.flops if peaks is not None and peaks.flops else None
    shapes = ({int(b): (bs, int(b)) + tuple(sample.shape[1:]) for b in shape_buckets}
              if shape_buckets else {None: (bs,) + tuple(sample.shape)})
    dtype = torch.from_numpy(np.zeros(1, sample.dtype)).dtype
    import_torch_dynamo()
    params = _map_tree(_meta_like, model.get_parameters())
    state = _map_tree(_meta_like, model.get_state())
    out: Dict = {}
    for key, shp in shapes.items():
        try:
            with _counting(model.device.type) as (box, counter), torch.no_grad():
                model._apply_params(params, state, torch.empty(shp, dtype=dtype, device="meta"),
                                    False, None)
        except Exception as e:
            log.warning("bucket cost of %s: the meta forward failed (%s)", key, e)
            continue
        flops = float(counter.get_total_flops()) + box[0]
        if flops:
            out[key] = {"flops": flops, "flops_per_record": flops / bs,
                        "peak_flops_total": peak_total}
    return out


def _flat_leaves(tree):
    from ..utils.serialization import tree_items

    return list(tree_items(tree).values())


def pipeline_bubble_fraction(n_stages: int, n_micro: int) -> float:
    """The GPipe schedule's idle fraction (S - 1) / (n_micro + S - 1)."""
    if n_stages < 1 or n_micro < 1:
        raise ValueError(f"need n_stages >= 1 and n_micro >= 1, got {n_stages}/{n_micro}")
    return (n_stages - 1) / (n_micro + n_stages - 1)


def achieved_flops_s(flops: Optional[float], wall_s: Optional[float]) -> Optional[float]:
    if not flops or not wall_s or wall_s <= 0:
        return None
    return flops / wall_s


def mfu(flops: Optional[float], wall_s: Optional[float], peak_flops: Optional[float],
        n_devices: int = 1) -> Optional[float]:
    """Achieved model FLOP/s over the peak of the participating cards; None
    wherever a term is unknown."""
    ach = achieved_flops_s(flops, wall_s)
    if ach is None or not peak_flops or n_devices < 1:
        return None
    return round(ach / (peak_flops * n_devices), 6)


def classify_roofline(arithmetic_intensity: Optional[float], peak_flops: Optional[float],
                      hbm_bytes_s: Optional[float]) -> Optional[str]:
    """``"compute"`` above the ridge point, else ``"bandwidth"``; None when a
    term is unknown."""
    if not arithmetic_intensity or not peak_flops or not hbm_bytes_s:
        return None
    return "compute" if arithmetic_intensity >= peak_flops / hbm_bytes_s else "bandwidth"


# --------------------------------------------------------------------------
# configuration
# --------------------------------------------------------------------------

@dataclass
class PerfConfig:
    """Knobs of the perf surface (the JAX package's).

    Args:
        every_n_steps: the ``perf`` record stride.
        cost: count the step cost (one meta step per run; ``False`` keeps
            the decomposition and the monitor without FLOPs/MFU). Also off
            with ``BIGDL_PERF_COST=0``.
        peak_flops: the card's peak override (FLOP/s); None reads
            :data:`DEVICE_PEAKS`.
        monitor: run the :class:`PerfMonitor`.
        slowdown_factor: the step-time breach bound over the baseline.
        mfu_collapse: the MFU breach bound under the baseline.
        window: the recent-median window (steps).
        baseline_steps: the steps frozen into the baseline.
        skip_steps: the leading steps left out of it.
        capture: a breach captures one bounded profiler window into
            ``<run_dir>/profile/perf_<iter>/`` (needs a run directory).
        capture_steps: that window's length in steps.
    """

    every_n_steps: int = 8
    cost: bool = True
    peak_flops: Optional[float] = None
    monitor: bool = True
    slowdown_factor: float = 1.75
    mfu_collapse: float = 0.5
    window: int = 8
    baseline_steps: int = 16
    skip_steps: int = 1
    capture: bool = True
    capture_steps: int = 4

    def __post_init__(self):
        if self.every_n_steps < 1:
            raise ValueError(f"every_n_steps must be >= 1, got {self.every_n_steps}")
        if self.slowdown_factor <= 1.0:
            raise ValueError(f"slowdown_factor must be > 1, got {self.slowdown_factor}")
        if not 0.0 < self.mfu_collapse < 1.0:
            raise ValueError(f"mfu_collapse must be in (0,1), got {self.mfu_collapse}")
        if self.window < 2 or self.baseline_steps < 2:
            raise ValueError("window and baseline_steps must be >= 2")
        if self.capture_steps < 1:
            raise ValueError(f"capture_steps must be >= 1, got {self.capture_steps}")


# --------------------------------------------------------------------------
# the monitor
# --------------------------------------------------------------------------

class PerfMonitor(MonitorBase):
    """Flags a run whose steps still complete, but slower: after
    ``skip_steps``, ``baseline_steps`` walls (and MFU samples) freeze into
    a baseline; the rolling median of the last ``window`` steps above
    ``slowdown_factor x`` it (or the MFU median under ``mfu_collapse x``
    its baseline) raises one event an episode, re-armed on recovery, naming
    the decomposition term that grew most. Detection is a pure function of
    the recorded samples: drive :meth:`note_step` directly."""

    def __init__(self, config: Optional[PerfConfig] = None, clock=time.monotonic,
                 poll_interval_s: float = 5.0):
        super().__init__(poll_interval_s)
        self.config = config or PerfConfig()
        self._clock = clock
        self._lock = threading.Lock()
        self.event_count = 0
        self.reset_run()

    def reset_run(self) -> None:
        """A new run: the baseline and the windows start empty."""
        cfg = self.config
        with self._lock:
            self._seen = 0
            self._baseline_walls: List[float] = []
            self._baseline_mfus: List[float] = []
            self._baseline_comp: List[Dict] = []
            self._recent_walls: collections.deque = collections.deque(maxlen=cfg.window)
            self._recent_mfus: collections.deque = collections.deque(maxlen=cfg.window)
            self._recent_comp: collections.deque = collections.deque(maxlen=cfg.window)
            self._breached = False

    def note_step(self, *, iteration: int, wall_s: float, mfu_value: Optional[float] = None,
                  breakdown: Optional[Dict] = None) -> List[Dict]:
        """Record one step; returns the breach events it raised (at most
        one)."""
        cfg = self.config
        with self._lock:
            self._seen += 1
            if self._seen <= cfg.skip_steps:
                return []
            if len(self._baseline_walls) < cfg.baseline_steps:
                self._baseline_walls.append(float(wall_s))
                if mfu_value is not None:
                    self._baseline_mfus.append(float(mfu_value))
                if breakdown:
                    self._baseline_comp.append(dict(breakdown))
                return []
            self._recent_walls.append(float(wall_s))
            if mfu_value is not None:
                self._recent_mfus.append(float(mfu_value))
            if breakdown:
                self._recent_comp.append(dict(breakdown))
            if len(self._recent_walls) < cfg.window:
                return []
            return self._evaluate(iteration)

    def baseline_wall_s(self) -> Optional[float]:
        with self._lock:
            if len(self._baseline_walls) < self.config.baseline_steps:
                return None
            return statistics.median(self._baseline_walls)

    def _breach_condition(self):
        cfg = self.config
        base = statistics.median(self._baseline_walls)
        recent = statistics.median(self._recent_walls)
        if base > 0 and recent > cfg.slowdown_factor * base:
            return "step_time", {"recent_wall_s": round(recent, 6),
                                 "baseline_wall_s": round(base, 6),
                                 "factor": round(recent / base, 3)}
        if len(self._baseline_mfus) >= 2 and len(self._recent_mfus) >= max(2, cfg.window // 2):
            bm = statistics.median(self._baseline_mfus)
            rm = statistics.median(self._recent_mfus)
            if bm > 0 and rm < cfg.mfu_collapse * bm:
                return "mfu_collapse", {"recent_mfu": round(rm, 6),
                                        "baseline_mfu": round(bm, 6),
                                        "collapse": round(rm / bm, 4)}
        return None, {}

    def _evaluate(self, iteration: int) -> List[Dict]:
        trigger, detail = self._breach_condition()
        if trigger is None:
            self._breached = False
            return []
        if self._breached:
            return []
        self._breached = True
        self.event_count += 1
        event = {"reason": "perf_regression", "trigger": trigger, "iteration": int(iteration),
                 "component": self._degraded_component()}
        event.update(detail)
        return [event]

    def _degraded_component(self) -> Optional[str]:
        if not self._baseline_comp or not self._recent_comp:
            return None

        def means(rows: List[Dict]) -> Dict[str, float]:
            return {key: sum(r.get(key) or 0.0 for r in rows) / len(rows)
                    for key in COMPONENTS}

        base = means(list(self._baseline_comp))
        recent = means(list(self._recent_comp))
        worst, worst_delta = None, 0.0
        for key in COMPONENTS:
            delta = recent[key] - base[key]
            if delta > worst_delta:
                worst, worst_delta = key, delta
        return worst[: -len("_s")] if worst else None

    def check(self) -> List[Dict]:
        """The poll hook: a read-only probe of the breach condition (the
        episode latch belongs to :meth:`note_step`)."""
        with self._lock:
            if (len(self._baseline_walls) < self.config.baseline_steps
                    or len(self._recent_walls) < self.config.window):
                return []
            trigger, detail = self._breach_condition()
            if trigger is None:
                return []
            event = {"reason": "perf_regression", "trigger": trigger,
                     "iteration": int(self._seen), "component": self._degraded_component()}
            event.update(detail)
            return [event]


# --------------------------------------------------------------------------
# the accountant
# --------------------------------------------------------------------------

class PerfAccountant:
    """The perf surface of one optimizer, driven from the one-step-late
    flush (no device sync; with no telemetry attached nothing here runs):
    :meth:`ensure_cost` counts the step once a run, :meth:`step_fields`
    stamps each ``step`` record, :meth:`note_step` feeds the window and the
    monitor and manages the breach capture, :meth:`perf_fields` drains a
    ``perf`` record."""

    def __init__(self, config: Optional[PerfConfig] = None):
        self.config = config or PerfConfig()
        self.monitor = PerfMonitor(self.config) if self.config.monitor else None
        self.cost: Optional[StepCost] = None
        self._cost_key = None
        self.pipe_bubble_frac: Optional[float] = None
        self.collectives: Optional[Dict[str, int]] = None  # the last step's wire bytes
        self._n_devices = 1
        self._peaks: Optional[DevicePeaks] = None
        self._window_rows: List[Dict] = []
        self._steps = 0
        self.captures = 0
        self._capture_left = 0

    def begin_run(self, n_devices: int = 1) -> None:
        """A new run: peaks resolved again, the window and monitor reset
        (the counted cost stays with its key)."""
        self._n_devices = max(1, int(n_devices))
        self._peaks = device_peaks()
        self._window_rows = []
        self._steps = 0
        if self.monitor is not None:
            self.monitor.reset_run()

    def end_run(self) -> None:
        """A breach capture still open is stopped (its trace written)."""
        if self._capture_left > 0:
            self._capture_left = 0
            stop_capture()

    def peak_flops(self) -> Optional[float]:
        if self.config.peak_flops is not None:
            return self.config.peak_flops
        return self._peaks.flops if self._peaks is not None else None

    def ensure_cost(self, key, count) -> None:
        """Count the step cost once for ``key`` (the model and the batch's
        shapes): ``count()`` returns a :class:`StepCost` or None."""
        if not self.config.cost or os.environ.get("BIGDL_PERF_COST") == "0":
            return
        if key == self._cost_key:
            return
        self._cost_key = key
        self.cost = count()

    def note_pipeline_schedule(self, n_stages: int, n_micro: int) -> None:
        self.pipe_bubble_frac = round(pipeline_bubble_fraction(n_stages, n_micro), 6)

    def note_collectives(self, fields: Dict[str, int]) -> None:
        """The step's collective bytes (``collective_bytes``,
        ``all_to_all_bytes``, ``ppermute_bytes``), counted on the host by
        ``parallel._comm`` where the JAX package reads them from the
        lowered program."""
        self.collectives = dict(fields)

    def _collective_bytes(self) -> Optional[int]:
        if self.collectives is not None:
            return self.collectives.get("collective_bytes")
        return self.cost.collective_bytes if self.cost is not None else None

    def step_fields(self, wall_s: Optional[float]) -> Dict:
        """``model_flops`` / ``achieved_flops_s`` / ``mfu`` of one step
        record (empty before the cost is known)."""
        c = self.cost
        if c is None or not c.flops:
            if self.pipe_bubble_frac is not None:
                return {"pipe_bubble_frac": self.pipe_bubble_frac}
            return {}
        ach = achieved_flops_s(c.flops, wall_s)
        out = {"model_flops": c.flops,
               "achieved_flops_s": None if ach is None else round(ach, 3),
               "mfu": mfu(c.flops, wall_s, self.peak_flops(), self._n_devices)}
        if self.pipe_bubble_frac is not None:
            out["pipe_bubble_frac"] = self.pipe_bubble_frac
        return out

    def _breakdown(self, rec: Dict) -> Dict:
        """compute/comms/input/host from the record's host clocks: input the
        prefetch wait, host the dispatch span, compute the rest of the wall
        (comms: no estimate without collective bytes)."""
        wall = rec.get("wall_s") or 0.0
        input_s = rec.get("input_wait_s") or 0.0
        spans = rec.get("spans") or {}
        d = spans.get("dispatch")
        host_s = float(d["s"]) if d else (rec.get("dispatch_s") or 0.0)
        comms_s = None
        wire = self._collective_bytes()
        if (wire and self._n_devices > 1 and self._peaks is not None
                and self._peaks.ici_bytes_s):  # None: the table has no link figure
            comms_s = wire / self._peaks.ici_bytes_s
        compute_s = max(wall - input_s - host_s - (comms_s or 0.0), 0.0)
        return {"compute_s": round(compute_s, 6),
                "comms_s": None if comms_s is None else round(comms_s, 6),
                "input_s": round(input_s, 6), "host_s": round(host_s, 6)}

    def note_step(self, rec: Dict) -> List[Dict]:
        """Fold one emitted ``step`` record into the window and the
        monitor; returns the ``warn`` payloads to emit."""
        self._steps += 1
        breakdown = self._breakdown(rec)
        self._window_rows.append({"wall_s": rec.get("wall_s") or 0.0, "mfu": rec.get("mfu"),
                                  "breakdown": breakdown})
        if self._capture_left > 0:
            self._capture_left -= 1
            if self._capture_left == 0:
                stop_capture()
        events: List[Dict] = []
        if self.monitor is not None:
            events = self.monitor.note_step(iteration=rec.get("iteration") or self._steps,
                                            wall_s=rec.get("wall_s") or 0.0,
                                            mfu_value=rec.get("mfu"), breakdown=breakdown)
            for ev in events:
                ev["capture_dir"] = self._maybe_capture(ev)
        return events

    def _maybe_capture(self, event: Dict) -> Optional[str]:
        if not self.config.capture or self._capture_left > 0:
            return None
        from ..utils.engine import Engine

        base = Engine.run_subdir("profile")
        if base is None:
            return None
        trace_dir = os.path.join(base, f"perf_{int(event.get('iteration') or 0):06d}")
        if not start_capture(trace_dir):
            return None
        log.warning("perf regression (%s, component=%s) at iteration %s: capturing %d-step "
                    "profiler trace into %s", event.get("trigger"), event.get("component"),
                    event.get("iteration"), self.config.capture_steps, trace_dir)
        self.captures += 1
        self._capture_left = self.config.capture_steps
        return trace_dir

    def should_emit(self) -> bool:
        return self._steps > 0 and self._steps % self.config.every_n_steps == 0

    def perf_fields(self) -> Dict:
        """Drain the window into one ``perf`` record's fields."""
        rows, self._window_rows = self._window_rows, []
        n = len(rows)
        wall_mean = sum(r["wall_s"] for r in rows) / n if n else 0.0
        breakdown = {}
        for key in COMPONENTS:
            known = [r["breakdown"].get(key) for r in rows
                     if r["breakdown"].get(key) is not None]
            breakdown[key] = round(sum(known) / len(known), 6) if known else None
        c = self.cost
        peak = self.peak_flops()
        hbm = self._peaks.hbm_bytes_s if self._peaks is not None else None
        ach = achieved_flops_s(c.flops if c else None, wall_mean)
        out = {
            "window": n,
            "wall_mean_s": round(wall_mean, 6),
            "breakdown": breakdown,
            "model_flops": c.flops if c else None,
            "achieved_flops_s": None if ach is None else round(ach, 3),
            "mfu": mfu(c.flops if c else None, wall_mean, peak, self._n_devices),
            "arithmetic_intensity": c.arithmetic_intensity if c else None,
            "bound": classify_roofline(c.arithmetic_intensity if c else None, peak, hbm),
            "collective_bytes": self._collective_bytes(),
            "hbm_bytes_accessed": c.bytes_accessed if c else None,
        }
        for key in ("all_to_all_bytes", "ppermute_bytes"):
            if self.collectives and self.collectives.get(key):
                out[key] = self.collectives[key]
        if self.pipe_bubble_frac is not None:
            out["pipe_bubble_frac"] = self.pipe_bubble_frac
        return out
