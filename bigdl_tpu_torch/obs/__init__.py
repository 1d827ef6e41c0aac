"""Observability of the port (counterpart of ``bigdl_tpu/obs``; the port's
own copies, the same record types and fields):

* :mod:`.telemetry` — the per-step event stream fanned out through
  exporters (JSONL, ``TrainSummary``, the ring, the flight recorder), with
  no device sync of its own;
* :mod:`.trace` — ``span("name")`` host seams, also ranges of a
  ``torch.profiler`` trace, and the causal trace context;
* :mod:`.watchdog` — :class:`StallWatchdog` and the monitors' chassis;
* :mod:`.health` — :class:`HealthMonitor` (``set_health``): per-layer
  statistics computed on the device, read with the loss;
* :mod:`.profiler` — the one-shot memory breakdown and step cost;
* :mod:`.perf` — MFU accounting (:class:`PerfAccountant`), the step-time
  decomposition and the :class:`PerfMonitor`;
* :mod:`.fleet` — process identity, heartbeat files and the
  :class:`FleetMonitor` (stragglers, lost and departed hosts);
* :mod:`.blackbox` — the flight recorder and postmortem bundles;
* :mod:`.export` — the scrape endpoint (:class:`ObsEndpoint`: ``/healthz``,
  ``/metrics``, ``/telemetry/tail``, ``/trace``) over the rings.
"""

from .blackbox import (BundleTampered, BundleTruncated, FlightRecorder, PostmortemBundleError,
                       arm_crash_handler, disarm_crash_handler, dump_postmortem, load_bundle,
                       verify_bundle)
from .export import ObsEndpoint
from .fleet import FleetMonitor, process_identity, read_heartbeats, write_heartbeat
from .health import ActivationDrift, DriftConfig, HealthConfig, HealthMonitor
from .perf import PerfAccountant, PerfConfig, PerfMonitor
from .profiler import cost_summary, memory_breakdown, profile_optimizer
from .telemetry import (JsonlExporter, Metrics, RingBufferExporter, SummaryExporter, Telemetry,
                        TelemetryExporter, device_memory_stats)
from .trace import span, step_annotation
from .watchdog import MonitorBase, StallWatchdog

__all__ = [
    "Telemetry",
    "TelemetryExporter",
    "JsonlExporter",
    "RingBufferExporter",
    "SummaryExporter",
    "device_memory_stats",
    "Metrics",
    "span",
    "step_annotation",
    "MonitorBase",
    "StallWatchdog",
    "ObsEndpoint",
    "FleetMonitor",
    "process_identity",
    "read_heartbeats",
    "write_heartbeat",
    "HealthConfig",
    "HealthMonitor",
    "ActivationDrift",
    "DriftConfig",
    "PerfAccountant",
    "PerfConfig",
    "PerfMonitor",
    "memory_breakdown",
    "cost_summary",
    "profile_optimizer",
    "FlightRecorder",
    "PostmortemBundleError",
    "BundleTruncated",
    "BundleTampered",
    "arm_crash_handler",
    "disarm_crash_handler",
    "dump_postmortem",
    "verify_bundle",
    "load_bundle",
]
