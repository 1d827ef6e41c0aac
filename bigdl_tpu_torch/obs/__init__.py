"""Observability of the port (counterpart of ``bigdl_tpu/obs``): the
telemetry stream serving writes and the monitor chassis its supervisor runs
on, the port's own copies."""

from .telemetry import JsonlExporter, RingBufferExporter, Telemetry, TelemetryExporter
from .watchdog import MonitorBase

__all__ = ["JsonlExporter", "MonitorBase", "RingBufferExporter", "Telemetry",
           "TelemetryExporter"]
