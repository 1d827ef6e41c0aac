"""Typed faults of the port's runtime: the checkpoint part and serving's."""

from .errors import CheckpointCorrupt, CircuitOpen, DeadlineExceeded

__all__ = ["CheckpointCorrupt", "CircuitOpen", "DeadlineExceeded"]
