"""Typed faults of the port's runtime: the checkpoint part and serving's."""

from .errors import ArtifactIncompatible, CheckpointCorrupt, CircuitOpen, DeadlineExceeded

__all__ = ["ArtifactIncompatible", "CheckpointCorrupt", "CircuitOpen", "DeadlineExceeded"]
