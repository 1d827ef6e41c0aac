"""Typed faults of the port's training runtime (the checkpoint part so far)."""

from .errors import CheckpointCorrupt

__all__ = ["CheckpointCorrupt"]
