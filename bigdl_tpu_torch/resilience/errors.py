"""Typed fault exceptions (counterpart of ``bigdl_tpu/resilience/errors.py``;
``CheckpointCorrupt`` so far, the port's own copy)."""

from __future__ import annotations


class CheckpointCorrupt(RuntimeError):
    """A checkpoint failed manifest verification (checksum/size mismatch or
    truncated file). ``load_checkpoint`` falls back to an older verified
    checkpoint; this surfaces only for an explicit step."""

    def __init__(self, directory: str, step: int, detail: str):
        super().__init__(
            f"checkpoint step {step} under {directory} failed verification: {detail}")
        self.directory = directory
        self.step = step
        self.detail = detail
