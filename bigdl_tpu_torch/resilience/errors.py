"""Typed fault exceptions (counterpart of ``bigdl_tpu/resilience/errors.py``;
``CheckpointCorrupt`` and serving's ``DeadlineExceeded`` and ``CircuitOpen``
so far, the port's own copies with the same fields and messages), and of
``bigdl_tpu/utils/aot.py``'s ``ArtifactIncompatible``, which a fleet
checkpoint that does not fit the model raises."""

from __future__ import annotations

from typing import Optional


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


class DeadlineExceeded(RuntimeError):
    """A serving request outlived its deadline before it could be served.

    Raised on the caller's thread: by ``ServeFuture.result()`` the moment the
    deadline passes, or pre-resolved onto the future by the batcher when it
    sweeps expired requests out of the queue or out of a popped batch.
    ``stage`` names the seam that declared the miss (``"admission"`` /
    ``"queue"`` / ``"flush"`` / ``"result"``)."""

    def __init__(self, model: Optional[str], deadline_ms: float,
                 waited_ms: float, stage: str = "queue"):
        super().__init__(
            f"request deadline {deadline_ms:.1f}ms exceeded after "
            f"{waited_ms:.1f}ms at the {stage} seam"
            + (f" (model {model!r})" if model else ""))
        self.model = model
        self.deadline_ms = deadline_ms
        self.waited_ms = waited_ms
        self.stage = stage


class CircuitOpen(RuntimeError):
    """The model's circuit breaker is open: the request was shed at submit
    time on the caller's thread. ``retry_in_s`` is the time until the next
    half-open probe slot."""

    def __init__(self, model: Optional[str], reason: str,
                 retry_in_s: Optional[float] = None):
        super().__init__(
            f"circuit open for model {model!r} ({reason})"
            + (f"; next probe in {retry_in_s:.3f}s" if retry_in_s is not None else ""))
        self.model = model
        self.reason = reason
        self.retry_in_s = retry_in_s


class ArtifactIncompatible(Exception):
    """An artifact cannot be used by this process: here a fleet checkpoint
    whose codec geometry is not the model's, or whose generation is stale.
    Carries a human-readable ``reason``."""

    def __init__(self, bundle: str, reason: str):
        self.bundle = bundle
        self.reason = reason
        super().__init__(f"artifact bundle {bundle}: {reason}")
