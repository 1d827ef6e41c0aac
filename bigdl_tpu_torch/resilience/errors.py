"""Typed fault exceptions (counterpart of ``bigdl_tpu/resilience/errors.py``,
the port's own copies with the same fields and messages, the elastic
fleet's ``ElasticRemesh`` and ``ElasticFleetExhausted`` among them), and of
``bigdl_tpu/utils/aot.py``'s
``ArtifactIncompatible``, which a fleet checkpoint that does not fit the
model raises.

Each carries what the :class:`~bigdl_tpu_torch.resilience.policy.FailurePolicy`
needs to classify it (data position, iteration, signal): the policy
classifies by ``isinstance``, never by the message.
"""

from __future__ import annotations

from typing import Optional, Tuple


class DivergenceError(RuntimeError):
    """The divergence guard pulled a NaN/Inf loss (one step late, the value
    the driver reads anyway). The parameters are taken as poisoned from the
    step that produced it: recovery rolls back to the newest *finite*
    verified checkpoint. With a :class:`~bigdl_tpu_torch.obs.HealthMonitor`
    attached, ``layer`` names the first parameter path whose non-finite
    counter fired on that step and ``source`` whether the gradients or the
    updated weights poisoned it (``"loss"`` when every counter was clean)."""

    def __init__(self, loss: float, iteration: int,
                 position: Optional[Tuple[int, int]] = None,
                 layer: Optional[str] = None, source: Optional[str] = None,
                 shard: Optional[str] = None):
        super().__init__(
            f"non-finite loss {loss!r} at iteration {iteration}"
            + (f" (data position epoch={position[0]}, batch={position[1]})"
               if position else "")
            + (f"; first non-finite layer {layer!r} poisoned via {source}"
               if layer else (f"; poisoned via {source}" if source else "")))
        self.loss = loss
        self.iteration = iteration
        self.position = position  # (epoch, iter_in_epoch) of the diverged step
        self.layer = layer
        self.source = source      # "grads" | "weights" | "loss" | None
        self.shard = shard        # the mesh optimizers' data shard (None elsewhere)


class StallEscalation(RuntimeError):
    """Raised by the driver loop after the stall watchdog's callback asked
    the policy to escalate (the watchdog itself never ends a run)."""

    def __init__(self, info: Optional[dict] = None):
        super().__init__(f"stall watchdog escalated: {info or {}}")
        self.info = dict(info or {})


class TrainingPreempted(Exception):
    """A preemption signal was handled: the emergency checkpoint (with a
    checkpoint path configured) is on disk when this leaves ``optimize()``.
    ``exit_code`` is 0: the run ended on purpose, and a driver that exits
    with it lets the scheduler resume the run."""

    exit_code = 0

    def __init__(self, signum: int, step: Optional[int] = None,
                 checkpoint_dir: Optional[str] = None):
        super().__init__(
            f"training preempted by signal {signum}"
            + (f"; emergency checkpoint at step {step} under {checkpoint_dir}"
               if checkpoint_dir else " (no checkpoint path configured)"))
        self.signum = signum
        self.step = step
        self.checkpoint_dir = checkpoint_dir


class ElasticRemesh(Exception):
    """The elastic runtime's internal signal, raised at a step or epoch
    boundary after the coordinated fleet checkpoint is written and consumed
    inside ``Optimizer.optimize()`` (it never escapes it): the survivors
    re-form their group and re-cut the flat master (``kind="shrink"``), or
    the returned ranks join again (``kind="rejoin"``), restore from that
    checkpoint and re-enter the step loop."""

    def __init__(self, kind: str, members, step: Optional[int] = None):
        if kind not in ("shrink", "rejoin"):
            raise ValueError(f"unknown remesh kind {kind!r}")
        members = sorted(int(k) for k in members)
        super().__init__(f"elastic remesh ({kind}): processes {members} at step {step}")
        self.kind = kind
        self.members = members
        self.step = step


class ElasticFleetExhausted(RuntimeError):
    """The survivors fell below ``ElasticConfig.min_processes``: raised out
    of ``optimize()`` after the coordinated emergency checkpoint is
    written, so the run resumes once the hosts return."""

    def __init__(self, active, lost, min_processes: int):
        active = sorted(int(k) for k in active)
        lost = sorted(int(k) for k in lost)
        super().__init__(
            f"elastic fleet exhausted: losing processes {lost} leaves {len(active)} "
            f"survivor(s) {active}, below min_processes={min_processes}; emergency "
            "checkpoint written, run is resumable")
        self.active = active
        self.lost = lost
        self.min_processes = int(min_processes)


class FaultInjected(RuntimeError):
    """What a :class:`~bigdl_tpu_torch.resilience.chaos.FaultPlan` raises at
    an armed seam: its own type, so a test can tell the injected fault from
    any other."""

    def __init__(self, seam: str, hit: int, kind: str = "raise"):
        super().__init__(f"chaos: injected {kind} at seam {seam!r} (hit {hit})")
        self.seam = seam
        self.hit = hit
        self.kind = kind


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
