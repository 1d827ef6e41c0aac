"""The port's resilient-training runtime (counterpart of
``bigdl_tpu/resilience``; the elastic fleet comes later, ROADMAP Queue 1
item 9):

* :mod:`.policy` — :class:`FailurePolicy`: fault classification (transient
  / poison_batch / divergence / stall), per-class budgets, seeded backoff,
  the skip of a batch that fails twice at the same data position;
* the divergence guard on the one-step-late loss, with rollback to the
  newest finite verified checkpoint and an LR back-off or skip window;
* :mod:`.preemption` — :class:`PreemptionGuard`: SIGTERM -> emergency
  checkpoint -> ``TrainingPreempted`` (exit code 0), resumed by
  ``Optimizer.resume()``;
* :mod:`.chaos` — :class:`FaultPlan`: deterministic fault injection at the
  span seams;
* :mod:`.errors` — the typed faults, with serving's and the checkpoints'.
"""

from .chaos import SERVING_SEAMS, FaultPlan, FaultSpec
from .errors import (ArtifactIncompatible, CheckpointCorrupt, CircuitOpen, DeadlineExceeded,
                     DivergenceError, FaultInjected, StallEscalation, TrainingPreempted)
from .policy import FailurePolicy, FaultClass, RetryDecision
from .preemption import PreemptionGuard

__all__ = [
    "FailurePolicy",
    "FaultClass",
    "RetryDecision",
    "FaultPlan",
    "FaultSpec",
    "SERVING_SEAMS",
    "PreemptionGuard",
    "ArtifactIncompatible",
    "CircuitOpen",
    "DeadlineExceeded",
    "DivergenceError",
    "StallEscalation",
    "TrainingPreempted",
    "FaultInjected",
    "CheckpointCorrupt",
]
