"""The port's resilient-training runtime (counterpart of
``bigdl_tpu/resilience``):

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
* :mod:`.elastic` — :class:`ElasticCoordinator` over the
  :class:`~bigdl_tpu_torch.obs.fleet.FleetMonitor`: a lost host's ranks
  leave the group at a step boundary behind a fleet checkpoint, the
  survivors continue, the host rejoins at an epoch boundary;
  :class:`SimulatedFleet` impersonates hosts as heartbeat writers;
* :mod:`.errors` — the typed faults, with serving's and the checkpoints'.
"""

from .chaos import FLEET_SEAMS, SERVING_SEAMS, FaultPlan, FaultSpec
from .elastic import ElasticConfig, ElasticCoordinator, SimulatedFleet, SimulatedPeer
from .errors import (ArtifactIncompatible, CheckpointCorrupt, CircuitOpen, DeadlineExceeded,
                     DivergenceError, ElasticFleetExhausted, ElasticRemesh, FaultInjected,
                     StallEscalation, TrainingPreempted)
from .policy import FailurePolicy, FaultClass, RetryDecision
from .preemption import PreemptionGuard

__all__ = [
    "FailurePolicy",
    "FaultClass",
    "RetryDecision",
    "FaultPlan",
    "FaultSpec",
    "SERVING_SEAMS",
    "FLEET_SEAMS",
    "ElasticConfig",
    "ElasticCoordinator",
    "SimulatedFleet",
    "SimulatedPeer",
    "ElasticFleetExhausted",
    "ElasticRemesh",
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
