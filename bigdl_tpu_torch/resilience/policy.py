"""FailurePolicy: classify training faults and decide retry, backoff and
skip (counterpart of ``bigdl_tpu/resilience/policy.py``; the port's own
copy, the same decisions and the same seeded backoff floats).

In place of the reference's Spark task retry (``bigdl.failure.retryTimes``),
``Optimizer.optimize()`` runs every failure through the policy. Four fault
classes, each with its own retry budget:

* ``transient``  — I/O hiccups, injected chaos, anything seen for the first
  time at a data position: resume from the last verified checkpoint and
  replay (the deterministic (seed, epoch) shuffle makes replay exact).
* ``poison_batch`` — the SAME data position failed twice: retrying would loop
  forever on the record, so the position enters ``skip_positions`` and the
  driver loop deterministically skips it after the next resume.
* ``divergence`` — the divergence guard pulled a NaN/Inf loss: roll back to
  the last *finite* verified checkpoint and either shrink the LR
  (``lr_backoff ** n_divergences``) or skip a window of batches at the blast
  site (``divergence_action='skip_window'``).
* ``stall`` — the stall watchdog escalated through :meth:`note_stall`: a
  controlled restart of the step loop from the last checkpoint.

Backoff between attempts is exponential with deterministic seeded jitter
(``backoff_base_s * 2**(attempt-1)``, capped, ±``jitter``) so a flapping
storage layer is not hammered in lockstep by every retrying host.

``FailurePolicy.legacy(n)`` reproduces the old ``set_retry_times(n)``
semantics exactly (n total attempts, no backoff, divergence guard off) — the
compat shim ``Optimizer.optimize()`` uses when only ``retry_times`` is set.
"""

from __future__ import annotations

import logging
import threading
from dataclasses import dataclass, field
from typing import Dict, Optional, Set, Tuple

import numpy as np

from .errors import DivergenceError, StallEscalation

log = logging.getLogger("bigdl_tpu_torch.resilience")

__all__ = ["FaultClass", "RetryDecision", "FailurePolicy"]


class FaultClass:
    TRANSIENT = "transient"
    POISON = "poison_batch"
    DIVERGENCE = "divergence"
    STALL = "stall"

    ALL = (TRANSIENT, POISON, DIVERGENCE, STALL)


DEFAULT_BUDGETS: Dict[str, int] = {
    FaultClass.TRANSIENT: 3,
    FaultClass.POISON: 2,
    FaultClass.DIVERGENCE: 2,
    FaultClass.STALL: 1,
}


@dataclass
class RetryDecision:
    """What the policy decided for one failure."""

    retry: bool
    fault_class: str
    attempt: int  # 1-based attempt count within the class
    total_attempts: int
    backoff_s: float
    reason: str
    skip_position: Optional[Tuple[int, int]] = None
    extra: dict = field(default_factory=dict)


class FailurePolicy:
    """Fault classifier + per-class retry budgets + backoff schedule.

    Args:
        budgets: per-class retry budgets; merged over ``DEFAULT_BUDGETS``.
        max_total: optional cap on total retries across all classes.
        backoff_base_s / backoff_max_s / jitter: exponential backoff between
            attempts, ``min(max, base * 2**(attempt-1)) * (1 + jitter*u)``
            with ``u`` drawn from a SEEDED rng (deterministic).
        divergence_guard: arm the NaN/Inf loss check in the driver loop.
        divergence_action: ``'lr_backoff'`` (scale the LR by
            ``lr_backoff ** n_divergences`` after each rollback) or
            ``'skip_window'`` (skip ``skip_window`` batches from the
            divergent data position onward).
        stall_escalate_after: escalate to a controlled restart after this
            many watchdog stall callbacks (see :meth:`note_stall`);
            ``0`` disables escalation (stalls stay telemetry-only).
        poison_skip: actually SKIP a position classified poison (the
            default). ``False`` keeps the classification (telemetry still
            says ``poison_batch``) but retries the batch until budgets
            exhaust and the failure re-raises — the legacy
            ``set_retry_times`` contract, where a persistent failure must
            surface, never silently drop data.
        seed: jitter rng seed.
    """

    def __init__(
        self,
        budgets: Optional[Dict[str, int]] = None,
        max_total: Optional[int] = None,
        backoff_base_s: float = 0.5,
        backoff_max_s: float = 30.0,
        jitter: float = 0.1,
        divergence_guard: bool = True,
        divergence_action: str = "lr_backoff",
        lr_backoff: float = 0.5,
        skip_window: int = 2,
        stall_escalate_after: int = 1,
        poison_skip: bool = True,
        seed: int = 0,
    ):
        if divergence_action not in ("lr_backoff", "skip_window"):
            raise ValueError(
                f"unknown divergence_action {divergence_action!r}"
            )
        self.budgets = dict(DEFAULT_BUDGETS)
        if budgets:
            unknown = set(budgets) - set(FaultClass.ALL)
            if unknown:
                raise ValueError(f"unknown fault class(es) in budgets: {unknown}")
            self.budgets.update(budgets)
        self.max_total = max_total
        self.backoff_base_s = float(backoff_base_s)
        self.backoff_max_s = float(backoff_max_s)
        self.jitter = float(jitter)
        self.divergence_guard = bool(divergence_guard)
        self.divergence_action = divergence_action
        self.lr_backoff = float(lr_backoff)
        self.skip_window = int(skip_window)
        self.stall_escalate_after = int(stall_escalate_after)
        self.poison_skip = bool(poison_skip)
        self._seed = int(seed)
        self._stall_event = threading.Event()
        self.reset()

    # ------------------------------------------------------------------ state
    def reset(self) -> "FailurePolicy":
        """Fresh counters for a new ``optimize()`` call (skip positions are
        per-run: they name (epoch, batch) slots of THIS run's shuffle)."""
        self.counts: Dict[str, int] = {c: 0 for c in FaultClass.ALL}
        self.total_attempts = 0
        self.position_failures: Dict[Tuple[int, int], int] = {}
        self.skip_positions: Set[Tuple[int, int]] = set()
        self.last_decision: Optional[RetryDecision] = None  # introspection/tests
        self._rng = np.random.default_rng(self._seed)
        self._stalls_seen = 0
        self._stall_event.clear()
        return self

    # --------------------------------------------------------------- classify
    def _classify(self, exc: BaseException,
                  position: Optional[Tuple[int, int]]) -> str:
        if isinstance(exc, StallEscalation):
            return FaultClass.STALL
        if position is not None and self.position_failures.get(position, 0) >= 1:
            # second failure at the SAME data position: deterministic poison.
            # DELIBERATELY outranks DivergenceError — a batch that keeps
            # producing NaN re-diverges on every replay no matter how far
            # the LR backs off, so the skip (not another rollback) is the
            # only decision that makes forward progress.
            return FaultClass.POISON
        if isinstance(exc, DivergenceError):
            return FaultClass.DIVERGENCE
        return FaultClass.TRANSIENT

    def _backoff(self, attempt: int) -> float:
        if self.backoff_base_s <= 0:
            return 0.0
        base = min(self.backoff_max_s, self.backoff_base_s * 2 ** (attempt - 1))
        if self.jitter > 0:
            base *= 1.0 + self.jitter * float(self._rng.random())
        return base

    # ----------------------------------------------------------------- decide
    def on_failure(self, exc: BaseException,
                   position: Optional[Tuple[int, int]] = None) -> RetryDecision:
        """Classify one failure and decide whether/how to retry.

        ``position`` is the (epoch, iter_in_epoch) data position the run was
        at — None for failures with no meaningful position (resume errors,
        stalls)."""
        cls = self._classify(exc, position)
        self.total_attempts += 1
        self.counts[cls] += 1
        attempt = self.counts[cls]
        if position is not None:
            self.position_failures[position] = (
                self.position_failures.get(position, 0) + 1
            )
        skip_position = None
        if cls == FaultClass.POISON and position is not None and self.poison_skip:
            self.skip_positions.add(position)
            skip_position = position
        if (
            cls == FaultClass.DIVERGENCE
            and self.divergence_action == "skip_window"
            and position is not None
        ):
            for w in range(self.skip_window):
                self.skip_positions.add((position[0], position[1] + w))
            skip_position = position
        within_budget = attempt <= self.budgets.get(cls, 0)
        within_total = (
            self.max_total is None or self.total_attempts <= self.max_total
        )
        retry = within_budget and within_total
        reason = (
            "retry" if retry
            else ("class budget exhausted" if not within_budget
                  else "total retry budget exhausted")
        )
        decision = RetryDecision(
            retry=retry,
            fault_class=cls,
            attempt=attempt,
            total_attempts=self.total_attempts,
            backoff_s=self._backoff(attempt) if retry else 0.0,
            reason=reason,
            skip_position=skip_position,
        )
        # health attribution (obs/health.py): a DivergenceError raised while
        # a HealthMonitor was attached carries the first non-finite layer
        # path and its poison source — surface both in the decision and the
        # log so the rollback is diagnosable, not a blind retry
        layer = getattr(exc, "layer", None)
        source = getattr(exc, "source", None)
        if layer is not None or source is not None:
            decision.extra["layer"] = layer
            decision.extra["source"] = source
        log.warning(
            "failure policy: %s fault (attempt %d/%d, total %d%s) -> %s%s%s",
            cls, attempt, self.budgets.get(cls, 0), self.total_attempts,
            f"/{self.max_total}" if self.max_total is not None else "",
            "retry" if retry else "give up",
            f", skip {skip_position}" if skip_position else "",
            (f", first non-finite layer {layer!r} via {source}"
             if layer else ""),
        )
        self.last_decision = decision
        return decision

    # ------------------------------------------------------------- divergence
    def lr_scale(self) -> float:
        """Cumulative LR backoff after the divergences seen so far (1.0 when
        the action is skip_window or nothing diverged)."""
        if self.divergence_action != "lr_backoff":
            return 1.0
        n = self.counts.get(FaultClass.DIVERGENCE, 0)
        return float(self.lr_backoff ** n) if n else 1.0

    # ------------------------------------------------------------------ stall
    def note_stall(self, info: dict) -> None:
        """Watchdog callback (register via ``watchdog.add_callback`` — the
        optimizer does this when a policy + telemetry watchdog are both
        attached). Thread-safe: called from the monitor thread; the driver
        loop polls :meth:`stall_pending` between steps."""
        self._stalls_seen += 1
        self._last_stall_info = dict(info)
        if 0 < self.stall_escalate_after <= self._stalls_seen:
            self._stall_event.set()

    def stall_pending(self) -> bool:
        return self._stall_event.is_set()

    def take_stall(self) -> dict:
        """Consume the pending escalation (re-arms for the next stall)."""
        self._stall_event.clear()
        self._stalls_seen = 0
        return getattr(self, "_last_stall_info", {})

    # ----------------------------------------------------------------- legacy
    @classmethod
    def legacy(cls, retry_times: int) -> "FailurePolicy":
        """The pre-policy ``set_retry_times(n)`` contract: n total attempts,
        any exception, no backoff, no divergence guard, no stall escalation
        (a watchdog stall stays telemetry-only, as before the policy
        existed) — and no poison skip, so a deterministically failing batch
        exhausts the budget and RE-RAISES instead of being silently
        dropped."""
        n = int(retry_times)
        return cls(
            budgets={c: n for c in FaultClass.ALL},
            max_total=n,
            backoff_base_s=0.0,
            jitter=0.0,
            divergence_guard=False,
            stall_escalate_after=0,
            poison_skip=False,
        )
