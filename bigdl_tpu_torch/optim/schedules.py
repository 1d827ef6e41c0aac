"""Learning-rate schedules (counterpart of ``bigdl_tpu/optim/schedules.py``;
reference: ``LearningRateSchedule`` inside ``$DL/optim/SGD.scala``).

Schedules run on the host from the optimizer's state table, between steps,
and hand the step a Python float. State-table keys are the JAX package's:
``neval`` (the 1-based iteration), ``epoch`` (1-based), ``score`` (the
latest validation's first result) and ``n_validations`` (validations so
far), all written by ``LocalOptimizer``. Two schedules write into the
table, under the JAX package's keys, so that a checkpoint of either package
resumes in the other: ``SequentialSchedule`` writes ``_schedule_offset``
(the first iteration of the active leg, read by ``Cosine`` and ``Warmup``)
and ``Plateau`` writes ``_plateau_seen_event`` (the last validation it
counted). ``Plateau``'s own progress (best score, wait, current rate) lives
on the object and is not checkpointed, as in the JAX package.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence


class LearningRateSchedule:
    """Returns the learning rate for the given optimizer state."""

    def update(self, optim_method, state: dict) -> float:
        raise NotImplementedError


class Default(LearningRateSchedule):
    """``lr / (1 + (neval - 1) * learningrate_decay)``, the reference's default."""

    def update(self, optim_method, state) -> float:
        n = state.get("neval", 1) - 1
        return optim_method.learningrate / (1 + n * optim_method.learningrate_decay)


class Step(LearningRateSchedule):
    """``lr * gamma^floor((neval - 1) / step_size)``."""

    def __init__(self, step_size: int, gamma: float = 0.1):
        self.step_size = step_size
        self.gamma = gamma

    def update(self, optim_method, state) -> float:
        n = state.get("neval", 1) - 1
        return optim_method.learningrate * self.gamma ** (n // self.step_size)


class MultiStep(LearningRateSchedule):
    """Decay by ``gamma`` at each listed iteration milestone."""

    def __init__(self, step_sizes: Sequence[int], gamma: float = 0.1):
        self.step_sizes = list(step_sizes)
        self.gamma = gamma

    def update(self, optim_method, state) -> float:
        n = state.get("neval", 1) - 1
        k = sum(1 for s in self.step_sizes if n >= s)
        return optim_method.learningrate * self.gamma**k


class EpochStep(LearningRateSchedule):
    """Decay by ``gamma`` every ``step_size`` epochs."""

    def __init__(self, step_size: int, gamma: float = 0.1):
        self.step_size = step_size
        self.gamma = gamma

    def update(self, optim_method, state) -> float:
        e = state.get("epoch", 1) - 1
        return optim_method.learningrate * self.gamma ** (e // self.step_size)


class EpochDecay(LearningRateSchedule):
    """``lr * 0.1^decay_fn(epoch)`` with a user decay function."""

    def __init__(self, decay_fn):
        self.decay_fn = decay_fn

    def update(self, optim_method, state) -> float:
        return optim_method.learningrate * (0.1 ** self.decay_fn(state.get("epoch", 1)))


class Poly(LearningRateSchedule):
    """``lr * (1 - (neval - 1) / max_iteration)^power``, 0 from
    ``max_iteration`` on (the ResNet/ImageNet recipe)."""

    def __init__(self, power: float, max_iteration: int):
        self.power = power
        self.max_iteration = max_iteration

    def update(self, optim_method, state) -> float:
        n = state.get("neval", 1) - 1
        if n >= self.max_iteration:
            return 0.0
        return optim_method.learningrate * (1 - n / self.max_iteration) ** self.power


class Cosine(LearningRateSchedule):
    """Cosine decay to ``min_lr`` over ``max_iteration`` steps, counted from
    the start of its ``SequentialSchedule`` leg (``_schedule_offset``), and
    held at ``min_lr`` past the horizon."""

    def __init__(self, max_iteration: int, min_lr: float = 0.0):
        if max_iteration < 1:
            raise ValueError(f"max_iteration must be >= 1, got {max_iteration}")
        self.max_iteration = max_iteration
        self.min_lr = min_lr

    def update(self, optim_method, state) -> float:
        n = state.get("neval", 1) - 1 - state.get("_schedule_offset", 0)
        n = min(max(n, 0), self.max_iteration)
        cos = 0.5 * (1 + math.cos(math.pi * n / self.max_iteration))
        return self.min_lr + (optim_method.learningrate - self.min_lr) * cos


class Exponential(LearningRateSchedule):
    """``lr * decay_rate^((neval - 1) / decay_step)``, the exponent floored
    when ``stair_case``."""

    def __init__(self, decay_step: int, decay_rate: float, stair_case: bool = False):
        self.decay_step = decay_step
        self.decay_rate = decay_rate
        self.stair_case = stair_case

    def update(self, optim_method, state) -> float:
        n = state.get("neval", 1) - 1
        p = n / self.decay_step
        if self.stair_case:
            p = math.floor(p)
        return optim_method.learningrate * self.decay_rate**p


class NaturalExp(LearningRateSchedule):
    """``lr * exp(-gamma * floor((neval - 1) / decay_step))``."""

    def __init__(self, decay_step: int, gamma: float):
        self.decay_step = decay_step
        self.gamma = gamma

    def update(self, optim_method, state) -> float:
        n = state.get("neval", 1) - 1
        return optim_method.learningrate * math.exp(-self.gamma * (n // self.decay_step))


class Warmup(LearningRateSchedule):
    """The method's base lr plus ``delta`` per iteration of its
    ``SequentialSchedule`` leg (the reference's ``SGD.Warmup``)."""

    def __init__(self, delta: float):
        self.delta = delta

    def update(self, optim_method, state) -> float:
        n = state.get("neval", 1) - 1 - state.get("_schedule_offset", 0)
        return optim_method.learningrate + self.delta * n


class LinearWarmup(LearningRateSchedule):
    """``lr * (n + 1) / warmup_iters`` for the first ``warmup_iters``
    iterations (``n = neval - 1``), then ``after``, which sees the unchanged
    base lr and the absolute iteration (the large-batch ImageNet warmup)."""

    def __init__(self, warmup_iters: int, after: LearningRateSchedule):
        if warmup_iters < 0:
            raise ValueError("warmup_iters must be >= 0")
        self.warmup_iters = warmup_iters
        self.after = after

    def update(self, optim_method, state) -> float:
        n = state.get("neval", 1) - 1
        if n < self.warmup_iters:
            return optim_method.learningrate * (n + 1) / self.warmup_iters
        return self.after.update(optim_method, state)


class Plateau(LearningRateSchedule):
    """Multiply the rate by ``factor`` (not below ``min_lr``) when the
    monitored score has not improved by ``epsilon`` for ``patience``
    validations, then wait ``cooldown`` validations. ``mode``: ``'min'``
    (loss-like) or ``'max'`` (accuracy-like). It ticks once per validation
    event (``n_validations``), not per iteration or per distinct value."""

    def __init__(self, monitor: str = "score", factor: float = 0.1, patience: int = 10,
                 mode: str = "min", epsilon: float = 1e-4, cooldown: int = 0,
                 min_lr: float = 0.0):
        self.monitor = monitor
        self.factor = factor
        self.patience = patience
        self.mode = mode
        self.epsilon = epsilon
        self.cooldown = cooldown
        self.min_lr = min_lr
        self._best: Optional[float] = None
        self._wait = 0
        self._cooldown_left = 0
        self._lr: Optional[float] = None

    def _improved(self, value: float) -> bool:
        if self._best is None:
            return True
        if self.mode == "min":
            return value < self._best - self.epsilon
        return value > self._best + self.epsilon

    def update(self, optim_method, state) -> float:
        if self._lr is None:
            self._lr = optim_method.learningrate
        value = state.get(self.monitor)
        event = state.get("n_validations", 0)
        if value is not None and event != state.get("_plateau_seen_event"):
            state["_plateau_seen_event"] = event
            if self._cooldown_left > 0:
                self._cooldown_left -= 1
            if self._improved(value):
                self._best = value
                self._wait = 0
            elif self._cooldown_left <= 0:
                self._wait += 1
                if self._wait >= self.patience:
                    self._lr = max(self._lr * self.factor, self.min_lr)
                    self._cooldown_left = self.cooldown
                    self._wait = 0
        return self._lr


class SequentialSchedule(LearningRateSchedule):
    """Schedules chained, each active for its number of iterations (the last
    one for ever); the active leg's first iteration is written to the state
    table as ``_schedule_offset``."""

    def __init__(self, iteration_per_epoch: int = 1):
        self.schedules: List[tuple] = []  # (schedule, max_iterations)
        self.iteration_per_epoch = iteration_per_epoch

    def add(self, schedule: LearningRateSchedule, max_iteration: int) -> "SequentialSchedule":
        self.schedules.append((schedule, max_iteration))
        return self

    def update(self, optim_method, state) -> float:
        n = state.get("neval", 1) - 1
        offset = 0
        for sched, span in self.schedules:
            if n < offset + span or (sched, span) == self.schedules[-1]:
                state["_schedule_offset"] = offset
                return sched.update(optim_method, state)
            offset += span
        return optim_method.learningrate
