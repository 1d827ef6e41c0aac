"""Learning-rate schedules (counterpart of ``bigdl_tpu/optim/schedules.py``;
``Default`` only so far). Schedules run on the host from the optimizer's
state table (``neval`` is the 1-based iteration)."""

from __future__ import annotations


class LearningRateSchedule:
    """Returns the learning rate for the given optimizer state."""

    def update(self, optim_method, state: dict) -> float:
        raise NotImplementedError


class Default(LearningRateSchedule):
    """``lr / (1 + (neval - 1) * learningrate_decay)``, the reference's default."""

    def update(self, optim_method, state) -> float:
        n = state.get("neval", 1) - 1
        return optim_method.learningrate / (1 + n * optim_method.learningrate_decay)
