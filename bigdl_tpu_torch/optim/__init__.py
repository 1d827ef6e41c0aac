"""Training (LocalOptimizer, optimization methods, schedules, triggers) and
fixed-batch inference (Predictor)."""

from .local_optimizer import LocalOptimizer
from .optim_method import SGD, Adam, OptimMethod
from .predictor import Predictor
from .schedules import Default, LearningRateSchedule
from .trigger import Trigger

__all__ = ["Adam", "Default", "LearningRateSchedule", "LocalOptimizer", "OptimMethod",
           "Predictor", "SGD", "Trigger"]
