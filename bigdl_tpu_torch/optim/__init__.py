"""Training (LocalOptimizer, optimization methods, schedules, triggers),
validation methods, and fixed-batch inference (Predictor, Evaluator)."""

from .local_optimizer import LocalOptimizer, validate
from .optim_method import SGD, Adam, OptimMethod
from .predictor import Evaluator, Predictor
from .schedules import Default, LearningRateSchedule
from .trigger import Trigger
from .validation import (MAE, NDCG, AccuracyResult, HitRatio, Loss, LossResult, Top1Accuracy,
                         Top5Accuracy, TreeNNAccuracy, ValidationMethod, ValidationResult)

__all__ = ["AccuracyResult", "Adam", "Default", "Evaluator", "HitRatio", "LearningRateSchedule",
           "LocalOptimizer", "Loss", "LossResult", "MAE", "NDCG", "OptimMethod", "Predictor",
           "SGD", "Top1Accuracy", "Top5Accuracy", "TreeNNAccuracy", "Trigger",
           "ValidationMethod", "ValidationResult", "validate"]
