"""Training (the Optimizer facade, LocalOptimizer, optimization methods, LBFGS, schedules,
regularizers, triggers), validation methods, and fixed-batch inference
(Predictor, Evaluator, PredictionService)."""

from .lbfgs import LBFGS
from .local_optimizer import LocalOptimizer, Optimizer, validate
from .optim_method import (SGD, Adadelta, Adagrad, Adam, Adamax, Ftrl, Lamb, LarsSGD,
                           OptimMethod, ParallelAdam, RMSprop)
from .predictor import Evaluator, PredictionService, Predictor
from .regularizer import L1L2Regularizer, L1Regularizer, L2Regularizer, Regularizer
from .schedules import (Cosine, Default, EpochDecay, EpochStep, Exponential,
                        LearningRateSchedule, LinearWarmup, MultiStep, NaturalExp, Plateau, Poly,
                        SequentialSchedule, Step, Warmup)
from .trigger import Trigger
from .validation import (MAE, NDCG, AccuracyResult, HitRatio, Loss, LossResult, Top1Accuracy,
                         Top5Accuracy, TreeNNAccuracy, ValidationMethod, ValidationResult)

__all__ = ["PredictionService",
           "AccuracyResult", "Adadelta", "Adagrad", "Adam", "Adamax", "Cosine", "Default",
           "EpochDecay", "EpochStep", "Evaluator", "Exponential", "Ftrl", "HitRatio",
           "L1L2Regularizer", "L1Regularizer", "L2Regularizer", "LBFGS", "Lamb", "LarsSGD",
           "LearningRateSchedule", "LinearWarmup", "LocalOptimizer", "Loss", "LossResult", "MAE",
           "MultiStep", "NDCG", "NaturalExp", "OptimMethod", "Optimizer", "ParallelAdam", "Plateau", "Poly",
           "Predictor", "RMSprop", "Regularizer", "SGD", "SequentialSchedule", "Step",
           "Top1Accuracy", "Top5Accuracy", "TreeNNAccuracy", "Trigger", "ValidationMethod",
           "ValidationResult", "Warmup", "validate"]
