"""ML-pipeline estimator API (counterpart of ``bigdl_tpu/ml``; reference:
``DLEstimator`` / ``DLClassifier`` under ``org/apache/spark/ml`` and
``$PY/ml``): sklearn-style ``fit`` / ``predict`` / ``score`` over the port's
``LocalOptimizer`` and ``Predictor``."""

from .estimator import DLClassifier, DLClassifierModel, DLEstimator, DLModel

__all__ = ["DLClassifier", "DLClassifierModel", "DLEstimator", "DLModel"]
