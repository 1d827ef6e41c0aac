"""Fixed-batch inference (Predictor) and serving flush triggers."""

from .predictor import Predictor
from .trigger import Trigger

__all__ = ["Predictor", "Trigger"]
