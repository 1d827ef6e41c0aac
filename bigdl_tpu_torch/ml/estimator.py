"""DLEstimator / DLClassifier (counterpart of ``bigdl_tpu/ml/estimator.py``;
reference: ``DLEstimator.scala`` / ``DLClassifier.scala`` in
``org/apache/spark/ml``).

* An ESTIMATOR holds (model, criterion, feature size, label size) and the
  training configuration (batch size, epochs, optim method, learning
  rate); ``fit(X, y)`` trains through ``LocalOptimizer`` and returns a
  fitted MODEL that transforms / predicts through ``Predictor``;
* ``DLClassifier`` 's fitted model predicts 0-based class ids (argmax over
  the module's output);
* numpy in, numpy out; the sklearn surface (``get_params`` /
  ``set_params``, ``fit``, ``predict``, ``score``) lets a
  ``sklearn.pipeline.Pipeline`` drive it.

The model trains and predicts on ``device`` (the card unless ``"cpu"``, as
the port's other entry points): ``fit`` places it there first.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..dataset import DataSet
from ..nn.criterion import AbstractCriterion
from ..nn.module import AbstractModule
from ..optim.local_optimizer import LocalOptimizer
from ..optim.optim_method import SGD, OptimMethod
from ..optim.predictor import Predictor
from ..optim.trigger import Trigger
from ..utils.engine import Engine

try:  # optional: lets sklearn>=1.6 pipelines introspect tags; no hard dependency
    from sklearn.base import BaseEstimator as _SkBase
except ImportError:  # pragma: no cover
    class _SkBase:
        pass


def _placed(model: AbstractModule, device) -> AbstractModule:
    """``model`` on ``device``: its parameters moved, and the modules not
    built yet told where to build theirs."""
    dev = Engine.device(device)
    for m in model.modules():
        if isinstance(m, AbstractModule):
            m._device = dev
    return model.to(dev)


def _host(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


class DLEstimator(_SkBase):
    """Trainable wrapper: ``fit(X, y) -> DLModel`` (reference: DLEstimator)."""

    def __init__(
        self,
        model: AbstractModule,
        criterion: AbstractCriterion,
        feature_size: Optional[Sequence[int]] = None,
        label_size: Optional[Sequence[int]] = None,
        batch_size: int = 32,
        max_epoch: int = 10,
        optim_method: Optional[OptimMethod] = None,
        learning_rate: float = 1e-3,
        telemetry=None,
        device=None,
    ):
        self.model = model
        self.criterion = criterion
        self.feature_size = tuple(feature_size) if feature_size else None
        self.label_size = tuple(label_size) if label_size else None
        self.batch_size = batch_size
        self.max_epoch = max_epoch
        self.optim_method = optim_method
        self.learning_rate = learning_rate
        self.telemetry = telemetry  # an obs.Telemetry for fit()'s LocalOptimizer
        self.device = device

    # ------------------------------------------------------- sklearn surface
    _PARAM_NAMES = ("model", "criterion", "feature_size", "label_size",
                    "batch_size", "max_epoch", "optim_method", "learning_rate",
                    "telemetry", "device")

    def get_params(self, deep: bool = True) -> dict:
        return {k: getattr(self, k) for k in self._PARAM_NAMES}

    def set_params(self, **params) -> "DLEstimator":
        for k, v in params.items():
            if k not in self._PARAM_NAMES:
                raise ValueError(f"unknown parameter {k!r}")
            setattr(self, k, v)
        return self

    # ------------------------------------------------------------------- fit
    def _reshape(self, arr, size: Optional[Sequence[int]], what: str) -> np.ndarray:
        arr = np.asarray(arr)
        if size is not None:
            arr = arr.reshape((-1,) + tuple(size))
        if arr.shape[0] == 0:
            raise ValueError(f"empty {what} array")
        return arr

    def _train(self, x: np.ndarray, y: np.ndarray) -> AbstractModule:
        opt = LocalOptimizer(_placed(self.model, self.device),
                             DataSet.array(x, y, batch_size=self.batch_size), self.criterion)
        opt.set_optim_method(self.optim_method or SGD(learningrate=self.learning_rate))
        opt.set_end_when(Trigger.max_epoch(self.max_epoch))
        if self.telemetry is not None:
            opt.set_telemetry(self.telemetry)
        return opt.optimize()

    def fit(self, X, y) -> "DLModel":
        """Returns the fitted ``DLModel`` and keeps it as ``self.model_``, so
        a sklearn ``Pipeline`` (which keeps the estimator) predicts and
        scores through it."""
        x = self._reshape(X, self.feature_size, "feature").astype(np.float32)
        t = self._reshape(y, self.label_size, "label")
        self.model_ = DLModel(self._train(x, t), self.feature_size, batch_size=self.batch_size)
        return self.model_

    def _fitted(self) -> "DLModel":
        model = getattr(self, "model_", None)
        if model is None:
            raise RuntimeError(f"{type(self).__name__} is not fitted yet")
        return model

    def predict(self, X):
        return self._fitted().predict(X)

    def transform(self, X):
        return self._fitted().transform(X)


class DLModel:
    """Fitted transformer: ``predict`` / ``transform`` (reference: DLModel),
    on the trained model's device."""

    def __init__(self, model: AbstractModule, feature_size: Optional[Sequence[int]] = None,
                 batch_size: int = 32):
        self.model = model
        self.feature_size = tuple(feature_size) if feature_size else None
        self.batch_size = batch_size
        self._predictor = Predictor(model, batch_size)

    def _prep(self, X) -> np.ndarray:
        arr = np.asarray(X, np.float32)
        if self.feature_size is not None:
            arr = arr.reshape((-1,) + self.feature_size)
        return arr

    def _scores(self, X) -> np.ndarray:
        return _host(self._predictor.predict(self._prep(X)))

    def predict(self, X) -> np.ndarray:
        return self._scores(X)

    def transform(self, X) -> np.ndarray:  # pipeline vocabulary
        return self.predict(X)


class DLClassifier(DLEstimator):
    """Classification specialization (reference: DLClassifier): the fitted
    model predicts integer class ids by argmax over the module's output."""

    def fit(self, X, y) -> "DLClassifierModel":
        x = self._reshape(X, self.feature_size, "feature").astype(np.float32)
        t = np.asarray(y).reshape(-1).astype(np.int32)
        self.model_ = DLClassifierModel(self._train(x, t), self.feature_size,
                                        batch_size=self.batch_size)
        return self.model_

    def predict_proba(self, X):
        return self._fitted().predict_proba(X)

    def score(self, X, y) -> float:
        return self._fitted().score(X, y)


class DLClassifierModel(DLModel):
    def predict(self, X) -> np.ndarray:
        return self._scores(X).argmax(axis=-1)

    def predict_proba(self, X) -> np.ndarray:
        """The outputs normalized with a softmax (a log-softmax head's
        probabilities; a ranking either way)."""
        scores = self._scores(X)
        e = np.exp(scores - scores.max(-1, keepdims=True))
        return e / e.sum(-1, keepdims=True)

    def score(self, X, y) -> float:
        return float((self.predict(X) == np.asarray(y).reshape(-1)).mean())
