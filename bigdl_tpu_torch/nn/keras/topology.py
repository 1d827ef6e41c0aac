"""Keras-style model containers (counterpart of
``bigdl_tpu/nn/keras/topology.py``; reference: ``$DL/nn/keras/Topology.scala``):
``Sequential`` chains keras (or core) layers, ``Model(input, output)`` wraps
the functional node wiring over the core ``Graph``. ``compile`` resolves a
loss, an optimizer and metrics by their keras names (or takes objects),
``fit`` trains through the port's ``LocalOptimizer`` (its ``history`` and
the optimizer are kept as ``last_optimizer``), ``evaluate(x, y)`` returns
``[loss, *metrics]`` and ``predict``/``predict_classes`` run a
``Predictor``; with no arguments ``evaluate()`` switches to eval mode, as
the core method does. Arrays in, numpy arrays out.
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence

import numpy as np

from ...dataset.dataset import DataSet
from ..criterion import AbsCriterion, BCECriterion, CrossEntropyCriterion, MSECriterion
from ..graph import Graph
from ..graph import Input as GraphInput
from ..graph import ModuleNode
from ..module import Sequential as CoreSequential


def Input(shape: Optional[Sequence[int]] = None, name: Optional[str] = None) -> ModuleNode:
    """Functional-API input node (reference: keras/Input.scala); ``shape``
    is the per-record shape, checked when the model is built."""
    node = GraphInput()
    node.keras_shape = tuple(shape) if shape is not None else None
    if name:
        node.module.set_name(name)
    return node


def _resolve_loss(loss):
    if not isinstance(loss, str):
        return loss, False
    table = {
        "mse": MSECriterion,
        "mean_squared_error": MSECriterion,
        "mae": AbsCriterion,
        "mean_absolute_error": AbsCriterion,
        "binary_crossentropy": BCECriterion,
        "categorical_crossentropy": CrossEntropyCriterion,
        "sparse_categorical_crossentropy": CrossEntropyCriterion,
    }
    try:
        crit = table[loss]()
    except KeyError:
        raise ValueError(f"unknown loss {loss!r}") from None
    return crit, loss == "categorical_crossentropy"


def _resolve_optimizer(optimizer):
    from ...optim import SGD, Adadelta, Adagrad, Adam, Adamax, RMSprop

    if not isinstance(optimizer, str):
        return optimizer
    table = {
        "sgd": lambda: SGD(learningrate=0.01),
        "adam": Adam,
        "rmsprop": RMSprop,
        "adagrad": Adagrad,
        "adadelta": Adadelta,
        "adamax": Adamax,
    }
    try:
        return table[optimizer.lower()]()
    except KeyError:
        raise ValueError(f"unknown optimizer {optimizer!r}") from None


def _resolve_metrics(metrics):
    from ...optim import Top1Accuracy, Top5Accuracy

    out = []
    for m in metrics or []:
        if isinstance(m, str):
            table = {"accuracy": Top1Accuracy, "acc": Top1Accuracy, "top5": Top5Accuracy}
            try:
                out.append(table[m]())
            except KeyError:
                raise ValueError(f"unknown metric {m!r}") from None
        else:
            out.append(m)
    return out


class KerasModelMixin:
    """compile/fit/evaluate/predict over a core container."""

    def compile(self, optimizer, loss, metrics: Optional[List[Any]] = None) -> None:
        self._optim_method = _resolve_optimizer(optimizer)
        self._criterion, self._onehot_targets = _resolve_loss(loss)
        self._metrics = _resolve_metrics(metrics)

    def _prep_targets(self, y) -> np.ndarray:
        y = np.asarray(y)
        if getattr(self, "_onehot_targets", False) and y.ndim > 1 and y.shape[-1] > 1:
            y = np.argmax(y, axis=-1)
        return y

    def fit(self, x, y=None, batch_size: int = 32, nb_epoch: int = 10,
            validation_data=None) -> None:
        """Train with the compiled optimizer and loss for ``nb_epoch``
        epochs (reference: Topology.fit); with ``validation_data`` the loss
        and the metrics are validated at every epoch's end."""
        if not hasattr(self, "_optim_method"):
            raise RuntimeError("call compile(optimizer, loss) before fit")
        from ...optim import LocalOptimizer, Loss, Trigger

        ds = DataSet.array(np.asarray(x), self._prep_targets(y), batch_size=batch_size)
        opt = LocalOptimizer(self, ds, self._criterion)
        opt.set_optim_method(self._optim_method)
        opt.set_end_when(Trigger.max_epoch(nb_epoch))
        if validation_data is not None:
            vx, vy = validation_data
            vds = DataSet.array(np.asarray(vx), self._prep_targets(vy), batch_size=batch_size)
            opt.set_validation(Trigger.every_epoch(), vds,
                               [Loss(self._criterion), *self._metrics])
        self.last_optimizer = opt
        opt.optimize()

    def evaluate(self, x=None, y=None, batch_size: int = 32):
        """With (x, y): ``[loss, *metrics]`` as floats (reference:
        Topology.evaluate). Without arguments: switch to eval mode."""
        if x is None:
            return super().evaluate()
        from ...optim import Loss, validate

        ds = DataSet.array(np.asarray(x), self._prep_targets(y), batch_size=batch_size)
        if not self.is_built():
            self.forward(np.asarray(x)[:batch_size])
        methods = [Loss(getattr(self, "_criterion", MSECriterion())),
                   *getattr(self, "_metrics", [])]
        results = validate(self, self.get_parameters(), self.get_state(), ds, methods)
        return [results[m.name].result()[0] for m in methods]

    def predict(self, x, batch_size: int = 32) -> np.ndarray:
        """Eval-mode outputs over ``x`` in batches of ``batch_size``."""
        from ...optim.predictor import Predictor

        return Predictor(self, batch_size).predict(np.asarray(x)).float().cpu().numpy()

    def predict_classes(self, x, batch_size: int = 32) -> np.ndarray:
        """0-based argmax classes (keras convention; the Torch-style
        ``predict_class`` stays 1-based like the reference)."""
        return np.argmax(self.predict(x, batch_size), axis=-1)


class Sequential(KerasModelMixin, CoreSequential):
    """Keras Sequential (reference: keras/Topology.scala Sequential)."""


class Model(KerasModelMixin, Graph):
    """Keras functional Model (reference: keras/Topology.scala Model):
    ``Model(input=node(s), output=node(s))`` over layers wired with
    ``layer(node)`` calls."""

    def __init__(self, input, output, device=None):
        Graph.__init__(self, input, output, device=device)

    def build(self, generator, sample) -> None:
        specs = list(sample) if isinstance(sample, (list, tuple)) or not hasattr(
            sample, "shape") else [sample]
        for node, s in zip(self.input_nodes, specs):
            declared = getattr(node, "keras_shape", None)
            got = tuple(getattr(s, "shape", ())[1:])
            if declared is not None and got and got != tuple(declared):
                raise ValueError(f"Input declared shape {tuple(declared)} but data has "
                                 f"per-sample shape {got}")
        Graph.build(self, generator, sample)
