"""Autoencoder (counterpart of ``bigdl_tpu/models/autoencoder.py``;
reference: ``$DL/models/autoencoder/Autoencoder.scala``, the MNIST
fully connected autoencoder): Reshape(feature_dim) -> Linear(class_num) ->
ReLU -> Linear(feature_dim) -> Sigmoid, trained with ``MSECriterion``
against its input. The layers are unnamed, as in the JAX package, so the
container names them ``Reshape_0`` ... ``Sigmoid_4`` in both. Every module
is created on ``device``."""

from __future__ import annotations

from .. import nn


def Autoencoder(class_num: int = 32, feature_dim: int = 784, device=None) -> nn.Sequential:
    """``class_num`` is the reference's name for the bottleneck width."""
    d = {"device": device}
    return nn.Sequential(
        nn.Reshape((feature_dim,), **d),
        nn.Linear(feature_dim, class_num, **d),
        nn.ReLU(**d),
        nn.Linear(class_num, feature_dim, **d),
        nn.Sigmoid(**d),
        **d,
    )
