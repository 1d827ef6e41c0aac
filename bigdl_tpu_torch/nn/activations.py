"""Activations (counterpart of part of ``bigdl_tpu/nn/activations.py``):
``ReLU``, ``Tanh``, ``Sigmoid`` and ``LogSoftMax``."""

from __future__ import annotations

import torch

from ..utils import precision
from .module import AbstractModule


class ReLU(AbstractModule):
    """max(0, x). Written as ``torch.maximum`` against a zero, not
    ``torch.relu``, so that an exact zero input takes half the gradient, as
    ``jnp.maximum(x, 0)`` gives it in the JAX package. ``inplace`` is
    accepted and ignored."""

    def __init__(self, inplace: bool = False, device=None):
        super().__init__(device)
        self.inplace = inplace

    def _apply_params(self, params, state, x, training, rng):
        return torch.maximum(x, x.new_zeros(())), state


class Tanh(AbstractModule):
    """tanh(x) in ``x``'s dtype. ``inplace`` is accepted and ignored."""

    def __init__(self, inplace: bool = False, device=None):
        super().__init__(device)
        self.inplace = inplace

    def _apply_params(self, params, state, x, training, rng):
        return torch.tanh(x), state


class Sigmoid(AbstractModule):
    """1 / (1 + exp(-x)) in ``x``'s dtype. ``inplace`` is accepted and
    ignored."""

    def __init__(self, inplace: bool = False, device=None):
        super().__init__(device)
        self.inplace = inplace

    def _apply_params(self, params, state, x, training, rng):
        return torch.sigmoid(x), state


class LogSoftMax(AbstractModule):
    """log-softmax over the last dim, in float32 (the loss head)."""

    def _apply_params(self, params, state, x, training, rng):
        return torch.log_softmax(precision.to_float(x), dim=-1), state
