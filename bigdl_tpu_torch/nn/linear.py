"""``Linear`` (counterpart of ``bigdl_tpu/nn/linear.py``): y = x Wᵀ + b over
the last dim, weight stored (out, in), ``RandomUniform`` initialisation, and
an optional ``activation`` epilogue (``precision.bias_act``): ``act(y + b)``
in torch ops, or, with a bias under ``Engine.set_fused_kernels(True)``, the
feature-mode ``fused_bias_act`` (the CUDA kernels on the card)."""

from __future__ import annotations

from typing import Optional

from ..utils import precision
from .initialization import InitializationMethod, RandomUniform
from .module import AbstractModule


class Linear(AbstractModule):
    def __init__(self, input_size: Optional[int] = None, output_size: int = 0,
                 with_bias: bool = True, activation: Optional[str] = None, device=None):
        super().__init__(device)
        precision._act_fn(activation)  # validate the name
        self.input_size = input_size
        self.output_size = output_size
        self.with_bias = with_bias
        self.activation = activation
        self.weight_init: InitializationMethod = RandomUniform()
        self.bias_init: InitializationMethod = RandomUniform()

    def set_init_method(self, weight_init=None, bias_init=None) -> "Linear":
        if weight_init is not None:
            self.weight_init = weight_init
        if bias_init is not None:
            self.bias_init = bias_init
        return self

    def _build(self, generator, sample):
        in_size = sample.shape[-1]
        if self.input_size is not None and self.input_size != in_size:
            raise ValueError(f"{self.name()}: expected last dim {self.input_size}, got {in_size}")
        self.input_size = in_size
        params = {"weight": self.weight_init(generator, (self.output_size, in_size), in_size,
                                             self.output_size)}
        if self.with_bias:
            params["bias"] = self.bias_init(generator, (self.output_size,), in_size,
                                            self.output_size)
        return params, {}

    def _apply_params(self, params, state, x, training, rng):
        y = precision.einsum("...i,oi->...o", x, params["weight"])
        return precision.bias_act(y, params["bias"] if self.with_bias else None,
                                  self.activation), state
