"""``Linear`` (counterpart of ``bigdl_tpu/nn/linear.py``): y = x Wᵀ + b over
the last dim, weight stored (out, in), ``RandomUniform`` initialisation, and
an optional ``activation`` epilogue (``precision.bias_act``): ``act(y + b)``
in torch ops, or, with a bias under ``Engine.set_fused_kernels(True)``, the
feature-mode ``fused_bias_act`` (the CUDA kernels on the card).

``SparseLinear`` takes a ``SparseTensor`` (wide&deep's wide column): W's
columns gathered at the feature ids, scaled by the values and summed per
row (``index_select`` and ``index_add_``, the JAX package's ``take`` and
``segment_sum``), in the weight's dtype: like the JAX module it does not
cast to the compute dtype, so its output is float32 under the bf16
policy. A dense input takes ``Linear``'s path."""

from __future__ import annotations

from typing import Optional

from ..tensor.sparse import SparseTensor
from ..utils import precision
from .initialization import InitializationMethod, RandomUniform
from .module import AbstractModule, spec


class Linear(AbstractModule):

    def infer_shape(self, in_spec):
        shape = tuple(in_spec.shape)
        if not shape:
            raise ValueError(f"{self.name()}: needs a trailing feature dim, got a scalar input")
        if self.input_size is not None and shape[-1] != self.input_size:
            raise ValueError(f"{self.name()}: expected last dim {self.input_size}, got "
                             f"{shape[-1]} (input shape {shape})")
        dt = in_spec.values.dtype if isinstance(in_spec, SparseTensor) else in_spec.dtype
        return spec(shape[:-1] + (self.output_size,), precision.result_dtype(dt))
    def __init__(self, input_size: Optional[int] = None, output_size: int = 0,
                 with_bias: bool = True, w_regularizer=None, b_regularizer=None,
                 activation: Optional[str] = None, device=None):
        super().__init__(device)
        precision._act_fn(activation)  # validate the name
        self.input_size = input_size
        self.output_size = output_size
        self.with_bias = with_bias
        self.w_regularizer = w_regularizer
        self.b_regularizer = b_regularizer
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

    def regularization_loss(self, params):
        loss = 0.0
        if self.w_regularizer is not None:
            loss = loss + self.w_regularizer(params["weight"])
        if self.b_regularizer is not None and self.with_bias:
            loss = loss + self.b_regularizer(params["bias"])
        return loss


class SparseLinear(Linear):
    def _apply_params(self, params, state, x, training, rng):
        if not isinstance(x, SparseTensor):
            return super()._apply_params(params, state, x, training, rng)
        w = params["weight"]  # (out, in)
        contrib = w.index_select(1, x.col_indices.long()).t() * x.values[:, None]  # (nnz, out)
        y = contrib.new_zeros((x.shape[0], w.shape[0])).index_add_(0, x.row_indices.long(),
                                                                   contrib)
        return precision.bias_act(y, params["bias"] if self.with_bias else None,
                                  self.activation), state
