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
policy. A dense input takes ``Linear``'s path.

``Maxout`` (keras ``MaxoutDense``) and ``Highway`` are containers of
``Linear`` s, as in the JAX package: Maxout's max over the pieces is an
``amax``, which splits the gradient evenly among tied pieces as
``jnp.max``'s does; Highway's gate is ``1 / (1 + exp(-t))`` as the JAX
package writes it, not ``torch.sigmoid``."""

from __future__ import annotations

from typing import Optional

import torch

from ..tensor.sparse import SparseTensor
from ..utils import precision
from .initialization import InitializationMethod, RandomUniform
from .module import AbstractModule, Container, infer_module_shape, spec


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


class Maxout(Container):
    """The maxout unit (reference: ``$DL/nn/Maxout.scala``; keras
    ``MaxoutDense``): one ``Linear`` to output_size × maxout_number, then
    the max over the maxout_number pieces of each output."""

    def __init__(self, input_size: Optional[int], output_size: int, maxout_number: int,
                 with_bias: bool = True, w_regularizer=None, b_regularizer=None, device=None):
        self.output_size = output_size
        self.maxout_number = maxout_number
        super().__init__(Linear(input_size, output_size * maxout_number, with_bias,
                                w_regularizer, b_regularizer, device=device), device=device)

    def build(self, generator, sample) -> None:
        if self._built:
            raise RuntimeError(f"{self.name()} is already built")
        with torch.no_grad():
            self._build_child(self._layers[0], generator, sample)
        self._built = True

    def infer_shape(self, in_spec):
        s = infer_module_shape(self._layers[0], in_spec)
        return spec(tuple(s.shape[:-1]) + (self.output_size,), s.dtype)

    def _apply_params(self, params, state, x, training, rng):
        lin = self._layers[0]
        y, s = lin._apply_params(params[lin.name()], state[lin.name()], x, training, rng)
        y = y.reshape(*y.shape[:-1], self.maxout_number, self.output_size)
        return torch.amax(y, dim=-2), {lin.name(): s}


class Highway(Container):
    """The highway unit (reference: keras ``Highway.scala``): ``y = t·H(x) +
    (1 - t)·x`` with ``t = 1 / (1 + exp(-T(x)))``, H and T two ``Linear``
    (size, size) made at build when ``size`` is None; T's bias starts 2
    lower, so a fresh unit mostly carries its input. ``activation`` (a
    callable) applies to H(x)."""

    def __init__(self, size: Optional[int] = None, with_bias: bool = True, activation=None,
                 w_regularizer=None, b_regularizer=None, device=None):
        super().__init__(device=device)
        self.size = size
        self.with_bias = with_bias
        self.regs = (w_regularizer, b_regularizer)
        self.activation = activation

    def build(self, generator, sample) -> None:
        if self._built:
            raise RuntimeError(f"{self.name()} is already built")
        size = self.size if self.size is not None else sample.shape[-1]
        if not self._layers:  # size=None: the children are made here
            self.add(Linear(size, size, self.with_bias, *self.regs, device=self._device))
            self.add(Linear(size, size, self.with_bias, *self.regs, device=self._device))
        h, t = self._layers
        with torch.no_grad():
            self._build_child(h, generator, sample)
            self._build_child(t, generator, sample)
            tp = t.get_parameters()
            if "bias" in tp:
                tp["bias"].sub_(2.0)  # carry-biased
        self._built = True

    def infer_shape(self, in_spec):
        shape = tuple(in_spec.shape)
        if self.size is not None and shape[-1] != self.size:
            raise ValueError(f"{self.name()}: declared size {self.size}, got last dim "
                             f"{shape[-1]} (input shape {shape})")
        return spec(shape, torch.promote_types(precision.result_dtype(in_spec.dtype),
                                               in_spec.dtype))

    def _apply_params(self, params, state, x, training, rng):
        hm, tm = self._layers
        h, hs = hm._apply_params(params[hm.name()], state[hm.name()], x, training, rng)
        if self.activation is not None:
            h = self.activation(h)
        t, ts = tm._apply_params(params[tm.name()], state[tm.name()], x, training, rng)
        gate = 1.0 / (1.0 + torch.exp(-t))
        return gate * h + (1.0 - gate) * x, {hm.name(): hs, tm.name(): ts}
