"""Activations (counterpart of ``bigdl_tpu/nn/activations.py``; reference:
one file per layer under ``$DL/nn/``). ``inplace`` is accepted and ignored.

Each is the JAX package's expression in torch ops, with its gradient:

* ``jnp.clip`` (``ReLU6``, ``HardSigmoid``, ``HardTanh``) is written
  ``torch.minimum(torch.maximum(x, lo), hi)``, whose gradient at an exact
  bound is 1/2, as ``jnp.clip``'s is (``torch.clamp`` gives 1 there); an
  exact zero into ``ReLU`` takes half the gradient for the same reason;
* ``GELU`` is the tanh approximation (``jax.nn.gelu``'s default);
* ``SoftPlus`` is ``log(1 + exp(βx)) / β`` with no threshold
  (``jax.nn.softplus``; ``F.softplus`` switches to ``x`` above βx = 20);
* ``SoftMax`` and ``LogSoftMax`` compute and return float32 (the loss
  head); ``SoftMin`` stays in ``x``'s dtype.

The comparisons are the JAX package's: ``>=`` for ``LeakyReLU``, ``PReLU``
and ``RReLU``; ``>`` for ``ELU``, ``SELU``, ``Threshold`` and
``ThresholdedReLU``; ``>=``/``<=`` for ``SReLU``. ``RReLU`` draws its
training slopes on the input's device from the module's generator, so they
differ from ``jax.random``'s; in eval mode (or without a generator) it is
the leaky ReLU of the mean slope.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..utils import precision
from .dropout import _device_generator
from .math_ops import _clip, _relu
from .module import AbstractModule, spec


class _Elementwise(AbstractModule):
    """A parameter-less activation: ``_fn(x, params, training, rng)``."""

    infer_shape = AbstractModule._infer_shape_via_apply  # parameter-less

    def __init__(self, inplace: bool = False, device=None):
        super().__init__(device)
        self.inplace = inplace

    def _fn(self, x, params, training, rng):
        raise NotImplementedError

    def _apply_params(self, params, state, x, training, rng):
        return self._fn(x, params, training, rng), state


class ReLU(_Elementwise):
    """max(0, x) (reference: $DL/nn/ReLU.scala)."""

    def _fn(self, x, params, training, rng):
        return _relu(x)


class ReLU6(_Elementwise):
    """min(max(0, x), 6) (reference: $DL/nn/ReLU6.scala)."""

    def _fn(self, x, params, training, rng):
        return _clip(x, 0.0, 6.0)


class Threshold(_Elementwise):
    """x if x > th else v (reference: $DL/nn/Threshold.scala)."""

    def __init__(self, th: float = 1e-6, v: float = 0.0, inplace: bool = False, device=None):
        super().__init__(inplace, device)
        self.th, self.v = th, v

    def _fn(self, x, params, training, rng):
        return torch.where(x > self.th, x, self.v)


class Tanh(_Elementwise):
    """tanh(x) in ``x``'s dtype."""

    def _fn(self, x, params, training, rng):
        return torch.tanh(x)


class Sigmoid(_Elementwise):
    """1 / (1 + exp(-x)) in ``x``'s dtype."""

    def _fn(self, x, params, training, rng):
        return torch.sigmoid(x)


class HardSigmoid(_Elementwise):
    """clip(0.2x + 0.5, 0, 1) (reference: $DL/nn/HardSigmoid.scala)."""

    def _fn(self, x, params, training, rng):
        return _clip(0.2 * x + 0.5, 0.0, 1.0)


class HardTanh(_Elementwise):
    """clip(x, min_value, max_value) (reference: $DL/nn/HardTanh.scala)."""

    def __init__(self, min_value: float = -1.0, max_value: float = 1.0, inplace: bool = False,
                 device=None):
        super().__init__(inplace, device)
        self.min_value, self.max_value = min_value, max_value

    def _fn(self, x, params, training, rng):
        return _clip(x, self.min_value, self.max_value)


class ELU(_Elementwise):
    """x if x > 0 else alpha·(exp(x) - 1)."""

    def __init__(self, alpha: float = 1.0, inplace: bool = False, device=None):
        super().__init__(inplace, device)
        self.alpha = alpha

    def _fn(self, x, params, training, rng):
        return torch.where(x > 0, x, self.alpha * torch.expm1(x))


class SELU(_Elementwise):
    """scale·ELU(x) with SELU's alpha and scale."""

    _ALPHA = 1.6732632423543772
    _SCALE = 1.0507009873554805

    def _fn(self, x, params, training, rng):
        return self._SCALE * torch.where(x > 0, x, self._ALPHA * torch.expm1(x))


class LeakyReLU(_Elementwise):
    """x if x >= 0 else negval·x."""

    def __init__(self, negval: float = 0.01, inplace: bool = False, device=None):
        super().__init__(inplace, device)
        self.negval = negval

    def _fn(self, x, params, training, rng):
        return torch.where(x >= 0, x, self.negval * x)


class PReLU(AbstractModule):
    """Learned negative slope (reference: $DL/nn/PReLU.scala): ``weight``
    (n_output_plane,) per channel on dim 1, or one shared slope when
    ``n_output_plane == 0``; initialised to 0.25. The result is promoted
    with the fp32 slope, as in the JAX package."""

    def infer_shape(self, in_spec):
        shape = tuple(in_spec.shape)
        if self.n_output_plane > 0:
            if len(shape) < 2:
                raise ValueError(f"{self.name()}: per-channel slopes need an (N, C, ...) "
                                 f"input, got shape {shape}")
            if shape[1] != self.n_output_plane:
                raise ValueError(f"{self.name()}: expected {self.n_output_plane} channels at "
                                 f"dim 1, got {shape[1]} (input shape {shape})")
        return spec(shape, torch.promote_types(in_spec.dtype, torch.float32))

    def __init__(self, n_output_plane: int = 0, device=None):
        super().__init__(device)
        self.n_output_plane = n_output_plane

    def _build(self, generator, sample):
        n = self.n_output_plane
        if n > 0:
            shape = tuple(sample.shape)
            if len(shape) < 2:
                raise ValueError(f"{self.name()}: per-channel slopes need an (N, C, ...) "
                                 f"input, got shape {shape}")
            if shape[1] != n:
                raise ValueError(f"{self.name()}: expected {n} channels at dim 1, got "
                                 f"{shape[1]} (input shape {shape})")
        return {"weight": torch.full((max(n, 1),), 0.25)}, {}

    def _apply_params(self, params, state, x, training, rng):
        w = params["weight"]
        if self.n_output_plane > 0:
            w = w.reshape((1, -1) + (1,) * (x.dim() - 2))
        return torch.where(x >= 0, x, w * x), state


class RReLU(AbstractModule):
    """Randomized leaky ReLU (reference: $DL/nn/RReLU.scala): in training
    each element's slope ~ U(lower, upper), drawn on ``x``'s device; in eval
    mode (or without a generator) the mean slope (lower + upper) / 2."""

    infer_shape = AbstractModule._infer_shape_via_apply  # parameter-less

    def __init__(self, lower: float = 1.0 / 8, upper: float = 1.0 / 3, inplace: bool = False,
                 device=None):
        super().__init__(device)
        self.lower, self.upper = lower, upper

    def _apply_params(self, params, state, x, training, rng):
        if training and rng is not None:
            gen = _device_generator(rng, x.device)
            a = torch.empty(x.shape, dtype=x.dtype, device=x.device).uniform_(
                self.lower, self.upper, generator=gen)
        else:
            a = (self.lower + self.upper) / 2.0
        return torch.where(x >= 0, x, a * x), state


class SoftMax(AbstractModule):
    """Softmax over the last dim, computed and returned in float32 (the loss
    head; reference: $DL/nn/SoftMax.scala)."""

    infer_shape = AbstractModule._infer_shape_via_apply  # parameter-less

    def _apply_params(self, params, state, x, training, rng):
        return torch.softmax(precision.to_float(x), dim=-1), state


class LogSoftMax(AbstractModule):
    """log-softmax over the last dim, in float32 (the loss head)."""

    infer_shape = AbstractModule._infer_shape_via_apply  # parameter-less

    def _apply_params(self, params, state, x, training, rng):
        return torch.log_softmax(precision.to_float(x), dim=-1), state


class SoftPlus(_Elementwise):
    """log(1 + exp(β·x)) / β, without a threshold (``jax.nn.softplus``)."""

    def __init__(self, beta: float = 1.0, device=None):
        super().__init__(device=device)
        self.beta = beta

    def _fn(self, x, params, training, rng):
        bx = self.beta * x
        # one rounding on every device: the card's ATen divides by a host
        # scalar as a product with its reciprocal (precision.true_div)
        return precision.true_div(torch.logaddexp(bx, torch.zeros_like(bx)), self.beta)


class SoftSign(_Elementwise):
    """x / (1 + |x|)."""

    def _fn(self, x, params, training, rng):
        return x / (1.0 + torch.abs(x))


class SoftMin(_Elementwise):
    """softmax(-x) over the last dim, in ``x``'s dtype."""

    def _fn(self, x, params, training, rng):
        return torch.softmax(-x, dim=-1)


class GELU(_Elementwise):
    """GELU, tanh approximation (``jax.nn.gelu``'s default)."""

    def _fn(self, x, params, training, rng):
        return F.gelu(x, approximate="tanh")


class Swish(_Elementwise):
    """x·sigmoid(x)."""

    def _fn(self, x, params, training, rng):
        return x * torch.sigmoid(x)


class ThresholdedReLU(AbstractModule):
    """x if x > theta else 0 (reference: keras ``ThresholdedReLU``)."""

    infer_shape = AbstractModule._infer_shape_via_apply  # parameter-less

    def __init__(self, theta: float = 1.0, device=None):
        super().__init__(device)
        self.theta = theta

    def _apply_params(self, params, state, x, training, rng):
        return torch.where(x > self.theta, x, 0.0), state


class SReLU(AbstractModule):
    """S-shaped ReLU with four learned tensors over the non-batch dims
    (reference: ``$DL/nn/SReLU.scala``)::

        f(x) = t_r + a_r (x - t_r)   for x >= t_r
             = x                     for t_l < x < t_r
             = t_l + a_l (x - t_l)   for x <= t_l

    ``shared_axes`` (1-based, batch excluded) share the tensors over those
    axes, e.g. (2, 3) over H and W of NCHW. ``t_left`` and ``a_left`` start
    at 0, ``t_right`` U(0, 1), ``a_right`` 1."""

    def infer_shape(self, in_spec):
        shape = tuple(in_spec.shape)
        if len(shape) < 2:
            raise ValueError(f"{self.name()}: needs an (N, ...) input with non-batch dims, "
                             f"got shape {shape}")
        for ax in self.shared_axes:
            if not 1 <= ax <= len(shape) - 1:
                raise ValueError(f"{self.name()}: shared axis {ax} out of range for input "
                                 f"shape {shape} (1-based, batch excluded)")
        return spec(shape, torch.promote_types(in_spec.dtype, torch.float32))

    def __init__(self, shared_axes=None, device=None):
        super().__init__(device)
        self.shared_axes = tuple(shared_axes) if shared_axes else ()

    def _build(self, generator, sample):
        shape = tuple(sample.shape)
        if len(shape) < 2:
            raise ValueError(f"{self.name()}: needs an (N, ...) input with non-batch dims, "
                             f"got shape {shape}")
        pshape = list(shape[1:])
        for ax in self.shared_axes:
            if not 1 <= ax <= len(shape) - 1:
                raise ValueError(f"{self.name()}: shared axis {ax} out of range for input "
                                 f"shape {shape} (1-based, batch excluded)")
            pshape[ax - 1] = 1
        return {"t_left": torch.zeros(pshape), "a_left": torch.zeros(pshape),
                "t_right": torch.empty(pshape).uniform_(0.0, 1.0, generator=generator),
                "a_right": torch.ones(pshape)}, {}

    def _apply_params(self, params, state, x, training, rng):
        tl, al = params["t_left"], params["a_left"]
        tr, ar = params["t_right"], params["a_right"]
        y = torch.where(x >= tr, tr + ar * (x - tr), x)
        return torch.where(x <= tl, tl + al * (x - tl), y), state
