"""Elementwise and reduction math layers (counterpart of
``bigdl_tpu/nn/math_ops.py``; reference: one file each under ``$DL/nn/``:
Abs.scala, Power.scala, CMul.scala, Sum.scala, Bilinear.scala,
Euclidean.scala, ...).

The elementwise layers are the JAX package's expressions in torch ops.
``Clamp`` is ``torch.minimum(torch.maximum(x, lo), hi)``, whose gradient at
an exact bound is 1/2 as ``jnp.clip``'s (``torch.clamp`` gives 1), and
``Abs``'s gradient at 0 is 1 as ``jnp.abs``'s (``torch.abs`` gives 0). The
learned ones keep the JAX parameter names and shapes (``weight``, ``bias``)
and promote with their fp32 parameters as ``jnp`` does: ``Bilinear`` and
``Cosine`` cast their operands to the promoted dtype before a product,
which torch would otherwise refuse for mixed dtypes. ``Euclidean`` adds
1e-12 under its square root and ``Cosine`` clips each norm at 1e-12, as in
the JAX package; their norms are ``sqrt(sum(v²))`` as ``jnp.linalg.norm``'s,
with its NaN gradient at a zero vector.

The reductions' ``dimension`` is 1-based (Torch convention). With
``n_input_dims > 0`` and an input of more dims than that, the axis moves
one past the batch dim, so ``Max(1, n_input_dims=2)`` on (N, T, C) reduces
T. ``squeeze=False`` keeps the reduced dim with extent 1.

``Max`` and ``Min`` are ``torch.amax``/``torch.amin``, whose gradient is
split evenly among tied extrema, as ``jnp.max``'s is (``torch.max(x, dim)``
would route all of it to one index).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from .initialization import RandomUniform
from ..utils.table import Table
from .module import AbstractModule, spec


def _promote(*ts: torch.Tensor):
    """``ts`` cast to their promoted dtype (``jnp``'s implicit promotion)."""
    dt = ts[0].dtype
    for t in ts[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return [t.to(dt) for t in ts]


def _norm(v: torch.Tensor, dim: int = -1, keepdim: bool = False) -> torch.Tensor:
    """``jnp.linalg.norm(v, axis=dim)``: sqrt(sum(v²)), NaN gradient at 0."""
    return torch.sqrt(torch.sum(v * v, dim=dim, keepdim=keepdim))


def _abs(x: torch.Tensor) -> torch.Tensor:
    """``jnp.abs(x)`` with its gradient: 1 at x == 0 (``torch.abs`` gives 0)."""
    return torch.where(x >= 0, x, -x)


def _clip_min(v: torch.Tensor, lo: float) -> torch.Tensor:
    """``jnp.clip(v, lo)``: max(v, lo) with its gradient (1/2 at v == lo).
    The bound is filled on ``v``'s device (``new_full``), not copied from
    the host, so a forward on the card does not wait for a copy."""
    return torch.maximum(v, v.new_full((), lo))


def _clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``jnp.clip(x, lo, hi)`` with its gradient (1/2 at an exact bound)."""
    return torch.minimum(_clip_min(x, lo), x.new_full((), hi))


def _relu(x: torch.Tensor) -> torch.Tensor:
    """``jnp.maximum(x, 0)``: half the gradient at an exact zero."""
    return _clip_min(x, 0.0)


class _Pointwise(AbstractModule):
    """A parameter-less layer ``y = _fn(x)``."""

    infer_shape = AbstractModule._infer_shape_via_apply  # parameter-less

    def _fn(self, x):
        raise NotImplementedError

    def _apply_params(self, params, state, x, training, rng):
        return self._fn(x), state


class Abs(_Pointwise):
    """|x|, with ``jnp.abs``'s gradient of 1 at 0."""

    def _fn(self, x):
        return _abs(x)


class Power(_Pointwise):
    """(shift + scale·x)^power (reference: Power)."""

    def __init__(self, power: float, scale: float = 1.0, shift: float = 0.0, device=None):
        super().__init__(device)
        self.power, self.scale, self.shift = power, scale, shift

    def _fn(self, x):
        return (self.shift + self.scale * x) ** self.power


class Square(_Pointwise):
    def _fn(self, x):
        return x * x


class Sqrt(_Pointwise):
    def _fn(self, x):
        return torch.sqrt(x)


class Log(_Pointwise):
    def _fn(self, x):
        return torch.log(x)


class Exp(_Pointwise):
    def _fn(self, x):
        return torch.exp(x)


class Clamp(_Pointwise):
    """clip(x, min_value, max_value), with ``jnp.clip``'s gradient."""

    def __init__(self, min_value: float, max_value: float, device=None):
        super().__init__(device)
        self.min_value, self.max_value = min_value, max_value

    def _fn(self, x):
        return _clip(x, self.min_value, self.max_value)


class MulConstant(_Pointwise):
    def __init__(self, scalar: float, inplace: bool = False, device=None):
        super().__init__(device)
        self.scalar = scalar

    def _fn(self, x):
        return x * self.scalar


class AddConstant(_Pointwise):
    def __init__(self, constant_scalar: float, inplace: bool = False, device=None):
        super().__init__(device)
        self.constant_scalar = constant_scalar

    def _fn(self, x):
        return x + self.constant_scalar


class Neg(_Pointwise):
    def _fn(self, x):
        return -x


class Mul(AbstractModule):
    """One learned scalar multiplier ``weight`` (1,) (reference: Mul)."""

    def infer_shape(self, in_spec):
        return spec(torch.broadcast_shapes(tuple(in_spec.shape), (1,)),
                    torch.promote_types(in_spec.dtype, torch.float32))

    def _build(self, generator, sample):
        return {"weight": RandomUniform()(generator, (1,), 1, 1)}, {}

    def _apply_params(self, params, state, x, training, rng):
        return x * params["weight"], state


class Add(AbstractModule):
    """A learned bias over the non-batch dims, ``bias`` of the input's shape
    without its batch dim, zeros at first (reference: Add). ``input_size``
    is kept as the JAX package keeps it (the shape comes from the input)."""

    def infer_shape(self, in_spec):
        return spec(tuple(in_spec.shape), torch.promote_types(in_spec.dtype, torch.float32))

    def __init__(self, input_size: Optional[int] = None, device=None):
        super().__init__(device)
        self.input_size = input_size

    def _build(self, generator, sample):
        return {"bias": torch.zeros(tuple(sample.shape[1:]))}, {}

    def _apply_params(self, params, state, x, training, rng):
        return x + params["bias"], state


def _check_broadcast(module, what: str, size, shape) -> None:
    try:
        torch.broadcast_shapes(tuple(shape), tuple(size))
    except RuntimeError:
        raise ValueError(f"{module.name()}: {what} size {tuple(size)} does not broadcast "
                         f"with input shape {tuple(shape)}") from None


class CMul(AbstractModule):
    """A learned componentwise scale ``weight`` of ``size`` (Torch's
    convention, a leading 1 for the batch: (1, C, 1, 1) per channel),
    broadcast over the input (reference: CMul)."""

    def infer_shape(self, in_spec):
        _check_broadcast(self, "weight", self.size, in_spec.shape)
        return spec(torch.broadcast_shapes(tuple(in_spec.shape), self.size),
                    torch.promote_types(in_spec.dtype, torch.float32))

    def __init__(self, size: Sequence[int], device=None):
        super().__init__(device)
        self.size = tuple(size)

    def _build(self, generator, sample):
        _check_broadcast(self, "weight", self.size, sample.shape)
        n = int(np.prod(self.size))
        return {"weight": RandomUniform()(generator, self.size, n, n)}, {}

    def _apply_params(self, params, state, x, training, rng):
        return x * params["weight"], state


class CAdd(AbstractModule):
    """A learned componentwise bias ``bias`` of ``size``, zeros at first,
    broadcast over the input (reference: CAdd)."""

    def infer_shape(self, in_spec):
        _check_broadcast(self, "bias", self.size, in_spec.shape)
        return spec(torch.broadcast_shapes(tuple(in_spec.shape), self.size),
                    torch.promote_types(in_spec.dtype, torch.float32))

    def __init__(self, size: Sequence[int], device=None):
        super().__init__(device)
        self.size = tuple(size)

    def _build(self, generator, sample):
        _check_broadcast(self, "bias", self.size, sample.shape)
        return {"bias": torch.zeros(self.size)}, {}

    def _apply_params(self, params, state, x, training, rng):
        return x + params["bias"], state


class _Reduce(AbstractModule):
    """A reduction over the 1-based ``dimension`` (see module docstring)."""

    infer_shape = AbstractModule._infer_shape_via_apply  # parameter-less

    def __init__(self, dimension: int = 1, n_input_dims: int = -1, size_average: bool = False,
                 squeeze: bool = True, device=None):
        super().__init__(device)
        self.dimension = dimension
        self.n_input_dims = n_input_dims
        self.size_average = size_average
        self.squeeze = squeeze

    def _axis(self, x: torch.Tensor) -> int:
        d = self.dimension - 1
        if self.n_input_dims > 0 and x.dim() > self.n_input_dims:
            d += 1
        return d

    def _reduce(self, x: torch.Tensor, axis: int) -> torch.Tensor:
        raise NotImplementedError

    def _apply_params(self, params, state, x, training, rng):
        axis = self._axis(x)
        y = self._reduce(x, axis)
        if not self.squeeze:
            y = y.unsqueeze(axis)
        return y, state


class Sum(_Reduce):
    """Sum; divided by the dim's extent with ``size_average``."""

    def _reduce(self, x, axis):
        y = torch.sum(x, dim=axis)
        if self.size_average:
            y = y / x.shape[axis]
        return y


class Mean(_Reduce):
    def _reduce(self, x, axis):
        return torch.mean(x, dim=axis)


class Max(_Reduce):
    def _reduce(self, x, axis):
        return torch.amax(x, dim=axis)


class Min(_Reduce):
    def _reduce(self, x, axis):
        return torch.amin(x, dim=axis)


def _pair(x):
    from .table_ops import _as_list

    return _as_list(x)[:2]


class Bilinear(AbstractModule):
    """y_k = x1ᵀ W_k x2 + b_k over Table(x1, x2) (reference: Bilinear):
    ``weight`` (output_size, input_size1, input_size2) ``RandomUniform``
    with fan-in input_size1·input_size2, ``bias`` (output_size) zeros when
    ``bias_res``."""

    accepts_table_input = True  # consumes a multi-parent Table when graph-wired

    def infer_shape(self, in_spec):
        xs = in_spec.to_list() if isinstance(in_spec, Table) else list(in_spec)
        if len(xs) < 2:
            raise ValueError(f"{self.name()}: expects Table(x1, x2), got {len(xs)} input(s)")
        a, b = xs[0], xs[1]
        if a.shape[-1] != self.input_size1 or b.shape[-1] != self.input_size2:
            raise ValueError(f"{self.name()}: declared input sizes ({self.input_size1}, "
                             f"{self.input_size2}), got shapes {tuple(a.shape)} and "
                             f"{tuple(b.shape)}")
        return spec((a.shape[0], self.output_size),
                    torch.promote_types(torch.promote_types(a.dtype, b.dtype), torch.float32))

    def __init__(self, input_size1: int, input_size2: int, output_size: int,
                 bias_res: bool = True, device=None):
        super().__init__(device)
        self.input_size1 = input_size1
        self.input_size2 = input_size2
        self.output_size = output_size
        self.bias_res = bias_res

    def _build(self, generator, sample):
        from .table_ops import _as_list

        xs = _as_list(sample)
        if len(xs) < 2:
            raise ValueError(f"{self.name()}: expects Table(x1, x2), got {len(xs)} input(s)")
        a, b = xs[0], xs[1]
        if a.shape[-1] != self.input_size1 or b.shape[-1] != self.input_size2:
            raise ValueError(f"{self.name()}: declared input sizes ({self.input_size1}, "
                             f"{self.input_size2}), got shapes {tuple(a.shape)} and "
                             f"{tuple(b.shape)}")
        params = {"weight": RandomUniform()(
            generator, (self.output_size, self.input_size1, self.input_size2),
            self.input_size1 * self.input_size2, self.output_size)}
        if self.bias_res:
            params["bias"] = torch.zeros((self.output_size,))
        return params, {}

    def _apply_params(self, params, state, x, training, rng):
        a, b, w = _promote(*_pair(x), params["weight"])
        y = torch.einsum("ni,oij,nj->no", a, w, b)
        if self.bias_res:
            y = y + params["bias"]
        return y, state


class Euclidean(AbstractModule):
    """The distance from the input to each of ``output_size`` learned
    centres, the columns of ``weight`` (input_size, output_size):
    sqrt(sum((x - w)²) + 1e-12) (reference: Euclidean)."""

    def infer_shape(self, in_spec):
        shape = tuple(in_spec.shape)
        if len(shape) != 2 or shape[-1] != self.input_size:
            raise ValueError(f"{self.name()}: expects (N, {self.input_size}) input, got "
                             f"shape {shape}")
        return spec((shape[0], self.output_size),
                    torch.promote_types(in_spec.dtype, torch.float32))

    def __init__(self, input_size: int, output_size: int, device=None):
        super().__init__(device)
        self.input_size = input_size
        self.output_size = output_size

    def _build(self, generator, sample):
        shape = tuple(sample.shape)
        if len(shape) != 2 or shape[-1] != self.input_size:
            raise ValueError(f"{self.name()}: expects (N, {self.input_size}) input, got "
                             f"shape {shape}")
        return {"weight": RandomUniform()(generator, (self.input_size, self.output_size),
                                          self.input_size, self.output_size)}, {}

    def _apply_params(self, params, state, x, training, rng):
        diff = x[:, :, None] - params["weight"][None, :, :]
        return torch.sqrt(torch.sum(diff * diff, dim=1) + 1e-12), state


class Cosine(AbstractModule):
    """The cosine similarity of the input to each row of ``weight``
    (output_size, input_size), each norm clipped at 1e-12 (reference:
    Cosine)."""

    def infer_shape(self, in_spec):
        shape = tuple(in_spec.shape)
        if shape[-1] != self.input_size:
            raise ValueError(f"{self.name()}: declared input size {self.input_size}, got "
                             f"last dim {shape[-1]} (input shape {shape})")
        return spec(shape[:-1] + (self.output_size,),
                    torch.promote_types(in_spec.dtype, torch.float32))

    def __init__(self, input_size: int, output_size: int, device=None):
        super().__init__(device)
        self.input_size = input_size
        self.output_size = output_size

    def _build(self, generator, sample):
        shape = tuple(sample.shape)
        if shape[-1] != self.input_size:
            raise ValueError(f"{self.name()}: declared input size {self.input_size}, got "
                             f"last dim {shape[-1]} (input shape {shape})")
        return {"weight": RandomUniform()(generator, (self.output_size, self.input_size),
                                          self.input_size, self.output_size)}, {}

    def _apply_params(self, params, state, x, training, rng):
        w = params["weight"]
        xn = x / _clip_min(_norm(x, keepdim=True), 1e-12)
        wn = w / _clip_min(_norm(w, keepdim=True), 1e-12)
        xn, wn = _promote(xn, wn)
        return xn @ wn.T, state


class Scale(AbstractModule):
    """Per-channel affine ``y = x·w + b`` over dim 1 (reference:
    ``$DL/nn/Scale.scala``; Caffe's ``Scale``): ``weight`` ones and ``bias``
    zeros of the channel count, ``size`` or the input's dim 1."""

    def infer_shape(self, in_spec):
        shape = tuple(in_spec.shape)
        if len(shape) < 2:
            raise ValueError(f"{self.name()}: needs a channel dim at axis 1, got shape {shape}")
        if self.size is not None and shape[1] != self.size:
            raise ValueError(f"{self.name()}: declared {self.size} channels, got {shape[1]} "
                             f"(input shape {shape})")
        return spec(shape, torch.promote_types(in_spec.dtype, torch.float32))

    def __init__(self, size: Optional[int] = None, device=None):
        super().__init__(device)
        self.size = size

    def _build(self, generator, sample):
        shape = tuple(sample.shape)
        if len(shape) < 2:
            raise ValueError(f"{self.name()}: needs a channel dim at axis 1, got shape {shape}")
        if self.size is not None and shape[1] != self.size:
            raise ValueError(f"{self.name()}: declared {self.size} channels, got {shape[1]} "
                             f"(input shape {shape})")
        c = self.size if self.size is not None else shape[1]
        return {"weight": torch.ones((c,)), "bias": torch.zeros((c,))}, {}

    def _apply_params(self, params, state, x, training, rng):
        shape = (1, -1) + (1,) * (x.dim() - 2)
        return x * params["weight"].reshape(shape) + params["bias"].reshape(shape), state
