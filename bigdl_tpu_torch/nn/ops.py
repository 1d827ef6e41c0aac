"""Op-granularity modules (counterpart of ``bigdl_tpu/nn/ops.py``; BigDL's
``nn/ops``): the ~60 TF-graph ops the TensorFlow importer
(:mod:`bigdl_tpu_torch.utils.tf_loader`) wires into a ``Graph``.

Each op is a thin ``AbstractModule`` over torch ops. XLA computed them in
the JAX package (no Pallas kernel), so library calls are the port here too.

Binary ops take a Table/list of two inputs (the reference's convention);
unary ops take a tensor. Stateful TF ops (``Variable``/``Assign``) map onto
the module parameter/state system.

The JAX package runs with 64-bit types off, so its ops turn a GraphDef's
``DT_INT64``/``DT_DOUBLE`` values into int32/float32 (``Cast``, ``Const``,
``Variable``), return int32 shapes and indices, and sum or multiply
integers in int32. The port follows: :func:`narrow_dtype` is the rule.
Ops whose torch name differs from their meaning: ``Mod`` is the floor
modulus (``torch.remainder``, not ``fmod``), ``TruncatedDivide`` truncates
a true division, ``TopKOp`` breaks ties by the lower index (a stable sort,
as ``lax.top_k``), ``Merge`` takes a 1-based index clipped to its inputs
and ``Switch`` zeroes the side not taken. ``Conv2D`` and the pools take
NHWC only; their ``SAME`` padding puts the odd pad at the end, ``MaxPool``
pads with -inf and ``AvgPool`` divides by the count of valid elements.
"""

from __future__ import annotations

import inspect
from typing import Any, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..utils import precision
from ..utils.table import Table
from .module import AbstractModule

_NARROW = {torch.int64: torch.int32, torch.float64: torch.float32}


def narrow_dtype(dtype) -> torch.dtype:
    """The dtype a value of ``dtype`` (numpy or torch) takes in the port:
    64-bit integers and floats narrow to 32 bits, as in the JAX package."""
    if not isinstance(dtype, torch.dtype):
        dtype = torch.from_numpy(np.zeros(0, np.dtype(dtype))).dtype
    return _NARROW.get(dtype, dtype)


def as_op_tensor(value, device=None) -> torch.Tensor:
    """``value`` (an array, a tensor or a number) as a tensor of its narrowed
    dtype on ``device`` (the JAX package's ``jnp.asarray``)."""
    if isinstance(value, torch.Tensor):
        t = value.detach()
    else:
        arr = np.asarray(value)
        if not (arr.flags.c_contiguous and arr.flags.writeable):
            arr = arr.copy(order="C")  # a 0-d value stays 0-d
        t = torch.from_numpy(arr)
    t = t.to(narrow_dtype(t.dtype))
    return t if device is None else t.to(device)


def _two(x):
    if isinstance(x, Table):
        vals = x.to_list()
    elif isinstance(x, (list, tuple)):
        vals = list(x)
    else:
        raise TypeError(f"expected a two-element Table, got {type(x)}")
    return vals[0], vals[1]


def _values(x):
    return x.to_list() if isinstance(x, Table) else list(x)


def _int32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.int32)


class _Unary(AbstractModule):
    _fn: Any = None

    def _apply_params(self, params, state, x, training, rng):
        return type(self)._fn(x), state


class _Binary(AbstractModule):
    _fn: Any = None

    def _apply_params(self, params, state, x, training, rng):
        a, b = _two(x)
        return type(self)._fn(a, b), state


# ----------------------------------------------------------- const / shape
class Const(AbstractModule):
    """Emit a constant regardless of input (reference: ops/Const). The value
    is a buffer on the module's device (it follows ``.to()``)."""

    graph_source = True  # legitimately wired with zero parents in a Graph

    def __init__(self, value, device=None):
        super().__init__(device)
        self.register_buffer("value", as_op_tensor(value, self._device), persistent=False)

    def _apply_params(self, params, state, x, training, rng):
        return self.value, state


class Variable(AbstractModule):
    """Mutable graph state: the initial value becomes a TRAINABLE parameter.

    Wired with zero parents by the TF importer. The reference's
    ``BigDLSessionImpl`` trains imported TF graphs by binding tf Variable
    nodes to weight storage; here a Variable is a parameter-emitting source
    module, so an imported graph containing them fine-tunes through any
    optimizer. ``utils.tf_session.TFSession`` creates these from
    VariableV2+Assign node pairs (and, with ``trainable=True``, from a
    frozen graph's float Consts)."""

    def __init__(self, initial_value, device=None):
        super().__init__(device)
        self.initial_value = as_op_tensor(initial_value)

    def _build(self, generator, sample):
        return {"value": self.initial_value.clone()}, {}

    def _apply_params(self, params, state, x, training, rng):
        return params["value"], state


class Shape(AbstractModule):
    def _apply_params(self, params, state, x, training, rng):
        return torch.tensor(tuple(x.shape), dtype=torch.int32, device=x.device), state


class Rank(AbstractModule):
    def _apply_params(self, params, state, x, training, rng):
        return torch.tensor(x.dim(), dtype=torch.int32, device=x.device), state


class SizeOp(AbstractModule):
    def _apply_params(self, params, state, x, training, rng):
        return torch.tensor(x.numel(), dtype=torch.int32, device=x.device), state


class Cast(AbstractModule):
    """Cast to ``dtype`` (a numpy dtype or name), narrowed as in the JAX
    package: int64 -> int32, float64 -> float32."""

    def __init__(self, dtype, device=None):
        super().__init__(device)
        self.to_dtype = narrow_dtype(np.dtype(dtype))

    def _apply_params(self, params, state, x, training, rng):
        dt = self.to_dtype
        if x.is_floating_point() and not dt.is_floating_point and dt != torch.bool:
            # XLA's float -> integer conversion: NaN to 0, out-of-range
            # values saturate (a plain torch cast wraps or is undefined)
            info = torch.iinfo(dt)
            x = torch.nan_to_num(x, nan=0.0)
            y = x.clamp(float(info.min), float(info.max)).to(dt)
            return torch.where(x >= float(info.max), torch.tensor(info.max, dtype=dt,
                                                                  device=x.device), y), state
        return x.to(dt), state


class Fill(AbstractModule):
    """Input: Table(shape tensor, scalar value) -> filled tensor. The output
    shape depends on the input's data (as the TF op's), so the shape comes
    to the host: graph-import glue, not a hot path."""

    def _apply_params(self, params, state, x, training, rng):
        shape, value = _two(x)
        dims = tuple(int(s) for s in torch.as_tensor(shape).tolist())
        v = torch.as_tensor(value)
        return torch.full(dims, v.item(), dtype=narrow_dtype(v.dtype), device=v.device), state


class ExpandDims(AbstractModule):
    def __init__(self, axis: int, device=None):
        super().__init__(device)
        self.axis = axis

    def _apply_params(self, params, state, x, training, rng):
        return torch.unsqueeze(x, self.axis), state


class Tile(AbstractModule):
    def __init__(self, multiples: Sequence[int], device=None):
        super().__init__(device)
        self.multiples = tuple(multiples)

    def _apply_params(self, params, state, x, training, rng):
        return torch.tile(x, self.multiples), state


class Pad(AbstractModule):
    def __init__(self, paddings: Sequence[Sequence[int]], value: float = 0.0, device=None):
        super().__init__(device)
        self.paddings = [tuple(int(v) for v in p) for p in paddings]
        self.value = value

    def _apply_params(self, params, state, x, training, rng):
        flat = [v for p in reversed(self.paddings) for v in p]  # last dim first
        return F.pad(x, flat, value=self.value), state


class SliceOp(AbstractModule):
    """``lax.dynamic_slice``: a negative start counts from the end, then
    each start is clamped so the slice fits."""

    def __init__(self, begin: Sequence[int], size: Sequence[int], device=None):
        super().__init__(device)
        self.begin = tuple(begin)
        self.size = tuple(size)

    def _apply_params(self, params, state, x, training, rng):
        idx = tuple(slice(s, s + n) for s, n in
                    ((min(max(int(b) + (d if int(b) < 0 else 0), 0), d - n), n)
                     for b, n, d in zip(self.begin, self.size, x.shape)))
        return x[idx], state


class OneHot(AbstractModule):
    def __init__(self, depth: int, on_value: float = 1.0, off_value: float = 0.0,
                 device=None):
        super().__init__(device)
        self.depth = depth
        self.on_value = on_value
        self.off_value = off_value

    def _apply_params(self, params, state, x, training, rng):
        idx = x.to(torch.int64)
        # jax.nn.one_hot: an index outside [0, depth) is an all-zero row
        valid = (idx >= 0) & (idx < self.depth)
        oh = F.one_hot(torch.where(valid, idx, 0), self.depth).to(torch.float32)
        oh = oh * valid.unsqueeze(-1)
        return oh * (self.on_value - self.off_value) + self.off_value, state


class GatherOp(AbstractModule):
    """Table(params, indices) -> take along ``axis`` (reference: ops/Gather)."""

    def __init__(self, axis: int = 0, device=None):
        super().__init__(device)
        self.axis = axis

    def _apply_params(self, params, state, x, training, rng):
        table, idx = _two(x)
        axis = self.axis % table.dim()
        out = torch.index_select(table, axis, idx.reshape(-1).to(torch.int64))
        return out.reshape(*table.shape[:axis], *idx.shape, *table.shape[axis + 1:]), state


# ----------------------------------------------------------------- matmul
class MatMul(AbstractModule):
    def __init__(self, transpose_a: bool = False, transpose_b: bool = False, device=None):
        super().__init__(device)
        self.transpose_a = transpose_a
        self.transpose_b = transpose_b

    def _apply_params(self, params, state, x, training, rng):
        a, b = _two(x)
        if self.transpose_a:
            a = a.transpose(-1, -2)
        if self.transpose_b:
            b = b.transpose(-1, -2)
        return precision.matmul(a, b), state


class BiasAdd(AbstractModule):
    def _apply_params(self, params, state, x, training, rng):
        value, bias = _two(x)
        return value + bias, state


class L2Loss(AbstractModule):
    def _apply_params(self, params, state, x, training, rng):
        return torch.sum(x.to(torch.float32) ** 2) / 2.0, state


# ------------------------------------------------------------ comparisons
class Equal(_Binary):
    _fn = staticmethod(torch.eq)


class NotEqual(_Binary):
    _fn = staticmethod(torch.ne)


class Greater(_Binary):
    _fn = staticmethod(torch.gt)


class GreaterEqual(_Binary):
    _fn = staticmethod(torch.ge)


class Less(_Binary):
    _fn = staticmethod(torch.lt)


class LessEqual(_Binary):
    _fn = staticmethod(torch.le)


class LogicalAnd(_Binary):
    _fn = staticmethod(torch.logical_and)


class LogicalOr(_Binary):
    _fn = staticmethod(torch.logical_or)


class LogicalNot(_Unary):
    _fn = staticmethod(torch.logical_not)


class Maximum(_Binary):
    _fn = staticmethod(torch.maximum)


class Minimum(_Binary):
    _fn = staticmethod(torch.minimum)


class SquaredDifference(_Binary):
    _fn = staticmethod(lambda a, b: (a - b) ** 2)


class TruncatedDivide(_Binary):
    """``trunc(a / b)`` with true division (int inputs give float32)."""

    _fn = staticmethod(lambda a, b: torch.trunc(torch.true_divide(a, b)))


class Mod(_Binary):
    """The floor modulus (``jnp.mod``): the result takes the divisor's sign."""

    _fn = staticmethod(torch.remainder)


class SelectOp(AbstractModule):
    """Table(cond, then, else) -> elementwise where (reference: ops/Select)."""

    def _apply_params(self, params, state, x, training, rng):
        cond, a, b = _values(x)[:3]
        return torch.where(cond.to(torch.bool), a, b), state


# -------------------------------------------------------------- reductions
def _reduce(kind: str, x: torch.Tensor, axis, keepdims: bool) -> torch.Tensor:
    """``jnp.<kind>(x, axis, keepdims)`` with 64-bit types off: integer and
    boolean sums and products are int32, an integer mean is float32."""
    dims = tuple(range(x.dim())) if axis is None else tuple(a % max(x.dim(), 1) for a in axis)
    if kind in ("all", "any"):
        b = x.to(torch.bool)
        if not dims or x.dim() == 0:
            return b
        r = torch.amin if kind == "all" else torch.amax
        return r(b.to(torch.uint8), dim=dims, keepdim=keepdims).to(torch.bool)
    integral = not x.is_floating_point() and not x.is_complex()
    if kind == "mean":
        xf = x.to(torch.float32) if integral else x
        return xf if not dims else torch.mean(xf, dim=dims, keepdim=keepdims)
    if kind in ("max", "min"):
        if not dims or x.dim() == 0:
            return x
        r = torch.amax if kind == "max" else torch.amin
        return r(x, dim=dims, keepdim=keepdims)
    if not dims:
        return x.to(torch.int32) if integral else x
    if kind == "sum":
        out = torch.sum(x, dim=dims, keepdim=keepdims)
    else:  # prod: torch takes one dim at a time
        out = x.to(torch.int64) if integral else x
        for d in sorted(dims, reverse=True):
            out = torch.prod(out, dim=d, keepdim=keepdims)
    return out.to(torch.int32) if integral else out


class _Reduction(AbstractModule):
    _kind = ""

    def __init__(self, axis: Optional[Sequence[int]] = None, keep_dims: bool = False,
                 device=None):
        super().__init__(device)
        self.axis = tuple(axis) if axis is not None else None
        self.keep_dims = keep_dims

    def _apply_params(self, params, state, x, training, rng):
        return _reduce(self._kind, x, self.axis, self.keep_dims), state


class ReduceSum(_Reduction):
    _kind = "sum"


class ReduceMean(_Reduction):
    _kind = "mean"


class ReduceProd(_Reduction):
    _kind = "prod"


class ReduceMax(_Reduction):
    _kind = "max"


class ReduceMin(_Reduction):
    _kind = "min"


class All(_Reduction):
    _kind = "all"


class Any(_Reduction):
    _kind = "any"


class ArgMax(AbstractModule):
    def __init__(self, axis: int = 0, device=None):
        super().__init__(device)
        self.axis = axis

    def _apply_params(self, params, state, x, training, rng):
        return _int32(torch.argmax(x, dim=self.axis)), state


class ArgMin(AbstractModule):
    def __init__(self, axis: int = 0, device=None):
        super().__init__(device)
        self.axis = axis

    def _apply_params(self, params, state, x, training, rng):
        return _int32(torch.argmin(x, dim=self.axis)), state


class TopKOp(AbstractModule):
    """(values, indices) of the top k along the last dim (reference:
    ops/TopK); among equal values the lower index comes first, as
    ``lax.top_k`` orders them (a stable descending sort)."""

    def __init__(self, k: int, device=None):
        super().__init__(device)
        self.k = k

    def _apply_params(self, params, state, x, training, rng):
        v, i = torch.sort(x, dim=-1, descending=True, stable=True)
        return (v[..., :self.k], _int32(i[..., :self.k])), state


# ------------------------------------------------------- elementwise unary
class Rsqrt(_Unary):
    _fn = staticmethod(lambda x: 1.0 / torch.sqrt(x))


class Erf(_Unary):
    _fn = staticmethod(torch.erf)


class Inv(_Unary):
    _fn = staticmethod(lambda x: 1.0 / x)


class Round(_Unary):
    """Round half to even (``jnp.round``)."""

    _fn = staticmethod(torch.round)


class Floor(_Unary):
    _fn = staticmethod(torch.floor)


class Ceil(_Unary):
    _fn = staticmethod(torch.ceil)


class Expm1(_Unary):
    _fn = staticmethod(torch.expm1)


class IsFinite(_Unary):
    _fn = staticmethod(torch.isfinite)


class IsInf(_Unary):
    _fn = staticmethod(torch.isinf)


class IsNan(_Unary):
    _fn = staticmethod(torch.isnan)


class Sign(_Unary):
    """``jnp.sign``: NaN stays NaN (``torch.sign`` gives 0)."""

    _fn = staticmethod(lambda x: torch.where(torch.isnan(x), x, torch.sign(x))
                       if x.is_floating_point() else torch.sign(x))


# ------------------------------------------------------- stateful TF ops
class Assign(AbstractModule):
    """Table(ref_like, value) -> value, recording it in module state
    (reference: ops/Assign — TF mutation mapped to the state tree)."""

    def _apply_params(self, params, state, x, training, rng):
        _, value = _two(x)
        return value, {"value": value}


# ------------------------------------------------------------ control flow
class Switch(AbstractModule):
    """Table(data, pred) -> (false_branch, true_branch) pair where the side
    not taken is zeros (reference: tf/ControlNodes Switch; as in the JAX
    package both sides exist and the predicate selects)."""

    def _apply_params(self, params, state, x, training, rng):
        data, pred = _two(x)
        z = torch.zeros_like(data)
        p = torch.as_tensor(pred, device=data.device).to(torch.bool)
        return (torch.where(p, z, data), torch.where(p, data, z)), state


class Merge(AbstractModule):
    """Table of a 1-based index scalar and candidate inputs -> the one it
    picks, the index clipped to the candidates (reference: tf/ControlNodes
    Merge)."""

    def _apply_params(self, params, state, x, training, rng):
        vals = _values(x)
        idx, rest = vals[0], vals[1:]
        stacked = torch.stack(rest)
        i = torch.clamp(torch.as_tensor(idx, device=stacked.device).to(torch.int64) - 1,
                        0, len(rest) - 1)
        return stacked[i], state


# ------------------------------------------------- TF-graph conv/pool ops
def _same_pads(size: int, k: int, s: int, d: int = 1) -> Tuple[int, int]:
    """TF's SAME padding of one spatial dim: the odd pad goes at the end."""
    out = -(-size // s)
    total = max((out - 1) * s + (k - 1) * d + 1 - size, 0)
    return total // 2, total - total // 2


def _pads(padding: str, hw, kernel, strides, dilation=(1, 1)):
    if padding == "VALID":
        return (0, 0), (0, 0)
    if padding == "SAME":
        return tuple(_same_pads(n, k, s, d) for n, k, s, d in
                     zip(hw, kernel, strides, dilation))
    raise ValueError(f"unsupported TF padding {padding!r} (SAME or VALID)")


class Conv2D(AbstractModule):
    """Table(input NHWC, filter HWIO) -> conv (reference: ops/Conv2D used by
    the TF loader; the native-layer path is nn.SpatialConvolution). Under
    the dtype policy as ``precision.conv2d``; cuDNN's on the card."""

    def __init__(self, strides, padding: str, data_format: str = "NHWC", dilations=None,
                 device=None):
        super().__init__(device)
        if data_format != "NHWC":
            raise ValueError("Conv2D op supports NHWC (TF default) only")
        self.strides = tuple(strides)  # [1, sh, sw, 1]
        self.padding = padding
        self.dilations = tuple(dilations) if dilations else (1, 1, 1, 1)

    def _apply_params(self, params, state, x, training, rng):
        inp, w = _two(x)
        dil = self.dilations[1:3]
        pads = _pads(self.padding, inp.shape[1:3], w.shape[:2], self.strides[1:3], dil)
        y = precision.conv2d(inp.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                             self.strides[1:3], pads, dilation=dil)
        return y.permute(0, 2, 3, 1), state


class _Pool2DOp(AbstractModule):
    def __init__(self, ksize, strides, padding: str, data_format: str = "NHWC", device=None):
        super().__init__(device)
        if data_format != "NHWC":
            raise ValueError("pool ops support NHWC (TF default) only")
        self.ksize = tuple(ksize)
        self.strides = tuple(strides)
        self.padding = padding

    def _window(self, x: torch.Tensor, fill: float):
        """``x`` as NCHW, padded with ``fill`` for the window, and the 2-D
        kernel and stride (TF's NHWC ksize/strides carry 1 at N and C)."""
        if self.ksize[0] != 1 or self.ksize[3] != 1 or self.strides[0] != 1 \
                or self.strides[3] != 1:
            raise ValueError("pool ops window over H and W only (ksize/strides "
                             "[1, h, w, 1])")
        k, s = self.ksize[1:3], self.strides[1:3]
        (ht, hb), (wl, wr) = _pads(self.padding, x.shape[1:3], k, s)
        xc = x.permute(0, 3, 1, 2)
        if ht or hb or wl or wr:
            xc = F.pad(xc, (wl, wr, ht, hb), value=fill)
        return xc, k, s


class MaxPool(_Pool2DOp):
    def _apply_params(self, params, state, x, training, rng):
        xc, k, s = self._window(x, float("-inf"))
        return F.max_pool2d(xc, k, s).permute(0, 2, 3, 1), state


class AvgPool(_Pool2DOp):
    def _apply_params(self, params, state, x, training, rng):
        xc, k, s = self._window(x, 0.0)
        summed = F.avg_pool2d(xc, k, s, divisor_override=1)
        # TF semantics: divide by the count of VALID (non-pad) elements
        ones = torch.ones((1, 1, *x.shape[1:3]), dtype=xc.dtype, device=x.device)
        counts = F.avg_pool2d(self._window(ones.permute(0, 2, 3, 1), 0.0)[0], k, s,
                              divisor_override=1)
        return (summed / counts).permute(0, 2, 3, 1).to(x.dtype), state


class ReshapeOp(AbstractModule):
    """Static-target reshape (TF Reshape with the shape const-folded)."""

    def __init__(self, target, device=None):
        super().__init__(device)
        self.target = tuple(int(t) for t in target)

    def _apply_params(self, params, state, x, training, rng):
        return x.reshape(self.target), state


class TransposeOp(AbstractModule):
    """Static-perm transpose (TF Transpose with the perm const-folded) — the
    layout bridge of the NCHW<->NHWC conv export/import path."""

    def __init__(self, perm, device=None):
        super().__init__(device)
        self.perm = tuple(int(p) for p in perm)

    def _apply_params(self, params, state, x, training, rng):
        return x.permute(self.perm), state


class Squeeze(AbstractModule):
    """TF Squeeze with static squeeze_dims (empty = all size-1 dims)."""

    def __init__(self, axes=(), device=None):
        super().__init__(device)
        self.axes = tuple(int(a) for a in axes)

    def _apply_params(self, params, state, x, training, rng):
        if self.axes:
            for a in self.axes:
                if x.shape[a] != 1:
                    raise ValueError(f"cannot squeeze axis {a} of size {x.shape[a]}")
            return torch.squeeze(x, self.axes), state
        return torch.squeeze(x), state


class ReduceOp(AbstractModule):
    """TF Mean/Sum/Max/Min with the reduction axes const-folded."""

    _KINDS = {"Mean": "mean", "Sum": "sum", "Max": "max", "Min": "min"}

    def __init__(self, op: str, axes, keep_dims: bool = False, device=None):
        super().__init__(device)
        self.op = op
        self.axes = tuple(int(a) for a in axes)
        self.keep_dims = bool(keep_dims)

    def _apply_params(self, params, state, x, training, rng):
        return _reduce(self._KINDS[self.op], x, self.axes or None, self.keep_dims), state


class ConcatOp(AbstractModule):
    """TF ConcatV2 with the axis const-folded; input is a Table of operands."""

    def __init__(self, axis: int, device=None):
        super().__init__(device)
        self.axis = int(axis)

    def _apply_params(self, params, state, x, training, rng):
        return torch.cat(_values(x), dim=self.axis), state


class FusedBatchNorm(AbstractModule):
    """TF FusedBatchNorm(V3) INFERENCE: Table(x, scale, offset, mean, var).
    Training-mode nodes are refused at import."""

    def __init__(self, epsilon: float = 1e-3, data_format: str = "NHWC", device=None):
        super().__init__(device)
        self.epsilon = float(epsilon)
        self.data_format = data_format

    def _apply_params(self, params, state, x, training, rng):
        v, scale, offset, mean, var = _values(x)
        c_axis = 3 if self.data_format == "NHWC" else 1
        shape = [1] * v.dim()
        shape[c_axis] = v.shape[c_axis]
        inv = torch.rsqrt(var.reshape(shape) + self.epsilon)
        return (v - mean.reshape(shape)) * inv * scale.reshape(shape) \
            + offset.reshape(shape), state


# TF-op modules are wired by the importers with whatever arity the source
# GraphDef declares (MatMul/BiasAdd/Select/reductions-with-axes all take
# multi-parent Tables), and the importer validates op arity itself — so every
# op module is exempt from analysis.GraphValidator's merge-arity check, and
# the source ops are legitimate zero-parent roots.
for _cls in list(globals().values()):
    if (inspect.isclass(_cls) and issubclass(_cls, AbstractModule)
            and _cls.__module__ == __name__):  # only the classes DEFINED here
        _cls.accepts_table_input = True
        if _cls.__name__ in ("Const", "Variable"):
            _cls.graph_source = True
del _cls
