"""BigDL-style ``Tensor`` façade over ``torch.Tensor`` (counterpart of
``bigdl_tpu/tensor/tensor.py``; reference: ``$DL/tensor/Tensor.scala``,
``DenseTensor``): 1-BASED dims and indices (Torch convention), the view
methods (``narrow`` / ``select`` / ``transpose``), mutating methods that
return ``self`` (``fill``, ``zero``, ``add``, ``copy``, ...) and a math
surface over torch ops, on an explicit device (``device=``; the card
unless ``"cpu"``, as the port's other entry points).

No aliasing, as in the JAX package, whose arrays are immutable: a view
method returns a new façade over a copy (torch's views would alias their
base), every mutating method swaps the wrapped tensor for a new one
(``self._data``), and the constructor copies a tensor it is given. So a
``fill`` on a ``narrow`` never writes into its parent, nor the reverse.

Dtypes follow the JAX package's arrays: float64 input becomes float32 and
int64 int32 (64-bit mode off there); two tensors combine in their
promoted dtype whatever their ranks (a 0-dim float32 operand promotes a
bfloat16 tensor, where torch would keep bfloat16); a Python scalar does
not widen a tensor of its kind (JAX's weak types); integer sums and
cumulative sums stay int32. Comparisons and returned indices are float32,
indices 1-based. The random fills draw from the port's generators
(``RandomGenerator``), not ``jax.random``. ``COVERAGE`` is the JAX
package's method table, the same names.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

from ..utils.engine import Engine

Scalar = Union[int, float]

_JAX_DTYPES = {np.dtype(np.float64): np.float32, np.dtype(np.int64): np.int32,
               np.dtype(np.uint64): np.uint32}
_INTS = (torch.bool, torch.uint8, torch.int8, torch.int16, torch.int32)


def _dtype(d) -> Optional[torch.dtype]:
    """A torch dtype from a torch dtype, a numpy dtype or a name."""
    if d is None or isinstance(d, torch.dtype):
        return d
    name = d if isinstance(d, str) else np.dtype(d).name
    return getattr(torch, name)


def _tensor_of(x, device, dtype=None) -> torch.Tensor:
    """``x`` as a new tensor on ``device``: numpy's 64-bit dtypes narrowed
    as the JAX package's arrays are."""
    if isinstance(x, torch.Tensor):
        t = x.detach().to(device).clone()
        if t.dtype == torch.float64:
            t = t.float()
        elif t.dtype == torch.int64:
            t = t.to(torch.int32)
    else:
        a = np.asarray(x)
        a = a.astype(_JAX_DTYPES.get(a.dtype, a.dtype), copy=True)
        t = torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return t if dtype is None else t.to(_dtype(dtype))


def _wrap(data: torch.Tensor) -> "Tensor":
    out = Tensor.__new__(Tensor)
    out._data = data
    return out


def _int32(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """An integer reduction's result in the JAX dtype: int32 for an int32
    or narrower (or bool) input, where torch widens to int64."""
    return t.to(torch.int32) if like.dtype in _INTS and t.dtype == torch.int64 else t


class Tensor:
    """n-dim array with the BigDL ``Tensor`` vocabulary (1-based dims)."""

    __slots__ = ("_data",)

    # ------------------------------------------------------------- creation
    def __init__(self, *args, dtype=None, device=None):
        """``Tensor()`` empty, ``Tensor(2, 3)`` zeros of that size (float32
        unless ``dtype``), ``Tensor(array_or_tensor)`` a copy of its data
        (its dtype unless ``dtype``). ``device``: where the data lives
        (the card unless ``"cpu"``; a façade keeps its own)."""
        if args and isinstance(args[0], Tensor):
            src = args[0]._data
            dev = src.device if device is None else Engine.device(device)
            self._data = src.to(dev).clone() if dtype is None else src.to(dev, _dtype(dtype))
            return
        dev = Engine.device(device)
        if not args:
            self._data = torch.zeros((0,), dtype=_dtype(dtype) or torch.float32, device=dev)
        elif all(isinstance(a, (int, np.integer)) and not isinstance(a, bool) for a in args):
            self._data = torch.zeros(tuple(int(a) for a in args),
                                     dtype=_dtype(dtype) or torch.float32, device=dev)
        else:
            self._data = _tensor_of(args[0], dev, dtype)

    @staticmethod
    def zeros(*shape, dtype=torch.float32, device=None) -> "Tensor":
        return _wrap(torch.zeros(shape, dtype=_dtype(dtype), device=Engine.device(device)))

    @staticmethod
    def ones(*shape, dtype=torch.float32, device=None) -> "Tensor":
        return _wrap(torch.ones(shape, dtype=_dtype(dtype), device=Engine.device(device)))

    @staticmethod
    def arange(start: Scalar, stop: Scalar, step: Scalar = 1, device=None) -> "Tensor":
        """Inclusive endpoint, like Torch's ``range`` used by the reference,
        with the exact element count."""
        n = int(np.floor((stop - start) / step)) + 1
        r = torch.arange(max(n, 0), dtype=torch.float32, device=Engine.device(device))
        return _wrap(start + r * step)

    @staticmethod
    def randn(*shape, seed: Optional[int] = None, device=None) -> "Tensor":
        return _wrap(torch.randn(shape, generator=_generator(seed)).to(Engine.device(device)))

    @staticmethod
    def rand(*shape, seed: Optional[int] = None, device=None) -> "Tensor":
        return _wrap(torch.rand(shape, generator=_generator(seed)).to(Engine.device(device)))

    # ----------------------------------------------------------------- meta
    @property
    def data(self) -> torch.Tensor:
        """The wrapped tensor (the façade swaps it on every mutation)."""
        return self._data

    def to_torch(self) -> torch.Tensor:
        return self._data

    @property
    def device(self) -> torch.device:
        return self._data.device

    def numpy(self) -> np.ndarray:
        d = self._data.detach().cpu()
        return (d.float() if d.dtype == torch.bfloat16 else d).numpy()

    def dim(self) -> int:
        return self._data.dim()

    def n_dimension(self) -> int:
        return self._data.dim()

    def size(self, dim: Optional[int] = None):
        if dim is None:
            return tuple(self._data.shape)
        return self._data.shape[dim - 1]

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self._data.shape)

    def n_element(self) -> int:
        return int(self._data.numel())

    def is_empty(self) -> bool:
        return self._data.numel() == 0

    def dtype(self):
        return self._data.dtype

    def is_same_size_as(self, other: "Tensor") -> bool:
        return self.shape == self._operand(other).shape

    def _operand(self, other) -> torch.Tensor:
        """``other`` 's data (a façade's own, else on this device)."""
        if isinstance(other, Tensor):
            return other._data
        return _tensor_of(other, self._data.device)

    def _pair(self, other):
        """This tensor and ``other`` 's in their promoted dtype (JAX's rule:
        a 0-dim operand promotes too)."""
        o = self._operand(other)
        dt = torch.promote_types(self._data.dtype, o.dtype)
        return self._data.to(dt), o.to(dt)

    # ---------------------------------------------------------------- views
    def narrow(self, dim: int, index: int, size: int) -> "Tensor":
        """``size`` entries from 1-based ``index`` along ``dim`` (a copy)."""
        return _wrap(self._data.narrow(dim - 1, index - 1, size).clone())

    def select(self, dim: int, index: int) -> "Tensor":
        """Drop ``dim`` by picking 1-based ``index`` (negative = from end)."""
        return _wrap(self._data.select(dim - 1, index - 1 if index > 0 else index).clone())

    def view(self, *shape) -> "Tensor":
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        return _wrap(self._data.reshape(shape).clone())

    def reshape(self, *shape) -> "Tensor":
        return self.view(*shape)

    def transpose(self, dim1: int, dim2: int) -> "Tensor":
        return _wrap(self._data.transpose(dim1 - 1, dim2 - 1).contiguous().clone())

    def t(self) -> "Tensor":
        if self._data.dim() != 2:
            raise ValueError("t() expects a 2D tensor")
        return _wrap(self._data.t().contiguous().clone())

    def squeeze(self, dim: Optional[int] = None) -> "Tensor":
        if dim is None:
            return _wrap(self._data.squeeze().clone())
        if self._data.shape[dim - 1] != 1:
            return _wrap(self._data.clone())
        return _wrap(self._data.squeeze(dim - 1).clone())

    def unsqueeze(self, dim: int) -> "Tensor":
        return _wrap(self._data.unsqueeze(dim - 1).clone())

    def expand(self, *sizes) -> "Tensor":
        if len(sizes) == 1 and isinstance(sizes[0], (tuple, list)):
            sizes = tuple(sizes[0])
        return _wrap(torch.broadcast_to(self._data, sizes).clone())

    def repeat_tensor(self, *sizes) -> "Tensor":
        return _wrap(torch.tile(self._data, sizes))

    def contiguous(self) -> "Tensor":
        return self  # the wrapped tensor is never a view

    def clone(self) -> "Tensor":
        return _wrap(self._data.clone())

    def split(self, size: int, dim: int = 1):
        n = self._data.shape[dim - 1]
        return [self.narrow(dim, i + 1, min(size, n - i)) for i in range(0, n, size)]

    def index_select(self, dim: int, indices) -> "Tensor":
        return _wrap(torch.index_select(self._data, dim - 1, self._index(indices)))

    def _index(self, index) -> torch.Tensor:
        """A 1-based index operand as 0-based int64 positions (a plain int
        stays one position; the size constructor is not involved)."""
        if isinstance(index, Tensor):
            index = index._data
        if isinstance(index, torch.Tensor):
            return torch.atleast_1d(index).to(self._data.device, torch.int64) - 1
        return torch.as_tensor(np.atleast_1d(index), device=self._data.device).long() - 1

    # ------------------------------------------------------------ accessors
    def value_at(self, *indices: int) -> Scalar:
        return self._data[tuple(i - 1 for i in indices)].item()

    def set_value(self, *args) -> "Tensor":
        *indices, value = args
        d = self._data.clone()
        d[tuple(i - 1 for i in indices)] = value
        self._data = d
        return self

    def item(self) -> Scalar:
        return self._data.item()

    def __getitem__(self, i):
        return _wrap(self._data[i].clone())

    # ------------------------------------------------ in-place (swap) math
    def fill(self, value: Scalar) -> "Tensor":
        self._data = torch.full_like(self._data, value)
        return self

    def zero(self) -> "Tensor":
        return self.fill(0)

    def copy(self, other: "Tensor") -> "Tensor":
        src = self._operand(other)
        self._data = src.reshape(self._data.shape).to(self._data.dtype).clone()
        return self

    def resize(self, *shape) -> "Tensor":
        if tuple(shape) == self.shape:
            return self
        self._data = torch.zeros(shape, dtype=self._data.dtype, device=self._data.device)
        return self

    def resize_as(self, other: "Tensor") -> "Tensor":
        return self.resize(*self._operand(other).shape)

    def _scaled(self, value, other):
        """This tensor and ``value * other``, in their promoted dtype."""
        a, o = self._pair(other)
        return a, value * o

    def add(self, *args) -> "Tensor":
        """add(value) | add(other) | add(value, other) — Torch overloads."""
        if len(args) == 1:
            other = args[0]
            if isinstance(other, (int, float)):
                self._data = self._data + other
            else:
                a, o = self._pair(other)
                self._data = a + o
        else:
            a, o = self._scaled(*args)
            self._data = a + o
        return self

    def sub(self, *args) -> "Tensor":
        if len(args) == 1:
            other = args[0]
            if isinstance(other, (int, float)):
                self._data = self._data - other
            else:
                a, o = self._pair(other)
                self._data = a - o
        else:
            a, o = self._scaled(*args)
            self._data = a - o
        return self

    def mul(self, value: Scalar) -> "Tensor":
        self._data = self._data * value
        return self

    def div(self, value: Scalar) -> "Tensor":
        self._data = self._data / value
        return self

    def cmul(self, other: "Tensor") -> "Tensor":
        a, o = self._pair(other)
        self._data = a * o
        return self

    def cdiv(self, other: "Tensor") -> "Tensor":
        a, o = self._pair(other)
        self._data = a / o
        return self

    def cadd(self, value: Scalar, other: "Tensor") -> "Tensor":
        a, o = self._scaled(value, other)
        self._data = a + o
        return self

    def pow(self, n: Scalar) -> "Tensor":
        self._data = self._data ** n
        return self

    def sqrt(self) -> "Tensor":
        self._data = torch.sqrt(self._data)
        return self

    def exp(self) -> "Tensor":
        self._data = torch.exp(self._data)
        return self

    def log(self) -> "Tensor":
        self._data = torch.log(self._data)
        return self

    def log1p(self) -> "Tensor":
        self._data = torch.log1p(self._data)
        return self

    def abs(self) -> "Tensor":
        self._data = torch.abs(self._data)
        return self

    def sign(self) -> "Tensor":
        self._data = torch.sign(self._data)
        return self

    def floor(self) -> "Tensor":
        self._data = torch.floor(self._data)
        return self

    def ceil(self) -> "Tensor":
        self._data = torch.ceil(self._data)
        return self

    def clamp(self, min_v: Scalar, max_v: Scalar) -> "Tensor":
        self._data = torch.clamp(self._data, min_v, max_v)
        return self

    def negative(self) -> "Tensor":
        self._data = -self._data
        return self

    def tanh(self) -> "Tensor":
        self._data = torch.tanh(self._data)
        return self

    def sigmoid(self) -> "Tensor":
        self._data = torch.sigmoid(self._data)
        return self

    def masked_fill(self, mask: "Tensor", value: Scalar) -> "Tensor":
        self._data = torch.where(self._operand(mask).to(torch.bool), value, self._data)
        return self

    def _draw(self, fn) -> torch.Tensor:
        d = self._data
        return fn(tuple(d.shape), _generator(None)).to(d.device, d.dtype)

    def uniform(self, lower: float = 0.0, upper: float = 1.0) -> "Tensor":
        self._data = self._draw(lambda s, g: lower + (upper - lower) * torch.rand(s, generator=g))
        return self

    def normal(self, mean: float = 0.0, std: float = 1.0) -> "Tensor":
        self._data = self._draw(lambda s, g: mean + std * torch.randn(s, generator=g))
        return self

    def bernoulli(self, p: float) -> "Tensor":
        self._data = self._draw(lambda s, g: (torch.rand(s, generator=g) < p).float())
        return self

    # ------------------------------------------------------------ BLAS-ish
    def _matmul(self, a, b) -> torch.Tensor:
        x, y = self._operand(a), self._operand(b)
        dt = torch.promote_types(x.dtype, y.dtype)
        return x.to(dt) @ y.to(dt)

    def addmm(self, beta: Scalar, m: "Tensor", alpha: Scalar,
              mat1: "Tensor", mat2: "Tensor") -> "Tensor":
        self._data = beta * self._operand(m) + alpha * self._matmul(mat1, mat2)
        return self

    def addmv(self, beta: Scalar, v: "Tensor", alpha: Scalar,
              mat: "Tensor", vec: "Tensor") -> "Tensor":
        self._data = beta * self._operand(v) + alpha * self._matmul(mat, vec)
        return self

    def mm(self, other: "Tensor") -> "Tensor":
        return _wrap(self._matmul(self, other))

    def mv(self, vec: "Tensor") -> "Tensor":
        return _wrap(self._matmul(self, vec))

    def dot(self, other: "Tensor") -> Scalar:
        a, o = self._pair(other)
        return float(torch.sum(a.reshape(-1) * o.reshape(-1)))

    # ----------------------------------------------------------- reductions
    def sum(self, dim: Optional[int] = None):
        if dim is None:
            return float(torch.sum(self._data))
        return _wrap(_int32(torch.sum(self._data, dim - 1, keepdim=True), self._data))

    def _inexact(self) -> torch.Tensor:
        d = self._data
        return d if d.is_floating_point() else d.float()

    def mean(self, dim: Optional[int] = None):
        if dim is None:
            return float(torch.mean(self._inexact()))
        return _wrap(torch.mean(self._inexact(), dim - 1, keepdim=True))

    def max(self, dim: Optional[int] = None):
        """max() -> scalar; max(dim) -> (values, 1-based indices), Torch-style
        (the first index among ties, as ``jnp.argmax``)."""
        if dim is None:
            return float(torch.max(self._data))
        values = torch.amax(self._data, dim - 1, keepdim=True)
        indices = torch.argmax(self._data, dim - 1, keepdim=True) + 1
        return _wrap(values), _wrap(indices.float())

    def min(self, dim: Optional[int] = None):
        if dim is None:
            return float(torch.min(self._data))
        values = torch.amin(self._data, dim - 1, keepdim=True)
        indices = torch.argmin(self._data, dim - 1, keepdim=True) + 1
        return _wrap(values), _wrap(indices.float())

    def prod(self) -> Scalar:
        return float(torch.prod(self._data))

    def norm(self, p: Scalar = 2) -> Scalar:
        if p == 1:
            return float(torch.sum(torch.abs(self._data)))
        return float(torch.sum(torch.abs(self._data) ** p) ** (1.0 / p))

    def dist(self, other: "Tensor", p: Scalar = 2) -> Scalar:
        a, o = self._pair(other)
        return _wrap(a - o).norm(p)

    def _order(self, data: torch.Tensor, axis: int, descending: bool) -> torch.Tensor:
        """A stable sort's positions (ties in index order, as JAX's)."""
        return torch.sort(data, dim=axis, descending=descending, stable=True).indices

    def topk(self, k: int, dim: Optional[int] = None, increase: bool = False):
        """(values, 1-based indices) along ``dim`` (default: last); among
        ties the lower index first, as ``lax.top_k``."""
        axis = (dim - 1) if dim is not None else self._data.dim() - 1
        i = self._order(self._data, axis, descending=not increase).narrow(axis, 0, k)
        v = torch.take_along_dim(self._data, i, axis)
        return _wrap(v), _wrap((i + 1).float())

    # ------------------------------------------------------------ tier 2
    def sort(self, dim: Optional[int] = None, descending: bool = False):
        """(values, 1-based indices) along ``dim`` (default: last)."""
        axis = (dim - 1) if dim is not None else self._data.dim() - 1
        order = self._order(self._data, axis, descending)
        values = torch.take_along_dim(self._data, order, axis)
        return _wrap(values), _wrap((order + 1).float())

    def cumsum(self, dim: int = 1) -> "Tensor":
        return _wrap(_int32(torch.cumsum(self._data, dim - 1), self._data))

    def cumprod(self, dim: int = 1) -> "Tensor":
        return _wrap(_int32(torch.cumprod(self._data, dim - 1), self._data))

    def gather(self, dim: int, index) -> "Tensor":
        return _wrap(torch.gather(self._data, dim - 1, self._index(index)))

    def masked_select(self, mask) -> "Tensor":
        """1-D tensor of elements where mask != 0 (a data-dependent shape,
        like the reference)."""
        return _wrap(self._data[self._operand(mask).to(torch.bool)].clone())

    def index_fill(self, dim: int, indices, value: Scalar) -> "Tensor":
        self._data = self._data.index_fill(dim - 1, self._index(indices), value)
        return self

    def kthvalue(self, k: int, dim: Optional[int] = None):
        """(values, 1-based indices) of the k-th SMALLEST along ``dim``;
        both keep the reduced dim (matching max/min/topk)."""
        axis = (dim - 1) if dim is not None else self._data.dim() - 1
        kth = self._order(self._data, axis, descending=False).narrow(axis, k - 1, 1)
        return _wrap(torch.take_along_dim(self._data, kth, axis)), _wrap((kth + 1).float())

    # --------------------------------------------------------- comparisons
    def _cmp(self, other, op) -> "Tensor":
        if isinstance(other, (int, float)):
            return _wrap(op(self._data, other).float())
        a, o = self._pair(other)
        return _wrap(op(a, o).float())

    def lt(self, other) -> "Tensor":
        return self._cmp(other, torch.lt)

    def le(self, other) -> "Tensor":
        return self._cmp(other, torch.le)

    def gt(self, other) -> "Tensor":
        return self._cmp(other, torch.gt)

    def ge(self, other) -> "Tensor":
        return self._cmp(other, torch.ge)

    def eq(self, other) -> "Tensor":
        return self._cmp(other, torch.eq)

    def ne(self, other) -> "Tensor":
        return self._cmp(other, torch.ne)

    def almost_equal(self, other: "Tensor", tolerance: float = 1e-6) -> bool:
        a, o = self._pair(other)
        return bool(torch.all(torch.abs(a - o) <= tolerance))

    # ------------------------------------------------------------ operators
    def __add__(self, other):
        return self._binop(other, torch.add)

    def __sub__(self, other):
        return self._binop(other, torch.sub)

    def __mul__(self, other):
        return self._binop(other, torch.mul)

    def __truediv__(self, other):
        return self._binop(other, torch.true_divide)

    def __neg__(self):
        return _wrap(-self._data)

    def _binop(self, other, op):
        if isinstance(other, (int, float)):
            return _wrap(op(self._data, other))
        return _wrap(op(*self._pair(other)))

    __radd__ = __add__
    __rmul__ = __mul__

    def __repr__(self) -> str:
        return f"Tensor{self.shape}\n{self.numpy()!r}"

    def __eq__(self, other) -> bool:  # BigDL: structural equality
        if not isinstance(other, (Tensor, torch.Tensor, np.ndarray)):
            return NotImplemented
        o = self._operand(other)
        if self.shape != tuple(o.shape):
            return False
        a, o = self._pair(o)
        return bool(torch.all(a == o))

    def __hash__(self) -> int:
        return id(self)


def _generator(seed: Optional[int]) -> torch.Generator:
    """The draw's CPU generator: seeded with ``seed``, else the next of the
    port's global stream."""
    if seed is not None:
        return torch.Generator().manual_seed(int(seed))
    from ..utils.random import RandomGenerator

    return RandomGenerator.generator()


#: The JAX package's coverage tracker, the same method names by group.
COVERAGE = {
    "creation": ["zeros", "ones", "arange", "randn", "rand"],
    "meta": ["dim", "n_dimension", "size", "shape", "n_element", "is_empty",
             "dtype", "is_same_size_as"],
    "views": ["narrow", "select", "view", "reshape", "transpose", "t",
              "squeeze", "unsqueeze", "expand", "repeat_tensor",
              "contiguous", "clone", "split", "index_select", "gather",
              "index_fill", "masked_select"],
    "access": ["value_at", "set_value", "item"],
    "mutating_math": ["fill", "zero", "copy", "resize", "resize_as", "add",
                      "sub", "mul", "div", "cmul", "cdiv", "cadd", "pow",
                      "sqrt", "exp", "log", "log1p", "abs", "sign", "floor",
                      "ceil", "clamp", "negative", "tanh", "sigmoid",
                      "masked_fill", "uniform", "normal", "bernoulli"],
    "blas": ["addmm", "addmv", "mm", "mv", "dot"],
    "reductions": ["sum", "mean", "max", "min", "prod", "norm", "dist",
                   "topk", "sort", "cumsum", "cumprod", "kthvalue"],
    "comparisons": ["lt", "le", "gt", "ge", "eq", "ne", "almost_equal"],
}
