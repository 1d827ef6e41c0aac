"""Table layers and multi-branch containers (counterpart of
``bigdl_tpu/nn/table_ops.py``; reference: ``$DL/nn/Concat.scala``,
``ConcatTable.scala``, ``ParallelTable.scala``, ``MapTable.scala``,
``JoinTable.scala``, ``CAddTable.scala``, ``SelectTable.scala``,
``MixtureTable.scala``, ...). Dims and table indices are 1-based (Torch
convention). A table input is a ``Table``, a list or a tuple; table outputs
are ``Table`` s.

``MapTable`` applies its one child to every entry with one parameter set,
threading the child's state through the entries in order; autograd sums
the entries' gradients into that set. ``CMaxTable``/``CMinTable`` split a
tie's gradient evenly (``torch.maximum``, as ``jnp.maximum``).
``CosineDistance`` divides by the norms' product clipped at 1e-12 and
``PairwiseDistance`` is ``(Σ|a - b|^p)^(1/p)``, as in the JAX package:
neither is ``F.cosine_similarity``/``F.pairwise_distance``, which clamp each
norm at 1e-8 and add 1e-6 to the difference. ``PairwiseDistance``'s
gradient at a == b is NaN there as in the JAX package.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, List

import torch

from ..utils.table import T, Table
from .math_ops import _abs, _clip_min, _norm, _promote
from .module import AbstractModule, Container, infer_module_shape, spec


def _as_list(x) -> List[Any]:
    if isinstance(x, Table):
        return x.to_list()
    if isinstance(x, (list, tuple)):
        return list(x)
    return [x]


def check_concat_specs(module, shapes, axis: int, names) -> None:
    """Merge-point contract check: every branch must agree on rank and on all
    non-concat dims; reports the first offending pair with both shapes."""
    ref = tuple(shapes[0])
    if not 0 <= axis < len(ref):
        raise ValueError(
            f"{module.name()}: concat dim {axis + 1} (1-based) out of range "
            f"for rank-{len(ref)} inputs (first branch shape {ref})"
        )
    for name, s in zip(names[1:], shapes[1:]):
        cur = tuple(s)
        if len(cur) != len(ref) or any(
            i != axis and a != b for i, (a, b) in enumerate(zip(ref, cur))
        ):
            raise ValueError(
                f"{module.name()}: cannot concatenate along dim {axis + 1} "
                f"(1-based): {names[0]} outputs {ref} but {name} outputs {cur}"
            )


class Concat(Container):
    """Apply each branch to the SAME input and concatenate the outputs along
    ``dimension`` (1-based), in the branches' promoted dtype (Inception's
    modules). Reference: $DL/nn/Concat.scala."""

    def infer_shape(self, in_spec):
        specs = [infer_module_shape(m, in_spec) for m in self._layers]
        d = self.dimension - 1
        check_concat_specs(self, [s.shape for s in specs], d, [m.name() for m in self._layers])
        shape = list(specs[0].shape)
        shape[d] = sum(s.shape[d] for s in specs)
        return spec(tuple(shape), functools.reduce(torch.promote_types, [s.dtype for s in specs]))

    def __init__(self, dimension: int = 2, device=None):
        super().__init__(device=device)
        self.dimension = dimension

    def build(self, generator: torch.Generator, sample) -> None:
        """Build the branches from ``sample`` and check that their outputs
        concatenate."""
        if self._built:
            raise RuntimeError(f"{self.name()} is already built")
        with torch.no_grad():
            ys = [self._build_child(m, generator, sample) for m in self._layers]
        check_concat_specs(self, [y.shape for y in ys], self.dimension - 1,
                           [m.name() for m in self._layers])
        self._built = True

    def _apply_params(self, params, state, x, training, rng):
        new_state: Dict[str, Any] = {}
        ys = []
        for m in self._layers:
            y, new_state[m.name()] = m._apply_params(params[m.name()], state[m.name()], x,
                                                     training, rng)
            ys.append(y)
        return torch.cat(ys, dim=self.dimension - 1), new_state


class ConcatTable(Container):
    """Each branch applied to the same input; a ``Table`` of their outputs
    (reference: ConcatTable)."""

    def infer_shape(self, in_spec):
        return T(*[infer_module_shape(m, in_spec) for m in self._layers])

    def build(self, generator: torch.Generator, sample) -> None:
        if self._built:
            raise RuntimeError(f"{self.name()} is already built")
        with torch.no_grad():
            for m in self._layers:
                self._build_child(m, generator, sample)
        self._built = True

    def _apply_params(self, params, state, x, training, rng):
        new_state: Dict[str, Any] = {}
        ys = []
        for m in self._layers:
            y, new_state[m.name()] = m._apply_params(params[m.name()], state[m.name()], x,
                                                     training, rng)
            ys.append(y)
        return T(*ys), new_state


class ParallelTable(Container):
    """The i-th branch applied to the i-th entry of the input table; a
    ``Table`` of their outputs (reference: ParallelTable)."""

    accepts_table_input = True  # consumes a multi-parent Table when graph-wired

    def infer_shape(self, in_spec):
        specs = _as_list(in_spec)
        if len(specs) != len(self._layers):
            raise ValueError(f"{self.name()}: {len(self._layers)} branches but {len(specs)} "
                             "inputs")
        return T(*[infer_module_shape(m, s) for m, s in zip(self._layers, specs)])

    def build(self, generator: torch.Generator, sample) -> None:
        if self._built:
            raise RuntimeError(f"{self.name()} is already built")
        xs = _as_list(sample)
        if len(xs) != len(self._layers):
            raise ValueError(f"{self.name()}: {len(self._layers)} branches but {len(xs)} inputs")
        with torch.no_grad():
            for m, xi in zip(self._layers, xs):
                self._build_child(m, generator, xi)
        self._built = True

    def _apply_params(self, params, state, x, training, rng):
        new_state: Dict[str, Any] = {}
        ys = []
        for m, xi in zip(self._layers, _as_list(x)):
            y, new_state[m.name()] = m._apply_params(params[m.name()], state[m.name()], xi,
                                                     training, rng)
            ys.append(y)
        return T(*ys), new_state


class MapTable(Container):
    """One child applied to every entry of the input table with ONE
    parameter set (reference: MapTable). The child's state is threaded
    through the entries in order, so each entry's update (BN running
    statistics) is kept; the parameters' gradient is the entries' sum. A
    container of one child, not a graph with a shared node."""

    accepts_table_input = True  # consumes a multi-parent Table when graph-wired

    def infer_shape(self, in_spec):
        return T(*[infer_module_shape(self._layers[0], s) for s in _as_list(in_spec)])

    def __init__(self, module: AbstractModule, device=None):
        super().__init__(module, device=device)

    def build(self, generator: torch.Generator, sample) -> None:
        if self._built:
            raise RuntimeError(f"{self.name()} is already built")
        m = self._layers[0]
        if not m.is_built():
            m.build(generator, _as_list(sample)[0])
        self._built = True

    def _apply_params(self, params, state, x, training, rng):
        m = self._layers[0]
        p, s = params[m.name()], state[m.name()]
        ys = []
        for xi in _as_list(x):
            y, s = m._apply_params(p, s, xi, training, rng)
            ys.append(y)
        return T(*ys), {m.name(): s}


class JoinTable(AbstractModule):
    """The table's entries concatenated along ``dimension`` (1-based); with
    ``n_input_dims > 0`` and entries of more dims than that, the dim moves
    one past the batch dim (reference: JoinTable)."""

    accepts_table_input = True  # consumes a multi-parent Table when graph-wired

    def infer_shape(self, in_spec):
        self._build(None, in_spec)  # the merge-point check
        return self._infer_shape_via_apply(in_spec)

    def __init__(self, dimension: int, n_input_dims: int = 0, device=None):
        super().__init__(device)
        self.dimension = dimension
        self.n_input_dims = n_input_dims

    def _axis(self, xs) -> int:
        d = self.dimension - 1
        if self.n_input_dims > 0 and xs[0].dim() > self.n_input_dims:
            d += 1
        return d

    def _build(self, generator, sample):
        xs = _as_list(sample)
        if not xs:
            raise ValueError(f"{self.name()}: empty input Table")
        check_concat_specs(self, [x.shape for x in xs], self._axis(xs),
                           [f"table entry {i + 1}" for i in range(len(xs))])
        return {}, {}

    def _apply_params(self, params, state, x, training, rng):
        xs = _as_list(x)
        return torch.cat(xs, dim=self._axis(xs)), state


class _ElementwiseTable(AbstractModule):
    """The table's entries combined left to right by ``_combine``
    (broadcasting as ``jnp`` does)."""

    accepts_table_input = True  # consumes a multi-parent Table when graph-wired

    def infer_shape(self, in_spec):
        xs = _as_list(in_spec)
        if not xs:
            raise ValueError(f"{self.name()}: empty input Table")
        shape = tuple(xs[0].shape)
        for i, s in enumerate(xs[1:], 2):
            try:
                shape = torch.broadcast_shapes(shape, tuple(s.shape))
            except RuntimeError:
                raise ValueError(f"{self.name()}: table entry 1 shape {tuple(xs[0].shape)} "
                                 f"does not broadcast with entry {i} shape "
                                 f"{tuple(s.shape)}") from None
        return self._infer_shape_via_apply(in_spec)

    def _build(self, generator, sample):
        xs = _as_list(sample)
        if not xs:
            raise ValueError(f"{self.name()}: empty input Table")
        shape = tuple(xs[0].shape)
        for i, s in enumerate(xs[1:], 2):
            try:
                shape = torch.broadcast_shapes(shape, tuple(s.shape))
            except RuntimeError:
                raise ValueError(f"{self.name()}: table entry 1 shape {tuple(xs[0].shape)} does "
                                 f"not broadcast with entry {i} shape {tuple(s.shape)}") from None
        return {}, {}

    def _combine(self, a, b):
        raise NotImplementedError

    def _apply_params(self, params, state, x, training, rng):
        xs = _as_list(x)
        out = xs[0]
        for xi in xs[1:]:
            out = self._combine(out, xi)
        return out, state


class CAddTable(_ElementwiseTable):
    """Elementwise sum of a ``Table`` (ResNet's shortcut add), left to right.
    ``inplace`` is accepted and ignored."""

    def __init__(self, inplace: bool = False, device=None):
        super().__init__(device)

    def _combine(self, a, b):
        return a + b


class CSubTable(_ElementwiseTable):
    def _combine(self, a, b):
        return a - b


class CMulTable(_ElementwiseTable):
    def _combine(self, a, b):
        return a * b


class CDivTable(_ElementwiseTable):
    def _combine(self, a, b):
        return a / b


class CMaxTable(_ElementwiseTable):
    def _combine(self, a, b):
        return torch.maximum(*_promote(a, b))


class CMinTable(_ElementwiseTable):
    def _combine(self, a, b):
        return torch.minimum(*_promote(a, b))


class CAveTable(AbstractModule):
    """The entries' mean: their sum, left to right, over their count."""

    accepts_table_input = True  # consumes a multi-parent Table when graph-wired
    infer_shape = AbstractModule._infer_shape_via_apply  # parameter-less

    def _apply_params(self, params, state, x, training, rng):
        xs = _as_list(x)
        return sum(xs) / len(xs), state


class SelectTable(AbstractModule):
    """The ``index``-th entry (1-based; negative from the end) (reference:
    SelectTable)."""

    accepts_table_input = True  # consumes a multi-parent Table when graph-wired
    infer_shape = AbstractModule._infer_shape_via_apply  # parameter-less

    def __init__(self, index: int, device=None):
        super().__init__(device)
        self.index = index

    def _apply_params(self, params, state, x, training, rng):
        xs = _as_list(x)
        return xs[self.index - 1 if self.index > 0 else len(xs) + self.index], state


class FlattenTable(AbstractModule):
    """Nested tables flattened into one ``Table``, depth first (reference:
    FlattenTable)."""

    accepts_table_input = True  # consumes a multi-parent Table when graph-wired
    infer_shape = AbstractModule._infer_shape_via_apply  # parameter-less

    def _apply_params(self, params, state, x, training, rng):
        out: List[Any] = []
        _flatten_into(x, out)
        return T(*out), state


def _flatten_into(v, out: List[Any]) -> None:
    """``v``'s leaves appended to ``out``, depth first (a module-level walk:
    a closure calling itself would hold ``out`` in a reference cycle)."""
    if isinstance(v, (Table, list, tuple)):
        for e in _as_list(v):
            _flatten_into(e, out)
    else:
        out.append(v)


class MixtureTable(AbstractModule):
    """Table(gater (N, E), experts): the experts' outputs weighted by the
    gater and summed (reference: MixtureTable)."""

    accepts_table_input = True  # consumes a multi-parent Table when graph-wired
    infer_shape = AbstractModule._infer_shape_via_apply  # parameter-less

    def _apply_params(self, params, state, x, training, rng):
        gater, experts = _as_list(x)[:2]
        stacked = torch.stack(_as_list(experts), dim=1)  # (N, E, ...)
        g = gater.reshape(tuple(gater.shape) + (1,) * (stacked.dim() - 2))
        return torch.sum(stacked * g, dim=1), state


class DotProduct(AbstractModule):
    """Row-wise dot product of Table(a, b) (reference: DotProduct)."""

    accepts_table_input = True  # consumes a multi-parent Table when graph-wired
    infer_shape = AbstractModule._infer_shape_via_apply  # parameter-less

    def _apply_params(self, params, state, x, training, rng):
        a, b = _as_list(x)[:2]
        return torch.sum(a * b, dim=-1), state


class CosineDistance(AbstractModule):
    """Row-wise cosine similarity of Table(a, b), the norms' product clipped
    at 1e-12 (reference: CosineDistance)."""

    accepts_table_input = True  # consumes a multi-parent Table when graph-wired
    infer_shape = AbstractModule._infer_shape_via_apply  # parameter-less

    def _apply_params(self, params, state, x, training, rng):
        a, b = _as_list(x)[:2]
        return torch.sum(a * b, dim=-1) / _clip_min(_norm(a) * _norm(b), 1e-12), state


class PairwiseDistance(AbstractModule):
    """Row-wise Lp distance (Σ|a - b|^p)^(1/p) of Table(a, b) (reference:
    PairwiseDistance)."""

    accepts_table_input = True  # consumes a multi-parent Table when graph-wired
    infer_shape = AbstractModule._infer_shape_via_apply  # parameter-less

    def __init__(self, norm: int = 2, device=None):
        super().__init__(device)
        self.norm = norm

    def _apply_params(self, params, state, x, training, rng):
        a, b = _as_list(x)[:2]
        return torch.sum(_abs(a - b) ** self.norm, dim=-1) ** (1.0 / self.norm), state


class MM(AbstractModule):
    """(Batch) matrix product of Table(a, b), each optionally transposed in
    its last two dims (reference: MM)."""

    accepts_table_input = True  # consumes a multi-parent Table when graph-wired
    infer_shape = AbstractModule._infer_shape_via_apply  # parameter-less

    def __init__(self, trans_a: bool = False, trans_b: bool = False, device=None):
        super().__init__(device)
        self.trans_a, self.trans_b = trans_a, trans_b

    def _apply_params(self, params, state, x, training, rng):
        a, b = _promote(*_as_list(x)[:2])
        if self.trans_a:
            a = a.transpose(-1, -2)
        if self.trans_b:
            b = b.transpose(-1, -2)
        return a @ b, state


class MV(AbstractModule):
    """(Batch) matrix-vector product of Table(mat, vec), the matrix
    optionally transposed (reference: MV)."""

    accepts_table_input = True  # consumes a multi-parent Table when graph-wired
    infer_shape = AbstractModule._infer_shape_via_apply  # parameter-less

    def __init__(self, trans: bool = False, device=None):
        super().__init__(device)
        self.trans = trans

    def _apply_params(self, params, state, x, training, rng):
        m, v = _promote(*_as_list(x)[:2])
        if self.trans:
            m = m.transpose(-1, -2)
        return torch.einsum("...ij,...j->...i", m, v), state
