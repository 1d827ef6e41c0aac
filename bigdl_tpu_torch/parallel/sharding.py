"""The port's device mesh and sharding plans (counterpart of
``bigdl_tpu/parallel/sharding.py`` and of the ``jax.sharding`` objects it
reads).

:class:`Mesh` names the axes of the group's ranks, in dict order, and maps
rank r to its coordinates as ``np.array(devices).reshape(shape)`` does
(row-major): ``make_mesh({"data": 2, "model": 2})`` puts ranks 0 and 1 on
data row 0. For every set of its axes it builds one ``torch.distributed``
subgroup per line of ranks that differ only along those axes, in one fixed
order, so every rank must build the same meshes in the same order before
any collective runs (``dist.new_group`` is collective). A set that spans
the whole group is the default group; a line of one rank has no group
(its collectives are identities, as without a group at all).

:class:`P` is a ``PartitionSpec``: one entry a dim, an axis name, a tuple
of names (the dim split over their product, the first name major) or
None.

:class:`ShardingPlan` maps parameter-tree paths (``"block0/self_q_w"``) to
specs by ordered regex rules, the first match winning and replicated the
default; :func:`megatron_transformer_rules` is the Megatron layout for
``nn.Transformer``'s names. :meth:`ShardingPlan.shard` cuts this rank's
block of a leaf out of the whole one; :func:`gather_block` puts the whole
leaf back together from the ranks' blocks.
"""

from __future__ import annotations

import itertools
import re
from typing import Any, Dict, List, Mapping, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils.serialization import tree_items, unflatten_to_like
from . import _comm


class P(tuple):
    """A partition spec: ``P("model", None)`` splits dim 0 over ``model``."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return "P(" + ", ".join(repr(p) for p in self) + ")"


def spec_axes(entry) -> Tuple[str, ...]:
    """The axis names of one spec entry (None -> ())."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


class Line(NamedTuple):
    """The ranks of one mesh line: its process group (None for the default
    group), its global ranks in the order of the axes asked for, and this
    rank's place among them."""

    group: Any
    ranks: Tuple[int, ...]
    index: int

    @property
    def size(self) -> int:
        return len(self.ranks)


class Mesh:
    """Named axes over the group's ranks (see the module docstring).

    ``ranks`` (global, in mesh order) and ``whole_group`` (their process
    group) build a mesh over a part of the world, as an elastic run does
    for its survivors; a rank outside ``ranks`` builds the same subgroups
    in the same order and holds no place on the mesh (``rank`` -1)."""

    def __init__(self, axis_sizes: Mapping[str, int], ranks: Optional[Sequence[int]] = None,
                 whole_group=None):
        names = tuple(axis_sizes)
        sizes = tuple(int(axis_sizes[n]) for n in names)
        self.axis_names = names
        self.shape: Dict[str, int] = dict(zip(names, sizes))
        self.size = int(np.prod(sizes)) if sizes else 1
        if ranks is None:
            ranks, whole_group = _comm.members(), _comm.group()
        ranks = tuple(int(r) for r in ranks)
        if self.size != len(ranks):
            raise ValueError(f"mesh {dict(axis_sizes)} needs {self.size} devices, have "
                             f"{len(ranks)}")
        self.devices = np.array(ranks, dtype=np.int64).reshape(sizes)
        me = _comm.global_rank()
        self.rank = ranks.index(me) if me in ranks else -1  # this rank's place
        self.coords: Dict[str, int] = (
            {n: int(c) for n, c in zip(names, np.unravel_index(self.rank, sizes))}
            if self.rank >= 0 else {})
        self._whole = whole_group
        # one group a line, for every non-empty set of axes, built in one
        # order on every rank (new_group is collective)
        self._groups: Dict[frozenset, Any] = {}
        for k in range(1, len(names) + 1):
            for axes in itertools.combinations(names, k):
                self._build_groups(axes)

    def _build_groups(self, axes: Tuple[str, ...]) -> None:
        import torch.distributed as dist

        key = frozenset(axes)
        others = [n for n in self.axis_names if n not in key]
        moving = np.moveaxis(self.devices, [self.axis_names.index(n) for n in others],
                             list(range(len(others))))
        lines = moving.reshape(int(np.prod([self.shape[n] for n in others])), -1)
        if lines.shape[1] == 1:
            return
        if lines.shape[1] == self.size:
            self._groups[key] = self._whole
            return
        me = _comm.global_rank()
        for line in lines:
            group = dist.new_group(sorted(int(r) for r in line))
            if me in line:
                self._groups[key] = group

    def index(self, axes: Sequence[str]) -> int:
        """This rank's combined coordinate over ``axes`` (the first major)."""
        i = 0
        for n in axes:
            i = i * self.shape[n] + self.coords[n]
        return i

    def axis_size(self, axes: Sequence[str]) -> int:
        return int(np.prod([self.shape[n] for n in axes])) if axes else 1

    def line(self, axes: Sequence[str]) -> Line:
        """This rank's line along ``axes``: its ranks ordered by their
        combined coordinate over ``axes`` in the order given."""
        axes = tuple(axes)
        for n in axes:
            if n not in self.shape:
                raise ValueError(f"mesh has no axis {n!r}; axes: {self.axis_names}")
        if len(set(axes)) != len(axes):
            raise ValueError(f"axis repeated in {axes}")
        ranks = []
        for combo in itertools.product(*(range(self.shape[n]) for n in axes)):
            c = dict(self.coords)
            c.update(zip(axes, combo))
            ranks.append(int(self.devices[tuple(c[n] for n in self.axis_names)]))
        return Line(self._groups.get(frozenset(axes)), tuple(ranks), self.index(axes))

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank})"


def _block_slices(shape, spec, mesh: Mesh):
    """The slices of this rank's block of a leaf of ``shape`` under ``spec``."""
    out = []
    for dim, size in enumerate(shape):
        axes = spec_axes(spec[dim]) if dim < len(spec) else ()
        n = mesh.axis_size(axes)
        k = size // n
        i = mesh.index(axes)
        out.append(slice(i * k, (i + 1) * k))
    return tuple(out)


def shard_leaf(leaf: torch.Tensor, spec, mesh: Mesh) -> torch.Tensor:
    """This rank's block of the whole ``leaf`` under ``spec`` (a copy)."""
    return leaf[_block_slices(leaf.shape, spec, mesh)].clone()


def gather_block(block: torch.Tensor, spec, mesh: Mesh) -> torch.Tensor:
    """The whole leaf from every rank's ``block`` under ``spec``: one
    all-gather a sharded dim, over that dim's axes."""
    out = block
    for dim in range(len(spec)):
        axes = spec_axes(spec[dim])
        if axes:
            out = _comm.axis_all_gather(out, mesh, axes, dim)
    return out


class ShardingPlan:
    """Ordered (regex, spec) rules applied to parameter-tree paths."""

    def __init__(self, rules: Sequence[Tuple[str, P]] = ()):
        self.rules: List[Tuple[re.Pattern, P]] = [(re.compile(pat), spec) for pat, spec in rules]

    def add(self, pattern: str, spec: P) -> "ShardingPlan":
        self.rules.append((re.compile(pattern), spec))
        return self

    def spec_for(self, path: str, leaf: Any = None) -> P:
        for pat, spec in self.rules:
            if pat.search(path):
                return spec
        return P()  # replicated

    def tree_specs(self, params) -> Any:
        """The tree of specs with ``params`` ' structure."""
        items = tree_items(params)
        return unflatten_to_like({p: self.spec_for(p, v) for p, v in items.items()}, params)

    def validate(self, params, mesh: Mesh) -> None:
        """Check every matched spec divides the parameter dims evenly."""
        for path, leaf in tree_items(params).items():
            spec = self.spec_for(path, leaf)
            for dim, axes in enumerate(spec):
                if axes is None:
                    continue
                if dim >= leaf.dim():
                    raise ValueError(f"{path}: spec {spec} has more dims than parameter shape "
                                     f"{tuple(leaf.shape)}")
                names = spec_axes(axes)
                size = 1
                for nm in names:
                    size *= mesh.shape[nm]
                if leaf.shape[dim] % size:
                    raise ValueError(f"{path}: dim {dim} ({leaf.shape[dim]}) not divisible by "
                                     f"mesh axes {names} (size {size})")

    def shard(self, leaf: torch.Tensor, spec: P, mesh: Mesh) -> torch.Tensor:
        """This rank's block of the whole ``leaf`` under ``spec``."""
        return shard_leaf(leaf, spec, mesh)


def replicated_plan() -> ShardingPlan:
    return ShardingPlan()


def megatron_transformer_rules(model_axis: str = "model") -> List[Tuple[str, P]]:
    """Megatron's tensor-parallel layout for ``nn.Transformer`` 's names:
    the q/k/v projections and the FFN filter column-parallel (their output
    features split), the attention and FFN outputs row-parallel (their
    input features split), everything else replicated."""
    a = model_axis
    return [
        (r"(self|cross)_(q|k|v)_w$", P(a, None)),  # (out, in) column-parallel
        (r"(self|cross)_out_w$", P(None, a)),  # row-parallel
        (r"filter_w$", P(a, None)),
        (r"filter_b$", P(a)),
        (r"(^|/)out_w$", P(None, a)),
    ]


def megatron_transformer_plan(model_axis: str = "model") -> ShardingPlan:
    return ShardingPlan(megatron_transformer_rules(model_axis))


def is_sharded(spec: Optional[P]) -> bool:
    return spec is not None and any(spec_axes(e) for e in spec)
