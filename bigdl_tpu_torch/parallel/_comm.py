"""The collectives of the data-parallel step over the ``torch.distributed``
group of ``Engine.init_distributed``: the JAX package's ``psum_scatter``,
``all_gather``, ``pmean``, ``psum``, ``pmax`` and ``all_to_all`` over a
mesh axis, here over the group's ranks.

Without a group the world size is 1 and each collective is the identity
(the JAX package's one-device mesh: there is nothing to synchronise).

Routes. Every collective runs on the tensors where they are, on NCCL or
on gloo. gloo also takes CUDA tensors (ranks sharing one card, where NCCL
refuses them), copying through host memory inside the backend: with torch
2.11 on an H100 (``chip_smoke.py`` [22b]-[22d]) the float32 and bfloat16
reduce-scatter and all-gather, the float32 sum and max all-reduce and the
int8 all-to-all of the steps below leave the two ranks bit-equal to the
plain simulation. So nothing is staged here, and nothing catches a failed
collective to try it another way.

Mesh axes. The collectives over a mesh line (``Mesh.line(axes)``, from
``sharding.py``) take the line's process group; ``ppermute`` is the JAX
package's ``lax.ppermute``. Its hop is one ``all_to_all_single`` over the
line with uneven splits (the sender's size towards its receiver, zeros
elsewhere), on every backend: gloo 2.11 on an H100 refuses ``send``/``recv``
and ``batch_isend_irecv`` of CUDA tensors (``tools/torch_p2p_probe.py``,
four ranks sharing the card: ``writev ... Bad address``, then the peers'
connections close), while the uneven all-to-all of the same float32
tensors left them bit-equal. NCCL takes the same uneven
all-to-all, so the one route that is tested here is also the route of
ranks on cards of their own. Nothing tries another route on a failure. The
autograd ``Function`` s below give the mesh boundaries their backward.

Counters. Each collective adds its operand's bytes (what a rank puts on
the wire: the full vector of a reduce-scatter, the shard of an all-gather)
to its count (:func:`counts`, :func:`reset_counts`), and a mesh-axis
collective to its axes' count too (:func:`axis_counts`; a ``ppermute``
counts the sender's tensor, a ``broadcast`` the source's): the port's
reading of what the JAX package's ``obs.profiler.collective_bytes`` locks
on the lowered program.

The active group. An elastic run (``resilience/elastic.py``) trains on a
part of the world after a host is lost: :func:`set_active` makes that part
(its process group and its global ranks) the group of every collective
here and of :func:`world` / :func:`rank` (the rank's place in it), until
the whole world is active again.

Wire types: float8 codes cross as ``view(torch.uint8)``. A ``pmean`` on a
bfloat16 wire sums in the backend's order, not XLA's, so its rounding
differs from the JAX package's by a few bf16 ulps.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from ..utils.engine import Engine

COLLECTIVES = ("psum_scatter", "all_gather", "pmean", "psum", "pmax", "all_to_all",
               "ppermute", "broadcast")

_lock = threading.Lock()
_bytes: Dict[str, int] = dict.fromkeys(COLLECTIVES, 0)
_calls: Dict[str, int] = dict.fromkeys(COLLECTIVES, 0)
_axis: Dict[Tuple[str, str], List[int]] = {}  # (collective, axes) -> [calls, bytes]
_active: Optional[Tuple[Any, Tuple[int, ...]]] = None  # (group, global ranks) of a part


def global_rank() -> int:
    """This process's rank in the whole group (0 without one)."""
    sl = Engine.process_slice()
    return 0 if sl is None else sl[0]


def set_active(group, ranks: Optional[Sequence[int]]) -> None:
    """Make ``ranks`` (global, ascending) and their process ``group`` the
    group of the collectives; ``ranks=None`` makes it the whole group."""
    global _active
    _active = None if ranks is None else (group, tuple(int(r) for r in ranks))


def members() -> Tuple[int, ...]:
    """The global ranks of the active group, ascending."""
    if _active is not None:
        return _active[1]
    return tuple(range(Engine.device_count()))


def group():
    """The active group's process group (None: the default group)."""
    return None if _active is None else _active[0]


def world() -> int:
    """Ranks in the active group (1 without a group)."""
    return Engine.device_count() if _active is None else len(_active[1])


def rank() -> int:
    """This process's place in the active group (0 without a group, -1
    when it is not in it)."""
    r = global_rank()
    if _active is None:
        return r
    return _active[1].index(r) if r in _active[1] else -1


def reset_counts() -> None:
    with _lock:
        for d in (_bytes, _calls):
            for k in d:
                d[k] = 0
        _axis.clear()


def counts() -> Dict[str, Dict[str, int]]:
    """``{collective: {"calls", "bytes"}}`` since the last
    :func:`reset_counts`."""
    with _lock:
        return {n: {"calls": _calls[n], "bytes": _bytes[n]} for n in COLLECTIVES}


def axis_counts() -> Dict[str, Dict[str, Dict[str, int]]]:
    """``{axes: {collective: {"calls", "bytes"}}}`` of the mesh-axis
    collectives since the last :func:`reset_counts` (``axes`` joined by
    ``+``); they are in :func:`counts` too."""
    with _lock:
        out: Dict[str, Dict[str, Dict[str, int]]] = {}
        for (name, axes), (calls, nbytes) in _axis.items():
            out.setdefault(axes, {})[name] = {"calls": calls, "bytes": nbytes}
        return out


def _count(name: str, operand: torch.Tensor, axes: Optional[Sequence[str]] = None,
           nbytes: Optional[int] = None) -> None:
    """Count one collective and its operand's bytes (``nbytes`` when the
    operand is not what crosses the wire), under its mesh axes too."""
    n = operand.numel() * operand.element_size() if nbytes is None else nbytes
    with _lock:
        _calls[name] += 1
        _bytes[name] += n
        if axes is not None:
            entry = _axis.setdefault((name, "+".join(axes)), [0, 0])
            entry[0] += 1
            entry[1] += n


def _wire(t: torch.Tensor) -> torch.Tensor:
    """float8 codes cross the wire as their bytes."""
    if t.dtype in (torch.float8_e4m3fn, torch.float8_e5m2):
        return t.view(torch.uint8)
    return t


def _all_reduce_(t: torch.Tensor, name: str, op) -> torch.Tensor:
    import torch.distributed as dist

    _count(name, t)
    dist.all_reduce(t, op=op, group=group())
    return t


def psum_(t: torch.Tensor) -> torch.Tensor:
    """Sum over the ranks, in place; returns ``t``."""
    if world() == 1:
        return t
    import torch.distributed as dist

    return _all_reduce_(t, "psum", dist.ReduceOp.SUM)


def pmean_(t: torch.Tensor) -> torch.Tensor:
    """Mean over the ranks, in place (a sum, then a division by the world
    size); returns ``t``."""
    n = world()
    if n == 1:
        return t
    import torch.distributed as dist

    return _all_reduce_(t, "pmean", dist.ReduceOp.SUM).div_(n)


def pmax_(t: torch.Tensor) -> torch.Tensor:
    """Maximum over the ranks, in place; returns ``t``."""
    if world() == 1:
        return t
    import torch.distributed as dist

    return _all_reduce_(t, "pmax", dist.ReduceOp.MAX)


def psum_scatter(flat: torch.Tensor) -> torch.Tensor:
    """The tiled reduce-scatter of a 1-D ``flat`` of ``n·k`` elements: this
    rank's ``k`` -element slice of the sum over the ranks (a new tensor)."""
    n = world()
    if n == 1:
        return flat
    import torch.distributed as dist

    k = flat.numel() // n
    out = torch.empty(k, dtype=flat.dtype, device=flat.device)
    _count("psum_scatter", flat)
    dist.reduce_scatter(out, list(flat.view(n, k).unbind(0)), group=group())
    return out


def all_gather_into(out: torch.Tensor, shard: torch.Tensor) -> torch.Tensor:
    """The tiled all-gather: each rank's ``k`` -element ``shard`` into its
    slice of the 1-D ``out`` of ``n·k`` elements (``shard`` may be a view
    of ``out``); returns ``out``."""
    n = world()
    if n == 1:
        if shard.data_ptr() != out.data_ptr():
            out.copy_(shard)
        return out
    import torch.distributed as dist

    _count("all_gather", shard)
    dist.all_gather(list(_wire(out).view(n, shard.numel()).unbind(0)), _wire(shard),
                    group=group())
    return out


def all_gather_stack(t: torch.Tensor) -> torch.Tensor:
    """The untiled all-gather: every rank's ``t`` stacked on a new leading
    axis of the world size."""
    n = world()
    if n == 1:
        return t.unsqueeze(0)
    import torch.distributed as dist

    _count("all_gather", t)
    out = torch.empty((n,) + tuple(t.shape), dtype=t.dtype, device=t.device)
    dist.all_gather(list(_wire(out).unbind(0)), _wire(t.contiguous()), group=group())
    return out


def all_to_all(t: torch.Tensor) -> torch.Tensor:
    """The tiled all-to-all of a 1-D ``t`` of ``n·k`` elements: chunk ``j``
    goes to rank ``j``; the result's chunk ``j`` is what rank ``j`` sent
    this rank."""
    if world() == 1:
        return t
    import torch.distributed as dist

    _count("all_to_all", t)
    out = torch.empty_like(t)
    dist.all_to_all_single(_wire(out), _wire(t.contiguous()), group=group())
    return out


def barrier() -> None:
    """Wait for every rank (a no-op without a group)."""
    if world() > 1:
        import torch.distributed as dist

        dist.barrier(group=group())


# ------------------------------------------------------------ mesh axes
# The collectives over a mesh line (``Mesh.line(axes)``: its process group,
# its global ranks in the order of ``axes`` and this rank's place). A line
# of one rank has nothing to exchange: each collective is the identity.
# torch orders a group's ranks by their global rank; the results below are
# put in the order of ``axes`` (the JAX package's ``P((a, b))`` order).


def _sorted_order(line) -> List[int]:
    """For each place along ``line``, where its rank stands in the group's
    (sorted) order."""
    order = sorted(line.ranks)
    return [order.index(r) for r in line.ranks]


def axis_all_gather(t: torch.Tensor, mesh, axes: Sequence[str], dim: int = 0) -> torch.Tensor:
    """Every rank's ``t`` along ``axes`` concatenated on ``dim`` in the
    axes' order (the tiled all-gather of a ``P(axes)`` dim)."""
    line = mesh.line(axes)
    if line.size == 1:
        return t
    import torch.distributed as dist

    t = t.contiguous()
    _count("all_gather", t, axes)
    parts = [torch.empty_like(t) for _ in line.ranks]
    dist.all_gather([_wire(p) for p in parts], _wire(t), group=line.group)
    pos = _sorted_order(line)
    return torch.cat([parts[pos[i]] for i in range(line.size)], dim)


def axis_block(t: torch.Tensor, mesh, axes: Sequence[str], dim: int = 0) -> torch.Tensor:
    """This rank's block of ``t`` along ``dim`` over ``axes`` (no
    communication)."""
    line = mesh.line(axes)
    if line.size == 1:
        return t
    k = t.shape[dim] // line.size
    return t.narrow(dim, line.index * k, k)


def axis_psum_(t: torch.Tensor, mesh, axes: Sequence[str]) -> torch.Tensor:
    """Sum over ``axes``, in place; returns ``t``."""
    line = mesh.line(axes)
    if line.size == 1:
        return t
    import torch.distributed as dist

    _count("psum", t, axes)
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=line.group)
    return t


def axis_pmean_(t: torch.Tensor, mesh, axes: Sequence[str]) -> torch.Tensor:
    """Mean over ``axes``, in place (a sum, then a division); returns ``t``."""
    line = mesh.line(axes)
    if line.size == 1:
        return t
    import torch.distributed as dist

    _count("pmean", t, axes)
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=line.group)
    return t.div_(line.size)


def axis_broadcast_(t: torch.Tensor, mesh, axis: str, src: int) -> torch.Tensor:
    """The ``t`` of the rank at place ``src`` along ``axis`` on every rank
    of the line, in place; returns ``t``."""
    line = mesh.line((axis,))
    if line.size == 1:
        return t
    import torch.distributed as dist

    if line.index == src:
        _count("broadcast", t, (axis,))
    dist.broadcast(_wire(t), src=line.ranks[src], group=line.group)
    return t


def axis_all_to_all(t: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The tiled all-to-all along dim 0 over ``axis``: block ``j`` of ``t``
    goes to place ``j``; block ``j`` of the result came from place ``j``
    (``lax.all_to_all(split_axis=0, concat_axis=0, tiled=True)``)."""
    line = mesh.line((axis,))
    if line.size == 1:
        return t
    import torch.distributed as dist

    t = t.contiguous()
    _count("all_to_all", t, (axis,))
    pos = _sorted_order(line)
    n, k = line.size, t.shape[0] // line.size
    # the group's order is the sorted ranks': put each block at its peer's
    send = torch.empty_like(t)
    for i in range(n):
        send.narrow(0, pos[i] * k, k).copy_(t.narrow(0, i * k, k))
    got = torch.empty_like(t)
    dist.all_to_all_single(_wire(got), _wire(send), group=line.group)
    out = torch.empty_like(t)
    for i in range(n):
        out.narrow(0, i * k, k).copy_(got.narrow(0, pos[i] * k, k))
    return out


def ppermute(t: Optional[torch.Tensor], mesh, axis: str, perm: Sequence[Tuple[int, int]],
             recv_like: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``lax.ppermute`` over ``axis``: for each ``(src, dst)`` of ``perm``
    (places along the axis), the ``t`` of ``src`` arrives at ``dst``; a
    place that receives nothing gets zeros. Every rank of the line calls
    it with the same ``perm``. A rank that sends nothing may pass
    ``t=None``; ``recv_like`` (default ``t``) gives the shape and dtype of
    what arrives. See the module docstring for the route."""
    line = mesh.line((axis,))
    me = line.index
    dst = [d for s, d in perm if s == me]
    src = [s for s, d in perm if d == me]
    if len(dst) > 1 or len(src) > 1:
        raise ValueError(f"ppermute: perm {list(perm)} is not a partial permutation")
    like = t if recv_like is None else recv_like
    make = torch.empty if src else torch.zeros
    out = make(like.shape, dtype=like.dtype, device=like.device)
    if line.size == 1:
        return out.copy_(t) if src else out
    if dst:
        t = t.contiguous()
        _count("ppermute", t, (axis,))
    _hop(t if dst else None, out if src else None, line,
         dst[0] if dst else None, src[0] if src else None, out)
    return out


def _hop(t, out, line, dst, src, like) -> None:
    """The hop as one all-to-all over the line with uneven splits: every
    rank of the line takes part, with the sizes of what it sends and
    receives and zeros elsewhere (``like`` gives an idle rank's dtype)."""
    import torch.distributed as dist

    pos = _sorted_order(line)
    ins = [0] * line.size
    outs = [0] * line.size
    if t is not None:
        ins[pos[dst]] = t.numel()
    if out is not None:
        outs[pos[src]] = out.numel()
    empty = torch.empty(0, dtype=_wire(like).dtype, device=like.device)
    send = _wire(t).reshape(-1) if t is not None else empty
    recv = _wire(out).view(-1) if out is not None else empty
    dist.all_to_all_single(recv, send, outs, ins, group=line.group)


def _inverse(perm: Sequence[Tuple[int, int]]) -> List[Tuple[int, int]]:
    return [(d, s) for s, d in perm]


# ------------------------------------------------- autograd at the boundaries
# In the JAX package the code around a ``shard_map`` is one replicated
# program; here every rank runs it on the same values. So each boundary's
# backward is the transpose JAX gives the shard_map (``check_vma=False``):
# a ``P(axes)`` input cut from a tensor every rank holds whole gathers the
# blocks' gradients; a ``P(axes)`` output gathered from the blocks keeps
# this rank's block of the gradient, with no sum; a tensor that enters
# whole while the work is split over ``axes`` sums its gradient over them.


class _Block(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return axis_block(t, mesh, axes, dim).clone()

    @staticmethod
    def backward(ctx, g):
        return axis_all_gather(g, ctx.mesh, ctx.axes, ctx.dim), None, None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return axis_all_gather(t, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return axis_block(g, ctx.mesh, ctx.axes, ctx.dim).contiguous(), None, None, None


class _SumGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return axis_psum_(g.clone(), ctx.mesh, ctx.axes), None, None


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axis, perm):
        ctx.mesh, ctx.axis, ctx.perm = mesh, axis, perm
        return ppermute(t, mesh, axis, perm)

    @staticmethod
    def backward(ctx, g):
        return ppermute(g, ctx.mesh, ctx.axis, _inverse(ctx.perm)), None, None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return axis_all_to_all(t, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        # the tiled all-to-all along one dim is its own transpose
        return axis_all_to_all(g, ctx.mesh, ctx.axis), None, None


def block(t: torch.Tensor, mesh, axes: Sequence[str], dim: int = 0) -> torch.Tensor:
    """This rank's ``P(axes)`` block of a tensor every rank holds whole;
    the backward gathers the blocks' gradients."""
    return _Block.apply(t, mesh, tuple(axes), dim) if mesh.line(axes).size > 1 else t


def gather(t: torch.Tensor, mesh, axes: Sequence[str], dim: int = 0) -> torch.Tensor:
    """The whole tensor from the ranks' ``P(axes)`` blocks; the backward
    keeps this rank's block of the gradient."""
    return _Gather.apply(t, mesh, tuple(axes), dim) if mesh.line(axes).size > 1 else t


def sum_grad(t: torch.Tensor, mesh, axes: Sequence[str]) -> torch.Tensor:
    """``t`` as it is; its gradient summed over ``axes`` (a ``P()`` input
    to work split over them)."""
    axes = tuple(a for a in axes if a is not None)
    if not axes or mesh.line(axes).size == 1 or not t.requires_grad:
        return t
    return _SumGrad.apply(t, mesh, axes)


def ppermute_ad(t: torch.Tensor, mesh, axis: str, perm) -> torch.Tensor:
    """:func:`ppermute` whose backward sends the gradients back along the
    inverse permutation."""
    return _PPermute.apply(t, mesh, axis, [tuple(p) for p in perm])


def all_to_all_ad(t: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """:func:`axis_all_to_all` with its backward."""
    return _AllToAll.apply(t, mesh, axis)
