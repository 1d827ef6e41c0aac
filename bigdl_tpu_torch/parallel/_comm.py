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

Counters. Each collective adds its operand's bytes (what a rank puts on
the wire: the full vector of a reduce-scatter, the shard of an all-gather)
to its count (:func:`counts`, :func:`reset_counts`): the port's reading of
what the JAX package's ``obs.profiler.collective_bytes`` locks on the
lowered program.

Wire types: float8 codes cross as ``view(torch.uint8)``. A ``pmean`` on a
bfloat16 wire sums in the backend's order, not XLA's, so its rounding
differs from the JAX package's by a few bf16 ulps.
"""

from __future__ import annotations

import threading
from typing import Dict

import torch

from ..utils.engine import Engine

COLLECTIVES = ("psum_scatter", "all_gather", "pmean", "psum", "pmax", "all_to_all")

_lock = threading.Lock()
_bytes: Dict[str, int] = dict.fromkeys(COLLECTIVES, 0)
_calls: Dict[str, int] = dict.fromkeys(COLLECTIVES, 0)


def world() -> int:
    """Ranks in the group (1 without one)."""
    return Engine.device_count()


def rank() -> int:
    """This process's rank (0 without a group)."""
    sl = Engine.process_slice()
    return 0 if sl is None else sl[0]


def reset_counts() -> None:
    with _lock:
        for d in (_bytes, _calls):
            for k in d:
                d[k] = 0


def counts() -> Dict[str, Dict[str, int]]:
    """``{collective: {"calls", "bytes"}}`` since the last
    :func:`reset_counts`."""
    with _lock:
        return {n: {"calls": _calls[n], "bytes": _bytes[n]} for n in COLLECTIVES}


def _count(name: str, operand: torch.Tensor) -> None:
    """Count one collective and its operand's bytes."""
    with _lock:
        _calls[name] += 1
        _bytes[name] += operand.numel() * operand.element_size()


def _wire(t: torch.Tensor) -> torch.Tensor:
    """float8 codes cross the wire as their bytes."""
    if t.dtype in (torch.float8_e4m3fn, torch.float8_e5m2):
        return t.view(torch.uint8)
    return t


def _all_reduce_(t: torch.Tensor, name: str, op) -> torch.Tensor:
    import torch.distributed as dist

    _count(name, t)
    dist.all_reduce(t, op=op)
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
    dist.reduce_scatter(out, list(flat.view(n, k).unbind(0)))
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
    dist.all_gather(list(_wire(out).view(n, shard.numel()).unbind(0)), _wire(shard))
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
    dist.all_gather(list(_wire(out).unbind(0)), _wire(t.contiguous()))
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
    dist.all_to_all_single(_wire(out), _wire(t.contiguous()))
    return out


def barrier() -> None:
    """Wait for every rank (a no-op without a group)."""
    if world() > 1:
        import torch.distributed as dist

        dist.barrier()
