"""Mixture-of-experts routing and expert parallelism (counterpart of
``bigdl_tpu/parallel/moe.py``).

``_route`` is the switch / GShard top-k router with a per-expert capacity,
``moe_capacity`` the buffer size every path shares, and
``moe_ffn_reference`` the dense oracle of the capacity semantics (tokens
capacity-limited within each of the ``n_experts`` source shards, as the
expert-parallel layout drops them).

``moe_ffn`` is the expert-parallel layer: one expert a rank along the
``expert`` axis, the tokens cut into one shard a rank (over
``(batch_axis, expert)`` under dp x ep), each rank routing its shard into an
(E, C, D) send buffer, and two tiled all-to-all hops
(:func:`~bigdl_tpu_torch.parallel._comm.all_to_all_ad`) carrying the
tokens to their expert's rank and back. The scatter into the buffer is an
``index_put_`` with ``accumulate=True`` (the JAX package's ``.at[].add``);
an entry past its expert's capacity goes to one extra row that is cut off,
as the dense path does, since ``index_put_`` refuses an out-of-range index
where ``.at[].add`` drops it.

Ties: ``lax.top_k`` puts the lower expert first among equal logits (an
all-zero token gives exact ties). ``torch.topk`` on the card promises no
order, so the router sorts stably, which does.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional

import torch
import torch.nn.functional as F

from . import _comm


def _route(gate_logits: torch.Tensor, n_experts: int, capacity: int, k: int = 1):
    """Top-k routing with per-expert capacity over one shard's (T, E)
    logits. Returns ``(expert_id, slot, keep, w)``, each (T, k): ``slot`` is
    the entry's place in its expert's buffer, ``keep`` False past the
    capacity. Capacity is choice-major (every first choice queues before any
    second one, GShard's policy). ``w`` is the gate probability for k = 1
    (the switch convention) and the top-k probabilities normalized over the
    k for k > 1 (GShard)."""
    prob_all = torch.softmax(gate_logits, dim=-1)
    topi = torch.sort(gate_logits, dim=-1, descending=True, stable=True).indices[:, :k]
    probk = torch.gather(prob_all, 1, topi)
    t = gate_logits.shape[0]
    ids_flat = topi.t().reshape(-1)  # choice-major: the first choices first
    onehot = F.one_hot(ids_flat, n_experts)
    slot = ((torch.cumsum(onehot, 0) * onehot).sum(-1) - 1).reshape(k, t).t()
    keep = slot < capacity
    if k == 1:
        w = probk
    else:
        w = probk / torch.clamp(probk.sum(-1, keepdim=True), min=1e-9)
    return topi, slot, keep, w


def moe_capacity(t_local: int, n_experts: int, capacity_factor: float, k: int = 1) -> int:
    """The per-(source shard, expert) buffer size shared by every path:
    ``ceil(t_local / n_experts * capacity_factor * k)``, at least 1."""
    return max(1, math.ceil(t_local / n_experts * capacity_factor * k))


def moe_ffn_reference(router_w, expert_params, expert_fn, x, n_experts: int,
                      capacity_factor: float = 1.25, router_top_k: int = 1):
    """Dense single-device oracle with the routing semantics of
    :func:`_route`: per source shard, every expert's FFN over the whole
    shard, each kept (token, choice) taking its expert's row, weighted."""
    b, d = x.shape
    k = router_top_k
    if b % n_experts:
        raise ValueError(f"batch {b} not divisible by experts {n_experts}")
    t_local = b // n_experts
    capacity = moe_capacity(t_local, n_experts, capacity_factor, k)
    shards = []
    for s in range(n_experts):
        xs = x[s * t_local:(s + 1) * t_local]
        expert_id, _, keep, w = _route(xs @ router_w, n_experts, capacity, k)
        per_expert = [expert_fn({name: p[e] for name, p in expert_params.items()}, xs)
                      for e in range(n_experts)]
        ys = torch.zeros_like(xs)
        for j in range(k):
            yj = torch.zeros_like(xs)
            for e in range(n_experts):
                mask = (expert_id[:, j] == e) & keep[:, j]
                yj = torch.where(mask[:, None], per_expert[e], yj)
            ys = ys + yj * w[:, j, None]
        shards.append(ys)
    return torch.cat(shards, 0)


def _per_rank(router_w, params_local: Dict[str, torch.Tensor], expert_fn, x_local, mesh,
              axis: str, n_experts: int, capacity: int, k: int) -> torch.Tensor:
    """One rank's part of :func:`moe_ffn`: route ``x_local`` (T, D), pack
    the (E, C, D) send buffer, the two hops around this rank's expert, and
    the gate-weighted combine."""
    t, d = x_local.shape
    expert_id, slot, keep, w = _route(x_local @ router_w, n_experts, capacity, k)
    n_rows = n_experts * capacity
    rows = torch.where(keep, expert_id * capacity + slot, torch.full_like(slot, n_rows))
    src = x_local[:, None, :].expand(t, k, d).reshape(-1, d)
    send = x_local.new_zeros((n_rows + 1, d)).index_put(
        (rows.reshape(-1),), src, accumulate=True)[:n_rows]
    # row e of the send buffer goes to expert e; on receipt the leading axis
    # is the source rank: recv[(s, c)] = what rank s routed to this expert
    recv = _comm.all_to_all_ad(send, mesh, axis)
    out = expert_fn({name: p[0] for name, p in params_local.items()}, recv)
    back = _comm.all_to_all_ad(out, mesh, axis)
    gathered = back[(expert_id * capacity + torch.clamp(slot, 0, capacity - 1)).reshape(-1)]
    gathered = gathered.reshape(t, k, d)
    return torch.sum(torch.where(keep[..., None], gathered, torch.zeros_like(gathered))
                     * w[..., None], dim=1)


def _check_moe(router_w, expert_params, x, mesh, axis, router_top_k, batch_axis,
               local: bool) -> int:
    """The JAX package's checks of :func:`moe_ffn`; returns the capacity."""
    n_experts = mesh.shape[axis]
    b = x.shape[0]
    k = router_top_k
    if not 1 <= k <= n_experts:
        raise ValueError(f"router_top_k {k} not in [1, {n_experts}]")
    if router_w.shape[1] != n_experts:
        raise ValueError(
            f"router_w routes over {router_w.shape[1]} experts but the {axis!r} mesh axis has "
            f"{n_experts} — an oversized router would silently corrupt over-range tokens")
    if batch_axis is not None:
        if batch_axis == axis:
            raise ValueError(f"batch_axis must differ from expert axis {axis!r}")
        if batch_axis not in mesh.shape:
            raise ValueError(f"batch_axis {batch_axis!r} not in mesh axes {tuple(mesh.shape)}")
    dp = mesh.shape[batch_axis] if batch_axis is not None else 1
    if b % (dp * n_experts):
        raise ValueError(f"batch {b} not divisible by data({dp}) x experts({n_experts})")
    lead = 1 if local else n_experts
    for leaf in expert_params.values():
        if leaf.shape[0] != lead:
            raise ValueError(f"expert_params leading dim {leaf.shape[0]} != experts "
                             f"{n_experts}")
    return b // (dp * n_experts)


def moe_ffn(router_w: torch.Tensor, expert_params: Dict[str, torch.Tensor],
            expert_fn: Callable[[Any, torch.Tensor], torch.Tensor], x: torch.Tensor, mesh,
            axis: str = "expert", capacity_factor: float = 1.25, router_top_k: int = 1,
            batch_axis: Optional[str] = None, local_experts: bool = False) -> torch.Tensor:
    """Expert-parallel top-k MoE over the (B, D) token batch every rank
    holds whole (see the module docstring).

    ``router_w`` (D, E) is replicated; ``expert_params`` holds leaves
    stacked over the E experts (or, with ``local_experts=True``, this
    rank's expert alone with a leading dim of 1, as the expert-parallel
    optimizer keeps them); ``expert_fn(params_one_expert, tokens)`` maps
    (N, D) -> (N, D). B divides by E (by dp·E with ``batch_axis``, which
    cuts the tokens over both axes: capacity is then counted per (data
    row, source rank), dp·E shards of B/(dp·E) tokens). ``router_top_k``
    1 is the switch (the raw gate probability scales the output), 2 GShard
    (the top-2 probabilities normalised). Returns (B, D) on every rank;
    dropped entries contribute 0."""
    n_experts = mesh.shape[axis]
    t_local = _check_moe(router_w, expert_params, x, mesh, axis, router_top_k, batch_axis,
                         local_experts)
    capacity = moe_capacity(t_local, n_experts, capacity_factor, router_top_k)
    tok_axes = (batch_axis, axis) if batch_axis is not None else (axis,)
    # the router's gradient from this rank's tokens sums over every axis
    # the tokens are cut over; an expert's over the data rows
    router_w = _comm.sum_grad(router_w, mesh, tok_axes)
    if local_experts:
        params = {n: _comm.sum_grad(p, mesh, (batch_axis,)) for n, p in expert_params.items()}
    else:
        params = {n: _comm.sum_grad(_comm.block(p, mesh, (axis,), 0), mesh, (batch_axis,))
                  for n, p in expert_params.items()}
    x_local = _comm.block(x, mesh, tok_axes, 0)
    y = _per_rank(router_w, params, expert_fn, x_local, mesh, axis, n_experts, capacity,
                  router_top_k)
    return _comm.gather(y, mesh, tok_axes, 0)
