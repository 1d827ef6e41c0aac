"""Mixture-of-experts routing on one device (counterpart of the single-device
part of ``bigdl_tpu/parallel/moe.py``).

``_route`` is the switch / GShard top-k router with a per-expert capacity,
``moe_capacity`` the buffer size every path shares, and
``moe_ffn_reference`` the dense oracle of the capacity semantics (tokens
capacity-limited within each of the ``n_experts`` source shards, as the
expert-parallel layout drops them). The expert-parallel ``moe_ffn`` (experts
one a device, tokens carried by two ``all_to_all`` hops) is not ported: it
needs the multi-process runtime (ROADMAP Queue 1 item 8).

Ties: ``lax.top_k`` puts the lower expert first among equal logits (an
all-zero token gives exact ties). ``torch.topk`` on the card promises no
order, so the router sorts stably, which does.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


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
