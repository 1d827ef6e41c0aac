"""``MoE``, the mixture-of-experts FFN layer (counterpart of
``bigdl_tpu/nn/moe.py``), on its dense path.

``(..., D) -> (..., D)``: a switch top-1 (default) or GShard top-2
(``router_top_k=2``) router sends each token to its experts' FFNs
(``act(h @ w1 + b1) @ w2 + b2`` per expert, float32 as the JAX layer's plain
``@``). Capacity follows the expert-parallel layout on one device: the
tokens are ``n_experts`` source shards, each with a buffer of
``moe_capacity(T / E, E, capacity_factor, k)`` slots per expert; an entry
past its expert's capacity bypasses the expert (a zero output: compose the
layer residually, the switch convention).

The dense path: each kept (token, choice) is added into its (shard, expert,
slot) row of the dispatch buffer, the experts run as batched products over
their rows, and each token gathers its rows back weighted by its gate.
The JAX package scatters with ``.at[].add``, which drops the updates of
dropped entries (their slot is past the buffer); ``index_put_`` would refuse
them (on the card as a device-side assert), so they are sent to one extra
row that is cut off, not clamped into the last slot. The gather clips the
slot as the JAX package does; a dropped entry's row is multiplied by 0.

A training forward puts the switch load-balancing loss (Fedus et al. 2021,
``aux_loss_coeff · E · Σ_e f_e · P_e``, ``f_e`` the fraction of tokens whose
argmax is e, ``P_e`` the mean router probability) in the state under
``"_aux_loss"``, which ``LocalOptimizer`` adds to the objective
(``auxiliary_loss_tree``); an eval forward leaves the state as it is.

``expert_parallel=True`` with a mesh carrying ``mesh_axis`` (from
``set_mesh``, or ``Engine.mesh()``) is the expert-parallel path
(:func:`bigdl_tpu_torch.parallel.moe.moe_ffn`): one expert a rank, the
tokens carried by two all-to-all hops, ``batch_axis`` cutting them over a
second axis. Under ``ExpertParallelOptimizer`` each rank holds only its
expert's block of ``w1``/``b1``/``w2``/``b2`` (a leading dim of 1, not E). Without
a mesh the layer runs its dense path. The load-balancing loss is computed
on the whole batch on both paths.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..parallel.moe import _route, moe_capacity
from .initialization import Xavier
from .module import AbstractModule, spec


def _gelu(x):
    return F.gelu(x, approximate="tanh")  # jax.nn.gelu's default


_ACTIVATIONS = {"relu": torch.relu, "gelu": _gelu, "silu": F.silu, "tanh": torch.tanh}


def _expert_ffn(p, h, activation):
    """One expert's FFN over (T, D) tokens; ``p`` holds unstacked leaves."""
    return _ACTIVATIONS[activation](h @ p["w1"] + p["b1"]) @ p["w2"] + p["b2"]


class MoE(AbstractModule):
    """MoE FFN over the last dim (see the module docstring). Arguments as
    the JAX layer's: ``n_experts`` E (>= 2), ``ffn_size`` F (default 4·D),
    ``capacity_factor``, ``activation`` (relu | gelu | silu | tanh),
    ``router_top_k`` (1 switch, 2 GShard), ``aux_loss_coeff`` (0 turns the
    load-balancing loss off); ``expert_parallel``, ``mesh_axis`` and
    ``batch_axis`` are recorded for the expert-parallel path. The token
    count (the product of the leading dims) must be a multiple of E."""

    def __init__(self, n_experts: int, ffn_size: Optional[int] = None,
                 capacity_factor: float = 1.25, activation: str = "relu",
                 expert_parallel: bool = False, mesh_axis: str = "expert",
                 aux_loss_coeff: float = 0.01, router_top_k: int = 1,
                 batch_axis: Optional[str] = None, device=None):
        super().__init__(device)
        if n_experts < 2:
            raise ValueError(f"n_experts must be >= 2, got {n_experts}")
        if activation not in _ACTIVATIONS:
            raise ValueError(f"activation must be one of {sorted(_ACTIVATIONS)}, "
                             f"got {activation!r}")
        if not 1 <= router_top_k <= n_experts:
            raise ValueError(f"router_top_k {router_top_k} not in [1, {n_experts}]")
        self.router_top_k = router_top_k
        self.n_experts = n_experts
        self.ffn_size = ffn_size
        self.capacity_factor = capacity_factor
        self.activation = activation
        self.expert_parallel = expert_parallel
        self.mesh_axis = mesh_axis
        self.batch_axis = batch_axis
        self.aux_loss_coeff = aux_loss_coeff
        self.weight_init = Xavier()
        self._mesh = None  # runtime state, never serialized

    def set_mesh(self, mesh) -> "MoE":
        """The mesh of the expert-parallel path (runtime state, not
        serialized)."""
        self._mesh = mesh
        return self

    def _resolve_mesh(self):
        if self._mesh is not None:
            return self._mesh
        from ..utils.engine import Engine

        mesh = Engine.mesh()
        if self.mesh_axis in mesh.shape:
            if mesh.shape[self.mesh_axis] != self.n_experts:
                raise ValueError(
                    f"{self.name()}: n_experts={self.n_experts} but the Engine mesh's "
                    f"{self.mesh_axis!r} axis has {mesh.shape[self.mesh_axis]} devices; size "
                    "the layer to the mesh or inject a matching mesh with set_mesh()")
            return mesh
        return None

    def infer_shape(self, in_spec):
        shape = tuple(in_spec.shape)
        if not shape:
            raise ValueError(f"{self.name()}: needs a trailing model dim, got a scalar")
        tokens = 1
        for s in shape[:-1]:
            tokens *= s
        if tokens % self.n_experts:
            raise ValueError(f"{self.name()}: token count {tokens} (product of leading dims of "
                             f"{shape}) not divisible by n_experts={self.n_experts}")
        return spec(shape, torch.promote_types(in_spec.dtype, torch.float32))

    def _build(self, generator, sample):
        d = sample.shape[-1]
        f = self.ffn_size or 4 * d
        e = self.n_experts
        params = {
            # small-init router (the switch recipe): near-uniform first routing
            "router_w": 0.02 * torch.randn((d, e), generator=generator),
            "w1": self.weight_init(generator, (e, d, f), d, f),
            "b1": torch.zeros((e, f)),
            "w2": self.weight_init(generator, (e, f, d), f, d),
            "b2": torch.zeros((e, d)),
        }
        state = {"_aux_loss": torch.zeros(())} if self.aux_loss_coeff else {}
        return params, state

    def _apply_params(self, params, state, x, training, rng):
        d = x.shape[-1]
        lead = x.shape[:-1]
        # the JAX layer's products promote a bf16 input against the float32
        # parameters; its buffers hold the input's values, exact in float32
        tokens = x.reshape(-1, d).to(torch.promote_types(x.dtype, params["router_w"].dtype))
        if tokens.shape[0] % self.n_experts:
            raise ValueError(f"{self.name()}: token count {tokens.shape[0]} not divisible by "
                             f"n_experts {self.n_experts}")
        mesh = self._resolve_mesh() if self.expert_parallel else None
        experts = {n: params[n] for n in ("w1", "b1", "w2", "b2")}
        if mesh is not None:
            from ..parallel.moe import moe_ffn

            y = moe_ffn(params["router_w"], experts,
                        lambda p, h: _expert_ffn(p, h, self.activation), tokens, mesh,
                        axis=self.mesh_axis, capacity_factor=self.capacity_factor,
                        router_top_k=self.router_top_k, batch_axis=self.batch_axis,
                        # one expert's block a rank (ExpertParallelOptimizer)
                        local_experts=params["w1"].shape[0] == 1 < self.n_experts)
        else:
            y = self._dense(params["router_w"], experts, tokens)
        if self.aux_loss_coeff and training:
            probs = torch.softmax(tokens @ params["router_w"], dim=-1)
            e = self.n_experts
            f_e = F.one_hot(torch.argmax(probs, dim=-1), e).to(probs.dtype).mean(0)
            p_e = probs.mean(0)
            aux = self.aux_loss_coeff * e * torch.sum(f_e.detach() * p_e)
            state = {**state, "_aux_loss": aux}
        return y.reshape(*lead, d), state

    def _dense(self, router_w, params, tokens):
        """Dispatch, batched experts, combine on one device, with the
        expert-parallel layout's capacity (the ``all_to_all`` a transpose)."""
        e, k = self.n_experts, self.router_top_k
        b, d = tokens.shape
        t_local = b // e
        capacity = moe_capacity(t_local, e, self.capacity_factor, k)
        xs = tokens.reshape(e, t_local, d)  # (S, T, D): S source shards
        logits = torch.einsum("std,de->ste", xs, router_w)
        routes = [_route(logits[s], e, capacity, k) for s in range(e)]
        expert_id, slot, keep, w = (torch.stack(r) for r in zip(*routes))  # each (S, T, k)
        shard = torch.arange(e, device=tokens.device)[:, None, None]
        base = (shard * e + expert_id) * capacity  # the (shard, expert) buffer's first row
        n_rows = e * e * capacity
        # dispatch: each kept entry added into its row; a dropped one into
        # the extra row n_rows, which is cut off
        rows = torch.where(keep, base + slot, torch.full_like(slot, n_rows))
        src = xs[:, :, None, :].expand(e, t_local, k, d).reshape(-1, d)
        send = tokens.new_zeros((n_rows + 1, d)).index_add(0, rows.reshape(-1), src)[:n_rows]
        recv = send.reshape(e, e, capacity, d).transpose(0, 1).reshape(e, e * capacity, d)
        h = _ACTIVATIONS[self.activation](torch.bmm(recv, params["w1"]) + params["b1"][:, None])
        out = torch.bmm(h, params["w2"]) + params["b2"][:, None]  # (E, S*C, D)
        back = out.reshape(e, e, capacity, d).transpose(0, 1).reshape(n_rows, d)
        g = back[(base + torch.clamp(slot, 0, capacity - 1)).reshape(-1)].reshape(e, t_local, k, d)
        ys = torch.sum(torch.where(keep[..., None], g, torch.zeros_like(g)) * w[..., None], dim=2)
        return ys.reshape(b, d)
