"""Sequence parallelism: ring attention over a mesh axis (counterpart of
``bigdl_tpu/parallel/sequence.py``).

The sequence is cut into one contiguous chunk a rank along ``sp``; each
rank keeps its query chunk and the K/V chunks travel around the ring with
:func:`~bigdl_tpu_torch.parallel._comm.ppermute` (one hop ``i -> i+1`` a
step, for K and for V), while the softmax is accumulated online with the
flash-attention recurrence, blocked at rank granularity. The block
products are torch ops, as they are ``jnp.einsum`` s outside any Pallas
kernel in the JAX package. The ring is differentiable: the hop's backward
sends the gradients back the other way (``_comm.ppermute_ad``), so
``backward()`` runs the reverse ring.

``ring_attention_shard`` is the per-rank body; ``ring_attention`` takes
the whole (N, heads, T, d) operands every rank holds, cuts this rank's
chunk (its backward gathers the chunks' gradients) and gathers the
output's chunks (its backward keeps this rank's chunk of the gradient),
the transposes of the JAX package's ``shard_map`` specs.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from . import _comm


def ring_attention_shard(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh,
                         axis_name: str, axis_size: int, causal: bool = False,
                         scale: Optional[float] = None, lengths: Optional[torch.Tensor] = None,
                         mask_q: Optional[bool] = None) -> torch.Tensor:
    """Exact attention over sequence shards, on this rank's chunks.

    ``q``/``k``/``v``: (N, heads, Tc, d), this rank's chunk of a sequence
    of ``Tc * axis_size`` (rank i along the axis holds chunk i). ``causal``
    masks with global positions, the queries aligned at the end for
    Tq != Tk: query t of rank i sits at ``i*Tc + t + n*(Tk - Tc)``. The K/V
    block visiting at step s came from rank ``(i - s) % n``. ``lengths``
    (int (N,), the same on every rank) masks keys at global positions past
    each row's length; with ``mask_q`` (None: Tc == Tk) the padded query
    rows give zeros."""
    n = axis_size
    me = mesh.line((axis_name,)).index
    _, _, tc, depth = q.shape
    tk = k.shape[2]
    if mask_q is None:
        mask_q = tc == tk
    if scale is None:
        scale = 1.0 / math.sqrt(depth)
    dev = q.device
    q_pos = me * tc + torch.arange(tc, device=dev) + n * (tk - tc)
    m = torch.full(q.shape[:3], -1e30, dtype=q.dtype, device=dev)  # running row max
    l = torch.zeros(q.shape[:3], dtype=q.dtype, device=dev)  # running denominator
    o = torch.zeros_like(q)  # running numerator
    perm = [(i, (i + 1) % n) for i in range(n)]
    for s in range(n):
        src = (me - s) % n
        k_pos = src * tk + torch.arange(tk, device=dev)
        logits = torch.einsum("nhqd,nhkd->nhqk", q, k) * scale
        allowed = None
        if causal:
            allowed = (q_pos[:, None] >= k_pos[None, :])[None]  # (1, Tc, Tk)
        if lengths is not None:
            key_ok = k_pos[None, None, :] < lengths.to(dev)[:, None, None]  # (N, 1, Tk)
            allowed = key_ok if allowed is None else (allowed & key_ok)
        if allowed is not None:
            logits = torch.where(allowed[:, None], logits,
                                 torch.tensor(float("-inf"), dtype=logits.dtype, device=dev))
        block_max = torch.amax(logits, dim=-1)  # -inf where a row is all masked
        m_new = torch.maximum(m, block_max)
        p = torch.exp(logits - m_new[..., None])
        p = torch.where(torch.isfinite(logits), p, torch.zeros((), dtype=p.dtype, device=dev))
        corr = torch.exp(m - m_new)
        l = l * corr + torch.sum(p, dim=-1)
        o = o * corr[..., None] + torch.einsum("nhqk,nhkd->nhqd", p, v)
        m = m_new
        if s != n - 1:
            k = _comm.ppermute_ad(k, mesh, axis_name, perm)
            v = _comm.ppermute_ad(v, mesh, axis_name, perm)
    out = o / torch.clamp(l, min=1e-30)[..., None]
    if lengths is not None and mask_q:
        row_valid = q_pos[None, :] < lengths.to(dev)[:, None]  # (N, Tc)
        out = out * row_valid[:, None, :, None].to(out.dtype)
    return out


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh,
                   axis_name: str = "sp", causal: bool = False, scale: Optional[float] = None,
                   lengths: Optional[torch.Tensor] = None,
                   mask_q: Optional[bool] = None) -> torch.Tensor:
    """The ring over whole (N, heads, T, d) operands (see the module
    docstring); ``lengths`` in global positions, ``mask_q=None`` resolved
    on the global shapes (Tq == Tk)."""
    n = mesh.shape[axis_name]
    if q.shape[2] % n or k.shape[2] % n:
        raise ValueError(f"sequence length {q.shape[2]}/{k.shape[2]} not divisible by mesh "
                         f"axis {axis_name!r} size {n}")
    mask_q = (q.shape[2] == k.shape[2]) if mask_q is None else mask_q
    axes = (axis_name,)
    qs, ks, vs = (_comm.block(t, mesh, axes, 2) for t in (q, k, v))
    out = ring_attention_shard(qs, ks, vs, mesh, axis_name, n, causal=causal, scale=scale,
                               lengths=lengths, mask_q=mask_q)
    return _comm.gather(out, mesh, axes, 2)
