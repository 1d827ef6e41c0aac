"""Flash attention, forward and backward: hand-written CUDA kernels for
Hopper and their plain PyTorch versions.

Counterpart of ``bigdl_tpu/ops/flash_attention.py``. The forward kernel
lives in ``bigdl_tpu_torch/csrc/flash_attention.cu``, the two backward
kernels (dQ, dK/dV) in ``csrc/flash_attention_bwd.cu`` (each source note
says what it replaces, what bounds it on the H100 and what the design does
about that); :mod:`bigdl_tpu_torch.ops._build` compiles and loads them.

:func:`flash_attention_fwd` and :func:`flash_attention_bwd` take their route
from where the tensors lie: CPU tensors go through the plain versions
(:func:`flash_attention_fwd_reference`, :func:`flash_attention_bwd_reference`);
CUDA tensors launch the kernels, and anything the kernels do not take
raises. There is no fallback from a kernel to its plain version.
A meta tensor takes the plain version (shape inference), except inside a
step-cost count (``obs/perf.py``'s ``program_cost``), where the call reports
its analytic FLOPs (:func:`attention_flops`) instead of computing.
:func:`flash_attention` is differentiable: a ``torch.autograd.Function``
whose backward is :func:`flash_attention_bwd`, as ``jax.custom_vjp`` wraps
the Pallas kernels in the JAX package.

Semantics (those of the TPU kernels): ``causal`` is aligned at the end (query
row i sees keys j <= i + Tk - Tq); ``lengths`` (N,) gives each sequence the
key horizon ``min(lengths[n], Tk)``; with ``mask_q`` (default: Tq == Tk) the
query rows at or past that horizon give 0 and get no gradient; a row with no
visible key gives out = 0 and lse = ``NEG_BIG``, and gets no gradient.
"""

from __future__ import annotations

import math
import threading
from typing import Optional, Tuple

import torch

NEG_BIG = -1e30
HEAD_DIMS = (64, 128)

# kernel launches (never the plain versions): forward, dQ, dK/dV
launches = 0
launches_dq = 0
launches_dkv = 0
_count_lock = threading.Lock()


def visible_mask(n: int, tq: int, tk: int, causal: bool, lengths, mask_q: bool,
             device) -> torch.Tensor:
    """(N or 1, 1, Tq, Tk) bool: which (query, key) pairs are visible."""
    rows = torch.arange(tq, device=device)[:, None] + (tk - tq)
    cols = torch.arange(tk, device=device)[None, :]
    vis = torch.ones((tq, tk), dtype=torch.bool, device=device)
    if causal:
        vis = vis & (rows >= cols)
    vis = vis[None, None]
    if lengths is not None:
        kl = torch.clamp(lengths.to(device=device, dtype=torch.long), max=tk)
        kl = kl[:, None, None, None]
        vis = vis & (cols[None, None] < kl)
        if mask_q:
            vis = vis & (rows[None, None] < kl)
    return vis


def flash_attention_fwd_reference(q, k, v, causal: bool = False,
                                  scale: Optional[float] = None,
                                  lengths: Optional[torch.Tensor] = None,
                                  mask_q: Optional[bool] = None
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the kernel on any device: dense fp32 scores, masked
    softmax, ``(out (N,H,Tq,d) in q's dtype, lse (N,H,Tq) f32)``. Written
    from ``bigdl_tpu.ops.flash_attention._dense_reference`` plus the
    kernel's lse and mask rules."""
    n, _, tq, d = q.shape
    tk = k.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if mask_q is None:
        mask_q = tq == tk
    s = torch.einsum("nhqd,nhkd->nhqk", q.float(), k.float()) * scale
    vis = visible_mask(n, tq, tk, causal, lengths, mask_q, q.device)
    s = s.masked_fill(~vis, float("-inf"))
    lse = torch.logsumexp(s, dim=-1)
    has = vis.any(dim=-1)
    p = torch.exp(s - torch.where(has, lse, 0.0).unsqueeze(-1))
    out = torch.einsum("nhqk,nhkd->nhqd", p, v.float()).to(q.dtype)
    lse = torch.where(has, lse, NEG_BIG).expand(s.shape[:3]).contiguous()
    return out, lse


def _check_cuda(q, k, v, lengths, fn: str = "flash_attention_fwd") -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{fn}: {name} on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise ValueError(f"{fn}: {name} is {t.dtype}, q is {q.dtype}")
        if t.dim() != 4:
            raise ValueError(f"{fn}: {name} must be (N, H, T, d), got {tuple(t.shape)}")
        _check_rows(t, name, fn)
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{fn}: dtype {q.dtype} (bfloat16 or float32 only)")
    n, h, _, d = q.shape
    if k.shape[:2] != (n, h) or v.shape != k.shape or k.shape[3] != d:
        raise ValueError(f"{fn}: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)} do not agree")
    if d not in HEAD_DIMS:
        raise ValueError(f"{fn}: head dim {d} (the kernel takes {HEAD_DIMS})")
    if n * h > 65535:
        raise ValueError(f"{fn}: N*H = {n * h} exceeds the grid limit 65535")
    if lengths is not None and (lengths.shape != (n,) or lengths.device != q.device):
        raise ValueError(f"{fn}: lengths must be ({n},) on {q.device}")


def _rows_ok(t) -> bool:
    """Last dim contiguous and every row 16-byte aligned (what the kernels'
    16-byte loads need)."""
    el = t.element_size()
    return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and not any((s * el) % 16 for s in t.stride()[:3]))


def _check_rows(t, name: str, fn: str) -> None:
    if t.stride(-1) != 1:
        raise ValueError(f"{fn}: {name} must be contiguous in its last dim")
    if not _rows_ok(t):
        raise ValueError(f"{fn}: {name} needs 16-byte aligned rows "
                         f"(strides {t.stride()}, {t.element_size()}-byte elements)")


def flash_attention_fwd(q, k, v, causal: bool = False,
                        scale: Optional[float] = None,
                        lengths: Optional[torch.Tensor] = None,
                        mask_q: Optional[bool] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact attention over (N, H, T, d) operands: ``(out, lse)``.

    CUDA tensors (bf16 or f32, d in {64, 128}, last dim contiguous, rows
    16-byte aligned; any strides over N/H/T) launch the kernel on the
    current stream; CPU tensors take the plain version."""
    if mask_q is None:
        mask_q = q.shape[2] == k.shape[2]
    if q.device.type == "cpu":
        return flash_attention_fwd_reference(q, k, v, causal, scale, lengths, mask_q)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_fwd: unsupported device {q.device}")
    _check_cuda(q, k, v, lengths)
    n, h, tq, d = q.shape
    tk = k.shape[2]
    out = torch.empty((n, h, tq, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((n, h, tq), dtype=torch.float32, device=q.device)
    if tq == 0 or n * h == 0:
        return out, lse
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    lens = None if lengths is None else lengths.to(torch.int32).contiguous()
    from . import _build

    lib = _build.load()
    rc = lib.bigdl_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
        None if lens is None else lens.data_ptr(),
        1 if q.dtype == torch.bfloat16 else 0, n, h, tq, tk, d,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        float(scale), int(causal), int(bool(mask_q)),
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention_fwd: kernel launch failed with CUDA error {rc}")
    global launches
    with _count_lock:
        launches += 1
    return out, lse


def flash_attention_bwd_reference(q, k, v, out, lse, d_out, causal: bool = False,
                                  scale: Optional[float] = None,
                                  lengths: Optional[torch.Tensor] = None,
                                  mask_q: Optional[bool] = None
                                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the backward kernels on any device: ``(dq, dk, dv)``
    in the inputs' dtypes. Dense fp32 P rebuilt from the forward's ``lse``
    (exponent clamped to [NEG_BIG, 0], masked entries 0, as
    ``bigdl_tpu.ops.flash_attention._bwd_masked_p``), ``delta =
    rowsum(dO·O)``; P is rounded to dO's dtype before Pᵀ·dO and dS to the
    operands' dtype before dS·K and dSᵀ·Q, as the TPU kernels do."""
    n, _, tq, d = q.shape
    tk = k.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if mask_q is None:
        mask_q = tq == tk
    qf, kf, vf, gf = q.float(), k.float(), v.float(), d_out.float()
    s = torch.einsum("nhqd,nhkd->nhqk", qf, kf) * scale
    vis = visible_mask(n, tq, tk, causal, lengths, mask_q, q.device)
    p = torch.where(vis, torch.exp(torch.clamp(s - lse.unsqueeze(-1), NEG_BIG, 0.0)), 0.0)
    delta = (gf * out.float()).sum(-1, keepdim=True)
    dv = torch.einsum("nhqk,nhqd->nhkd", p.to(d_out.dtype).float(), gf)
    ds = p * (torch.einsum("nhqd,nhkd->nhqk", gf, vf) - delta) * scale
    dq = torch.einsum("nhqk,nhkd->nhqd", ds.to(k.dtype).float(), kf)
    dk = torch.einsum("nhqk,nhqd->nhkd", ds.to(q.dtype).float(), qf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _bwd_kernel_args(q, k, v, out, lse, d_out, causal, scale, lengths, mask_q):
    """Arguments of the backward entry points around their outputs:
    ``(head, tail, keep)``; the caller holds ``keep`` (delta and the int32
    lengths the pointers refer to) until the kernels have run."""
    d = q.shape[3]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    delta = (d_out.float() * out.float()).sum(-1)  # (N, H, Tq) fp32, contiguous
    lens = None if lengths is None else lengths.to(torch.int32).contiguous()
    head = (q.data_ptr(), k.data_ptr(), v.data_ptr(), d_out.data_ptr(),
            lse.data_ptr(), delta.data_ptr())
    tail = (None if lens is None else lens.data_ptr(),
            1 if q.dtype == torch.bfloat16 else 0, *q.shape[:3], k.shape[2], d,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *d_out.stride()[:3],
            float(scale), int(causal), int(bool(mask_q)),
            torch.cuda.current_stream(q.device).cuda_stream)
    return head, tail, (delta, lens)


def flash_attention_bwd(q, k, v, out, lse, d_out, causal: bool = False,
                        scale: Optional[float] = None,
                        lengths: Optional[torch.Tensor] = None,
                        mask_q: Optional[bool] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gradients ``(dq, dk, dv)`` of :func:`flash_attention_fwd` for the
    cotangent ``d_out``, from the forward's ``out`` and ``lse``.

    CUDA tensors launch the dQ and dK/dV kernels on the current stream (q,
    k, v and ``d_out`` as the forward takes q/k/v: any strides over N/H/T,
    rows 16-byte aligned; ``out`` and ``lse`` as the forward made them);
    ``delta = rowsum(dO·O)`` is one fp32 torch op outside the kernels, as
    the JAX package computes it outside its grid. CPU tensors take the plain
    version."""
    if mask_q is None:
        mask_q = q.shape[2] == k.shape[2]
    if q.device.type == "cpu":
        return flash_attention_bwd_reference(q, k, v, out, lse, d_out, causal, scale,
                                             lengths, mask_q)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd: unsupported device {q.device}")
    fn = "flash_attention_bwd"
    _check_cuda(q, k, v, lengths, fn)
    n, h, tq, d = q.shape
    tk = k.shape[2]
    for name, t in (("d_out", d_out), ("out", out)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{fn}: {name} must be {tuple(q.shape)} {q.dtype} on "
                             f"{q.device}, got {tuple(t.shape)} {t.dtype} on {t.device}")
    _check_rows(d_out, "d_out", fn)
    if lse.shape != (n, h, tq) or lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError(f"{fn}: lse must be a contiguous ({n}, {h}, {tq}) float32 tensor")
    if n * h == 0 or tq == 0 or tk == 0:
        return torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    head, tail, keep = _bwd_kernel_args(q, k, v, out, lse, d_out, causal, scale,
                                        lengths, mask_q)
    dq = torch.empty((n, h, tq, d), dtype=q.dtype, device=q.device)
    dk = torch.empty((n, h, tk, d), dtype=k.dtype, device=q.device)
    dv = torch.empty((n, h, tk, d), dtype=v.dtype, device=q.device)
    from . import _build

    lib = _build.load()
    # one call launches dQ, then dK/dV, from one set of tensor maps
    rc = lib.bigdl_flash_attention_bwd(*head, dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                                       *tail)
    if rc != 0:
        raise RuntimeError(f"{fn}: dQ/dK/dV kernel launch failed with CUDA error {rc}")
    global launches_dq, launches_dkv
    with _count_lock:
        launches_dq += 1
        launches_dkv += 1
    return dq, dk, dv


class _FlashAttentionFunction(torch.autograd.Function):
    """Differentiable flash attention: forward :func:`flash_attention_fwd`,
    backward :func:`flash_attention_bwd` (``lengths`` is not differentiable)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, lengths, mask_q):
        out, lse = flash_attention_fwd(q, k, v, causal, scale, lengths, mask_q)
        ctx.save_for_backward(q, k, v, out, lse, lengths)
        ctx.causal, ctx.scale, ctx.mask_q = causal, scale, mask_q
        return out

    @staticmethod
    def backward(ctx, d_out):
        q, k, v, out, lse, lengths = ctx.saved_tensors
        if d_out.is_cuda and not _rows_ok(d_out):
            # e.g. the stride-0 cotangent of a sum(): one copy the kernels can read
            d_out = d_out.contiguous()
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, d_out, ctx.causal,
                                         ctx.scale, lengths, ctx.mask_q)
        return dq, dk, dv, None, None, None, None


def visible_pairs(tq: int, tk: int, causal: bool) -> int:
    """The (query, key) pairs one head attends: all ``tq * tk``, or with
    ``causal`` (aligned at the end) row i's ``min(tk, i + tk - tq + 1)``."""
    if not causal:
        return tq * tk
    off = tk - tq
    return sum(max(0, min(tk, i + off + 1)) for i in range(tq))


def attention_flops(q, k, causal: bool, backward: bool = False) -> float:
    """Model FLOPs of the kernels over ``q`` / ``k`` 's shapes: ``4 d`` a
    visible pair forward (the two products), ``8 d`` backward (four
    products, the recompute not counted). A call with ``lengths`` counts
    the pairs of the full length (the lengths are data)."""
    n, h, tq, d = q.shape
    return (8.0 if backward else 4.0) * d * n * h * visible_pairs(tq, k.shape[2], causal)


class _FlashAttentionCost(torch.autograd.Function):
    """The meta stand-in inside a step-cost count: reports the kernels'
    FLOPs forward and backward, computes nothing."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        from ..obs.perf import kernel_flops

        kernel_flops(attention_flops(q, k, causal))
        ctx.causal = causal
        ctx.save_for_backward(q, k, v)
        return torch.empty(q.shape[:3] + (v.shape[3],), dtype=q.dtype, device=q.device)

    @staticmethod
    def backward(ctx, d_out):
        from ..obs.perf import kernel_flops

        q, k, v = ctx.saved_tensors
        kernel_flops(attention_flops(q, k, ctx.causal, backward=True))
        return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v), None


def flash_attention(q, k, v, causal: bool = False, scale: Optional[float] = None,
                    lengths: Optional[torch.Tensor] = None,
                    mask_q: Optional[bool] = None) -> torch.Tensor:
    """Attention output only, differentiable in q, k and v (see
    :func:`flash_attention_fwd` and :func:`flash_attention_bwd`). A meta
    tensor takes the plain version, or inside a step-cost count the
    FLOP-reporting stand-in."""
    if mask_q is None:
        mask_q = q.shape[2] == k.shape[2]
    if q.device.type == "meta":
        from ..obs.perf import cost_routes_like

        if cost_routes_like() is not None:
            return _FlashAttentionCost.apply(q, k, v, causal)
        return flash_attention_fwd_reference(q, k, v, causal, scale, lengths, bool(mask_q))[0]
    return _FlashAttentionFunction.apply(q, k, v, causal, scale, lengths, bool(mask_q))
