"""Flash attention forward: a hand-written CUDA kernel for Hopper and its
plain PyTorch version.

Counterpart of ``bigdl_tpu/ops/flash_attention.py`` (forward only; the
backward kernels wait for the training slice). The kernel lives in
``bigdl_tpu_torch/csrc/flash_attention.cu`` (its source note says what it
replaces, what bounds it on the H100 and what the design does about that);
:mod:`bigdl_tpu_torch.ops._build` compiles and loads it.

:func:`flash_attention_fwd` takes its route from where the tensors lie: CPU
tensors go through :func:`flash_attention_fwd_reference`; CUDA tensors
launch the kernel, and anything the kernel does not take raises. There is no
fallback from the kernel to the plain version.

Semantics (those of the TPU kernel): ``causal`` is aligned at the end (query
row i sees keys j <= i + Tk - Tq); ``lengths`` (N,) gives each sequence the
key horizon ``min(lengths[n], Tk)``; with ``mask_q`` (default: Tq == Tk) the
query rows at or past that horizon give 0; a row with no visible key gives
out = 0 and lse = ``NEG_BIG``.
"""

from __future__ import annotations

import math
import threading
from typing import Optional, Tuple

import torch

NEG_BIG = -1e30
HEAD_DIMS = (64, 128)

launches = 0  # kernel launches by flash_attention_fwd (never the plain version)
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


def _check_cuda(q, k, v, lengths) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"flash_attention_fwd: {name} on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise ValueError(f"flash_attention_fwd: {name} is {t.dtype}, q is {q.dtype}")
        if t.dim() != 4:
            raise ValueError(f"flash_attention_fwd: {name} must be (N, H, T, d), got {tuple(t.shape)}")
        if t.stride(-1) != 1:
            raise ValueError(f"flash_attention_fwd: {name} must be contiguous in its last dim")
        el = t.element_size()
        if t.data_ptr() % 16 or any((s * el) % 16 for s in t.stride()[:3]):
            raise ValueError(f"flash_attention_fwd: {name} needs 16-byte aligned rows "
                             f"(strides {t.stride()}, {el}-byte elements)")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"flash_attention_fwd: dtype {q.dtype} (bfloat16 or float32 only)")
    n, h, _, d = q.shape
    if k.shape[:2] != (n, h) or v.shape != k.shape or k.shape[3] != d:
        raise ValueError(f"flash_attention_fwd: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)} do not agree")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention_fwd: head dim {d} (the kernel takes {HEAD_DIMS})")
    if n * h > 65535:
        raise ValueError(f"flash_attention_fwd: N*H = {n * h} exceeds the grid limit 65535")
    if lengths is not None and (lengths.shape != (n,) or lengths.device != q.device):
        raise ValueError(f"flash_attention_fwd: lengths must be ({n},) on {q.device}")


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


def flash_attention(q, k, v, causal: bool = False, scale: Optional[float] = None,
                    lengths: Optional[torch.Tensor] = None,
                    mask_q: Optional[bool] = None) -> torch.Tensor:
    """Attention output only (see :func:`flash_attention_fwd`)."""
    return flash_attention_fwd(q, k, v, causal, scale, lengths, mask_q)[0]
