"""LayerNorm and RMSNorm over the last dim whose forward and backward are
hand-written CUDA kernels for Hopper, and the kernels' plain PyTorch
versions.

Counterpart of ``bigdl_tpu/ops/fused_norm.py``. The kernels live in
``bigdl_tpu_torch/csrc/fused_norm.cu`` (its source note says what each
replaces, what bounds it on the H100 and how its sums keep a fixed order);
:mod:`bigdl_tpu_torch.ops._build` compiles and loads them.

Semantics (those of the TPU kernels), over ``x`` viewed as ``(rows, H)``:

* LayerNorm: fp32 mean, then the mean of the centred squares (two passes),
  ``r = rsqrt(var + eps)``, ``y = (x - mean)·r·w + b``; ``y`` is fp32
  whatever ``x``'s dtype (the fp32 gain and bias promote it). The backward
  recomputes the statistics from ``x``: ``dx = r·(g - mean(g) -
  x̂·mean(g·x̂))`` with ``g = dy·w``, in ``x``'s dtype; ``dw = Σ dy·x̂`` and
  ``db = Σ dy`` in fp32 over every row, returned in ``w``'s dtype.
* RMSNorm: ``y = x·rsqrt(mean(x²) + eps)·w`` in fp32, rounded once to
  ``x``'s dtype; ``dx = r·g - x·r³·Σ(g·x)/H``, ``dw = Σ dy·x·r`` in fp32.

The autograd Functions save ``(x, w)`` only, as the TPU custom VJPs do.
For a bf16 ``x`` the statistics are fp32 here, while the modules' routes
with the fused-kernel switch off keep LayerNorm's mean and variance in
``x``'s dtype (see :mod:`bigdl_tpu_torch.nn.normalization`).

Routing: the wrappers take CPU tensors through the plain versions
(:func:`layer_norm_reference`, :func:`layer_norm_bwd_reference`,
:func:`rms_norm_reference`, :func:`rms_norm_bwd_reference`), launch the
kernels for CUDA tensors, and raise on anything the kernels do not take
(``H`` above :data:`MAX_H`, another dtype, a non-contiguous ``x``). There is
no fallback.
"""

from __future__ import annotations

import threading
from typing import Tuple

import torch

__all__ = ["MAX_H", "fused_layer_norm", "fused_rms_norm", "layer_norm_bwd",
           "layer_norm_bwd_reference", "layer_norm_fwd", "layer_norm_reference",
           "norm_row_tile", "rms_norm_bwd", "rms_norm_bwd_reference", "rms_norm_fwd",
           "rms_norm_reference"]

MAX_H = 8192  # a 256-thread block holds a row of up to 32 values a thread

# kernel launches (never the plain versions)
launches_layer_norm_fwd = 0
launches_layer_norm_bwd = 0
launches_rms_norm_fwd = 0
launches_rms_norm_bwd = 0
_count_lock = threading.Lock()

_TARGET_TILES = 264  # backward: about two row tiles per SM of an H100


def _count(name: str) -> None:
    with _count_lock:
        globals()[name] += 1


def norm_row_tile(rows: int) -> int:
    """Rows per backward block: about ``_TARGET_TILES`` tiles, a multiple of
    the 8 rows a block holds at once. It depends on the shape alone, so the
    order of the dw/db sums does too."""
    tile = -(-rows // _TARGET_TILES)
    return max(8, -(-tile // 8) * 8)


# ------------------------------------------------------------ plain versions
def _stats(x: torch.Tensor, eps: float):
    """(x - mean, r) in fp32 over the last dim: the two-pass statistic."""
    xf = x.float()
    xc = xf - xf.mean(-1, keepdim=True)
    return xc, torch.rsqrt((xc * xc).mean(-1, keepdim=True) + eps)


def layer_norm_reference(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                         eps: float = 1e-5) -> torch.Tensor:
    """Plain version of the LayerNorm forward on any device: fp32
    statistics and fp32 output."""
    xc, r = _stats(x, eps)
    return xc * r * weight.float() + bias.float()


def layer_norm_bwd_reference(x: torch.Tensor, weight: torch.Tensor, dy: torch.Tensor,
                             eps: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor,
                                                          torch.Tensor]:
    """Plain version of the LayerNorm backward: ``(dx, dw, db)``, ``dx`` in
    ``x``'s dtype, ``dw`` and ``db`` summed in fp32 and returned in
    ``weight``'s dtype."""
    h = x.shape[-1]
    xc, r = _stats(x, eps)
    xh = xc * r
    d = dy.float()
    g = d * weight.float()
    m1 = g.mean(-1, keepdim=True)
    m2 = (g * xh).mean(-1, keepdim=True)
    dx = r * (g - m1 - xh * m2)
    dw = (d * xh).reshape(-1, h).sum(0)
    db = d.reshape(-1, h).sum(0)
    return dx.to(x.dtype), dw.to(weight.dtype), db.to(weight.dtype)


def _rms_r(x: torch.Tensor, eps: float):
    xf = x.float()
    return xf, torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)


def rms_norm_reference(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Plain version of the RMSNorm forward on any device: fp32 statistics,
    the gain applied before the single narrowing cast to ``x``'s dtype (the
    JAX package's ``rms_norm_reference``, and ``nn.RMSNorm``'s chain)."""
    xf, r = _rms_r(x, eps)
    return (xf * r * weight).to(x.dtype)


def rms_norm_bwd_reference(x: torch.Tensor, weight: torch.Tensor, dy: torch.Tensor,
                           eps: float = 1e-6) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the RMSNorm backward: ``(dx, dw)``, ``dx`` in ``x``'s
    dtype, ``dw`` summed in fp32 and returned in ``weight``'s dtype."""
    h = x.shape[-1]
    xf, r = _rms_r(x, eps)
    d = dy.float()
    g = d * weight.float()
    dot = (g * xf).sum(-1, keepdim=True)
    dx = r * g - xf * (r * r * r) * (dot / h)
    dw = (d * xf * r).reshape(-1, h).sum(0)
    return dx.to(x.dtype), dw.to(weight.dtype)


# ------------------------------------------------------------------ kernels
def _check(fn: str, x: torch.Tensor, weight: torch.Tensor, bias=None) -> Tuple[int, int]:
    """Shape checks of every route; returns (rows, H)."""
    if x.dim() < 1:
        raise ValueError(f"{fn}: x must have a last dim to normalize, got a scalar")
    h = x.shape[-1]
    for name, p in (("weight", weight), ("bias", bias)):
        if p is not None and tuple(p.shape) != (h,):
            raise ValueError(f"{fn}: {name} {tuple(p.shape)} must be ({h},) for x "
                             f"{tuple(x.shape)}")
    return (x.numel() // h if h else 0), h


def _on_cpu(*tensors) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


def _kernel_args(fn: str, x: torch.Tensor, h: int, tensors):
    """Checks a kernel launch needs; returns the dtype code."""
    if x.device.type != "cuda" or any(t.device != x.device for t in tensors):
        raise ValueError(f"{fn}: tensors on " + ", ".join(str(t.device) for t in (x, *tensors))
                         + "; the kernel takes every tensor on one CUDA device")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{fn}: x is {x.dtype} (bfloat16 or float32)")
    if not all(t.is_floating_point() for t in tensors):
        raise ValueError(f"{fn}: every operand must be floating point")
    if not all(t.is_contiguous() for t in (x, *tensors)):
        raise ValueError(f"{fn}: x and dy must be contiguous")
    if h > MAX_H:
        raise ValueError(f"{fn}: H = {h} is above the kernels' {MAX_H} (a row lives in one "
                         "block's registers)")
    return 1 if x.dtype == torch.bfloat16 else 0


def _launch(fn: str, rc: int, counter: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{fn}: kernel launch failed with CUDA error {rc}")
    _count(counter)


def _stream(x: torch.Tensor):
    return torch.cuda.current_stream(x.device).cuda_stream


def layer_norm_fwd(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                   eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last dim, fp32 output. CUDA tensors (``x`` bf16 or
    f32, contiguous) launch the forward kernel on the current stream; CPU
    tensors take the plain version."""
    fn = "layer_norm_fwd"
    rows, h = _check(fn, x, weight, bias)
    if _on_cpu(x, weight, bias):
        return layer_norm_reference(x, weight, bias, eps)
    w32, b32 = weight.float().contiguous(), bias.float().contiguous()
    dtype = _kernel_args(fn, x, h, (w32, b32))
    y = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    if y.numel() == 0:
        return y
    from . import _build

    _launch(fn, _build.load().bigdl_layer_norm_fwd(
        x.data_ptr(), w32.data_ptr(), b32.data_ptr(), y.data_ptr(), dtype, rows, h, eps,
        _stream(x)), "launches_layer_norm_fwd")
    return y


def layer_norm_bwd(x: torch.Tensor, weight: torch.Tensor, dy: torch.Tensor,
                   eps: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dx, dw, db)`` of :func:`layer_norm_fwd` for the cotangent ``dy``
    (taken in fp32, as ``y`` is). CUDA tensors launch the backward kernel and
    the fold of its per-tile partials; CPU tensors take the plain version.
    Two calls on the same inputs give the same bits."""
    fn = "layer_norm_bwd"
    rows, h = _check(fn, x, weight)
    if dy.shape != x.shape:
        raise ValueError(f"{fn}: dy {tuple(dy.shape)} must be x's shape {tuple(x.shape)}")
    if _on_cpu(x, weight, dy):
        return layer_norm_bwd_reference(x, weight, dy, eps)
    w32, d32 = weight.float().contiguous(), dy.float()
    dtype = _kernel_args(fn, x, h, (w32, d32))
    dx = torch.empty_like(x)
    if dx.numel() == 0:
        return dx, torch.zeros_like(weight), torch.zeros_like(weight)
    tile = norm_row_tile(rows)
    f32 = dict(dtype=torch.float32, device=x.device)
    partial = torch.empty((-(-rows // tile), 2 * h), **f32)
    dwdb = torch.empty((2 * h,), **f32)
    from . import _build

    _launch(fn, _build.load().bigdl_layer_norm_bwd(
        x.data_ptr(), w32.data_ptr(), d32.data_ptr(), dx.data_ptr(), partial.data_ptr(),
        dwdb.data_ptr(), dtype, rows, h, tile, eps, _stream(x)), "launches_layer_norm_bwd")
    return dx, dwdb[:h].to(weight.dtype), dwdb[h:].to(weight.dtype)


def rms_norm_fwd(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last dim in ``x``'s dtype. CUDA tensors launch the
    forward kernel; CPU tensors take the plain version."""
    fn = "rms_norm_fwd"
    rows, h = _check(fn, x, weight)
    if _on_cpu(x, weight):
        return rms_norm_reference(x, weight, eps)
    w32 = weight.float().contiguous()
    dtype = _kernel_args(fn, x, h, (w32,))
    y = torch.empty_like(x)
    if y.numel() == 0:
        return y
    from . import _build

    _launch(fn, _build.load().bigdl_rms_norm_fwd(
        x.data_ptr(), w32.data_ptr(), y.data_ptr(), dtype, rows, h, eps, _stream(x)),
        "launches_rms_norm_fwd")
    return y


def rms_norm_bwd(x: torch.Tensor, weight: torch.Tensor, dy: torch.Tensor,
                 eps: float = 1e-6) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dx, dw)`` of :func:`rms_norm_fwd` for the cotangent ``dy`` (in
    ``x``'s dtype). CUDA tensors launch the backward kernel and the fold;
    CPU tensors take the plain version. Two calls give the same bits."""
    fn = "rms_norm_bwd"
    rows, h = _check(fn, x, weight)
    if dy.shape != x.shape:
        raise ValueError(f"{fn}: dy {tuple(dy.shape)} must be x's shape {tuple(x.shape)}")
    if _on_cpu(x, weight, dy):
        return rms_norm_bwd_reference(x, weight, dy, eps)
    w32 = weight.float().contiguous()
    dtype = _kernel_args(fn, x, h, (w32, dy))
    if dy.dtype != x.dtype:
        raise ValueError(f"{fn}: dy is {dy.dtype}, x is {x.dtype} (one dtype)")
    dx = torch.empty_like(x)
    if dx.numel() == 0:
        return dx, torch.zeros_like(weight)
    tile = norm_row_tile(rows)
    f32 = dict(dtype=torch.float32, device=x.device)
    partial = torch.empty((-(-rows // tile), h), **f32)
    dw = torch.empty((h,), **f32)
    from . import _build

    _launch(fn, _build.load().bigdl_rms_norm_bwd(
        x.data_ptr(), w32.data_ptr(), dy.data_ptr(), dx.data_ptr(), partial.data_ptr(),
        dw.data_ptr(), dtype, rows, h, tile, eps, _stream(x)), "launches_rms_norm_bwd")
    return dx, dw.to(weight.dtype)


# ----------------------------------------------------------------- autograd
class _LayerNormFunction(torch.autograd.Function):
    """LayerNorm whose backward recomputes the statistics (saves x and w)."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        x = x.contiguous()
        ctx.save_for_backward(x, weight)
        ctx.eps = eps
        return layer_norm_fwd(x, weight, bias, eps)

    @staticmethod
    def backward(ctx, dy):
        x, weight = ctx.saved_tensors
        dx, dw, db = layer_norm_bwd(x, weight, dy.contiguous(), ctx.eps)
        return dx, dw, db, None


class _RMSNormFunction(torch.autograd.Function):
    """RMSNorm whose backward recomputes the statistics (saves x and w)."""

    @staticmethod
    def forward(ctx, x, weight, eps):
        x = x.contiguous()
        ctx.save_for_backward(x, weight)
        ctx.eps = eps
        return rms_norm_fwd(x, weight, eps)

    @staticmethod
    def backward(ctx, dy):
        x, weight = ctx.saved_tensors
        dx, dw = rms_norm_bwd(x, weight, dy.to(x.dtype).contiguous(), ctx.eps)
        return dx, dw, None


def fused_layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                     eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last dim in one fused pass each way, differentiable
    in ``x``, ``weight`` and ``bias``; fp32 output."""
    _check("fused_layer_norm", x, weight, bias)
    return _LayerNormFunction.apply(x, weight, bias, eps)


def fused_rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last dim in one fused pass each way, differentiable
    in ``x`` and ``weight``; the output keeps ``x``'s dtype."""
    _check("fused_rms_norm", x, weight)
    return _RMSNormFunction.apply(x, weight, eps)
