"""Max pooling whose backward is a hand-written CUDA kernel for Hopper, and
the kernel's plain PyTorch version.

Counterpart of ``bigdl_tpu/ops/maxpool.py``. The kernel lives in
``bigdl_tpu_torch/csrc/maxpool_bwd.cu`` (its source note says what it
replaces, what bounds it on the H100 and why it gathers where the TPU
kernel scatters); :mod:`bigdl_tpu_torch.ops._build` compiles and loads it.

Semantics (those of the TPU kernel and of XLA's SelectAndScatter): the
input is padded with -inf by ``padding = ((h_lo, h_hi), (w_lo, w_hi))``,
already resolved by the caller (the Torch floor/ceil/SAME rules live in
``nn/pooling.py``); each window's gradient goes to its FIRST maximum in
row-major order over the window offsets (strict ``>``, so ties, such as
the zeros of a post-ReLU map, go to the earliest offset); positions that
no window covers get 0; a window's gradient that lands on a padded cell is
dropped.

* :func:`maxpool_grad_reference` is the plain version, on any device.
* :func:`maxpool_grad` takes its route from where the tensors lie: CPU
  tensors go through the plain version, CUDA tensors launch the kernel, and
  anything the kernel does not take raises. There is no fallback.
* :func:`maxpool2d` is differentiable: a ``torch.autograd.Function`` whose
  forward is torch ops (a -inf ``F.pad`` and ``F.max_pool2d`` without
  indices, as XLA's ``reduce_window`` is in JAX) and whose backward is
  :func:`maxpool_grad`. It saves ``x`` only, never indices: the backward
  recomputes each window's argmax from ``x``, as the TPU kernel does.
"""

from __future__ import annotations

import threading
from typing import Tuple

import torch
import torch.nn.functional as F

Pair = Tuple[int, int]
Padding = Tuple[Pair, Pair]

# kernel launches (never the plain version)
launches = 0
_count_lock = threading.Lock()


def pooled_size(x_hw: Pair, kernel: Pair, stride: Pair, padding: Padding) -> Pair:
    """(Ho, Wo) of a max pool over the padded input (floor of the padded
    extent, as ``reduce_window`` counts)."""
    return tuple((size + lo + hi - k) // s + 1
                 for size, k, s, (lo, hi) in zip(x_hw, kernel, stride, padding))


def _check_geometry(x, dy, kernel, stride, padding, fn: str) -> None:
    if x.dim() != 4:
        raise ValueError(f"{fn}: x must be (N, C, H, W), got {tuple(x.shape)}")
    if min(kernel) < 1 or min(stride) < 1 or min(p for pair in padding for p in pair) < 0:
        raise ValueError(f"{fn}: kernel {kernel} and stride {stride} must be >= 1 and "
                         f"padding {padding} >= 0")
    ho, wo = pooled_size(x.shape[2:], kernel, stride, padding)
    if ho < 1 or wo < 1:
        raise ValueError(f"{fn}: window {kernel} exceeds the padded input "
                         f"(x {tuple(x.shape)}, padding {padding})")
    if tuple(dy.shape) != (*x.shape[:2], ho, wo):
        raise ValueError(f"{fn}: dy must be {(*x.shape[:2], ho, wo)}, got {tuple(dy.shape)}")


def _pad(x: torch.Tensor, padding: Padding) -> torch.Tensor:
    (h_lo, h_hi), (w_lo, w_hi) = padding
    return F.pad(x, (w_lo, w_hi, h_lo, h_hi), value=float("-inf"))


def maxpool_forward(x: torch.Tensor, kernel: Pair, stride: Pair, padding: Padding) -> torch.Tensor:
    """The max pool itself (torch ops on any device)."""
    return F.max_pool2d(_pad(x, padding), kernel, stride)


def maxpool_grad_reference(x: torch.Tensor, dy: torch.Tensor, kernel: Pair, stride: Pair,
                           padding: Padding) -> torch.Tensor:
    """Plain version on any device, from the definition: the first argmax of
    each window over its kh·kw offsets in row-major order (strict ``>``),
    then each window's dy added at that offset's input position, in fp32,
    rounded once to ``x``'s dtype."""
    _check_geometry(x, dy, kernel, stride, padding, "maxpool_grad_reference")
    (kh, kw), (sh, sw) = kernel, stride
    (h_lo, _), (w_lo, _) = padding
    h, w = x.shape[2:]
    ho, wo = dy.shape[2:]
    xp = _pad(x, padding)

    def window_offset(a: int, b: int):  # (N, C, Ho, Wo) view: offset (a, b) of every window
        return (slice(None), slice(None), slice(a, a + (ho - 1) * sh + 1, sh),
                slice(b, b + (wo - 1) * sw + 1, sw))

    best = xp[window_offset(0, 0)]
    arg = torch.zeros(best.shape, dtype=torch.int32, device=x.device)
    for a in range(kh):
        for b in range(kw):
            if a == b == 0:
                continue
            v = xp[window_offset(a, b)]
            take = v > best
            arg = torch.where(take, a * kw + b, arg)
            best = torch.where(take, v, best)
    dxp = torch.zeros(xp.shape, dtype=torch.float32, device=x.device)
    dyf = dy.float()
    for a in range(kh):
        for b in range(kw):
            dxp[window_offset(a, b)] += torch.where(arg == a * kw + b, dyf, 0.0)
    return dxp[:, :, h_lo:h_lo + h, w_lo:w_lo + w].to(x.dtype)


def maxpool_grad(x: torch.Tensor, dy: torch.Tensor, kernel: Pair, stride: Pair,
                 padding: Padding) -> torch.Tensor:
    """Gradient of :func:`maxpool_forward` with respect to ``x`` for the
    cotangent ``dy``, in ``x``'s dtype.

    CUDA tensors (bf16 or f32, contiguous NCHW, both on one card) launch the
    kernel on the current stream; CPU tensors take the plain version."""
    kernel, stride = tuple(kernel), tuple(stride)
    padding = tuple(tuple(p) for p in padding)
    if x.device.type == "cpu" and dy.device.type == "cpu":
        return maxpool_grad_reference(x, dy, kernel, stride, padding)
    fn = "maxpool_grad"
    if x.device.type != "cuda" or dy.device != x.device:
        raise ValueError(f"{fn}: x on {x.device} and dy on {dy.device}; the kernel takes "
                         "both on one CUDA device")
    if x.dtype not in (torch.bfloat16, torch.float32) or dy.dtype != x.dtype:
        raise ValueError(f"{fn}: x is {x.dtype}, dy is {dy.dtype} (both bfloat16 or both "
                         "float32)")
    _check_geometry(x, dy, kernel, stride, padding, fn)
    if not (x.is_contiguous() and dy.is_contiguous()):
        raise ValueError(f"{fn}: x and dy must be contiguous NCHW")
    if kernel[0] * kernel[1] > 65535:
        raise ValueError(f"{fn}: a {kernel} window has more offsets than the kernel's "
                         "16-bit argmax holds")
    n, c, h, w = x.shape
    ho, wo = dy.shape[2:]
    dx = torch.empty_like(x)
    if dx.numel() == 0:
        return dx
    from . import _build

    lib = _build.load()
    rc = lib.bigdl_maxpool2d_bwd(
        x.data_ptr(), dy.data_ptr(), dx.data_ptr(), 1 if x.dtype == torch.bfloat16 else 0,
        n * c, h, w, ho, wo, *kernel, *stride, padding[0][0], padding[1][0],
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{fn}: kernel launch failed with CUDA error {rc}")
    global launches
    with _count_lock:
        launches += 1
    return dx


class _MaxPool2dFunction(torch.autograd.Function):
    """Max pool with the backward of :func:`maxpool_grad` (see module docstring)."""

    @staticmethod
    def forward(ctx, x, kernel, stride, padding):
        ctx.save_for_backward(x)
        ctx.geometry = (kernel, stride, padding)
        return maxpool_forward(x, kernel, stride, padding)

    @staticmethod
    def backward(ctx, dy):
        (x,) = ctx.saved_tensors
        return maxpool_grad(x, dy.contiguous(), *ctx.geometry), None, None, None


def maxpool2d(x: torch.Tensor, kernel: Pair, stride: Pair, padding: Padding) -> torch.Tensor:
    """NCHW max pool, differentiable in ``x``; ``padding`` is ((h_lo, h_hi),
    (w_lo, w_hi)) of -inf cells."""
    padding = tuple(tuple(int(p) for p in pair) for pair in padding)
    return _MaxPool2dFunction.apply(x, tuple(kernel), tuple(stride), padding)
