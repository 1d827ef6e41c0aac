"""Fused bias + activation epilogue whose forward and backward are
hand-written CUDA kernels for Hopper, and the kernels' plain PyTorch
versions.

Counterpart of ``bigdl_tpu/ops/fused_epilogue.py``. The kernels live in
``bigdl_tpu_torch/csrc/fused_epilogue.cu`` (its source note says what each
replaces, what bounds it on the H100 and how its sums keep a fixed order);
:mod:`bigdl_tpu_torch.ops._build` compiles and loads them.

Semantics (those of the TPU kernels):

* ``z = float32(x) + float32(b)`` with the fp32 master bias (not the bias
  rounded to ``x``'s dtype, as ``precision.bias_add`` rounds it);
* ``y = act(z)`` in fp32, rounded once to ``x``'s dtype; ``act`` is
  ``None``, ``"relu"``, ``"gelu"`` (the tanh approximation, ``_GELU_C =
  sqrt(2/pi)``) or ``"tanh"``;
* the backward recomputes ``z`` from ``x`` (the autograd Function saves
  ``x`` and ``bias`` only), ``dx = dy * act'(z)`` in ``x``'s dtype, ``db``
  summed in fp32 and returned in ``b``'s dtype; the ReLU derivative is
  ``z > 0``, so 0 at ``z == 0`` (not the half gradient of ``max(z, 0)``);
* ``axis=-1`` (feature mode, ``Linear``): ``x`` viewed as ``(-1, H)``, the
  bias over ``H``; ``axis=1`` (row mode, an NCHW conv): ``x`` viewed as
  ``(N*C, H*W)`` with the bias of row ``r`` ``b[r % C]``, ``db`` summed per
  row in the kernel and folded ``(N, C) -> (C,)`` outside it.

Routing: :func:`fused_bias_act_fwd` and :func:`fused_bias_act_bwd` take CPU
tensors through the plain versions (:func:`fused_bias_act_reference`,
:func:`fused_bias_act_bwd_reference`), launch the kernels for CUDA tensors,
and raise on anything the kernels do not take. There is no fallback.
"""

from __future__ import annotations

import math
import threading
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

__all__ = ["ACTIVATIONS", "act_reference", "fused_bias_act", "fused_bias_act_bwd",
           "fused_bias_act_bwd_reference", "fused_bias_act_fwd", "fused_bias_act_reference"]

ACTIVATIONS = (None, "relu", "gelu", "tanh")
_ACT_CODE = {None: 0, "relu": 1, "gelu": 2, "tanh": 3}
_GELU_C = math.sqrt(2.0 / math.pi)

# kernel launches (never the plain versions)
launches_fwd = 0
launches_bwd_feature = 0
launches_bwd_row = 0
_count_lock = threading.Lock()

# feature backward: about this many stage-1 blocks (8 per SM of an H100)
_TARGET_BLOCKS = 1056
_MAX_ROW_TILES = 65535  # gridDim.y


_TORCH_ACTS = {
    None: lambda z: z,
    "relu": lambda z: torch.maximum(z, z.new_zeros(())),
    "gelu": lambda z: F.gelu(z, approximate="tanh"),
    "tanh": torch.tanh,
}


def act_reference(act: Optional[str]):
    """The torch activation each kernel name mirrors (ReLU as ``max(z, 0)``,
    GELU as ``F.gelu(approximate="tanh")``); raises ``KeyError`` on an
    unknown name."""
    return _TORCH_ACTS[act]


def _act_f32(z: torch.Tensor, act: Optional[str]) -> torch.Tensor:
    """The kernels' forward arithmetic, term by term."""
    if act is None:
        return z
    if act == "relu":
        return torch.maximum(z, z.new_zeros(()))
    if act == "tanh":
        return torch.tanh(z)
    u = _GELU_C * (z + 0.044715 * z * z * z)
    return 0.5 * z * (1.0 + torch.tanh(u))


def _act_grad_f32(z: torch.Tensor, act: Optional[str]) -> torch.Tensor:
    """The kernels' derivative arithmetic, term by term."""
    if act is None:
        return torch.ones_like(z)
    if act == "relu":
        return (z > 0.0).to(z.dtype)
    if act == "tanh":
        t = torch.tanh(z)
        return 1.0 - t * t
    u = _GELU_C * (z + 0.044715 * z * z * z)
    t = torch.tanh(u)
    du = _GELU_C * (1.0 + 3.0 * 0.044715 * z * z)
    return 0.5 * (1.0 + t) + 0.5 * z * (1.0 - t * t) * du


def _geometry(x: torch.Tensor, bias: torch.Tensor, act, axis: int,
              fn: str) -> Tuple[int, int, int, str]:
    """(rows, cols, channels, mode) of the 2-D view the kernels work on."""
    if act not in _ACT_CODE:
        raise ValueError(f"{fn}: unsupported fused activation {act!r} (expected one of "
                         f"{ACTIVATIONS})")
    if x.dim() >= 1 and axis in (-1, x.dim() - 1):
        cols = x.shape[-1]
        rows, channels, mode = x.numel() // max(cols, 1), cols, "feature"
    elif axis == 1 and x.dim() >= 2:
        channels = x.shape[1]
        rows, cols, mode = x.shape[0] * channels, math.prod(x.shape[2:]), "row"
    else:
        raise ValueError(f"{fn}: axis must be -1 or 1 (of a tensor with at least 2 dims), "
                         f"got axis={axis} for x {tuple(x.shape)}")
    if bias.numel() != channels:
        raise ValueError(f"{fn}: bias has {bias.numel()} entries, x {tuple(x.shape)} needs "
                         f"{channels} along axis {axis}")
    return rows, cols, channels, mode


def _z(x: torch.Tensor, bias: torch.Tensor, mode: str) -> torch.Tensor:
    b = bias.float().reshape(-1)
    if mode == "row":
        b = b.reshape((1, -1) + (1,) * (x.dim() - 2))
    return x.float() + b


def fused_bias_act_reference(x: torch.Tensor, bias: torch.Tensor, act: Optional[str] = None,
                             axis: int = -1) -> torch.Tensor:
    """Plain version of the forward on any device: ``act(float(x) + float(b))``
    in fp32, rounded once to ``x``'s dtype."""
    _, _, _, mode = _geometry(x, bias, act, axis, "fused_bias_act_reference")
    return _act_f32(_z(x, bias, mode), act).to(x.dtype)


def fused_bias_act_bwd_reference(x: torch.Tensor, bias: torch.Tensor, dy: torch.Tensor,
                                 act: Optional[str] = None,
                                 axis: int = -1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the backward on any device: ``(dx, db)`` for the
    cotangent ``dy``; ``db`` in fp32 (per row, then over N in row mode),
    returned in ``bias``'s dtype and shape."""
    rows, cols, channels, mode = _geometry(x, bias, act, axis, "fused_bias_act_bwd_reference")
    if dy.shape != x.shape:
        raise ValueError(f"fused_bias_act_bwd_reference: dy {tuple(dy.shape)} must be x's "
                         f"shape {tuple(x.shape)}")
    dz = dy.float() * _act_grad_f32(_z(x, bias, mode), act)
    if mode == "feature":
        db = dz.reshape(rows, cols).sum(0)
    else:
        db = dz.reshape(rows, cols).sum(1).reshape(-1, channels).sum(0)
    return dz.to(x.dtype), db.to(bias.dtype).reshape(bias.shape)


def _kernel_args(x: torch.Tensor, bias: torch.Tensor, others, fn: str):
    """Checks a kernel launch needs; returns (dtype code, fp32 bias)."""
    if x.device.type != "cuda" or any(t.device != x.device for t in (bias, *others)):
        raise ValueError(f"{fn}: x on {x.device}, bias on {bias.device}"
                         + "".join(f", {t.device}" for t in others)
                         + "; the kernel takes every tensor on one CUDA device")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{fn}: x is {x.dtype} (bfloat16 or float32)")
    if any(t.dtype != x.dtype for t in others):
        raise ValueError(f"{fn}: dy is {others[0].dtype}, x is {x.dtype} (one dtype)")
    if not bias.is_floating_point():
        raise ValueError(f"{fn}: bias is {bias.dtype}")
    if not all(t.is_contiguous() for t in (x, *others)):
        raise ValueError(f"{fn}: x and dy must be contiguous")
    return (1 if x.dtype == torch.bfloat16 else 0), bias.float().contiguous()


def _count(name: str) -> None:
    with _count_lock:
        globals()[name] += 1


def fused_bias_act_fwd(x: torch.Tensor, bias: torch.Tensor, act: Optional[str] = None,
                       axis: int = -1) -> torch.Tensor:
    """``act(x + bias)`` in ``x``'s dtype. CUDA tensors (``x`` bf16 or f32,
    contiguous) launch the forward kernel on the current stream; CPU
    tensors take the plain version."""
    fn = "fused_bias_act_fwd"
    rows, cols, channels, mode = _geometry(x, bias, act, axis, fn)
    if x.device.type == "cpu" and bias.device.type == "cpu":
        return fused_bias_act_reference(x, bias, act, axis)
    dtype, b32 = _kernel_args(x, bias, (), fn)
    y = torch.empty_like(x)
    if y.numel() == 0:
        return y
    from . import _build

    rc = _build.load().bigdl_bias_act_fwd(
        x.data_ptr(), b32.data_ptr(), y.data_ptr(), dtype, _ACT_CODE[act],
        1 if mode == "row" else 0, rows, cols, channels,
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{fn}: kernel launch failed with CUDA error {rc}")
    _count("launches_fwd")
    return y


def feature_row_tile(rows: int, cols: int) -> int:
    """Rows per stage-1 block of the feature backward: enough row tiles for
    about ``_TARGET_BLOCKS`` blocks over the column tiles of 256 columns (a
    multiple of the kernel's 8 thread rows), and at most 65535 row tiles.
    It depends on the shape alone, so the summation order does too."""
    col_tiles = -(-cols // 256)
    row_tiles = max(1, -(-_TARGET_BLOCKS // col_tiles))
    tile = -(-rows // row_tiles)
    tile = max(8, -(-tile // 8) * 8)
    return max(tile, -(-rows // _MAX_ROW_TILES))


def fused_bias_act_bwd(x: torch.Tensor, bias: torch.Tensor, dy: torch.Tensor,
                       act: Optional[str] = None,
                       axis: int = -1) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dx, db)`` of :func:`fused_bias_act_fwd` for the cotangent ``dy``.
    CUDA tensors launch the feature or row backward kernel; CPU tensors take
    the plain version. Two calls on the same inputs give the same bits."""
    fn = "fused_bias_act_bwd"
    rows, cols, channels, mode = _geometry(x, bias, act, axis, fn)
    if dy.shape != x.shape:
        raise ValueError(f"{fn}: dy {tuple(dy.shape)} must be x's shape {tuple(x.shape)}")
    if all(t.device.type == "cpu" for t in (x, bias, dy)):
        return fused_bias_act_bwd_reference(x, bias, dy, act, axis)
    dtype, b32 = _kernel_args(x, bias, (dy,), fn)
    dx = torch.empty_like(x)
    if dx.numel() == 0:
        return dx, torch.zeros_like(bias)
    from . import _build

    lib = _build.load()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    f32 = dict(dtype=torch.float32, device=x.device)
    if mode == "feature":
        tile = feature_row_tile(rows, cols)
        partial = torch.empty((-(-rows // tile), cols), **f32)
        db = torch.empty((cols,), **f32)
        rc = lib.bigdl_bias_act_bwd_feature(
            x.data_ptr(), b32.data_ptr(), dy.data_ptr(), dx.data_ptr(), partial.data_ptr(),
            db.data_ptr(), dtype, _ACT_CODE[act], rows, cols, tile, stream)
        counter = "launches_bwd_feature"
    else:
        db_rows = torch.empty((rows,), **f32)
        rc = lib.bigdl_bias_act_bwd_row(
            x.data_ptr(), b32.data_ptr(), dy.data_ptr(), dx.data_ptr(), db_rows.data_ptr(),
            dtype, _ACT_CODE[act], rows, cols, channels, stream)
        counter = "launches_bwd_row"
    if rc != 0:
        raise RuntimeError(f"{fn}: kernel launch failed with CUDA error {rc}")
    _count(counter)
    if mode == "row":
        db = db_rows.reshape(-1, channels).sum(0)  # (N, C) -> (C,), outside the kernel
    return dx, db.to(bias.dtype).reshape(bias.shape)


class _FusedBiasActFunction(torch.autograd.Function):
    """``act(x + bias)`` whose backward recomputes z (saves x and bias only)."""

    @staticmethod
    def forward(ctx, x, bias, act, axis):
        x = x.contiguous()
        ctx.save_for_backward(x, bias)
        ctx.act, ctx.axis = act, axis
        return fused_bias_act_fwd(x, bias, act, axis)

    @staticmethod
    def backward(ctx, dy):
        x, bias = ctx.saved_tensors
        dx, db = fused_bias_act_bwd(x, bias, dy.contiguous(), ctx.act, ctx.axis)
        return dx, db, None, None


def fused_bias_act(x: torch.Tensor, bias: torch.Tensor, act: Optional[str] = None,
                   axis: int = -1) -> torch.Tensor:
    """``act(x + bias)`` in one fused pass each way, the bias broadcast along
    ``axis`` (-1: features, 1: NCHW channels); differentiable in ``x`` and
    ``bias``. The output keeps ``x``'s dtype."""
    _geometry(x, bias, act, axis, "fused_bias_act")
    return _FusedBiasActFunction.apply(x, bias, act, axis)
