"""Pooling layers of the flagship (counterpart of ``SpatialMaxPooling`` and
``SpatialAveragePooling`` in ``bigdl_tpu/nn/pooling.py``), with Torch's
semantics: explicit (padW, padH) with ``-1`` meaning SAME, floor or ceil
output sizes, and the rule that the last window starts inside the input or
its left pad.

``SpatialMaxPooling`` runs :func:`bigdl_tpu_torch.ops.maxpool.maxpool2d`,
whose backward is the hand-written CUDA kernel on the card.
``SpatialAveragePooling`` sums each window with ``F.avg_pool2d`` (divisor 1),
which accumulates in fp32 and rounds once to the input's dtype: for bf16 that
is more exact than the JAX package, whose ``reduce_window`` sums in bf16.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..ops.maxpool import maxpool2d
from .module import AbstractModule


def _out_size(in_size: int, k: int, s: int, p: int, ceil_mode: bool) -> int:
    if ceil_mode:
        out = int(math.ceil((in_size + 2 * p - k) / s)) + 1
    else:
        out = int(math.floor((in_size + 2 * p - k) / s)) + 1
    if p > 0 and (out - 1) * s >= in_size + p:
        # Torch rule: the last pooling window must start inside the input or left pad
        out -= 1
    return out


def _pool_padding(in_size: int, k: int, s: int, p: int, ceil_mode: bool) -> Tuple[int, int]:
    """(lo, hi) padding of one dim: the ceil-mode overhang is on the high side."""
    if p == -1:  # pad = -1 means TF "SAME" (as in conv)
        out = int(math.ceil(in_size / s))
        total = max(0, (out - 1) * s + k - in_size)
        return total // 2, total - total // 2
    out = _out_size(in_size, k, s, p, ceil_mode)
    needed = max(0, (out - 1) * s + k - in_size - p)
    return p, needed


def _check_window(module, shape, spatial, kernel, pad) -> None:
    """Every pooling window must fit the padded input."""
    for size, k, p in zip(spatial, kernel, pad):
        if p != -1 and size + 2 * p < k:
            raise ValueError(f"{module.name()}: pooling window {kernel} exceeds the padded "
                             f"input extent (input shape {shape}, pad {pad})")


class _Pool2d(AbstractModule):
    def __init__(self, kernel_w: int, kernel_h: Optional[int], stride_w: Optional[int],
                 stride_h: Optional[int], pad_w: int, pad_h: Optional[int], device):
        super().__init__(device)
        kh = kernel_h if kernel_h is not None else kernel_w
        sw = stride_w if stride_w is not None else kernel_w
        sh = stride_h if stride_h is not None else kh
        self.kernel = (kh, kernel_w)
        self.stride = (sh, sw)
        self.pad = (pad_h if pad_h is not None else pad_w, pad_w)
        self.ceil_mode = False

    def ceil(self):
        self.ceil_mode = True
        return self

    def floor(self):
        self.ceil_mode = False
        return self

    def _geometry(self, x: torch.Tensor, kernel=None, stride=None, pad=None):
        kernel, stride, pad = kernel or self.kernel, stride or self.stride, pad or self.pad
        if x.dim() != 4:
            raise ValueError(f"{self.name()}: expects NCHW input, got shape {tuple(x.shape)}")
        _check_window(self, tuple(x.shape), x.shape[2:], kernel, pad)
        padding = tuple(_pool_padding(size, k, s, p, self.ceil_mode)
                        for size, k, s, p in zip(x.shape[2:], kernel, stride, pad))
        return kernel, stride, padding


class SpatialMaxPooling(_Pool2d):
    """Max pool over NCHW; the backward is the max-pool kernel on the card."""

    def __init__(self, kernel_w: int, kernel_h: Optional[int] = None,
                 stride_w: Optional[int] = None, stride_h: Optional[int] = None,
                 pad_w: int = 0, pad_h: Optional[int] = None, device=None):
        super().__init__(kernel_w, kernel_h, stride_w, stride_h, pad_w, pad_h, device)

    def _apply_params(self, params, state, x, training, rng):
        return maxpool2d(x, *self._geometry(x)), state


class SpatialAveragePooling(_Pool2d):
    """Average pool. ``count_include_pad`` counts the explicit pad cells in
    the divisor (the ceil-mode overhang never counts); ``global_pooling``
    pools the whole spatial extent; ``divide=False`` returns the sums."""

    def __init__(self, kernel_w: int, kernel_h: Optional[int] = None,
                 stride_w: Optional[int] = None, stride_h: Optional[int] = None,
                 pad_w: int = 0, pad_h: Optional[int] = None, global_pooling: bool = False,
                 ceil_mode: bool = False, count_include_pad: bool = True, divide: bool = True,
                 device=None):
        super().__init__(kernel_w, kernel_h, stride_w, stride_h, pad_w, pad_h, device)
        self.global_pooling = global_pooling
        self.ceil_mode = ceil_mode
        self.count_include_pad = count_include_pad
        self.divide = divide

    def _apply_params(self, params, state, x, training, rng):
        if self.global_pooling:
            kernel, stride, padding = self._geometry(x, tuple(x.shape[2:]), (1, 1), (0, 0))
            pad = (0, 0)
        else:
            (kernel, stride, padding), pad = self._geometry(x), self.pad
        (h_lo, h_hi), (w_lo, w_hi) = padding
        summed = F.avg_pool2d(F.pad(x, (w_lo, w_hi, h_lo, h_hi)), kernel, stride,
                              divisor_override=1)
        if not self.divide:
            return summed, state
        # Torch divisor rule: the cells of each window inside the input, plus
        # the explicit pad cells when count_include_pad (every pad cell under
        # SAME), never the ceil-mode overhang
        masks = []
        for size, (lo, hi), p in zip(x.shape[2:], padding, pad):
            i = torch.arange(size + lo + hi, device=x.device)
            if not self.count_include_pad:
                m = (i >= lo) & (i < lo + size)
            elif p == -1:
                m = torch.ones_like(i, dtype=torch.bool)
            else:
                m = i < size + 2 * p
            masks.append(m.float())
        counts = F.avg_pool2d((masks[0][:, None] * masks[1][None, :])[None, None], kernel,
                              stride, divisor_override=1)[0, 0]
        return summed / torch.clamp(counts, min=1.0).to(x.dtype), state
