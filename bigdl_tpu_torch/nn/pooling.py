"""Pooling layers (counterpart of ``SpatialMaxPooling``,
``SpatialAveragePooling`` and ``TemporalMaxPooling`` in
``bigdl_tpu/nn/pooling.py``). The spatial ones have Torch's
semantics: explicit (padW, padH) with ``-1`` meaning SAME, floor or ceil
output sizes, and the rule that the last window starts inside the input or
its left pad.

``SpatialMaxPooling`` runs :func:`bigdl_tpu_torch.ops.maxpool.maxpool2d`,
whose backward is the hand-written CUDA kernel on the card.
``SpatialAveragePooling`` sums each window with ``F.avg_pool2d`` (divisor 1),
which accumulates in fp32 and rounds once to the input's dtype: for bf16 that
is more exact than the JAX package, whose ``reduce_window`` sums in bf16.
``TemporalMaxPooling`` is ``F.max_pool1d`` (torch ops, no kernel of this
repo, as the JAX package's is ``reduce_window`` and not its Pallas kernel).
``RoiPooling`` (Fast R-CNN's roi max pool) is a masked max in torch ops, as
the JAX package's is XLA's.

The rest are torch ops too, as the JAX package's are XLA's
``reduce_window`` (none reaches a Pallas kernel):
``VolumetricMaxPooling`` is ``F.max_pool3d``, whose backward sends each
window's gradient to its first maximum, as XLA's select-and-scatter does
(``-inf`` padding); ``SpatialAdaptiveMaxPooling`` is an ``amax`` over each
cell's slice, which splits a window's gradient evenly among tied maxima,
as ``jnp.max``'s does (``F.adaptive_max_pool2d`` would send it to one);
``TemporalAveragePooling`` and ``VolumetricAveragePooling`` sum each window
(in fp32 for bf16 input, rounded once, where XLA sums in bf16) and divide
by the window's size with ``precision.true_div``, rounded once on every
device.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..ops.maxpool import maxpool2d
from ..utils.precision import true_div
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
    """Max pool over NCHW; the backward is the max-pool kernel on the card,
    or the ``shift`` gradient under ``BIGDL_MAXPOOL_GRAD_IMPL=shift``
    (:func:`~bigdl_tpu_torch.ops.maxpool.grad_impl`)."""

    def infer_shape(self, in_spec):
        self._geometry(in_spec)  # NCHW, each window within the padded input
        return self._infer_shape_via_apply(in_spec)

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

    def infer_shape(self, in_spec):
        shape = tuple(in_spec.shape)
        if len(shape) != 4:
            raise ValueError(f"{self.name()}: expects NCHW input, got shape {shape}")
        if not self.global_pooling:
            _check_window(self, shape, shape[2:], self.kernel, self.pad)
        return self._infer_shape_via_apply(in_spec)

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


class TemporalMaxPooling(AbstractModule):
    """Max pool over the time dim of (N, T, C) input (reference:
    ``$DL/nn/TemporalMaxPooling.scala``): windows of ``k_w`` frames every
    ``d_w`` (default ``k_w``), none past the end (XLA's ``VALID``). Each
    window's gradient goes to its first maximum, as the JAX package's
    ``reduce_window`` gradient (a select with ``ge``) sends it; ATen's
    max-pool backward picks the first maximum too (strict ``>``)."""

    def infer_shape(self, in_spec):
        shape = tuple(in_spec.shape)
        if len(shape) != 3:
            raise ValueError(f"{self.name()}: expects (N, T, C) input, got shape {shape}")
        _check_window(self, shape, (shape[1],), (self.k_w,), (0,))
        return self._infer_shape_via_apply(in_spec)

    def __init__(self, k_w: int, d_w: Optional[int] = None, device=None):
        super().__init__(device)
        self.k_w = k_w
        self.d_w = d_w if d_w is not None else k_w

    def _apply_params(self, params, state, x, training, rng):
        shape = tuple(x.shape)
        if len(shape) != 3:
            raise ValueError(f"{self.name()}: expects (N, T, C) input, got shape {shape}")
        _check_window(self, shape, (shape[1],), (self.k_w,), (0,))
        y = F.max_pool1d(x.transpose(1, 2), self.k_w, self.d_w)
        return y.transpose(1, 2), state


class RoiPooling(AbstractModule):
    """Region-of-interest max pooling (reference: ``$DL/nn/RoiPooling.scala``).

    Input: ``Table(features (N, C, H, W), rois (R, 5))``, each roi row
    ``[batch_idx, x1, y1, x2, y2]`` in input-image coordinates; output (R, C,
    pooled_h, pooled_w). The roi's corners are scaled and rounded (Torch
    rounding, half to even), each bin spans ``floor``/``ceil`` of its
    fractional edges clipped to the map, and a bin that covers no cell (a
    degenerate roi) is 0. As in the JAX package, each bin's max is a masked
    max over the roi's whole feature map, rows first then columns, one bin
    row (then column) at a time: memory O(R C H W), torch ops only.
    """

    accepts_table_input = True  # consumes a multi-parent Table when graph-wired

    def __init__(self, pooled_w: int, pooled_h: int, spatial_scale: float = 1.0, device=None):
        super().__init__(device)
        self.pooled_w = pooled_w
        self.pooled_h = pooled_h
        self.spatial_scale = spatial_scale

    def infer_shape(self, in_spec):
        specs = list(in_spec) if not hasattr(in_spec, "shape") else [in_spec]
        if len(specs) < 2:
            raise ValueError(f"{self.name()}: expects Table(features NCHW, rois (R, 5)), "
                             f"got {len(specs)} input(s)")
        feats, rois = specs[0], specs[1]
        if len(feats.shape) != 4 or len(rois.shape) != 2 or rois.shape[1] != 5:
            raise ValueError(f"{self.name()}: expects Table(features NCHW, rois (R, 5)), got "
                             f"shapes {tuple(feats.shape)} and {tuple(rois.shape)}")
        return self._infer_shape_via_apply(in_spec)

    def _apply_params(self, params, state, x, training, rng):
        feats, rois = list(x)[:2]
        h, w = feats.shape[2], feats.shape[3]
        ph, pw = self.pooled_h, self.pooled_w
        batch_idx = rois[:, 0].to(torch.int32)
        # the roi's corners on the feature map (inclusive), Torch rounding
        x1 = torch.round(rois[:, 1] * self.spatial_scale)
        y1 = torch.round(rois[:, 2] * self.spatial_scale)
        x2 = torch.round(rois[:, 3] * self.spatial_scale)
        y2 = torch.round(rois[:, 4] * self.spatial_scale)
        bin_h = true_div(torch.clamp(y2 - y1 + 1.0, min=1.0), ph)  # (R,)
        bin_w = true_div(torch.clamp(x2 - x1 + 1.0, min=1.0), pw)

        def bounds(start, bin_size, n_bins, limit):
            i = torch.arange(n_bins, dtype=torch.float32, device=start.device)
            lo = torch.floor(start[:, None] + i[None, :] * bin_size[:, None])
            hi = torch.ceil(start[:, None] + (i[None, :] + 1.0) * bin_size[:, None])
            return torch.clamp(lo, 0, limit), torch.clamp(hi, 0, limit)

        ylo, yhi = bounds(y1, bin_h, ph, h)  # (R, ph)
        xlo, xhi = bounds(x1, bin_w, pw, w)  # (R, pw)
        ys = torch.arange(h, dtype=torch.float32, device=feats.device)
        xs = torch.arange(w, dtype=torch.float32, device=feats.device)
        row_in = (ys >= ylo[..., None]) & (ys < yhi[..., None])  # (R, ph, H)
        col_in = (xs >= xlo[..., None]) & (xs < xhi[..., None])  # (R, pw, W)
        roi_feats = feats[batch_idx.long()]  # (R, C, H, W)
        neg_inf = float("-inf")
        tmp = torch.stack([torch.where(row_in[:, i, None, :, None], roi_feats, neg_inf).amax(2)
                           for i in range(ph)])  # (ph, R, C, W)
        out = torch.stack([torch.where(col_in[None, :, j, None, :], tmp, neg_inf).amax(-1)
                           for j in range(pw)])  # (pw, ph, R, C)
        out = out.permute(2, 3, 1, 0)  # (R, C, ph, pw)
        # empty bins (degenerate rois) -> 0, as the reference's memset
        return torch.where(torch.isfinite(out), out, 0.0), state


class VolumetricMaxPooling(AbstractModule):
    """3-D max pool over NCDHW (reference: ``$DL/nn/VolumetricMaxPooling.scala``):
    windows (k_t, k_h, k_w) every (d_t, d_h, d_w), ``-inf`` padding
    (pad_t, pad_h, pad_w) on both sides, none past the end."""

    def __init__(self, k_t: int, k_w: int, k_h: int, d_t: int = 1, d_w: int = 1, d_h: int = 1,
                 pad_t: int = 0, pad_w: int = 0, pad_h: int = 0, device=None):
        super().__init__(device)
        self.kernel = (k_t, k_h, k_w)
        self.stride = (d_t, d_h, d_w)
        self.pad = (pad_t, pad_h, pad_w)

    def infer_shape(self, in_spec):
        shape = tuple(in_spec.shape)
        if len(shape) != 5:
            raise ValueError(f"{self.name()}: expects NCDHW input, got shape {shape}")
        _check_window(self, shape, shape[2:], self.kernel, self.pad)
        return self._infer_shape_via_apply(in_spec)

    def _apply_params(self, params, state, x, training, rng):
        if all(2 * p <= k for p, k in zip(self.pad, self.kernel)):
            return F.max_pool3d(x, self.kernel, self.stride, self.pad), state
        pt, ph, pw = self.pad  # wider than ATen's implicit padding takes
        xp = F.pad(x, (pw, pw, ph, ph, pt, pt), value=float("-inf"))
        return F.max_pool3d(xp, self.kernel, self.stride), state


class SpatialAdaptiveMaxPooling(AbstractModule):
    """Max pool of NCHW to (out_h, out_w) cells, cell i spanning
    [floor(i·in/out), ceil((i+1)·in/out)) (reference: the Torch layer of
    the same name); each cell an ``amax`` of its slice, so tied maxima
    share the gradient evenly, as in the JAX package."""

    def __init__(self, out_w: int, out_h: int, device=None):
        super().__init__(device)
        self.out_w, self.out_h = out_w, out_h

    def infer_shape(self, in_spec):
        shape = tuple(in_spec.shape)
        if len(shape) != 4:
            raise ValueError(f"{self.name()}: expects NCHW input, got shape {shape}")
        return self._infer_shape_via_apply(in_spec)

    def _apply_params(self, params, state, x, training, rng):
        in_h, in_w = x.shape[2], x.shape[3]
        rows = []
        for i in range(self.out_h):
            h0, h1 = (i * in_h) // self.out_h, -(-((i + 1) * in_h) // self.out_h)
            cols = []
            for j in range(self.out_w):
                w0, w1 = (j * in_w) // self.out_w, -(-((j + 1) * in_w) // self.out_w)
                cols.append(x[:, :, h0:h1, w0:w1].amax(dim=(2, 3)))
            rows.append(torch.stack(cols, dim=-1))
        return torch.stack(rows, dim=-2), state


class TemporalAveragePooling(AbstractModule):
    """Average pool over the time dim of (N, T, C) (reference:
    ``$DL/nn/TemporalAveragePooling.scala``; keras ``AveragePooling1D``):
    windows of ``k_w`` frames every ``d_w`` (default ``k_w``), none past
    the end."""

    def __init__(self, k_w: int, d_w: Optional[int] = None, device=None):
        super().__init__(device)
        self.k_w = k_w
        self.d_w = d_w if d_w is not None else k_w

    def infer_shape(self, in_spec):
        shape = tuple(in_spec.shape)
        if len(shape) != 3:
            raise ValueError(f"{self.name()}: expects (N, T, C) input, got shape {shape}")
        _check_window(self, shape, (shape[1],), (self.k_w,), (0,))
        return self._infer_shape_via_apply(in_spec)

    def _apply_params(self, params, state, x, training, rng):
        summed = x.unfold(1, self.k_w, self.d_w).sum(dim=-1, dtype=torch.float32)
        return true_div(summed, self.k_w).to(x.dtype), state


class VolumetricAveragePooling(AbstractModule):
    """Average pool over (N, C, D, H, W) (reference:
    ``$DL/nn/VolumetricAveragePooling.scala``): windows (k_t, k_h, k_w) every
    (d_t, d_h, d_w) (default the window), no padding."""

    def __init__(self, k_t: int, k_w: int, k_h: int, d_t: Optional[int] = None,
                 d_w: Optional[int] = None, d_h: Optional[int] = None, device=None):
        super().__init__(device)
        self.k = (k_t, k_h, k_w)
        self.d = (d_t or k_t, d_h or k_h, d_w or k_w)

    def infer_shape(self, in_spec):
        shape = tuple(in_spec.shape)
        if len(shape) != 5:
            raise ValueError(f"{self.name()}: expects NCDHW input, got shape {shape}")
        _check_window(self, shape, shape[2:], self.k, (0, 0, 0))
        return self._infer_shape_via_apply(in_spec)

    def _apply_params(self, params, state, x, training, rng):
        summed = F.avg_pool3d(x.float(), self.k, self.d, divisor_override=1)
        return true_div(summed, float(self.k[0] * self.k[1] * self.k[2])).to(x.dtype), state
