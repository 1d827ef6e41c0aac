"""Detection / MaskRCNN building blocks (counterpart of
``bigdl_tpu/nn/detection.py``; reference: ``Anchor.scala``, ``Nms.scala``,
``BboxUtil``, ``Pooler.scala``, ``FPN.scala``, ``RegionProposal``,
``BoxHead`` and ``MaskHead`` under ``$DL/nn/``).

Static shapes, as in the JAX package, and no host round trip: NMS runs a
fixed ``max_output`` Python steps of tensor ops over the score-sorted boxes
and returns exactly ``max_output`` indices (-1 padded); RoiAlign gathers a
fixed sample grid and interpolates; no ``.item()``, ``nonzero`` or boolean
mask indexing anywhere, so a forward on the card never waits for it. Where
the JAX package ``vmap`` s over images, the port runs one batched op over
the images.

Order among ties is the JAX package's: every sort is a stable sort (the
lower index first among equal values, as ``jnp.argsort`` and ``lax.top_k``
give), never ``torch.topk``, which promises no order among ties on the
card. Ties are common here: a detector zeroes every score under its
threshold before its NMS.

Box convention: (x1, y1, x2, y2) corner boxes without the legacy +1. The
box utilities take any leading batch dims, ``(..., N, 4)``. A division by
a constant is ``precision.true_div``: rounded once on the card as on the
CPU and in XLA (ATen's card divides by a host scalar through its
reciprocal).

``sample_matches``' draws come from a ``torch.Generator`` on its own device
(two uniform vectors, as the JAX function splits its key in two), or are
handed to it as the two vectors, so the same draws give the same weights
in either package.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils.precision import true_div
from .conv import SpatialConvolution, SpatialFullConvolution
from .linear import Linear
from .module import AbstractModule, Container

# ln 2 rounded to float32, as ``jnp.log2`` divides ``log(x)`` by it
_LN2_F32 = float(np.float32(math.log(2.0)))

# ---------------------------------------------------------------- box utils


def bbox_area(boxes: torch.Tensor) -> torch.Tensor:
    """(..., N, 4) corner boxes -> (..., N) areas (clamped at 0)."""
    w = torch.clamp(boxes[..., 2] - boxes[..., 0], min=0.0)
    h = torch.clamp(boxes[..., 3] - boxes[..., 1], min=0.0)
    return w * h


def bbox_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., N, 4) x (..., M, 4) -> (..., N, M) IoU matrix."""
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = torch.clamp(rb - lt, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = bbox_area(a)[..., :, None] + bbox_area(b)[..., None, :] - inter
    return inter / torch.clamp(union, min=1e-10)


def bbox_encode(reference: torch.Tensor, proposals: torch.Tensor,
                weights: Sequence[float] = (1.0, 1.0, 1.0, 1.0)) -> torch.Tensor:
    """Boxes -> regression deltas (dx, dy, dw, dh) with respect to proposals."""
    wx, wy, ww, wh = weights
    pw = proposals[..., 2] - proposals[..., 0]
    ph = proposals[..., 3] - proposals[..., 1]
    px = proposals[..., 0] + 0.5 * pw
    py = proposals[..., 1] + 0.5 * ph
    gw = reference[..., 2] - reference[..., 0]
    gh = reference[..., 3] - reference[..., 1]
    gx = reference[..., 0] + 0.5 * gw
    gy = reference[..., 1] + 0.5 * gh
    return torch.stack([
        wx * (gx - px) / torch.clamp(pw, min=1e-6),
        wy * (gy - py) / torch.clamp(ph, min=1e-6),
        ww * torch.log(torch.clamp(gw, min=1e-6) / torch.clamp(pw, min=1e-6)),
        wh * torch.log(torch.clamp(gh, min=1e-6) / torch.clamp(ph, min=1e-6)),
    ], dim=-1)


def bbox_decode(deltas: torch.Tensor, boxes: torch.Tensor,
                weights: Sequence[float] = (1.0, 1.0, 1.0, 1.0),
                clip: float = math.log(1000.0 / 16)) -> torch.Tensor:
    """Regression deltas + anchor/proposal boxes -> decoded corner boxes."""
    wx, wy, ww, wh = weights
    bw = boxes[..., 2] - boxes[..., 0]
    bh = boxes[..., 3] - boxes[..., 1]
    bx = boxes[..., 0] + 0.5 * bw
    by = boxes[..., 1] + 0.5 * bh
    dx, dy = true_div(deltas[..., 0], wx), true_div(deltas[..., 1], wy)
    dw = torch.clamp(true_div(deltas[..., 2], ww), max=clip)
    dh = torch.clamp(true_div(deltas[..., 3], wh), max=clip)
    cx = dx * bw + bx
    cy = dy * bh + by
    w = torch.exp(dw) * bw
    h = torch.exp(dh) * bh
    return torch.stack([cx - 0.5 * w, cy - 0.5 * h, cx + 0.5 * w, cy + 0.5 * h], dim=-1)


def bbox_clip(boxes: torch.Tensor, height: float, width: float) -> torch.Tensor:
    return torch.stack([
        torch.clamp(boxes[..., 0], 0.0, width),
        torch.clamp(boxes[..., 1], 0.0, height),
        torch.clamp(boxes[..., 2], 0.0, width),
        torch.clamp(boxes[..., 3], 0.0, height),
    ], dim=-1)


def _take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[b, idx[b, i]]`` for (B, N, ...) ``x`` and (B, K) ``idx``: (B, K, ...)."""
    return x[torch.arange(x.shape[0], device=x.device)[:, None], idx.long()]


# ---------------------------------------------------------------------- nms


def _stable_desc(scores: torch.Tensor):
    """Values and indices sorted descending along the last dim, the lower
    index first among equal values (``jnp.argsort(-s)``'s and
    ``lax.top_k``'s order)."""
    return torch.sort(scores, dim=-1, descending=True, stable=True)


def batched_nms(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float,
                max_output: int) -> torch.Tensor:
    """:func:`nms` over a batch: (B, N, 4) boxes and (B, N) scores -> (B,
    max_output) int32 indices, -1 padded."""
    b, n = scores.shape
    _, order = _stable_desc(scores)
    sorted_boxes = _take_rows(boxes, order)
    # (B, N, N) in score order: which boxes each one suppresses (itself included)
    over = (bbox_iou(sorted_boxes, sorted_boxes) > iou_threshold) | \
        torch.eye(n, dtype=torch.bool, device=boxes.device)
    alive = torch.ones((b, n), dtype=torch.bool, device=boxes.device)
    picked = torch.full((b, max_output), -1, dtype=torch.long, device=boxes.device)
    for i in range(max_output):
        idx = torch.argmax(alive.to(torch.int32), dim=1)  # the first still-alive candidate
        any_alive = alive.gather(1, idx[:, None])  # (B, 1)
        picked[:, i] = torch.where(any_alive[:, 0], idx, -1)
        row = torch.gather(over, 1, idx[:, None, None].expand(b, 1, n))[:, 0]
        alive = alive & ~(row & any_alive)
    # map sorted positions back to the caller's indices, keeping -1 padding
    keep = torch.gather(order, 1, torch.clamp(picked, min=0))
    return torch.where(picked >= 0, keep, -1).to(torch.int32)


def nms(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float,
        max_output: int) -> torch.Tensor:
    """Greedy NMS with static shapes (reference: ``Nms.scala``): exactly
    ``max_output`` int32 indices into ``boxes`` (N, 4), the highest-scoring
    survivors first, -1 padding. Each of the ``max_output`` steps takes the
    first candidate still alive in score order and suppresses every box whose
    IoU with it exceeds the threshold."""
    return batched_nms(boxes[None], scores[None], iou_threshold, max_output)[0]


# ------------------------------------------------------------------ anchors


class Anchor:
    """Anchor-grid generator (reference: ``Anchor.scala``): ``sizes`` x
    ``ratios`` base anchors tiled over an (Hf, Wf) feature grid with the
    given stride; (Hf * Wf * A, 4) corner boxes, row-major over (y, x,
    anchor) as in the reference. The base anchors are made once a device."""

    def __init__(self, ratios: Sequence[float], sizes: Sequence[float]):
        self.ratios = list(ratios)
        self.sizes = list(sizes)
        self._ctor_spec = ((list(self.ratios), list(self.sizes)), {})  # for the model file
        self._base = {}

    def base_anchors(self) -> np.ndarray:
        out = []
        for size in self.sizes:
            area = float(size) * float(size)
            for ratio in self.ratios:
                w = math.sqrt(area / ratio)
                h = w * ratio
                out.append([-w / 2, -h / 2, w / 2, h / 2])
        return np.asarray(out, np.float32)

    def generate(self, feat_h: int, feat_w: int, stride: float, device=None) -> torch.Tensor:
        device = torch.device(device or "cpu")
        base = self._base.get(device)
        if base is None:
            base = self._base[device] = torch.from_numpy(self.base_anchors()).to(device)
        shift_x = (torch.arange(feat_w, device=device) + 0.5) * stride
        shift_y = (torch.arange(feat_h, device=device) + 0.5) * stride
        sx, sy = torch.meshgrid(shift_x, shift_y, indexing="xy")  # (Hf, Wf)
        shifts = torch.stack([sx, sy, sx, sy], dim=-1).reshape(-1, 1, 4)
        return (shifts + base[None]).reshape(-1, 4)


# ----------------------------------------------------------------- RoiAlign


def batched_roi_align(features: torch.Tensor, rois: torch.Tensor,
                      output_size: Tuple[int, int], spatial_scale: float,
                      sampling_ratio: int = 2) -> torch.Tensor:
    """:func:`roi_align` over a batch: (B, C, H, W) features and (B, R, 4)
    rois -> (B, R, C, ph, pw). The four corners of every sample are
    gathered as (B, C, R, Py, Px) from each channel's plane directly."""
    bsz, c, h, w = features.shape
    r = rois.shape[1]
    ph, pw = output_size
    s = sampling_ratio
    boxes = rois * spatial_scale
    x1, y1, x2, y2 = boxes[..., 0], boxes[..., 1], boxes[..., 2], boxes[..., 3]
    roi_w = torch.clamp(x2 - x1, min=1.0)
    roi_h = torch.clamp(y2 - y1, min=1.0)
    bin_w = true_div(roi_w, pw)
    bin_h = true_div(roi_h, ph)
    # sample positions: (B, R, ph*s) ys and (B, R, pw*s) xs
    iy = true_div(torch.arange(ph * s, device=rois.device) + 0.5, s)  # in bin units
    ix = true_div(torch.arange(pw * s, device=rois.device) + 0.5, s)
    ys = y1[..., None] + iy * bin_h[..., None]
    xs = x1[..., None] + ix * bin_w[..., None]
    y0 = torch.clamp(torch.floor(ys - 0.5), 0, h - 1)
    x0 = torch.clamp(torch.floor(xs - 0.5), 0, w - 1)
    y1i = torch.clamp(y0 + 1, 0, h - 1).long()
    x1i = torch.clamp(x0 + 1, 0, w - 1).long()
    wy = torch.clamp(ys - 0.5 - y0, 0.0, 1.0)[:, :, None, :, None]  # (B, R, 1, Py, 1)
    wx = torch.clamp(xs - 0.5 - x0, 0.0, 1.0)[:, :, None, None, :]  # (B, R, 1, 1, Px)
    y0i, x0i = y0.long(), x0.long()
    planes = features.reshape(bsz, c, h * w)
    py_, px_ = ys.shape[-1], xs.shape[-1]

    def g(yy, xx):  # (B, R, C, Py, Px)
        flat = (yy[..., :, None] * w + xx[..., None, :]).reshape(bsz, 1, r * py_ * px_)
        out = torch.gather(planes, 2, flat.expand(bsz, c, r * py_ * px_))
        return out.reshape(bsz, c, r, py_, px_).transpose(1, 2)

    top = g(y0i, x0i) * (1 - wx) + g(y0i, x1i) * wx
    bot = g(y1i, x0i) * (1 - wx) + g(y1i, x1i) * wx
    sampled = top * (1 - wy) + bot * wy
    # (B, R, C, ph*s, pw*s) -> the mean of each s x s sample block
    return sampled.reshape(bsz, r, c, ph, s, pw, s).mean(dim=(4, 6))


def roi_align(features: torch.Tensor, rois: torch.Tensor, output_size: Tuple[int, int],
              spatial_scale: float, sampling_ratio: int = 2) -> torch.Tensor:
    """RoiAlign over (C, H, W) features and (R, 4) corner rois -> (R, C, ph,
    pw) (reference: the Pooler's roialign): bilinear samples on a fixed
    ``sampling_ratio``² grid a bin, averaged. The sample at ``v`` reads the
    cells around ``v - 0.5``, its lower corner clipped to the map before
    the +1 neighbour is taken (the JAX package's convention, not
    torchvision's ``aligned``)."""
    return batched_roi_align(features[None], rois[None], output_size, spatial_scale,
                             sampling_ratio)[0]


def _canonical_level_index(scales: Sequence[float]) -> int:
    """Index of the canonical 1/16-scale (FPN level 4) within ``scales``."""
    for i, s in enumerate(scales):
        if abs(s - 1.0 / 16) < 1e-9:
            return i
    return min(2, len(scales) - 1)


def roi_levels(rois: torch.Tensor, n_levels: int, canonical: int) -> torch.Tensor:
    """Each roi's FPN level index: the canonical level for a 224²-area roi,
    one level an octave of sqrt(area), ``floor(4 + log2(sqrt(area) / 224 +
    1e-6))`` in float32 with ``log2`` as ``jnp.log2`` computes it (``log(x)
    / log(2)``), clipped to the levels."""
    area = bbox_area(rois)
    ratio = true_div(torch.sqrt(torch.clamp(area, min=1e-6)), 224.0) + 1e-6
    target = torch.floor(4.0 + true_div(torch.log(ratio), _LN2_F32))
    return torch.clamp(target - 4 + canonical, 0, n_levels - 1).long()


def batched_multilevel_roi_align(feats, rois: torch.Tensor, scales: Sequence[float],
                                 output_size: Tuple[int, int],
                                 sampling_ratio: int = 2) -> torch.Tensor:
    """:func:`multilevel_roi_align` over a batch: levels (B, C, Hi, Wi) and
    (B, R, 4) rois -> (B, R, C, ph, pw)."""
    idx = roi_levels(rois, len(scales), _canonical_level_index(scales))
    pooled = torch.stack([batched_roi_align(f, rois, output_size, s, sampling_ratio)
                          for f, s in zip(feats, scales)])  # (L, B, R, C, ph, pw)
    sel = idx[None, :, :, None, None, None].expand((1,) + pooled.shape[1:])
    return torch.gather(pooled, 0, sel)[0]


def multilevel_roi_align(feats, rois: torch.Tensor, scales: Sequence[float],
                         output_size: Tuple[int, int], sampling_ratio: int = 2) -> torch.Tensor:
    """RoiAlign each roi on its FPN-assigned level (the Pooler's core):
    levels (C, Hi, Wi), rois (R, 4) -> (R, C, ph, pw). Every level pools
    every roi and each roi keeps its level's result (exact, static shapes,
    as in the JAX package)."""
    return batched_multilevel_roi_align([f[None] for f in feats], rois[None], scales,
                                        output_size, sampling_ratio)[0]


class Pooler(AbstractModule):
    """Multi-level RoiAlign pooler (reference: ``Pooler.scala``).

    Input: ``Table(features: list of (C, Hi, Wi) FPN levels, rois (R, 4))``."""

    accepts_table_input = True  # consumes a multi-parent Table when graph-wired

    def __init__(self, output_size: Tuple[int, int], scales: Sequence[float],
                 sampling_ratio: int = 2, device=None):
        super().__init__(device)
        self.output_size = tuple(output_size)
        self.scales = list(scales)
        self.sampling_ratio = sampling_ratio

    def _apply_params(self, params, state, x, training, rng):
        feats, rois = list(x)[:2]
        return multilevel_roi_align(feats, rois, self.scales, self.output_size,
                                    self.sampling_ratio), state


# ---------------------------------------------------------------------- FPN


def _child(m: AbstractModule, params, state, new_state, x, training, rng, generator=None):
    """``m`` on ``x``: built from ``x`` first and run on its own parameters
    when ``generator`` is given (a container's build), else on ``params``
    with its new state recorded in ``new_state``."""
    if generator is not None:
        return Container._build_child(m, generator, x)
    y, new_state[m.name()] = m._apply_params(params[m.name()], state[m.name()], x, training,
                                             rng)
    return y


class _BuiltByForward(Container):
    """A container built by one eval-mode pass of its forward over the
    sample, each child built from its own input on the way."""

    def build(self, generator: torch.Generator, sample) -> None:
        if self._built:
            raise RuntimeError(f"{self.name()} is already built")
        with torch.no_grad():
            self._forward({}, {}, sample, False, None, generator)
        self._built = True

    def _apply_params(self, params, state, x, training, rng):
        return self._forward(params, state, x, training, rng)


class FPN(_BuiltByForward):
    """Feature Pyramid Network neck (reference: ``FPN.scala``).

    Input: a list of backbone maps (N, Ci, Hi, Wi), coarsest last. Output: a
    list of (N, out_channels, Hi, Wi) maps: lateral 1x1 convolutions, the
    top-down pathway's nearest-neighbour upsampling (each coarser map
    repeated by the ceiling of the size ratio and cropped, so 25 over 13
    merges), then 3x3 smoothing convolutions."""

    accepts_table_input = True  # consumes a multi-parent Table when graph-wired

    def __init__(self, in_channels: Sequence[int], out_channels: int = 256, device=None):
        d = {"device": device}
        laterals = [SpatialConvolution(c, out_channels, 1, 1, **d) for c in in_channels]
        smooths = [SpatialConvolution(out_channels, out_channels, 3, 3, pad_w=1, pad_h=1, **d)
                   for _ in in_channels]
        super().__init__(*laterals, *smooths, device=device)
        self.n_levels = len(in_channels)
        self.out_channels = out_channels

    def _forward(self, params, state, xs, training, rng, generator=None):
        new_state = {}
        lat = [_child(self._layers[i], params, state, new_state, x, training, rng, generator)
               for i, x in enumerate(xs)]
        merged = [lat[-1]]
        for i in range(len(lat) - 2, -1, -1):
            up, target = merged[0], lat[i]
            sh = -(-target.shape[2] // up.shape[2])
            sw = -(-target.shape[3] // up.shape[3])
            n, c, h, w = up.shape
            up = up[:, :, :, None, :, None].expand(n, c, h, sh, w, sw).reshape(n, c, h * sh,
                                                                               w * sw)
            merged.insert(0, target + up[:, :, : target.shape[2], : target.shape[3]])
        outs = [_child(self._layers[self.n_levels + i], params, state, new_state, y, training,
                       rng, generator) for i, y in enumerate(merged)]
        return outs, new_state


# -------------------------------------------------------------------- heads


class RegionProposal(_BuiltByForward):
    """RPN head and proposal decoding (reference: ``RegionProposal.scala``).

    A 3x3 convolution (ReLU) scores A anchors a location and regresses their
    deltas (1x1 convolutions); each image's ``pre_nms_top_n`` best anchors
    (a stable sort: ties keep anchor order) are decoded, clipped to the
    image and NMS-selected down to exactly ``post_nms_top_n`` proposals,
    zero rows for the padding. (N, C, Hf, Wf) -> (N, post_nms_top_n, 4)."""

    accepts_table_input = True  # consumes a multi-parent Table when graph-wired

    def __init__(self, in_channels: int, anchor: Anchor, stride: float = 16.0,
                 pre_nms_top_n: int = 1000, post_nms_top_n: int = 100,
                 nms_threshold: float = 0.7, device=None):
        a = len(anchor.ratios) * len(anchor.sizes)
        d = {"device": device}
        super().__init__(
            SpatialConvolution(in_channels, in_channels, 3, 3, pad_w=1, pad_h=1, **d),
            SpatialConvolution(in_channels, a, 1, 1, **d),
            SpatialConvolution(in_channels, a * 4, 1, 1, **d), device=device)
        self.anchor = anchor
        self.stride = stride
        self.pre_nms_top_n = pre_nms_top_n
        self.post_nms_top_n = post_nms_top_n
        self.nms_threshold = nms_threshold

    def head(self, params, state, x, training=False, rng=None, generator=None):
        """The convolutions: (objectness logits (N, A, Hf, Wf), deltas (N,
        4A, Hf, Wf), new state)."""
        conv, cls_head, box_head = self._layers
        new_state = {}
        t = torch.relu(_child(conv, params, state, new_state, x, training, rng, generator))
        logits = _child(cls_head, params, state, new_state, t, training, rng, generator)
        deltas = _child(box_head, params, state, new_state, t, training, rng, generator)
        return logits, deltas, new_state

    def flat_outputs(self, logits: torch.Tensor, deltas: torch.Tensor):
        """Per image, row-major over (y, x, anchor) like :meth:`Anchor.generate`:
        (objectness (N, Hf*Wf*A), deltas (N, Hf*Wf*A, 4))."""
        n, a, hf, wf = logits.shape
        scores = logits.permute(0, 2, 3, 1).reshape(n, -1)
        d = deltas.reshape(n, a, 4, hf, wf).permute(0, 3, 4, 1, 2).reshape(n, -1, 4)
        return scores, d

    def proposals(self, logits: torch.Tensor, deltas: torch.Tensor) -> torch.Tensor:
        """Decoded, clipped and NMS-selected proposals (N, post_nms_top_n, 4)."""
        hf, wf = logits.shape[2], logits.shape[3]
        anchors = self.anchor.generate(hf, wf, self.stride, logits.device)  # (Hf*Wf*A, 4)
        img_h, img_w = hf * self.stride, wf * self.stride
        scores, d = self.flat_outputs(logits, deltas)
        k = min(self.pre_nms_top_n, scores.shape[1])
        top_scores, top_idx = _stable_desc(scores)
        top_scores, top_idx = top_scores[:, :k], top_idx[:, :k]
        boxes = bbox_decode(_take_rows(d, top_idx), anchors[top_idx])
        boxes = bbox_clip(boxes, img_h, img_w)
        keep = batched_nms(boxes, top_scores, self.nms_threshold, self.post_nms_top_n)
        return _take_rows(boxes, torch.clamp(keep, min=0)) * (keep >= 0)[..., None]

    def _forward(self, params, state, x, training, rng, generator=None):
        logits, deltas, new_state = self.head(params, state, x, training, rng, generator)
        return self.proposals(logits, deltas), new_state


class BoxHead(_BuiltByForward):
    """Per-roi classification and box regression head (reference:
    ``BoxHead.scala``): two fully connected layers (ReLU) then class scores
    and per-class deltas. (R, ...) -> ((R, n_classes), (R, 4 n_classes))."""

    accepts_table_input = True  # consumes a multi-parent Table when graph-wired

    def __init__(self, in_features: int, fc_dim: int, n_classes: int, device=None):
        d = {"device": device}
        super().__init__(Linear(in_features, fc_dim, **d), Linear(fc_dim, fc_dim, **d),
                         Linear(fc_dim, n_classes, **d), Linear(fc_dim, n_classes * 4, **d),
                         device=device)
        self.n_classes = n_classes

    def _forward(self, params, state, x, training, rng, generator=None):
        f1, f2, cls, box = self._layers
        new_state = {}
        y = x.reshape(x.shape[0], -1)
        y = torch.relu(_child(f1, params, state, new_state, y, training, rng, generator))
        y = torch.relu(_child(f2, params, state, new_state, y, training, rng, generator))
        scores = _child(cls, params, state, new_state, y, training, rng, generator)
        deltas = _child(box, params, state, new_state, y, training, rng, generator)
        return (scores, deltas), new_state


class MaskHead(_BuiltByForward):
    """Per-roi mask predictor (reference: ``MaskHead.scala``): ``n_convs``
    3x3 convolutions, a 2x2 stride-2 deconvolution
    (``SpatialFullConvolution``) and a 1x1 per-class predictor; ReLU after
    the convolutions and the deconvolution, not after the predictor.
    (R, C, m, m) -> (R, n_classes, 2m, 2m)."""

    accepts_table_input = True  # consumes a multi-parent Table when graph-wired

    def __init__(self, in_channels: int, dim: int, n_convs: int, n_classes: int, device=None):
        d = {"device": device}
        convs = []
        c = in_channels
        for _ in range(n_convs):
            convs.append(SpatialConvolution(c, dim, 3, 3, pad_w=1, pad_h=1, **d))
            c = dim
        super().__init__(*convs, SpatialFullConvolution(dim, dim, 2, 2, 2, 2, **d),
                         SpatialConvolution(dim, n_classes, 1, 1, **d), device=device)
        self.n_convs = n_convs

    def _forward(self, params, state, x, training, rng, generator=None):
        new_state = {}
        y = x
        for i, m in enumerate(self._layers):
            y = _child(m, params, state, new_state, y, training, rng, generator)
            if i <= self.n_convs:  # relu after the convs and the deconv, not the predictor
                y = torch.relu(y)
        return y, new_state


# ------------------------------------------------------- training machinery


def match_targets(boxes: torch.Tensor, gt_boxes: torch.Tensor, gt_valid: torch.Tensor,
                  high_threshold: float = 0.7, low_threshold: float = 0.3,
                  allow_low_quality: bool = True) -> torch.Tensor:
    """Each anchor's or proposal's ground-truth index (reference: the Matcher
    of ``RegionProposal``/``BoxHead`` training): (N,) int32, >= 0 a matched
    gt, -1 background, -2 ignored (between the thresholds). ``gt_valid``
    (G,) masks padded gt rows. ``allow_low_quality`` forces each valid gt's
    best anchor positive even under the threshold; that is a scatter-max in
    int32, so a padded gt whose best anchor is the same one cannot take a
    valid gt's mark away."""
    valid = gt_valid != 0
    iou = torch.where(valid[None, :], bbox_iou(boxes, gt_boxes), -1.0)  # (N, G)
    best_iou = iou.amax(dim=1)
    best_gt = torch.argmax(iou, dim=1).to(torch.int32)  # the first maximum
    match = torch.where(best_iou >= high_threshold, best_gt, -1)
    match = torch.where((best_iou >= low_threshold) & (best_iou < high_threshold), -2, match)
    if allow_low_quality:
        best_anchor_per_gt = torch.argmax(iou, dim=0)  # (G,)
        forced = torch.zeros(match.shape[0], dtype=torch.int32, device=match.device)
        forced = forced.scatter_reduce(0, best_anchor_per_gt, valid.to(torch.int32), "amax")
        match = torch.where(forced > 0, best_gt, match)
    return match.to(torch.int32)


def sample_matches(match: torch.Tensor, rng, batch_size: int,
                   positive_fraction: float = 0.5):
    """Random positive/negative subsample weights (reference: the
    BalancedPositiveNegativeSampler): float32 (N,) weights, 1.0 for a
    sampled anchor, never index lists. Two (N,) uniform vectors order the
    positives and the negatives (stable sorts, everything else last); the
    first ``min(#pos, round(batch_size * positive_fraction))`` positives
    and ``min(#neg, batch_size - those)`` negatives are sampled. ``rng``:
    a ``torch.Generator`` (the two vectors drawn on its device) or the pair
    of vectors itself, so the JAX function's own draws give its weights."""
    n = match.shape[0]
    if isinstance(rng, torch.Generator):
        u_pos, u_neg = torch.rand((2, n), generator=rng, device=rng.device).to(match.device)
    else:
        u_pos, u_neg = (torch.as_tensor(u, device=match.device) for u in rng)
    k_pos = int(round(batch_size * positive_fraction))
    pos = match >= 0
    neg = match == -1
    _, pos_rank = torch.sort(torch.where(pos, u_pos, 2.0), stable=True)
    _, neg_rank = torch.sort(torch.where(neg, u_neg, 2.0), stable=True)
    n_pos = torch.clamp(pos.sum(), max=k_pos)
    n_neg = torch.minimum(neg.sum(), batch_size - n_pos)
    rank = torch.arange(n, device=match.device)
    zeros = torch.zeros(n, device=match.device)
    pos_w = zeros.scatter(0, pos_rank, (rank < n_pos).to(torch.float32))
    neg_w = zeros.scatter(0, neg_rank, (rank < n_neg).to(torch.float32))
    return pos_w, neg_w


def smooth_l1(x: torch.Tensor, beta: float = 1.0 / 9) -> torch.Tensor:
    ax = torch.abs(x)
    return torch.where(ax < beta, true_div(0.5 * ax * ax, beta), ax - 0.5 * beta)


def rpn_loss(objectness: torch.Tensor, deltas: torch.Tensor, anchors: torch.Tensor,
             gt_boxes: torch.Tensor, gt_valid: torch.Tensor, rng,
             batch_size: int = 256, positive_fraction: float = 0.5):
    """RPN objectness BCE and box smooth-L1 over sampled anchors (reference:
    RegionProposal's training loss), one image: objectness (N,), deltas (N,
    4), anchors (N, 4), gt (G, 4) and valid (G,). Both terms are divided by
    the whole sampled count. Returns (cls_loss, box_loss) scalars."""
    match = match_targets(anchors, gt_boxes, gt_valid)
    pos_w, neg_w = sample_matches(match, rng, batch_size, positive_fraction)
    labels = (match >= 0).to(torch.float32)
    w = pos_w + neg_w
    denom = torch.clamp(w.sum(), min=1.0)
    cls = torch.sum(w * (torch.logaddexp(torch.zeros_like(objectness), objectness)
                         - labels * objectness)) / denom
    targets = bbox_encode(gt_boxes[torch.clamp(match, min=0).long()], anchors)
    box = torch.sum(pos_w[:, None] * smooth_l1(deltas - targets)) / denom
    return cls, box


def fast_rcnn_loss(class_logits: torch.Tensor, box_deltas: torch.Tensor,
                   proposals: torch.Tensor, gt_boxes: torch.Tensor, gt_labels: torch.Tensor,
                   gt_valid: torch.Tensor, rng, batch_size: int = 128,
                   positive_fraction: float = 0.25):
    """Box-head loss (reference: BoxHead training): softmax cross-entropy
    over sampled proposals (label 0 the background) and the matched class's
    box smooth-L1 on positives, both divided by the sampled count.
    class_logits (N, C), box_deltas (N, 4C), proposals (N, 4), gt_boxes (G,
    4), gt_labels (G,) 1-based class ids, gt_valid (G,)."""
    n, c = class_logits.shape
    match = match_targets(proposals, gt_boxes, gt_valid, high_threshold=0.5,
                          low_threshold=0.5, allow_low_quality=False)
    pos_w, neg_w = sample_matches(match, rng, batch_size, positive_fraction)
    w = pos_w + neg_w
    denom = torch.clamp(w.sum(), min=1.0)
    matched = torch.clamp(match, min=0).long()
    labels = torch.where(match >= 0, gt_labels.to(match.device)[matched].to(torch.int32),
                         0).long()
    logp = torch.log_softmax(class_logits, dim=-1)
    cls = -torch.sum(w * logp.gather(1, labels[:, None])[:, 0]) / denom
    targets = bbox_encode(gt_boxes[matched], proposals)
    picked = box_deltas.reshape(n, c, 4).gather(1, labels[:, None, None].expand(n, 1, 4))[:, 0]
    box = torch.sum(pos_w[:, None] * smooth_l1(picked - targets)) / denom
    return cls, box
