"""MaskRCNN, the two-stage detector with a mask branch (counterpart of
``bigdl_tpu/models/maskrcnn.py``; reference: the MaskRCNN assembly of the
``$DL/nn`` detection pieces).

Backbone -> FPN -> RPN -> multi-level RoiAlign -> box head -> NMS -> mask
head, over the pieces of :mod:`bigdl_tpu_torch.nn.detection`, with the JAX
package's static shapes: a fixed ``post_nms_top_n`` proposal budget flows
through RoiAlign and the heads, and the detections are a fixed-size (boxes,
scores, labels, masks) set, zero-score padded. Every image of a batch goes
through each stage in one batched op (the JAX package ``vmap`` s). No stage
waits for the host, so a forward on the card runs under
``torch.cuda.set_sync_debug_mode("error")``. The inference assembly, as in
the JAX package: the training losses are ``nn.rpn_loss`` and
``nn.fast_rcnn_loss``."""

from __future__ import annotations

from typing import Sequence

import torch

from .. import nn
from ..nn.detection import (Anchor, _BuiltByForward, _child, _take_rows, batched_nms,
                            batched_multilevel_roi_align, bbox_clip, bbox_decode)
from ..nn.module import infer_module_shape, spec
from ..utils.table import T


def _conv_backbone(channels: Sequence[int], device=None):
    """A small strided-convolution backbone, one feature map a level (the
    JAX package's stand-in for the reference's ResNet backbones)."""
    d = {"device": device}
    levels = []
    c_in = 3
    for i, c in enumerate(channels):
        levels.append(nn.Sequential(
            nn.SpatialConvolution(c_in, c, 3, 3, 2, 2, 1, 1, **d), nn.ReLU(**d),
            nn.SpatialConvolution(c, c, 3, 3, 1, 1, 1, 1, **d), nn.ReLU(**d),
            **d).set_name(f"backbone_level{i}"))
        c_in = c
    return levels


class MaskRCNN(_BuiltByForward):
    """Backbone -> FPN -> RPN -> RoiAlign -> box and mask heads.

    ``forward(images)`` with images (N, 3, H, W) returns ``T(boxes (N, D,
    4), scores (N, D), labels (N, D) int32, masks (N, D, n_classes, 2m,
    2m))``, D = ``detections_per_image``, m = ``mask_pool``: fixed shapes,
    zero-score padding. One RPN over the finest FPN level (stride 2)."""

    def __init__(self, n_classes: int, backbone_channels: Sequence[int] = (32, 64, 128, 256),
                 fpn_channels: int = 128, anchor_ratios: Sequence[float] = (0.5, 1.0, 2.0),
                 anchor_size: float = 32.0, pre_nms_top_n: int = 256, post_nms_top_n: int = 64,
                 detections_per_image: int = 16, box_pool: int = 7, mask_pool: int = 14,
                 score_threshold: float = 0.05, nms_threshold: float = 0.5, device=None):
        d = {"device": device}
        backbone = _conv_backbone(backbone_channels, device)
        fpn = nn.FPN(list(backbone_channels), fpn_channels, **d).set_name("fpn")
        rpn = nn.RegionProposal(fpn_channels, Anchor(list(anchor_ratios), [anchor_size]),
                                stride=2.0,  # backbone level 0 halves the image
                                pre_nms_top_n=pre_nms_top_n, post_nms_top_n=post_nms_top_n,
                                **d).set_name("rpn")
        box_head = nn.BoxHead(fpn_channels * box_pool * box_pool, 256, n_classes,
                              **d).set_name("box_head")
        mask_head = nn.MaskHead(fpn_channels, 128, 2, n_classes, **d).set_name("mask_head")
        super().__init__(*backbone, fpn, rpn, box_head, mask_head, device=device)
        self.n_backbone = len(backbone)
        self.n_classes = n_classes
        self.detections_per_image = detections_per_image
        self.box_pool = box_pool
        self.mask_pool = mask_pool
        self.score_threshold = score_threshold
        self.nms_threshold = nms_threshold
        self.fpn_scales = [1.0 / (2 ** (i + 1)) for i in range(len(backbone_channels))]

    def infer_shape(self, in_spec):
        out = in_spec
        for m in self._layers[: self.n_backbone]:  # the backbone checks the image's shape
            out = infer_module_shape(m, out)
        n, d, m = in_spec.shape[0], self.detections_per_image, 2 * self.mask_pool
        return T(spec((n, d, 4), torch.float32), spec((n, d), torch.float32),
                 spec((n, d), torch.int32), spec((n, d, self.n_classes, m, m), torch.float32))

    # ------------------------------------------------------------- the stages
    def features(self, params, state, x, training=False, rng=None, generator=None):
        """Backbone and FPN: (the FPN levels, finest first, new state)."""
        new_state = {}
        feats = []
        y = x
        for m in self._layers[: self.n_backbone]:
            y = _child(m, params, state, new_state, y, training, rng, generator)
            feats.append(y)
        fpn = self._layers[self.n_backbone]
        return _child(fpn, params, state, new_state, feats, training, rng, generator), new_state

    def detect(self, params, state, levels, proposals, img_hw, training=False, rng=None,
               generator=None):
        """Box head, per-class decoding, score threshold and NMS, then the
        mask head on the kept boxes: ((boxes, scores, labels, masks), new state)."""
        box_head, mask_head = self._layers[self.n_backbone + 2:]
        new_state = {}
        n, p = proposals.shape[:2]
        d = self.detections_per_image
        pooled = batched_multilevel_roi_align(levels, proposals, self.fpn_scales,
                                              (self.box_pool, self.box_pool))
        scores, deltas = _child(box_head, params, state, new_state,
                                pooled.reshape((n * p,) + pooled.shape[2:]), training, rng,
                                generator)
        probs = torch.softmax(scores, dim=-1).reshape(n, p, -1)  # class 0 = background
        best_cls = torch.argmax(probs[..., 1:], dim=-1) + 1  # (N, P)
        best_score = probs.gather(2, best_cls[..., None])[..., 0]
        best_deltas = deltas.reshape(n, p, -1, 4).gather(
            2, best_cls[..., None, None].expand(n, p, 1, 4))[:, :, 0]
        boxes = bbox_clip(bbox_decode(best_deltas, proposals), *img_hw)
        best_score = torch.where(best_score >= self.score_threshold, best_score, 0.0)
        keep = batched_nms(boxes, best_score, self.nms_threshold, d)
        valid = keep >= 0
        sel = torch.clamp(keep, min=0)
        det_boxes = _take_rows(boxes, sel) * valid[..., None]
        det_scores = _take_rows(best_score, sel) * valid
        det_labels = (_take_rows(best_cls, sel) * valid).to(torch.int32)
        mask_in = batched_multilevel_roi_align(levels, det_boxes, self.fpn_scales,
                                               (self.mask_pool, self.mask_pool))
        masks = _child(mask_head, params, state, new_state,
                       mask_in.reshape((n * d,) + mask_in.shape[2:]), training, rng, generator)
        return (det_boxes, det_scores, det_labels,
                masks.reshape((n, d) + masks.shape[1:])), new_state

    def _forward(self, params, state, x, training, rng, generator=None):
        levels, new_state = self.features(params, state, x, training, rng, generator)
        rpn = self._layers[self.n_backbone + 1]
        proposals = _child(rpn, params, state, new_state, levels[0], training, rng,
                           generator)  # (N, P, 4)
        out, heads_state = self.detect(params, state, levels, proposals,
                                       (x.shape[2], x.shape[3]), training, rng, generator)
        new_state.update(heads_state)
        return T(*out), new_state
