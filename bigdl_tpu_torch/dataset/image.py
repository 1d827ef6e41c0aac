"""Classic image-pipeline transformer names (reference: ``$DL/dataset/image/
{BGRImgNormalizer,BGRImgCropper,BGRImgRdmCropper,HFlip,BGRImgToSample,
BGRImgToBatch}.scala`` -- the classic image pipeline).

These are the pre-ImageFrame names used by the ImageNet/CIFAR training
recipes; here they are thin constructors over the vision pipeline
(``bigdl_tpu_torch.transform.vision.image``), which owns the actual math --
one implementation, both vocabularies (counterpart of
``bigdl_tpu/dataset/image.py``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..transform.vision.image import (
    CenterCrop,
    ChannelNormalize,
    FeatureTransformer,
    HFlip,
    ImageFeature,
    ImageFrameToSample,
    MatToTensor,
    Pipeline,
    RandomCrop,
    RandomTransformer,
)

__all__ = [
    "BGRImgCropper",
    "BGRImgNormalizer",
    "BGRImgRdmCropper",
    "BGRImgToSample",
    "HFlip",
    "RandomHFlip",
]


def BGRImgNormalizer(mean_b: float, mean_g: float, mean_r: float,
                     std_b: float = 1.0, std_g: float = 1.0,
                     std_r: float = 1.0) -> ChannelNormalize:
    """Per-channel BGR normalize (reference: BGRImgNormalizer)."""
    return ChannelNormalize(mean_b, mean_g, mean_r, std_b, std_g, std_r)


def BGRImgCropper(crop_width: int, crop_height: int,
                  cropper_method: str = "random") -> FeatureTransformer:
    """Center/random crop (reference: BGRImgCropper's CropCenter/CropRandom)."""
    if cropper_method == "center":
        return CenterCrop(crop_width, crop_height)
    if cropper_method == "random":
        return RandomCrop(crop_width, crop_height)
    raise ValueError(f"cropper_method must be center|random, got {cropper_method!r}")


class _PadThenRandomCrop(FeatureTransformer):
    def __init__(self, crop_width: int, crop_height: int, padding: int):
        self.inner = RandomCrop(crop_width, crop_height)
        self.padding = padding

    def transform(self, feature: ImageFeature) -> ImageFeature:
        p = self.padding
        if p > 0:
            feature.set_mat(np.pad(feature.mat(), ((p, p), (p, p), (0, 0))))
        return self.inner.transform(feature)


def BGRImgRdmCropper(crop_width: int, crop_height: int,
                     padding: int = 0) -> FeatureTransformer:
    """Zero-pad then random-crop (reference: BGRImgRdmCropper — the CIFAR
    recipe's pad-4-crop-32 augmentation)."""
    return _PadThenRandomCrop(crop_width, crop_height, padding)


def RandomHFlip(prob: float = 0.5) -> FeatureTransformer:
    """Probabilistic mirror (reference: HFlip's threshold parameter)."""
    return RandomTransformer(HFlip(), prob)


def BGRImgToSample(with_label: bool = True) -> Pipeline:
    """CHW tensor + (input, label) sample (reference: BGRImgToSample)."""
    target_keys = (ImageFeature.LABEL,) if with_label else ()
    return Pipeline([MatToTensor(), ImageFrameToSample(target_keys=target_keys)])
