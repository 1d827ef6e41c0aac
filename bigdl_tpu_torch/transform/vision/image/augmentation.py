"""Vision augmentations (reference: ``$DL/transform/vision/image/augmentation/
{Resize,Crop,Flip,Brightness,Contrast,Saturation,Hue,ColorJitter,Expand,
Lighting,ChannelNormalize}.scala`` + ``MatToTensor``/``ImageFrameToSample``).

OpenCV ops become numpy/PIL host math; mats are float32 HWC BGR throughout
(the reference's channel order). Randomness draws from the framework's host
RNG (``RandomGenerator.numpy_rng()``) so augmentation streams are seeded with
the global seed exactly like the reference's per-thread RNGs.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from ....utils.random import RandomGenerator
from .feature import ImageFeature
from .transformer import FeatureTransformer


def _rng():
    return RandomGenerator.numpy_rng()


class PixelBytesToMat(FeatureTransformer):
    """Decode ``bytes`` into the working mat (reference: PixelBytesToMat)."""

    def transform(self, feature: ImageFeature) -> ImageFeature:
        if ImageFeature.MAT not in feature:
            feature.decode()
        return feature


class Resize(FeatureTransformer):
    """Bilinear resize to (resize_h, resize_w) (reference: Resize)."""

    def __init__(self, resize_h: int, resize_w: int):
        self.resize_h, self.resize_w = resize_h, resize_w

    def transform(self, feature: ImageFeature) -> ImageFeature:
        from PIL import Image

        # per-channel float ('F' mode) resize: preserves float-valued mats
        # (post-Brightness/ChannelNormalize pipelines) exactly like the
        # reference's OpenCV resize — no silent uint8 quantization/clipping
        m = feature.mat()
        chans = [
            np.asarray(
                Image.fromarray(np.ascontiguousarray(m[:, :, c]), mode="F").resize(
                    (self.resize_w, self.resize_h), Image.BILINEAR
                ),
                np.float32,
            )
            for c in range(m.shape[2])
        ]
        feature.set_mat(np.stack(chans, axis=2))
        return feature


class AspectScale(FeatureTransformer):
    """Scale the short side to ``min_size`` capping the long side (reference:
    AspectScale, the SSD/Faster-RCNN resize rule)."""

    def __init__(self, min_size: int, max_size: int = 1000):
        self.min_size, self.max_size = min_size, max_size

    def transform(self, feature: ImageFeature) -> ImageFeature:
        h, w, _ = feature.size()
        scale = self.min_size / min(h, w)
        if round(scale * max(h, w)) > self.max_size:
            scale = self.max_size / max(h, w)
        return Resize(int(round(h * scale)), int(round(w * scale))).transform(feature)


class _Crop(FeatureTransformer):
    def _crop(self, feature: ImageFeature, x1: int, y1: int, w: int, h: int):
        m = feature.mat()
        feature.set_mat(m[y1:y1 + h, x1:x1 + w])
        return feature


class CenterCrop(_Crop):
    def __init__(self, crop_width: int, crop_height: int):
        self.cw, self.ch = crop_width, crop_height

    def transform(self, feature: ImageFeature) -> ImageFeature:
        h, w, _ = feature.size()
        return self._crop(feature, (w - self.cw) // 2, (h - self.ch) // 2,
                          self.cw, self.ch)


class RandomCrop(_Crop):
    def __init__(self, crop_width: int, crop_height: int):
        self.cw, self.ch = crop_width, crop_height

    def transform(self, feature: ImageFeature) -> ImageFeature:
        h, w, _ = feature.size()
        x1 = int(_rng().integers(0, w - self.cw + 1))
        y1 = int(_rng().integers(0, h - self.ch + 1))
        return self._crop(feature, x1, y1, self.cw, self.ch)


class FixedCrop(_Crop):
    """Crop a fixed box; coordinates normalized to [0,1] when ``normalized``."""

    def __init__(self, x1: float, y1: float, x2: float, y2: float,
                 normalized: bool = True):
        self.box = (x1, y1, x2, y2)
        self.normalized = normalized

    def transform(self, feature: ImageFeature) -> ImageFeature:
        h, w, _ = feature.size()
        x1, y1, x2, y2 = self.box
        if self.normalized:
            x1, x2 = x1 * w, x2 * w
            y1, y2 = y1 * h, y2 * h
        x1, y1, x2, y2 = int(x1), int(y1), int(round(x2)), int(round(y2))
        return self._crop(feature, x1, y1, x2 - x1, y2 - y1)


class HFlip(FeatureTransformer):
    """Horizontal mirror (reference: HFlip always flips; wrap in
    RandomTransformer for probabilistic application)."""

    def transform(self, feature: ImageFeature) -> ImageFeature:
        feature.set_mat(feature.mat()[:, ::-1])
        return feature


class RandomTransformer(FeatureTransformer):
    """Apply ``transformer`` with probability ``prob`` (reference:
    RandomTransformer)."""

    def __init__(self, transformer: FeatureTransformer, prob: float):
        self.inner = transformer
        self.prob = prob

    def transform(self, feature: ImageFeature) -> ImageFeature:
        if _rng().random() < self.prob:
            return self.inner(feature)
        return feature


class Brightness(FeatureTransformer):
    """Add a uniform delta in [delta_low, delta_high] (reference: Brightness)."""

    def __init__(self, delta_low: float = -32.0, delta_high: float = 32.0):
        self.lo, self.hi = delta_low, delta_high

    def transform(self, feature: ImageFeature) -> ImageFeature:
        delta = float(_rng().uniform(self.lo, self.hi))
        feature.set_mat(feature.mat() + delta)
        return feature


class Contrast(FeatureTransformer):
    """Scale by a uniform factor (reference: Contrast)."""

    def __init__(self, delta_low: float = 0.5, delta_high: float = 1.5):
        self.lo, self.hi = delta_low, delta_high

    def transform(self, feature: ImageFeature) -> ImageFeature:
        factor = float(_rng().uniform(self.lo, self.hi))
        feature.set_mat(feature.mat() * factor)
        return feature


class Saturation(FeatureTransformer):
    """Blend with the grayscale image (reference: Saturation)."""

    def __init__(self, delta_low: float = 0.5, delta_high: float = 1.5):
        self.lo, self.hi = delta_low, delta_high

    def transform(self, feature: ImageFeature) -> ImageFeature:
        factor = float(_rng().uniform(self.lo, self.hi))
        m = feature.mat()
        # BGR weights for luminance
        gray = (0.114 * m[..., 0] + 0.587 * m[..., 1] + 0.299 * m[..., 2])[..., None]
        feature.set_mat(gray + (m - gray) * factor)
        return feature


class Hue(FeatureTransformer):
    """Rotate hue by a uniform angle in degrees (reference: Hue)."""

    def __init__(self, delta_low: float = -18.0, delta_high: float = 18.0):
        self.lo, self.hi = delta_low, delta_high

    def transform(self, feature: ImageFeature) -> ImageFeature:
        angle = np.deg2rad(float(_rng().uniform(self.lo, self.hi)))
        m = feature.mat()
        b, g, r = m[..., 0], m[..., 1], m[..., 2]
        # YIQ rotation: hue shift as a rotation in the IQ chroma plane
        y = 0.299 * r + 0.587 * g + 0.114 * b
        i = 0.596 * r - 0.274 * g - 0.322 * b
        q = 0.211 * r - 0.523 * g + 0.312 * b
        c, s = np.cos(angle), np.sin(angle)
        i2, q2 = i * c - q * s, i * s + q * c
        r2 = y + 0.956 * i2 + 0.621 * q2
        g2 = y - 0.272 * i2 - 0.647 * q2
        b2 = y - 1.106 * i2 + 1.703 * q2
        feature.set_mat(np.stack([b2, g2, r2], axis=-1))
        return feature


class ColorJitter(FeatureTransformer):
    """Random-order brightness/contrast/saturation (+hue) (reference:
    ColorJitter)."""

    def __init__(self, brightness: float = 32.0, contrast: float = 0.5,
                 saturation: float = 0.5, hue: float = 18.0,
                 shuffle: bool = True):
        self.stages: List[FeatureTransformer] = [
            Brightness(-brightness, brightness),
            Contrast(1 - contrast, 1 + contrast),
            Saturation(1 - saturation, 1 + saturation),
            Hue(-hue, hue),
        ]
        self.shuffle = shuffle

    def transform(self, feature: ImageFeature) -> ImageFeature:
        order = list(range(len(self.stages)))
        if self.shuffle:
            _rng().shuffle(order)
        for i in order:
            feature = self.stages[i](feature)
        return feature


class Expand(FeatureTransformer):
    """Place the image on a larger mean-filled canvas at a random offset
    (reference: Expand, the SSD zoom-out augmentation)."""

    def __init__(self, means: Sequence[float] = (123.0, 117.0, 104.0),
                 max_expand_ratio: float = 4.0):
        self.means = np.asarray(means, np.float32)  # BGR
        self.max_ratio = max_expand_ratio

    def transform(self, feature: ImageFeature) -> ImageFeature:
        ratio = float(_rng().uniform(1.0, self.max_ratio))
        h, w, c = feature.size()
        nh, nw = int(h * ratio), int(w * ratio)
        canvas = np.broadcast_to(self.means, (nh, nw, c)).copy()
        y0 = int(_rng().integers(0, nh - h + 1))
        x0 = int(_rng().integers(0, nw - w + 1))
        canvas[y0:y0 + h, x0:x0 + w] = feature.mat()
        feature.set_mat(canvas)
        return feature


class Lighting(FeatureTransformer):
    """AlexNet-style PCA lighting noise (reference: Lighting): add
    ``eigvec @ (alpha * eigval)`` with alpha ~ N(0, alphastd) per channel."""

    IMAGENET_EIGVAL = np.array([0.2175, 0.0188, 0.0045], np.float32)
    IMAGENET_EIGVEC = np.array(
        [[-0.5675, 0.7192, 0.4009],
         [-0.5808, -0.0045, -0.8140],
         [-0.5836, -0.6948, 0.4203]], np.float32)  # rows = R,G,B

    def __init__(self, alphastd: float = 0.1,
                 eigval: Optional[np.ndarray] = None,
                 eigvec: Optional[np.ndarray] = None):
        self.alphastd = alphastd
        self.eigval = np.asarray(eigval if eigval is not None else self.IMAGENET_EIGVAL)
        self.eigvec = np.asarray(eigvec if eigvec is not None else self.IMAGENET_EIGVEC)

    def transform(self, feature: ImageFeature) -> ImageFeature:
        alpha = _rng().normal(0.0, self.alphastd, 3).astype(np.float32)
        rgb_shift = self.eigvec @ (alpha * self.eigval)  # (R,G,B)
        feature.set_mat(feature.mat() + rgb_shift[::-1])  # BGR order
        return feature


class ChannelNormalize(FeatureTransformer):
    """Per-channel (x - mean) / std, BGR order (reference: ChannelNormalize)."""

    def __init__(self, mean_b: float, mean_g: float, mean_r: float,
                 std_b: float = 1.0, std_g: float = 1.0, std_r: float = 1.0):
        self.mean = np.asarray([mean_b, mean_g, mean_r], np.float32)
        self.std = np.asarray([std_b, std_g, std_r], np.float32)

    def transform(self, feature: ImageFeature) -> ImageFeature:
        feature.set_mat((feature.mat() - self.mean) / self.std)
        return feature


class ChannelScaledNormalizer(FeatureTransformer):
    """Mean-subtract then global scale (reference: ChannelScaledNormalizer)."""

    def __init__(self, mean_b: float, mean_g: float, mean_r: float, scale: float):
        self.mean = np.asarray([mean_b, mean_g, mean_r], np.float32)
        self.scale = scale

    def transform(self, feature: ImageFeature) -> ImageFeature:
        feature.set_mat((feature.mat() - self.mean) * self.scale)
        return feature


class MatToFloats(FeatureTransformer):
    """Flatten the mat into the ``floats`` slot (reference: MatToFloats)."""

    def transform(self, feature: ImageFeature) -> ImageFeature:
        feature[ImageFeature.FLOATS] = feature.mat().reshape(-1).copy()
        return feature


class MatToTensor(FeatureTransformer):
    """HWC -> CHW float tensor under key ``tensor`` (reference: MatToTensor,
    which emits the NCHW layout the model zoo consumes)."""

    def __init__(self, to_chw: bool = True, key: str = "tensor"):
        self.to_chw = to_chw
        self.key = key

    def transform(self, feature: ImageFeature) -> ImageFeature:
        m = feature.mat()
        feature[self.key] = np.ascontiguousarray(
            m.transpose(2, 0, 1) if self.to_chw else m
        )
        return feature


class ImageFrameToSample(FeatureTransformer):
    """Assemble (input, target) sample tuples (reference: ImageFrameToSample)."""

    def __init__(self, input_keys: Sequence[str] = ("tensor",),
                 target_keys: Sequence[str] = (ImageFeature.LABEL,)):
        self.input_keys = list(input_keys)
        self.target_keys = list(target_keys)

    def transform(self, feature: ImageFeature) -> ImageFeature:
        xs = [feature[k] for k in self.input_keys]
        ts = [feature.get(k) for k in self.target_keys]
        x = xs[0] if len(xs) == 1 else xs
        t = ts[0] if len(ts) == 1 else ts
        feature[ImageFeature.SAMPLE] = (x, t)
        return feature
