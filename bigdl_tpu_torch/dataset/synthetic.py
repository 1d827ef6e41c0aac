"""Planted-signal synthetic images (counterpart of
``bigdl_tpu/dataset/synthetic.py``): K low-resolution class templates,
nearest-neighbour upsampled so the signal survives conv stems, plus
per-image noise -- the CIFAR loader's template trick at any resolution,
drawn as the JAX package draws it.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

TEMPLATE_RES = 14
_TEMPLATE_SEED = 888


def template_images(
    n: int,
    k_classes: int,
    size: int,
    seed: int,
    layout: str = "CHW",
    dtype: str = "float32",
    noise: float = 0.3,
) -> Tuple[np.ndarray, np.ndarray]:
    """(images, labels): K-class template images at ``size`` x ``size``.

    ``layout`` 'CHW' (model input) or 'HWC' (record-shard payload);
    ``dtype`` 'float32' (values in [0, 1]) or 'uint8' ([0, 255]);
    ``noise`` is the per-pixel Gaussian sigma on the [0, 1] scale.
    ``size`` must be a multiple of ``TEMPLATE_RES`` (= 14)."""
    if size % TEMPLATE_RES:
        raise ValueError(
            f"size must be a multiple of {TEMPLATE_RES}, got {size}")
    if layout not in ("CHW", "HWC"):
        raise ValueError(f"layout must be 'CHW' or 'HWC', got {layout!r}")
    if dtype not in ("float32", "uint8"):
        raise ValueError(f"dtype must be 'float32' or 'uint8', got {dtype!r}")
    base = np.random.default_rng(_TEMPLATE_SEED).uniform(
        0, 1, (k_classes, TEMPLATE_RES, TEMPLATE_RES, 3))
    r = size // TEMPLATE_RES
    templates = np.repeat(np.repeat(base, r, axis=1), r, axis=2)  # (K,H,W,C)
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, k_classes, n)
    x = templates[labels] + noise * rng.standard_normal(
        (n, size, size, 3))
    x = np.clip(x, 0.0, 1.0)
    if layout == "CHW":
        x = x.transpose(0, 3, 1, 2)
    if dtype == "uint8":
        return (x * 255.0).astype(np.uint8), labels.astype(np.int32)
    return x.astype(np.float32), labels.astype(np.int32)
