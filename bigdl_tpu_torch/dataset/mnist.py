"""MNIST (counterpart of ``bigdl_tpu/dataset/mnist.py``; reference:
``$PY/dataset/mnist.py`` and the idx readers of
``$DL/models/lenet/Utils.scala``).

``load_mnist(data_dir, train)`` reads the idx files
(``train-images-idx3-ubyte`` and ``train-labels-idx1-ubyte``, or ``t10k-*``,
optionally gzipped) from ``data_dir``; without them it draws the JAX
package's synthetic digits (class templates plus noise) from the same
seeded numpy generators, so both packages return the same arrays. Images
come back as (N, 1, 28, 28) float32 in [0, 1], normalized by the training
set's ``TRAIN_MEAN``/``TRAIN_STD`` when ``normalize``; labels (N,) int32,
0-based. Host numpy only: no download.
"""

from __future__ import annotations

import gzip
import os
import struct
from typing import Optional, Tuple

import numpy as np

TRAIN_MEAN = 0.13066047740239506
TRAIN_STD = 0.3081078


def _read_idx(path: str) -> np.ndarray:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        magic = struct.unpack(">I", f.read(4))[0]
        ndim = magic & 0xFF
        dims = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        data = np.frombuffer(f.read(), dtype=np.uint8)
    return data.reshape(dims)


def _find(data_dir: str, stem: str) -> Optional[str]:
    for suffix in ("", ".gz"):
        p = os.path.join(data_dir, stem + suffix)
        if os.path.exists(p):
            return p
    return None


def _synthetic(n: int, seed: int, image_size: int = 28) -> Tuple[np.ndarray, np.ndarray]:
    """Class-conditional templates + noise; learnable by LeNet in a few epochs."""
    # class templates are split-independent (fixed seed); noise/labels vary per split
    templates = np.random.default_rng(12345).uniform(
        0, 1, (10, image_size, image_size)
    ).astype(np.float32)
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 10, n)
    images = templates[labels] + 0.35 * rng.standard_normal(
        (n, image_size, image_size)
    ).astype(np.float32)
    images = np.clip(images, 0.0, 1.0)
    return (images * 255).astype(np.uint8), labels.astype(np.int32)


def load_mnist(
    data_dir: Optional[str] = None,
    train: bool = True,
    normalize: bool = True,
    synthetic_size: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (images (N,1,28,28) float32, labels (N,) int32, 0-based)."""
    images = labels = None
    if data_dir:
        stem = "train" if train else "t10k"
        ip = _find(data_dir, f"{stem}-images-idx3-ubyte")
        lp = _find(data_dir, f"{stem}-labels-idx1-ubyte")
        if ip and lp:
            images, labels = _read_idx(ip), _read_idx(lp).astype(np.int32)
    if images is None:
        n = synthetic_size or (2048 if train else 512)
        images, labels = _synthetic(n, seed=1 if train else 2)
    x = images.astype(np.float32) / 255.0
    if normalize:
        x = (x - TRAIN_MEAN) / TRAIN_STD
    return x[:, None, :, :], labels
