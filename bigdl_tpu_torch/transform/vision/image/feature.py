"""ImageFeature — the mutable per-image record (reference:
``$DL/transform/vision/image/ImageFeature.scala``: a string-keyed map carrying
the image through bytes -> OpenCV mat -> float tensor -> Sample, plus metadata
like uri/label/original size)."""

from __future__ import annotations

import io
from typing import Any, Dict, Optional

import numpy as np


class ImageFeature:
    """Dict-like carrier. Well-known keys mirror the reference constants:
    ``bytes`` (raw file bytes), ``mat`` (float32 HWC BGR), ``floats``,
    ``label``, ``uri``, ``original_size`` (h, w, c), ``sample``."""

    BYTES = "bytes"
    MAT = "mat"
    FLOATS = "floats"
    LABEL = "label"
    URI = "uri"
    ORIGINAL_SIZE = "original_size"
    SAMPLE = "sample"
    IS_VALID = "is_valid"

    def __init__(self, bytes_: Optional[bytes] = None, label=None,
                 uri: Optional[str] = None, mat: Optional[np.ndarray] = None):
        self._store: Dict[str, Any] = {}
        if bytes_ is not None:
            self._store[self.BYTES] = bytes_
        if label is not None:
            self._store[self.LABEL] = label
        if uri is not None:
            self._store[self.URI] = uri
        if mat is not None:
            self.set_mat(np.asarray(mat, np.float32))
        self._store[self.IS_VALID] = True

    # ----------------------------------------------------------- map protocol
    def __getitem__(self, key: str):
        return self._store[key]

    def __setitem__(self, key: str, value) -> None:
        self._store[key] = value

    def __contains__(self, key: str) -> bool:
        return key in self._store

    def get(self, key: str, default=None):
        return self._store.get(key, default)

    def keys(self):
        return self._store.keys()

    # ------------------------------------------------------------- well-known
    def bytes(self) -> Optional[bytes]:
        return self.get(self.BYTES)

    def mat(self) -> np.ndarray:
        """The working image, float32 HWC BGR (reference: ``opencvMat()``)."""
        m = self.get(self.MAT)
        if m is None:
            raise ValueError("ImageFeature has no mat; run PixelBytesToMat first")
        return m

    def set_mat(self, m: np.ndarray) -> None:
        m = np.asarray(m, np.float32)
        if m.ndim == 2:
            m = m[:, :, None]
        self._store[self.MAT] = m
        self._store.setdefault(self.ORIGINAL_SIZE, m.shape)

    def label(self):
        return self.get(self.LABEL)

    def uri(self) -> Optional[str]:
        return self.get(self.URI)

    def sample(self):
        return self.get(self.SAMPLE)

    def is_valid(self) -> bool:
        return bool(self.get(self.IS_VALID, True))

    # ---------------------------------------------------------------- helpers
    def size(self):
        """(height, width, channels) of the current mat."""
        return tuple(self.mat().shape)

    @classmethod
    def from_file(cls, path: str, label=None) -> "ImageFeature":
        with open(path, "rb") as f:
            return cls(bytes_=f.read(), label=label, uri=path)

    def decode(self) -> "ImageFeature":
        """bytes -> mat via PIL (BGR, the reference's OpenCV channel order)."""
        from PIL import Image

        img = Image.open(io.BytesIO(self.bytes())).convert("RGB")
        rgb = np.asarray(img, np.float32)
        self.set_mat(rgb[:, :, ::-1])  # RGB -> BGR
        return self

    def __repr__(self):
        keys = ", ".join(sorted(self._store))
        return f"ImageFeature({keys})"
