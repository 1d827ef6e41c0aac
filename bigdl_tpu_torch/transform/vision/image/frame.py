"""ImageFrame — a collection of ImageFeatures (reference:
``$DL/transform/vision/image/ImageFrame.scala``: LocalImageFrame wraps an
array, DistributedImageFrame wraps an RDD; ``transform`` maps a
FeatureTransformer over it).

Both flavors are host collections: the "distributed" one splits its list
into per-device shards (``shards(n)``), there being no cluster-side compute
in image preparation.
"""

from __future__ import annotations

import glob as _glob
import os
from typing import Callable, List, Optional, Sequence

import numpy as np

from .feature import ImageFeature
from .transformer import FeatureTransformer


class ImageFrame:
    """Factory facade (reference: object ImageFrame)."""

    @staticmethod
    def read(path: str, with_label_from_dirs: bool = False) -> "LocalImageFrame":
        """Read image files from a path/glob; with ``with_label_from_dirs``,
        parent directory names become 0-based integer labels sorted
        alphabetically (the ImageFolder convention)."""
        if os.path.isdir(path):
            paths = sorted(
                p for p in _glob.glob(os.path.join(path, "**", "*"), recursive=True)
                if os.path.isfile(p)
            )
        else:
            paths = sorted(_glob.glob(path))
        if with_label_from_dirs:
            dirs = sorted({os.path.basename(os.path.dirname(p)) for p in paths})
            label_of = {d: i for i, d in enumerate(dirs)}
            feats = [
                ImageFeature.from_file(p, label_of[os.path.basename(os.path.dirname(p))])
                for p in paths
            ]
        else:
            feats = [ImageFeature.from_file(p) for p in paths]
        for f in feats:
            try:
                f.decode()
            except Exception:  # corrupt/non-image file: mark invalid, continue
                # (the pipeline's log-mark-and-continue failure model; the
                # recursive glob can pick up arbitrary files)
                f[ImageFeature.IS_VALID] = False
        return LocalImageFrame(feats)

    @staticmethod
    def from_arrays(images: Sequence[np.ndarray], labels=None) -> "LocalImageFrame":
        """Wrap in-memory HWC arrays (BGR float) as a frame."""
        labels = labels if labels is not None else [None] * len(images)
        return LocalImageFrame(
            [ImageFeature(mat=m, label=l) for m, l in zip(images, labels)]
        )


class LocalImageFrame(ImageFrame):
    def __init__(self, features: List[ImageFeature]):
        self.features = list(features)

    def transform(self, transformer: FeatureTransformer) -> "LocalImageFrame":
        self.features = transformer.apply(self.features)
        return self

    def __len__(self) -> int:
        return len(self.features)

    def __iter__(self):
        return iter(self.features)

    def is_local(self) -> bool:
        return True

    def is_distributed(self) -> bool:
        return False

    def to_valid(self) -> "LocalImageFrame":
        return LocalImageFrame([f for f in self.features if f.is_valid()])

    def to_samples(self):
        """Collect the 'sample' entries (after ImageFrameToSample)."""
        return [f.sample() for f in self.features if f.is_valid()]

    def to_dataset(self, batch_size: int = 32, normalize=None):
        """Bridge into the training data pipeline: (x, label) arrays ->
        ``DataSet.array`` minibatches.

        ``normalize=(mean_bgr, std_bgr)`` takes the fused fast path: mats
        (still 0-255 after decode/resize, BEFORE any float-valued transform)
        are batched as uint8 and normalized+transposed to CHW in one native
        threaded pass (``bigdl_tpu_torch.native.u8hwc_to_f32chw``) — skipping the
        per-image ChannelNormalize/MatToTensor/ImageFrameToSample chain.
        """
        from ....dataset.dataset import DataSet

        if normalize is not None:
            from ....native import u8hwc_to_f32chw

            feats = [f for f in self.features if f.is_valid()]
            u8 = np.stack([f.mat() for f in feats])
            if u8.min() < 0 or u8.max() > 255:
                raise ValueError(
                    "fused normalize path expects raw 0-255 mats; apply "
                    "float-valued transforms via the per-image pipeline instead"
                )
            mean, std = normalize
            xs = u8hwc_to_f32chw(np.clip(u8, 0, 255).astype(np.uint8), mean, std)
            ys = np.asarray([f.label() for f in feats])
            return DataSet.array(xs, ys, batch_size=batch_size)

        samples = self.to_samples()
        if any(s is None for s in samples):
            raise ValueError("run ImageFrameToSample (after MatToTensor) first")
        xs = np.stack([s[0] for s in samples])
        ys = np.asarray([s[1] for s in samples])
        return DataSet.array(xs, ys, batch_size=batch_size)


class DistributedImageFrame(LocalImageFrame):
    """Host-sharded frame: ``shards(n)`` yields per-device partitions
    (reference: DistributedImageFrame over an RDD; here the shard map is the
    host loader's device feed)."""

    def shards(self, n: int) -> List[LocalImageFrame]:
        return [LocalImageFrame(self.features[i::n]) for i in range(n)]

    def is_local(self) -> bool:
        return False

    def is_distributed(self) -> bool:
        return True
