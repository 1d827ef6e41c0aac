"""Vision ImageFrame pipeline (counterpart of ``bigdl_tpu/transform/vision/image``;
reference: ``$DL/transform/vision/image`` -- ``ImageFrame.scala``,
``ImageFeature.scala``, ``augmentation/*.scala``, ``opencv/OpenCVMat.scala``).

Image preprocessing is host work: the OpenCV JNI layer becomes numpy (and
PIL for decoding and ``Resize``, imported inside those calls only). An
``ImageFeature`` carries ``bytes -> mat -> sample`` through a chain of
``FeatureTransformer`` s, and ``ImageFrame`` maps a chain over a collection.
Mats are float32 HWC **BGR** (the reference's OpenCV order); ``MatToTensor``
emits CHW for the NCHW models. Random augmentations draw from
``RandomGenerator.numpy_rng()``, so under a ``DataPipeline`` chunk's
scoped generator they draw the JAX package's numbers for the same seed.
"""

from .feature import ImageFeature
from .frame import DistributedImageFrame, ImageFrame, LocalImageFrame
from .transformer import FeatureTransformer, Pipeline
from .augmentation import (
    AspectScale,
    Brightness,
    CenterCrop,
    ChannelNormalize,
    ChannelScaledNormalizer,
    ColorJitter,
    Contrast,
    Expand,
    FixedCrop,
    Hue,
    HFlip,
    ImageFrameToSample,
    Lighting,
    MatToFloats,
    MatToTensor,
    PixelBytesToMat,
    RandomCrop,
    RandomTransformer,
    Resize,
    Saturation,
)

__all__ = [
    "AspectScale",
    "Brightness",
    "CenterCrop",
    "ChannelNormalize",
    "ChannelScaledNormalizer",
    "ColorJitter",
    "Contrast",
    "DistributedImageFrame",
    "Expand",
    "FeatureTransformer",
    "FixedCrop",
    "HFlip",
    "Hue",
    "ImageFeature",
    "ImageFrame",
    "ImageFrameToSample",
    "Lighting",
    "LocalImageFrame",
    "MatToFloats",
    "MatToTensor",
    "Pipeline",
    "PixelBytesToMat",
    "RandomCrop",
    "RandomTransformer",
    "Resize",
    "Saturation",
]
