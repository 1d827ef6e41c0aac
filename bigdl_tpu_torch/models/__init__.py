"""Models of the port: the flagship ResNet and VGG."""

from .resnet import ResNet
from .vgg import Vgg_16, Vgg_19, VggForCifar10


def flagship_model(batch: int = 8, seed: int = 0, stem: str = "conv7", device=None):
    """The flagship benchmark configuration: ResNet-50 on synthetic ImageNet.

    Returns ``(model, images (B, 3, 224, 224) f32, labels (B,), name)``; the
    images and labels are numpy arrays drawn as the JAX package draws them
    (``default_rng(seed)`` and ``default_rng(seed + 1)``)."""
    import numpy as np

    model = ResNet(50, class_num=1000, dataset="imagenet", stem=stem, device=device)
    x = np.random.default_rng(seed).standard_normal((batch, 3, 224, 224)).astype(np.float32)
    labels = np.random.default_rng(seed + 1).integers(0, 1000, batch)
    return model, x, labels, "ResNet-50 synthetic-ImageNet"


__all__ = ["ResNet", "Vgg_16", "Vgg_19", "VggForCifar10", "flagship_model"]
