"""Models of the port: the flagship ResNet, VGG, and BASELINE's LeNet-5,
Inception-v1 and BiLSTM text classifier."""

from .inception import Inception_v1
from .lenet import LeNet5
from .resnet import ResNet
from .textclassifier import BiLSTMClassifier
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


_PARITY_BATCH = {"lenet": 512, "inception": 128, "bilstm": 128}


def parity_config(name: str, batch=None, device=None):
    """Model and synthetic batch of one of BASELINE's parity configs 1, 3 and
    4: ``lenet`` (LeNet5(10)), ``inception`` (Inception_v1(1000), dropout
    on) and ``bilstm``
    (BiLSTMClassifier(vocab 20001, embedding and hidden 128, 20 classes),
    T = 200). Returns ``(model, x, labels, batch)``; ``x`` and ``labels``
    are numpy arrays drawn as the JAX bench draws them (one
    ``default_rng(0)``: the inputs, f32 standard normal or int32 ids in
    [1, 20000), then the labels); ``batch`` defaults to the bench's."""
    import numpy as np

    if name not in _PARITY_BATCH:
        raise ValueError(f"unknown parity config {name!r} (the port has "
                         f"{sorted(_PARITY_BATCH)})")
    batch = _PARITY_BATCH[name] if batch is None else int(batch)
    rng = np.random.default_rng(0)
    if name == "lenet":
        x = rng.standard_normal((batch, 784)).astype(np.float32)
        model, classes = LeNet5(10, device=device), 10
    elif name == "inception":
        x = rng.standard_normal((batch, 3, 224, 224)).astype(np.float32)
        model, classes = Inception_v1(1000, device=device), 1000
    else:
        x = rng.integers(1, 20000, (batch, 200)).astype(np.int32)
        model, classes = BiLSTMClassifier(vocab_size=20001, hidden_size=128, device=device), 20
    return model, x, rng.integers(0, classes, batch), batch


__all__ = ["BiLSTMClassifier", "Inception_v1", "LeNet5", "ResNet", "Vgg_16", "Vgg_19",
           "VggForCifar10", "flagship_model", "parity_config"]
