"""Models of the port: the flagship ResNet, VGG, BASELINE's LeNet-5,
VGG-for-CIFAR-10, Inception-v1, BiLSTM text classifier and Wide&Deep, and
AlexNet, the Autoencoder, NeuralCF, the CNN text classifier, the PTB
language model and the MaskRCNN detector."""

from .alexnet import AlexNet
from .autoencoder import Autoencoder
from .inception import Inception_v1
from .lenet import LeNet5
from .maskrcnn import MaskRCNN
from .ncf import NeuralCF
from .resnet import ResNet
from .textclassifier import BiLSTMClassifier, CNNTextClassifier, PTBModel
from .vgg import Vgg_16, Vgg_19, VggForCifar10
from .widedeep import WideAndDeep


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


_PARITY_BATCH = {"lenet": 512, "vgg": 128, "inception": 128, "bilstm": 128, "widedeep": 2048}


def parity_config(name: str, batch=None, device=None):
    """Model and synthetic batch of one of BASELINE's five parity configs:
    ``lenet`` (config 1, LeNet5(10)), ``vgg`` (2, VggForCifar10(10), dropout
    on, 3x32x32), ``inception`` (3, Inception_v1(1000), dropout on),
    ``bilstm`` (4, BiLSTMClassifier(vocab 20001, embedding and hidden 128,
    20 classes), T = 200) and ``widedeep`` (5, WideAndDeep(2) at its default
    widths). Returns ``(model, x, labels, batch)``, drawn as the JAX bench
    draws them: for ``widedeep`` ``load_criteo(None, n=batch)`` (``x`` a
    ``Table(wide SparseTensor, deep matrix)``); for the others one
    ``default_rng(0)``, the inputs (f32 standard normal or int32 ids in
    [1, 20000)) then the labels, as numpy arrays. ``batch`` defaults to the
    bench's."""
    import numpy as np

    if name not in _PARITY_BATCH:
        raise ValueError(f"unknown parity config {name!r} (the port has "
                         f"{sorted(_PARITY_BATCH)})")
    batch = _PARITY_BATCH[name] if batch is None else int(batch)
    if name == "widedeep":
        from ..dataset.criteo import load_criteo

        table, labels = load_criteo(None, n=batch)
        return WideAndDeep(class_num=2, device=device), table, labels, batch
    rng = np.random.default_rng(0)
    if name == "lenet":
        x = rng.standard_normal((batch, 784)).astype(np.float32)
        model, classes = LeNet5(10, device=device), 10
    elif name == "vgg":
        x = rng.standard_normal((batch, 3, 32, 32)).astype(np.float32)
        model, classes = VggForCifar10(10, device=device), 10
    elif name == "inception":
        x = rng.standard_normal((batch, 3, 224, 224)).astype(np.float32)
        model, classes = Inception_v1(1000, device=device), 1000
    else:
        x = rng.integers(1, 20000, (batch, 200)).astype(np.int32)
        model, classes = BiLSTMClassifier(vocab_size=20001, hidden_size=128, device=device), 20
    return model, x, rng.integers(0, classes, batch), batch


__all__ = ["AlexNet", "Autoencoder", "BiLSTMClassifier", "CNNTextClassifier", "Inception_v1",
           "LeNet5", "MaskRCNN", "NeuralCF", "PTBModel", "ResNet", "Vgg_16", "Vgg_19", "VggForCifar10",
           "WideAndDeep", "flagship_model", "parity_config"]
