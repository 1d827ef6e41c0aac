"""VGG (counterpart of ``bigdl_tpu/models/vgg.py``; reference:
``VggForCifar10.scala``, ``Vgg_16.scala``, ``Vgg_19.scala``): conv stacks,
with BN after each conv in the CIFAR-10 variant, as plain ``Sequential``
models. The layer names are the JAX package's (``conv{i}``, ``bn{i}``,
``relu{i}``, ``pool{i}`` with ``i`` counting the pools too, then the head's),
so parameter and state paths coincide. Every module is created on
``device``."""

from __future__ import annotations

from typing import List, Union

from .. import nn

_VGG16 = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M", 512, 512, 512, "M"]
_VGG19 = [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M", 512, 512, 512, 512, "M",
          512, 512, 512, 512, "M"]


def _features(cfg: List[Union[int, str]], batch_norm: bool, device=None) -> nn.Sequential:
    seq = nn.Sequential(device=device)
    c_in = 3
    for i, v in enumerate(cfg):
        if v == "M":
            seq.add(nn.SpatialMaxPooling(2, 2, 2, 2, device=device).set_name(f"pool{i}"))
            continue
        seq.add(nn.SpatialConvolution(c_in, v, 3, 3, 1, 1, 1, 1, device=device)
                .set_name(f"conv{i}"))
        if batch_norm:
            seq.add(nn.SpatialBatchNormalization(v, device=device).set_name(f"bn{i}"))
        seq.add(nn.ReLU(device=device).set_name(f"relu{i}"))
        c_in = v
    return seq


def VggForCifar10(class_num: int = 10, has_dropout: bool = True, device=None) -> nn.Sequential:
    """VGG-16 features with BN and a 512-wide head (reference: VggForCifar10.scala)."""
    model = _features(_VGG16, batch_norm=True, device=device)
    model.add(nn.Reshape([512], device=device).set_name("flatten"))
    if has_dropout:
        model.add(nn.Dropout(0.5, device=device).set_name("drop1"))
    model.add(nn.Linear(512, 512, device=device).set_name("fc1"))
    model.add(nn.BatchNormalization(512, device=device).set_name("fc1_bn"))
    model.add(nn.ReLU(device=device).set_name("fc1_relu"))
    if has_dropout:
        model.add(nn.Dropout(0.5, device=device).set_name("drop2"))
    model.add(nn.Linear(512, class_num, device=device).set_name("fc2"))
    model.add(nn.LogSoftMax(device=device).set_name("logsoftmax"))
    return model


def _vgg_imagenet(cfg, class_num: int, has_dropout: bool, device) -> nn.Sequential:
    model = _features(cfg, batch_norm=False, device=device)
    model.add(nn.Reshape([512 * 7 * 7], device=device).set_name("flatten"))
    for fc, n_in in (("fc6", 512 * 7 * 7), ("fc7", 4096)):
        model.add(nn.Linear(n_in, 4096, device=device).set_name(fc))
        model.add(nn.ReLU(device=device).set_name(f"{fc}_relu"))
        if has_dropout:
            model.add(nn.Dropout(0.5, device=device).set_name(f"drop{fc[2:]}"))
    model.add(nn.Linear(4096, class_num, device=device).set_name("fc8"))
    model.add(nn.LogSoftMax(device=device).set_name("logsoftmax"))
    return model


def Vgg_16(class_num: int = 1000, has_dropout: bool = True, device=None) -> nn.Sequential:
    return _vgg_imagenet(_VGG16, class_num, has_dropout, device)


def Vgg_19(class_num: int = 1000, has_dropout: bool = True, device=None) -> nn.Sequential:
    return _vgg_imagenet(_VGG19, class_num, has_dropout, device)
