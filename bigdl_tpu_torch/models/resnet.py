"""ResNet (counterpart of ``bigdl_tpu/models/resnet.py``), the flagship.

The same graph as the JAX package's, with the same names at every node, so
parameter and state paths coincide (``stem_seq.stem_s2d_seq.stem.stem_conv.
weight``): ImageNet variants with bottleneck blocks (depth >= 50) or basic
blocks, the 1x1-projection shortcut on a shape change (ShortcutType.B), and
the CIFAR-10 variant of depth 6n+2. Every module is created on ``device``.
"""

from __future__ import annotations

from typing import Dict, List

from ..nn.activations import LogSoftMax, ReLU
from ..nn.conv import SpatialConvolution
from ..nn.graph import Graph, Input
from ..nn.initialization import MsraFiller
from ..nn.linear import Linear
from ..nn.module import Identity, Sequential
from ..nn.normalization import SpatialBatchNormalization
from ..nn.pooling import SpatialAveragePooling, SpatialMaxPooling
from ..nn.structural import Reshape, SpaceToDepth
from ..nn.table_ops import CAddTable


def _conv_bn(n_in, n_out, k, stride, pad, name, device, relu=True):
    seq = Sequential(
        SpatialConvolution(n_in, n_out, k, k, stride, stride, pad, pad, with_bias=False,
                           device=device)
        .set_init_method(MsraFiller(False)).set_name(f"{name}_conv"),
        SpatialBatchNormalization(n_out, device=device).set_name(f"{name}_bn"),
        device=device,
    ).set_name(name)
    if relu:
        seq.add(ReLU(device=device).set_name(f"{name}_relu"))
    return seq


def _shortcut(n_in, n_out, stride, name, device):
    """Identity when the shapes match, else a 1x1 projection conv + BN."""
    if n_in == n_out and stride == 1:
        return Identity(device=device).set_name(f"{name}_id")
    return _conv_bn(n_in, n_out, 1, stride, 0, f"{name}_proj", device, relu=False)


def _block(x_node, main, shortcut, name, device):
    m = main.set_name(f"{name}_main").inputs(x_node)
    s = shortcut.inputs(x_node)
    add = CAddTable(device=device).set_name(f"{name}_add").inputs(m, s)
    return ReLU(device=device).set_name(f"{name}_out").inputs(add)


def _basic_block(x_node, n_in, n_out, stride, name, device):
    main = Sequential(_conv_bn(n_in, n_out, 3, stride, 1, f"{name}_a", device),
                      _conv_bn(n_out, n_out, 3, 1, 1, f"{name}_b", device, relu=False),
                      device=device)
    return _block(x_node, main, _shortcut(n_in, n_out, stride, name, device), name, device)


def _bottleneck_block(x_node, n_in, planes, stride, name, device, expansion=4):
    n_out = planes * expansion
    main = Sequential(_conv_bn(n_in, planes, 1, 1, 0, f"{name}_a", device),
                      _conv_bn(planes, planes, 3, stride, 1, f"{name}_b", device),
                      _conv_bn(planes, n_out, 1, 1, 0, f"{name}_c", device, relu=False),
                      device=device)
    return _block(x_node, main, _shortcut(n_in, n_out, stride, name, device), name, device)


_IMAGENET_CFG: Dict[int, List[int]] = {
    18: [2, 2, 2, 2],
    34: [3, 4, 6, 3],
    50: [3, 4, 6, 3],
    101: [3, 4, 23, 3],
    152: [3, 8, 36, 3],
}


def ResNet(depth: int = 50, class_num: int = 1000, dataset: str = "imagenet",
           with_log_softmax: bool = False, stem: str = "conv7", device=None) -> Graph:
    """ResNet-``depth``. ``dataset``: 'imagenet' (bottleneck blocks from depth
    50, basic blocks below) or 'cifar10' (depth = 6n+2). ``stem``: 'conv7'
    (7x7/s2 conv) or 's2d' (SpaceToDepth(2), then a 5x5/s1 conv over 12
    channels: the same 112x112x64 output)."""
    inp = Input()
    d = device
    if dataset == "imagenet":
        if depth not in _IMAGENET_CFG:
            raise ValueError(f"unsupported imagenet depth {depth}")
        if stem == "conv7":
            first = _conv_bn(3, 64, 7, 2, 3, "stem", d)
        elif stem == "s2d":
            first = Sequential(SpaceToDepth(2, device=d).set_name("stem_s2d"),
                               _conv_bn(12, 64, 5, 1, 2, "stem", d),
                               device=d).set_name("stem_s2d_seq")
        else:
            raise ValueError(f"unknown stem {stem!r}")
        stem_seq = Sequential(
            first, SpatialMaxPooling(3, 3, 2, 2, 1, 1, device=d).set_name("stem_pool"),
            device=d).set_name("stem_seq")
        x = stem_seq.inputs(inp)
        n_in = planes = 64
        for stage, n_blocks in enumerate(_IMAGENET_CFG[depth]):
            for b in range(n_blocks):
                name = f"res{stage + 2}{chr(ord('a') + b)}"
                s = (1 if stage == 0 else 2) if b == 0 else 1
                if depth >= 50:
                    x = _bottleneck_block(x, n_in, planes, s, name, d)
                    n_in = planes * 4
                else:
                    x = _basic_block(x, n_in, planes, s, name, d)
                    n_in = planes
            planes *= 2
        pool = SpatialAveragePooling(7, 7, global_pooling=True, device=d).set_name("gap")
    elif dataset == "cifar10":
        if (depth - 2) % 6 != 0:
            raise ValueError("cifar10 ResNet depth must be 6n+2")
        x = _conv_bn(3, 16, 3, 1, 1, "stem", d).inputs(inp)
        n_in = 16
        for stage, planes in enumerate([16, 32, 64]):
            for b in range((depth - 2) // 6):
                s = 2 if (stage > 0 and b == 0) else 1
                x = _basic_block(x, n_in, planes, s, f"s{stage}b{b}", d)
                n_in = planes
        pool = SpatialAveragePooling(8, 8, global_pooling=True, device=d).set_name("gap")
    else:
        raise ValueError(f"unknown dataset {dataset!r}")
    flat = Reshape([n_in], device=d).set_name("flatten").inputs(pool.inputs(x))
    out = Linear(n_in, class_num, device=d).set_name("fc").inputs(flat)
    if with_log_softmax:
        out = LogSoftMax(device=d).set_name("logsoftmax").inputs(out)
    return Graph(inp, out, device=d)
