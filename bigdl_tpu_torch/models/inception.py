"""Inception-v1 / GoogLeNet (counterpart of ``bigdl_tpu/models/inception.py``;
reference: ``$DL/models/inception/Inception_v1.scala``): each inception
module is a ``Concat`` of four branches along the channels, under the JAX
package's layer names, so parameter paths coincide. The inference graph
without the reference's auxiliary heads, as in the JAX package. Every
module is created on ``device``."""

from __future__ import annotations

from .. import nn


def _inception_module(c_in: int, config, name: str, device=None) -> nn.Concat:
    """config = ((1x1,), (3x3 reduce, 3x3), (5x5 reduce, 5x5), (pool proj,))."""
    d = {"device": device}
    concat = nn.Concat(2, **d).set_name(name)
    concat.add(nn.Sequential(
        nn.SpatialConvolution(c_in, config[0][0], 1, 1, **d).set_name(f"{name}_1x1"),
        nn.ReLU(**d).set_name(f"{name}_relu_1x1"),
        **d).set_name(f"{name}_b1"))
    concat.add(nn.Sequential(
        nn.SpatialConvolution(c_in, config[1][0], 1, 1, **d).set_name(f"{name}_3x3r"),
        nn.ReLU(**d).set_name(f"{name}_relu_3x3r"),
        nn.SpatialConvolution(config[1][0], config[1][1], 3, 3, 1, 1, 1, 1, **d)
        .set_name(f"{name}_3x3"),
        nn.ReLU(**d).set_name(f"{name}_relu_3x3"),
        **d).set_name(f"{name}_b2"))
    concat.add(nn.Sequential(
        nn.SpatialConvolution(c_in, config[2][0], 1, 1, **d).set_name(f"{name}_5x5r"),
        nn.ReLU(**d).set_name(f"{name}_relu_5x5r"),
        nn.SpatialConvolution(config[2][0], config[2][1], 5, 5, 1, 1, 2, 2, **d)
        .set_name(f"{name}_5x5"),
        nn.ReLU(**d).set_name(f"{name}_relu_5x5"),
        **d).set_name(f"{name}_b3"))
    concat.add(nn.Sequential(
        nn.SpatialMaxPooling(3, 3, 1, 1, 1, 1, **d).ceil().set_name(f"{name}_pool"),
        nn.SpatialConvolution(c_in, config[3][0], 1, 1, **d).set_name(f"{name}_poolproj"),
        nn.ReLU(**d).set_name(f"{name}_relu_poolproj"),
        **d).set_name(f"{name}_b4"))
    return concat


def Inception_v1(class_num: int = 1000, has_dropout: bool = True, device=None) -> nn.Sequential:
    d = {"device": device}

    def block(c_in, config, name):
        return _inception_module(c_in, config, name, device)

    m = nn.Sequential(
        nn.SpatialConvolution(3, 64, 7, 7, 2, 2, 3, 3, **d).set_name("conv1/7x7_s2"),
        nn.ReLU(**d).set_name("conv1/relu_7x7"),
        nn.SpatialMaxPooling(3, 3, 2, 2, **d).ceil().set_name("pool1/3x3_s2"),
        nn.SpatialCrossMapLRN(5, 0.0001, 0.75, **d).set_name("pool1/norm1"),
        nn.SpatialConvolution(64, 64, 1, 1, **d).set_name("conv2/3x3_reduce"),
        nn.ReLU(**d).set_name("conv2/relu_3x3_reduce"),
        nn.SpatialConvolution(64, 192, 3, 3, 1, 1, 1, 1, **d).set_name("conv2/3x3"),
        nn.ReLU(**d).set_name("conv2/relu_3x3"),
        nn.SpatialCrossMapLRN(5, 0.0001, 0.75, **d).set_name("conv2/norm2"),
        nn.SpatialMaxPooling(3, 3, 2, 2, **d).ceil().set_name("pool2/3x3_s2"),
        block(192, ((64,), (96, 128), (16, 32), (32,)), "inception_3a"),
        block(256, ((128,), (128, 192), (32, 96), (64,)), "inception_3b"),
        nn.SpatialMaxPooling(3, 3, 2, 2, **d).ceil().set_name("pool3/3x3_s2"),
        block(480, ((192,), (96, 208), (16, 48), (64,)), "inception_4a"),
        block(512, ((160,), (112, 224), (24, 64), (64,)), "inception_4b"),
        block(512, ((128,), (128, 256), (24, 64), (64,)), "inception_4c"),
        block(512, ((112,), (144, 288), (32, 64), (64,)), "inception_4d"),
        block(528, ((256,), (160, 320), (32, 128), (128,)), "inception_4e"),
        nn.SpatialMaxPooling(3, 3, 2, 2, **d).ceil().set_name("pool4/3x3_s2"),
        block(832, ((256,), (160, 320), (32, 128), (128,)), "inception_5a"),
        block(832, ((384,), (192, 384), (48, 128), (128,)), "inception_5b"),
        nn.SpatialAveragePooling(7, 7, 1, 1, **d).set_name("pool5/7x7_s1"),
        **d,
    ).set_name("inception_v1")
    if has_dropout:
        m.add(nn.Dropout(0.4, **d).set_name("pool5/drop_7x7_s1"))
    m.add(nn.Reshape([1024], **d).set_name("flatten"))
    m.add(nn.Linear(1024, class_num, **d).set_name("loss3/classifier"))
    m.add(nn.LogSoftMax(**d).set_name("loss3/loss3"))
    return m
