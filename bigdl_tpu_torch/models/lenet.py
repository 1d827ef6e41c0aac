"""LeNet-5 (counterpart of ``bigdl_tpu/models/lenet.py``; reference:
``$DL/models/lenet/LeNet5.scala``): Reshape(1, 28, 28) -> conv(1->6, 5x5) ->
Tanh -> maxpool(2, 2) -> conv(6->12, 5x5) -> Tanh -> maxpool(2, 2) ->
Reshape(12*4*4) -> Linear(100) -> Tanh -> Linear(classNum) -> LogSoftMax,
under the JAX package's layer names, so parameter paths coincide. Every
module is created on ``device``."""

from __future__ import annotations

from .. import nn


def LeNet5(class_num: int = 10, device=None) -> nn.Sequential:
    d = {"device": device}
    return nn.Sequential(
        nn.Reshape([1, 28, 28], **d).set_name("reshape_28x28"),
        nn.SpatialConvolution(1, 6, 5, 5, **d).set_name("conv1_5x5"),
        nn.Tanh(**d).set_name("tanh1"),
        nn.SpatialMaxPooling(2, 2, 2, 2, **d).set_name("pool1"),
        nn.SpatialConvolution(6, 12, 5, 5, **d).set_name("conv2_5x5"),
        nn.Tanh(**d).set_name("tanh2"),
        nn.SpatialMaxPooling(2, 2, 2, 2, **d).set_name("pool2"),
        nn.Reshape([12 * 4 * 4], **d).set_name("flatten"),
        nn.Linear(12 * 4 * 4, 100, **d).set_name("fc1"),
        nn.Tanh(**d).set_name("tanh3"),
        nn.Linear(100, class_num, **d).set_name("fc2"),
        nn.LogSoftMax(**d).set_name("logsoftmax"),
        **d,
    )
