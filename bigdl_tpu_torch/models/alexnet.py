"""AlexNet (counterpart of ``bigdl_tpu/models/alexnet.py``; reference:
``$DL/models/alexnet/AlexNet.scala``, the BigDL paper's perf benchmark
model), the OWT variant (no LRN groups split across cards): five
convolutions on 227x227 input, two cross-map LRNs, three 3x3/s2 max pools
(their backward is the max-pool kernel on the card: pool1 on 55-wide
planes, pool2 27, pool5 13), three fully connected layers with dropout
0.5 before fc7 and fc8 when ``has_dropout``, and a LogSoftMax head; under
the JAX package's layer names (``conv1`` ... ``fc8``), so parameter paths
coincide. Every module is created on ``device``."""

from __future__ import annotations

from .. import nn


def AlexNet(class_num: int = 1000, has_dropout: bool = True, device=None) -> nn.Sequential:
    d = {"device": device}
    m = nn.Sequential(
        nn.SpatialConvolution(3, 96, 11, 11, 4, 4, **d).set_name("conv1"),
        nn.ReLU(**d).set_name("relu1"),
        nn.SpatialCrossMapLRN(5, 0.0001, 0.75, **d).set_name("norm1"),
        nn.SpatialMaxPooling(3, 3, 2, 2, **d).set_name("pool1"),
        nn.SpatialConvolution(96, 256, 5, 5, 1, 1, 2, 2, n_group=1, **d).set_name("conv2"),
        nn.ReLU(**d).set_name("relu2"),
        nn.SpatialCrossMapLRN(5, 0.0001, 0.75, **d).set_name("norm2"),
        nn.SpatialMaxPooling(3, 3, 2, 2, **d).set_name("pool2"),
        nn.SpatialConvolution(256, 384, 3, 3, 1, 1, 1, 1, **d).set_name("conv3"),
        nn.ReLU(**d).set_name("relu3"),
        nn.SpatialConvolution(384, 384, 3, 3, 1, 1, 1, 1, **d).set_name("conv4"),
        nn.ReLU(**d).set_name("relu4"),
        nn.SpatialConvolution(384, 256, 3, 3, 1, 1, 1, 1, **d).set_name("conv5"),
        nn.ReLU(**d).set_name("relu5"),
        nn.SpatialMaxPooling(3, 3, 2, 2, **d).set_name("pool5"),
        nn.Reshape([256 * 6 * 6], **d).set_name("flatten"),
        nn.Linear(256 * 6 * 6, 4096, **d).set_name("fc6"),
        nn.ReLU(**d).set_name("relu6"),
        **d,
    )
    if has_dropout:
        m.add(nn.Dropout(0.5, **d).set_name("drop6"))
    m.add(nn.Linear(4096, 4096, **d).set_name("fc7"))
    m.add(nn.ReLU(**d).set_name("relu7"))
    if has_dropout:
        m.add(nn.Dropout(0.5, **d).set_name("drop7"))
    m.add(nn.Linear(4096, class_num, **d).set_name("fc8"))
    m.add(nn.LogSoftMax(**d).set_name("logsoftmax"))
    return m
