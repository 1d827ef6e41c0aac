"""Model-import walkthrough on one card (counterpart of
``examples/interop/import_models.py``; reference: ``Module.loadCaffeModel`` /
``Module.loadTF`` / ``TorchFile``).

    python3 -m bigdl_tpu_torch.examples.import_models [--platform cpu]

Runs the three import paths end to end with self-contained inputs: a Caffe
prototxt string, a frozen TF GraphDef assembled in protobuf wire format and
a .t7 tensor file. The imported graphs run on the card, or on the CPU with
``--platform cpu``.
"""

from __future__ import annotations

import os
import tempfile
from typing import Dict, Optional, Sequence

from ._common import base_parser, device_of, setup_logging

PROTOTXT = """
name: "MiniNet"
input: "data"
layer { name: "conv1" type: "Convolution" bottom: "data" top: "conv1"
        convolution_param { num_output: 6 kernel_size: 3 pad: 1 } }
layer { name: "relu1" type: "ReLU" bottom: "conv1" top: "conv1" }
layer { name: "pool1" type: "Pooling" bottom: "conv1" top: "pool1"
        pooling_param { pool: MAX kernel_size: 2 stride: 2 } }
layer { name: "ip1" type: "InnerProduct" bottom: "pool1" top: "ip1"
        inner_product_param { num_output: 4 } }
layer { name: "prob" type: "Softmax" bottom: "ip1" top: "prob" }
"""


def parser():
    return base_parser("model import walkthrough")


def _graph_def(w1, b1, w2) -> bytes:
    """A frozen GraphDef x -> MatMul/BiasAdd/Relu/MatMul/Softmax, written in
    protobuf wire format without tensorflow (a real flow reads a .pb)."""
    def varint(v):
        out = b""
        while True:
            b7 = v & 0x7F
            v >>= 7
            if v:
                out += bytes([b7 | 0x80])
            else:
                return out + bytes([b7])

    def field(num, wire, payload):
        tag = varint(num << 3 | wire)
        return tag + (varint(len(payload)) + payload if wire == 2 else payload)

    def tensor_attr(arr):
        shape = b"".join(field(2, 2, field(1, 0, varint(d))) for d in arr.shape)
        tp = field(1, 0, varint(1)) + field(2, 2, shape) + field(4, 2, arr.tobytes())
        return field(5, 2, field(1, 2, b"value") + field(2, 2, field(8, 2, tp)))

    def node(name, op, inputs=(), attrs=b""):
        body = field(1, 2, name.encode()) + field(2, 2, op.encode())
        for i in inputs:
            body += field(3, 2, i.encode())
        return field(1, 2, body + attrs)

    return (node("x", "Placeholder")
            + node("w1", "Const", attrs=tensor_attr(w1))
            + node("b1", "Const", attrs=tensor_attr(b1))
            + node("w2", "Const", attrs=tensor_attr(w2))
            + node("mm1", "MatMul", ["x", "w1"])
            + node("add1", "BiasAdd", ["mm1", "b1"])
            + node("relu1", "Relu", ["add1"])
            + node("mm2", "MatMul", ["relu1", "w2"])
            + node("prob", "Softmax", ["mm2"]))


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, object]:
    """Parse ``argv`` (the command line when None), run the three imports
    and return their outputs (host arrays) by path."""
    import numpy as np
    import torch

    from ..utils.caffe import CaffeLoader
    from ..utils.random import RandomGenerator
    from ..utils.tf_loader import TensorflowLoader
    from ..utils.torch_file import load_t7, save_t7

    args = parser().parse_args(argv)
    setup_logging()
    device = device_of(args)
    RandomGenerator.set_seed(1)
    x = np.random.default_rng(0).standard_normal((2, 3, 8, 8)).astype(np.float32)
    out: Dict[str, object] = {}

    # 1. Caffe prototxt -> Graph
    net = CaffeLoader(PROTOTXT, device=device).create_module()
    with torch.no_grad():
        y = net.forward(x).cpu().numpy()
    print(f"caffe import: output {y.shape}, rows sum to {y.sum(1)}")
    out["caffe"] = y

    # 2. torch .t7 round trip (e.g. exchanging weights with torch7 tooling)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "weights.t7")
        save_t7(path, {"conv1": net.get_parameters()["conv1"]["weight"]})
        back = load_t7(path)
        print(f"t7 round trip: conv1 weight {back['conv1'].shape} ok")
        out["t7"] = back["conv1"]

    # 3. frozen TF GraphDef
    rng = np.random.default_rng(1)
    w1 = rng.standard_normal((4, 8)).astype(np.float32)
    b1 = rng.standard_normal(8).astype(np.float32)
    w2 = rng.standard_normal((8, 3)).astype(np.float32)
    g = TensorflowLoader(_graph_def(w1, b1, w2), device=device).create_module(["x"], ["prob"])
    with torch.no_grad():
        probs = g.forward(rng.standard_normal((5, 4)).astype(np.float32)).cpu().numpy()
    print(f"tf import: output {probs.shape}, rows sum to {probs.sum(1)}")
    out["tf"] = probs
    return out


if __name__ == "__main__":
    main()
