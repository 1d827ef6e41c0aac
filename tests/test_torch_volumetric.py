"""The port's volumetric layers against the JAX package's:
``VolumetricConvolution`` (``precision.conv3d``, cuDNN on the card) with
strides and padding, in f32 and bf16 input and under the bf16 compute
policy; ``VolumetricMaxPooling`` (``F.max_pool3d``) with native and wide
``-inf`` padding, on all-zero windows (ReLU output: ATen's backward and
XLA's select-and-scatter both send a tied window's gradient to its first
element) and on windows half in the padding; ``VolumetricAveragePooling``
(``precision.true_div``); and a narrow C3D (Tran et al. 2015, Fig. 3, at
widths 4-16 and a 3x16x32x32 clip), forward and gradients of every input
and parameter, through ``test_torch_activations.check_pair``. Tolerances:
check_pair's f32 ones (1e-6 + 1e-5 relative) for the layers; the C3D's
outputs and gradients 1e-5 + 1e-4 relative plus 1e-5 of the tensor's
largest value (11 stacked layers, each product summed in another order);
under the bf16 policy 2^-7 relative plus 2^-7 of the largest value (one
bf16 rounding of the operands, the same in both packages, then fp32 sums in
other orders)."""

import numpy as np
import pytest

import bigdl_tpu.nn as jnn
from bigdl_tpu.utils.engine import Engine as JEngine
from bigdl_tpu_torch import Engine
from bigdl_tpu_torch import nn as pnn

from test_torch_activations import _fp32_policy, check_pair  # noqa: F401 (fixture)


def _x(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _relu_x(*shape, seed=0):
    return np.maximum(_x(*shape, seed=seed), 0.0)  # many all-zero windows


CASES = {
    "VolumetricConvolution": (lambda nn, d: nn.VolumetricConvolution(2, 4, 3, 3, 3, **d),
                              lambda: _x(1, 2, 6, 6, 6)),
    "VolumetricConvolution_pad_stride": (
        lambda nn, d: nn.VolumetricConvolution(3, 5, 3, 2, 3, 1, 2, 1, 1, 0, 1, **d),
        lambda: _x(2, 3, 5, 7, 6)),
    "VolumetricConvolution_no_bias": (
        lambda nn, d: nn.VolumetricConvolution(2, 3, 1, 3, 2, 2, 1, 1, with_bias=False, **d),
        lambda: _x(2, 2, 4, 5, 5)),
    "VolumetricMaxPooling": (lambda nn, d: nn.VolumetricMaxPooling(2, 2, 2, 2, 2, 2, **d),
                             lambda: _x(1, 2, 6, 6, 6)),
    "VolumetricMaxPooling_overlap": (lambda nn, d: nn.VolumetricMaxPooling(3, 3, 2, 1, 2, 1, **d),
                                     lambda: _x(2, 2, 5, 6, 7)),
    "VolumetricMaxPooling_relu_ties": (
        lambda nn, d: nn.VolumetricMaxPooling(2, 3, 3, 1, 2, 2, **d),
        lambda: _relu_x(2, 3, 5, 7, 7, seed=2)),
    "VolumetricMaxPooling_c3d_pool5": (
        lambda nn, d: nn.VolumetricMaxPooling(2, 2, 2, 2, 2, 2, 0, 1, 1, **d),
        lambda: _relu_x(2, 3, 2, 7, 7, seed=3)),
    "VolumetricMaxPooling_wide_pad": (
        lambda nn, d: nn.VolumetricMaxPooling(3, 3, 3, 2, 2, 2, 2, 2, 2, **d),
        lambda: _relu_x(1, 2, 5, 5, 5, seed=4)),
    "VolumetricAveragePooling": (lambda nn, d: nn.VolumetricAveragePooling(2, 2, 2, **d),
                                 lambda: _x(1, 2, 4, 4, 4)),
    "VolumetricAveragePooling_stride": (
        lambda nn, d: nn.VolumetricAveragePooling(3, 2, 3, 1, 2, 1, **d),
        lambda: _x(2, 3, 5, 6, 7)),
}


# the JAX convolution takes no bf16 input against f32 weights: bf16 input only
# for the pools; test_volumetric_convolution_under_the_bf16_policy holds bf16
PAIRS = [(n, dt) for n in sorted(CASES) for dt in ("float32", "bfloat16")
         if dt == "float32" or "Convolution" not in n]


@pytest.mark.parametrize("name,dtype", PAIRS)
def test_volumetric_matches_jax(name, dtype):
    make, data = CASES[name]
    conv = "Convolution" in name
    # a weight gradient sums every output position: 1e-6 of its largest value
    check_pair(make(jnn, {}), make(pnn, {"device": "cpu"}), data(), dtype,
               grad_share=1e-6 if conv else None)


def test_relu_ties_send_the_gradient_to_the_first_element():
    """An all-zero window's gradient lands on its first cell in both."""
    import torch

    x = np.zeros((1, 1, 2, 2, 2), np.float32)
    m = pnn.VolumetricMaxPooling(2, 2, 2, device="cpu")
    xt = torch.from_numpy(x).requires_grad_(True)
    m.forward(xt).sum().backward()
    want = np.zeros_like(x)
    want[0, 0, 0, 0, 0] = 1.0
    np.testing.assert_array_equal(xt.grad.numpy(), want)
    check_pair(jnn.VolumetricMaxPooling(2, 2, 2), pnn.VolumetricMaxPooling(2, 2, 2, device="cpu"),
               x)


def c3d(nn, widths, fc, classes, d):
    """C3D (Tran et al. 2015, arXiv:1412.0767, Fig. 3) at ``widths`` (the
    paper's: 64, 128, 256, 512, 512) for a 3x16xHxW clip: 3x3x3/s1/p1
    convolutions each with a ReLU, pool1 1x2x2, pools 2-5 2x2x2, pool5
    padded (0, 1, 1), then two ``fc`` hidden layers with dropout 0.5."""
    w1, w2, w3, w4, w5 = widths
    layers = []

    def conv(cin, cout):
        layers.extend([nn.VolumetricConvolution(cin, cout, 3, 3, 3, 1, 1, 1, 1, 1, 1, **d),
                       nn.ReLU(**d)])

    conv(3, w1)
    layers.append(nn.VolumetricMaxPooling(1, 2, 2, 1, 2, 2, **d))
    conv(w1, w2)
    layers.append(nn.VolumetricMaxPooling(2, 2, 2, 2, 2, 2, **d))
    conv(w2, w3)
    conv(w3, w3)
    layers.append(nn.VolumetricMaxPooling(2, 2, 2, 2, 2, 2, **d))
    conv(w3, w4)
    conv(w4, w4)
    layers.append(nn.VolumetricMaxPooling(2, 2, 2, 2, 2, 2, **d))
    conv(w4, w5)
    conv(w5, w5)
    layers.append(nn.VolumetricMaxPooling(2, 2, 2, 2, 2, 2, 0, 1, 1, **d))
    layers.extend([nn.View(-1, **d), nn.Linear(None, fc, **d), nn.ReLU(**d),
                   nn.Dropout(0.5, **d), nn.Linear(fc, fc, **d), nn.ReLU(**d),
                   nn.Dropout(0.5, **d), nn.Linear(fc, classes, **d)])
    return nn.Sequential(*layers, **d)


C3D_NARROW = dict(widths=(4, 8, 8, 16, 16), fc=32, classes=11)


def test_narrow_c3d_matches_jax():
    x = _x(2, 3, 16, 32, 32, seed=11)
    y = check_pair(c3d(jnn, d={}, **C3D_NARROW), c3d(pnn, d={"device": "cpu"}, **C3D_NARROW),
                   x, atol=1e-5, rtol=1e-4, grad_share=1e-5)
    assert tuple(y[0].shape) == (2, 11)


@pytest.fixture
def bf16_policy():
    Engine.set_compute_dtype("bfloat16")
    JEngine.set_compute_dtype("bfloat16")
    yield
    Engine.set_compute_dtype("float32")
    JEngine.set_compute_dtype(None)


def test_volumetric_convolution_under_the_bf16_policy(bf16_policy):
    check_pair(jnn.VolumetricConvolution(4, 6, 3, 3, 3, 1, 1, 1, 1, 1, 1),
               pnn.VolumetricConvolution(4, 6, 3, 3, 3, 1, 1, 1, 1, 1, 1, device="cpu"),
               _x(2, 4, 4, 6, 6, seed=12), atol=1e-5, rtol=2.0 ** -7, grad_share=2.0 ** -7)
