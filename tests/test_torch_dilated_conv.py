"""The port's ``SpatialDilatedConvolution`` against the JAX package's, with the
JAX layer's parameters carried over: outputs and the gradients of the input
and of every parameter (``jax.vjp`` against torch autograd, one numpy-made
cotangent), over dilations, paddings (SAME included: XLA pads for the
dilated kernel's extent ``(k - 1) * d + 1``), strides and groups, with and
without a bias and an activation epilogue. The port runs with the
fused-kernel switch on, so an epilogue with a bias and an activation takes
``fused_bias_act``'s route, its plain version on the CPU (counted); the JAX
layer runs its default route.

Inputs from numpy with a seed, f32 on the CPU. Tolerance 1e-5 absolute and
relative, as ``test_torch_conv_bn.py`` (the same products summed in another
order, at most a few hundred terms per output). The ``gpu`` case: the card's
route (cuDNN and kernels #8/#9b) against the CPU's, f32 with TF32 off, 1e-4
(fp32 sums in another order through cuDNN's algorithms).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bigdl_tpu.nn as jnn
from bigdl_tpu_torch import Engine
from bigdl_tpu_torch import nn as pnn
from bigdl_tpu_torch.nn.conv import resolve_padding
from bigdl_tpu_torch.ops import fused_epilogue as fe
from bigdl_tpu_torch.utils.convert import load_jax_params

ATOL = RTOL = 1e-5


@pytest.fixture(autouse=True)
def _policy():
    Engine.set_compute_dtype("float32")
    Engine.set_fused_kernels(True)
    yield
    Engine.set_compute_dtype(None)
    Engine.set_fused_kernels(None)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _jax_side(args, kw, x):
    """The JAX layer's params, y, the cotangent dy (numpy, seeded), dx and
    the parameter gradients."""
    jm = jnn.SpatialDilatedConvolution(*args, **kw)
    jp, js = jm.init(jax.random.PRNGKey(0), sample_input=x)
    jy, vjp = jax.vjp(lambda p, v: jm.apply(p, js, v, training=True, rng=None)[0],
                      jp, jnp.asarray(x))
    dy = _x(jy.shape, seed=7)
    jgp, jdx = vjp(jnp.asarray(dy))
    return jp, np.asarray(jy), dy, np.asarray(jdx), _np_tree(jgp)


def _port_side(pm, x, dy):
    xt = torch.from_numpy(x).to(pm.device).requires_grad_(True)
    y, _ = pm.apply(pm.get_parameters(), {}, xt, training=True)
    names = [n for n, _ in pm.named_parameters()]
    grads = torch.autograd.grad(y, [xt] + [p for _, p in pm.named_parameters()],
                                torch.from_numpy(dy).to(y.device))
    return (y.detach().cpu().numpy(), grads[0].cpu().numpy(),
            {n: g.cpu().numpy() for n, g in zip(names, grads[1:])})


# (args, kw, input shape): SpatialConvolution's positional arguments
# (n_in, n_out, kW, kH, dW, dH, padW, padH) and the dilation keywords
CASES = {
    "d2_pad2": ((4, 6, 3, 3, 1, 1, 2, 2), dict(dilation_w=2, dilation_h=2), (2, 4, 11, 10)),
    "d3x2_pad": ((4, 6, 3, 3, 1, 1, 1, 2), dict(dilation_w=3, dilation_h=2), (2, 4, 12, 13)),
    "same_d2": ((4, 5, 3, 3, 1, 1, -1, -1), dict(dilation_w=2, dilation_h=2), (2, 4, 9, 8)),
    "same_d3_s2": ((4, 5, 3, 3, 2, 2, -1, -1), dict(dilation_w=3, dilation_h=3), (2, 4, 10, 9)),
    "same_2x4_d2": ((4, 5, 4, 2, 1, 1, -1, -1), dict(dilation_w=2, dilation_h=3), (1, 4, 8, 11)),
    "groups_d2": ((4, 6, 3, 3, 1, 1, 2, 2), dict(dilation_w=2, dilation_h=2, n_group=2),
                  (2, 4, 9, 9)),
    "stride2_d2": ((3, 4, 3, 3, 2, 2, 0, 0), dict(dilation_w=2, dilation_h=2), (2, 3, 13, 12)),
    "no_bias": ((4, 6, 3, 3, 1, 1, 2, 2), dict(dilation_w=2, dilation_h=2, with_bias=False),
                (2, 4, 9, 9)),
    "aspp_d6": ((8, 4, 3, 3, 1, 1, 6, 6), dict(dilation_w=6, dilation_h=6), (2, 8, 13, 13)),
}
ACTIVATIONS = [None, "relu", "gelu", "tanh"]


@pytest.mark.parametrize("activation", ACTIVATIONS, ids=[str(a) for a in ACTIVATIONS])
@pytest.mark.parametrize("case", sorted(CASES))
def test_dilated_convolution_matches_jax(case, activation, monkeypatch):
    args, kw, shape = CASES[case]
    kw = dict(kw, activation=activation)
    x = _x(shape)
    jp, jy, dy, jdx, jgp = _jax_side(args, kw, x)
    pm = pnn.SpatialDilatedConvolution(*args, **kw, device="cpu")
    pm.init(sample_input=x)
    load_jax_params(pm, _np_tree(jp))
    calls = []
    real = fe.fused_bias_act_reference
    monkeypatch.setattr(fe, "fused_bias_act_reference",
                        lambda *a: calls.append(a[-1]) or real(*a))
    y, dx, dparams = _port_side(pm, x, dy)
    assert y.shape == jy.shape
    np.testing.assert_allclose(y, jy, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(dx, jdx, atol=ATOL, rtol=RTOL)
    assert set(dparams) == set(jgp)
    for k in jgp:
        np.testing.assert_allclose(dparams[k], jgp[k], atol=ATOL, rtol=RTOL, err_msg=k)
    fused = activation is not None and kw.get("with_bias", True)
    assert calls == ([1] if fused else [])  # the switch's channel route, axis 1


@pytest.mark.parametrize("size,k,s,d", [(9, 3, 1, 2), (10, 3, 2, 3), (33, 3, 1, 18),
                                        (8, 4, 1, 2), (7, 1, 2, 5)])
def test_same_padding_uses_the_dilated_extent(size, k, s, d):
    """SAME: output ceil(size / s), total pad max(0, (out - 1) * s +
    (k - 1) * d + 1 - size), the odd cell high."""
    (lo, hi), _ = resolve_padding((-1, -1), (size, size), (k, k), (s, s), (d, d))
    out = -(-size // s)
    total = max(0, (out - 1) * s + (k - 1) * d + 1 - size)
    assert (lo, hi) == (total // 2, total - total // 2)
    y = torch.nn.functional.conv2d(torch.nn.functional.pad(torch.zeros(1, 1, size, size),
                                                           (lo, hi, lo, hi)),
                                   torch.zeros(1, 1, k, k), stride=s, dilation=d)
    assert y.shape[-1] == out


def test_dilation_one_is_spatial_convolution():
    args, x = (4, 6, 3, 3, 1, 1, 1, 1), _x((2, 4, 7, 7))
    a = pnn.SpatialDilatedConvolution(*args, device="cpu")
    b = pnn.SpatialConvolution(*args, device="cpu")
    a.init(sample_input=x)
    b.init(sample_input=x)
    load_jax_params(b, {k: v.detach().numpy() for k, v in a.named_parameters()})
    torch.testing.assert_close(a.forward(x), b.forward(x))
    assert a.dilation == (1, 1) and b.dilation == (1, 1)


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run on the card with "
                    "`python -m pytest -m gpu tests/test_torch_dilated_conv.py`")


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["aspp_d6", "same_d3_s2", "groups_d2"])
def test_card_route_matches_cpu(cuda_card, case):
    """The card (cuDNN, kernels #8 and #9b under the switch) against the CPU
    (the plain versions), f32 with TF32 off, from the same weights."""
    args, kw, shape = CASES[case]
    kw = dict(kw, activation="relu")
    x = _x(shape)
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        cpu = pnn.SpatialDilatedConvolution(*args, **kw, device="cpu")
        cpu.init(sample_input=x)
        card = pnn.SpatialDilatedConvolution(*args, **kw, device="cuda")
        card.init(sample_input=x)
        load_jax_params(card, {k: v.detach().numpy() for k, v in cpu.named_parameters()})
        y_cpu = cpu.forward(x).detach()
        dy = _x(tuple(y_cpu.shape), seed=3)
        before = (fe.launches_fwd, fe.launches_bwd_row)
        got = _port_side(card, x, dy)
        torch.cuda.synchronize()
        launched = (fe.launches_fwd - before[0], fe.launches_bwd_row - before[1])
        want = _port_side(cpu, x, dy)
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    assert launched == (1, 1)
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g, w, atol=1e-4, rtol=1e-4)
    for k in want[2]:
        np.testing.assert_allclose(got[2][k], want[2][k], atol=1e-4, rtol=1e-4, err_msg=k)
