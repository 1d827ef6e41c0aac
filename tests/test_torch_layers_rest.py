"""The rest of ``nn/``'s new layers against the JAX package's, forward and
gradients through ``test_torch_activations.check_pair`` (f32 1e-6 + 1e-5
relative, bf16 input 2^-6 relative plus 2^-7 of the largest value; a weight
gradient that sums every position also 1e-6 of its largest value):

* ``LocallyConnected2D`` with kh != kw (the (C, kh, kw) patch order of
  ``lax.conv_general_dilated_patches``, which ``F.unfold`` shares),
  strides and padding; ``LocallyConnected1D``;
* ``SpatialSeparableConvolution`` with SAME padding, strides and a depth
  multiplier;
* ``SpatialAdaptiveMaxPooling`` and ``Maxout`` on plateaus: ``jnp.max``
  splits a tie's gradient evenly, and so does the port's ``amax``;
* ``TemporalAveragePooling``, ``Normalize`` (p 1, 2, 3 and inf, over the
  last dim, ``norm + eps``), ``SpatialWithinChannelLRN``, ``Highway``
  (size inferred, with an activation);
* the initialisers ``Ones``, ``ConstInitMethod`` and ``BilinearFiller``
  to the bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bigdl_tpu.nn as jnn
from bigdl_tpu.nn import initialization as jinit
from bigdl_tpu_torch import nn as pnn
from bigdl_tpu_torch.nn import initialization as pinit
from bigdl_tpu_torch.utils.convert import load_jax_params

from test_torch_activations import _fp32_policy, check_pair  # noqa: F401 (fixture)
from test_torch_conv_bn import np_tree


def _x(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _plateaus(*shape, seed=0):
    """Values in {-1, 0, 1, 2}: most windows hold a tied maximum."""
    return np.random.default_rng(seed).integers(-1, 3, shape).astype(np.float32)


# name -> (maker(nn, device kwargs), input, weighted (sums positions), bf16 input too)
CASES = {
    "LocallyConnected2D": (lambda nn, d: nn.LocallyConnected2D(3, 8, 7, 4, 3, 2, **d),
                           lambda: _x(2, 3, 7, 8), True, False),
    "LocallyConnected2D_stride_pad": (
        lambda nn, d: nn.LocallyConnected2D(2, 9, 6, 3, 2, 3, 2, 1, 1, 0, **d),
        lambda: _x(2, 2, 6, 9, seed=1), True, False),
    "LocallyConnected2D_no_bias": (
        lambda nn, d: nn.LocallyConnected2D(2, 5, 5, 3, 3, 3, with_bias=False, **d),
        lambda: _x(2, 2, 5, 5, seed=2), True, False),
    "LocallyConnected1D": (lambda nn, d: nn.LocallyConnected1D(7, 4, 5, 3, **d),
                           lambda: _x(2, 7, 4, seed=3), True, False),
    "LocallyConnected1D_stride": (lambda nn, d: nn.LocallyConnected1D(9, 3, 2, 3, 2, **d),
                                  lambda: _x(3, 9, 3, seed=4), True, False),
    "SpatialSeparableConvolution": (
        lambda nn, d: nn.SpatialSeparableConvolution(3, 6, 2, 3, 3, **d),
        lambda: _x(2, 3, 8, 8, seed=5), True, False),
    "SpatialSeparableConvolution_same_stride": (
        lambda nn, d: nn.SpatialSeparableConvolution(4, 5, 1, 3, 2, 2, 2, -1, -1, **d),
        lambda: _x(2, 4, 7, 9, seed=6), True, False),
    "SpatialAdaptiveMaxPooling": (lambda nn, d: nn.SpatialAdaptiveMaxPooling(4, 4, **d),
                                  lambda: _x(2, 3, 9, 9, seed=7), False, True),
    "SpatialAdaptiveMaxPooling_plateaus": (
        lambda nn, d: nn.SpatialAdaptiveMaxPooling(3, 2, **d),
        lambda: _plateaus(2, 2, 7, 5, seed=8), False, True),
    "TemporalAveragePooling": (lambda nn, d: nn.TemporalAveragePooling(2, **d),
                               lambda: _x(2, 8, 4, seed=9), False, True),
    "TemporalAveragePooling_3_2": (lambda nn, d: nn.TemporalAveragePooling(3, 2, **d),
                                   lambda: _x(2, 9, 4, seed=10), False, True),
    "Normalize": (lambda nn, d: nn.Normalize(2.0, **d), lambda: _x(3, 6, seed=11), False, True),
    "Normalize_p1": (lambda nn, d: nn.Normalize(1.0, **d), lambda: _x(2, 3, 5, seed=12),
                     False, True),
    "Normalize_p3": (lambda nn, d: nn.Normalize(3.0, 1e-6, **d), lambda: _x(3, 6, seed=13),
                     False, False),
    "Normalize_inf": (lambda nn, d: nn.Normalize(float("inf"), **d),
                      lambda: _x(3, 6, seed=14), False, True),
    "SpatialWithinChannelLRN": (lambda nn, d: nn.SpatialWithinChannelLRN(**d),
                                lambda: _x(2, 3, 6, 6, seed=15), False, True),
    "SpatialWithinChannelLRN_4": (lambda nn, d: nn.SpatialWithinChannelLRN(4, 0.5, 0.6, **d),
                                  lambda: _x(2, 2, 5, 7, seed=16), False, False),
    "Maxout": (lambda nn, d: nn.Maxout(6, 4, 3, **d), lambda: _x(5, 6, seed=17), True, False),
    "Maxout_no_bias": (lambda nn, d: nn.Maxout(None, 3, 2, with_bias=False, **d),
                       lambda: _x(4, 5, seed=18), True, False),
    "Highway": (lambda nn, d: nn.Highway(6, **d), lambda: _x(4, 6, seed=19), True, False),
    "Highway_inferred": (lambda nn, d: nn.Highway(**d), lambda: _x(3, 5, seed=20), True, False),
    "Highway_tanh": (
        lambda nn, d: nn.Highway(4, activation=(torch.tanh if d else jnp.tanh), **d),
        lambda: _x(3, 4, seed=21), True, False),
}

PAIRS = [(n, dt) for n, c in sorted(CASES.items()) for dt in ("float32", "bfloat16")
         if dt == "float32" or c[3]]


@pytest.mark.parametrize("name,dtype", PAIRS)
def test_layer_matches_jax(name, dtype):
    make, data, weighted, _ = CASES[name]
    check_pair(make(jnn, {}), make(pnn, {"device": "cpu"}), data(), dtype,
               grad_share=1e-6 if weighted else None)


def test_locally_connected_patch_order_is_channel_major():
    """Unequal kh and kw: the weight's last axis is (C, kh, kw) in both."""
    jm = jnn.LocallyConnected2D(2, 4, 3, 1, 3, 1)  # kh 1, kw 3: one output column
    pm = pnn.LocallyConnected2D(2, 4, 3, 1, 3, 1, device="cpu")
    x = np.arange(2 * 3 * 4, dtype=np.float32).reshape(1, 2, 3, 4)
    jp, js = jm.init(jax.random.PRNGKey(0), sample_input=jnp.asarray(x))
    pm.init(sample_input=torch.from_numpy(x))
    w = np.zeros((3 * 2, 1, 2 * 1 * 3), np.float32)
    w[:, 0, 4] = 1.0  # channel 1, kh 0, kw 1: the input at (c=1, row, col+1)
    jp = {"weight": jnp.asarray(w), "bias": jnp.zeros_like(jp["bias"])}
    load_jax_params(pm, np_tree(jp))
    jy = np.asarray(jm.apply(jp, js, jnp.asarray(x))[0])
    py = pm.forward(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_array_equal(py, jy)
    np.testing.assert_array_equal(py[0, 0], x[0, 1, :, 1:3])


def test_maxout_splits_a_tied_pieces_gradient_evenly():
    jm, pm = jnn.Maxout(3, 2, 2), pnn.Maxout(3, 2, 2, device="cpu")
    x = _x(4, 3, seed=22)
    jp, js = jm.init(jax.random.PRNGKey(1), sample_input=jnp.asarray(x))
    pm.init(sample_input=torch.from_numpy(x))
    lin = jm[0].name()
    w = np.asarray(jp[lin]["weight"]).copy()
    b = np.asarray(jp[lin]["bias"]).copy()
    w[2:4], b[2:4] = w[0:2], b[0:2]  # piece 1 equals piece 0: every output ties
    jp = {lin: {"weight": jnp.asarray(w), "bias": jnp.asarray(b)}}
    load_jax_params(pm, np_tree(jp))
    jg = jax.grad(lambda p: jnp.sum(jm.apply(p, js, jnp.asarray(x))[0]))(jp)
    pm.forward(torch.from_numpy(x)).sum().backward()
    got = pm[0].weight.grad.numpy()
    np.testing.assert_allclose(got, np.asarray(jg[lin]["weight"]), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got[0:2], got[2:4], rtol=0, atol=0)  # half to each piece


def test_adaptive_max_pool_splits_a_plateaus_gradient_evenly():
    x = np.ones((1, 1, 4, 4), np.float32)
    xt = torch.from_numpy(x).requires_grad_(True)
    pnn.SpatialAdaptiveMaxPooling(1, 1, device="cpu").forward(xt).sum().backward()
    jg = jax.grad(lambda v: jnp.sum(jnn.SpatialAdaptiveMaxPooling(1, 1).apply(
        {}, {}, v)[0]))(jnp.asarray(x))
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(jg))
    np.testing.assert_array_equal(xt.grad.numpy(), np.full_like(x, 1 / 16))


@pytest.mark.parametrize("name,args,shape", [
    ("Ones", (), (3, 4)),
    ("ConstInitMethod", (0.7,), (2, 5)),
    ("BilinearFiller", (), (2, 3, 4, 4)),
    ("BilinearFiller", (), (1, 1, 3, 5)),
    ("BilinearFiller", (), (4, 2, 5, 2)),
])
def test_initializer_matches_jax(name, args, shape):
    want = np.asarray(getattr(jinit, name)(*args)(jax.random.PRNGKey(0), shape, 4, 4))
    got = getattr(pinit, name)(*args)(torch.Generator(), shape, 4, 4)
    assert tuple(got.shape) == shape and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
