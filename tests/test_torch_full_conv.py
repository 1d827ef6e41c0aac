"""The port's ``SpatialFullConvolution`` and ``RoiPooling`` against the JAX
package's, with the JAX layer's parameters carried over.

``SpatialFullConvolution``: outputs and the gradients of the input, the
weight and the bias (``jax.vjp`` against torch autograd, one numpy-made
cotangent) over strides, paddings, ``adj`` below the stride (torch's
``output_padding``) and at or above it (which ``F.conv_transpose2d``
refuses, so the port crops and extends the full transposed convolution),
rectangular kernels and no bias; ``infer_shape`` and its error texts.
Tolerances fixed before the first run: f32 1e-5 absolute and relative (the
same products summed in another order, a few hundred terms an output, as
``test_torch_conv_bn.py``); under the bf16 policy (bf16 operands, the
product rounded to bf16 and returned as f32 in both packages) each value
within 2^-7 of the largest value plus 2^-7 of its own, two bf16 rounding
steps: the two products are summed in fp32 in another order, so one
rounding may land a step apart, and the gradients are rounded again.

``RoiPooling``: outputs over rois inside, across and outside the map,
degenerate rois (x2 < x1, a single cell) and a scale of 1/2, and the
features' gradient on tie-free input: equal to the bit, since a max picks
an element and both packages round the same corners the same way (half to
even).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bigdl_tpu.nn as jnn
from bigdl_tpu.utils.engine import Engine as JEngine
from bigdl_tpu.utils.table import T as JT
from bigdl_tpu_torch import Engine
from bigdl_tpu_torch import nn as pnn
from bigdl_tpu_torch.nn.module import infer_module_shape, spec
from bigdl_tpu_torch.utils import precision
from bigdl_tpu_torch.utils.convert import load_jax_params
from bigdl_tpu_torch.utils.table import T

ATOL = RTOL = 1e-5
BF16_STEP = 2.0 ** -7


@pytest.fixture(autouse=True)
def _policy():
    prev = (JEngine._state.compute_dtype, JEngine._state.activation_dtype)
    Engine.set_compute_dtype("float32")
    Engine.set_activation_dtype(None)
    yield
    JEngine._state.compute_dtype, JEngine._state.activation_dtype = prev
    Engine.set_compute_dtype(None)
    Engine.set_activation_dtype(None)


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# (positional args: n_in, n_out, kW, kH, dW, dH, padW, padH, adjW, adjH), kw, input shape
CASES = {
    "mask_head_2x2_s2": ((6, 5, 2, 2, 2, 2), {}, (3, 6, 7, 7)),
    "3x3_s2_p1": ((3, 5, 3, 3, 2, 2, 1, 1), {}, (2, 3, 6, 6)),
    "3x3_s2_p1_adj1": ((3, 4, 3, 3, 2, 2, 1, 1, 1, 1), {}, (2, 3, 5, 6)),
    "4x3_s3x2_adj21": ((3, 4, 4, 3, 3, 2, 1, 0, 2, 1), {}, (2, 3, 5, 4)),
    "adj_eq_stride": ((3, 4, 3, 3, 2, 2, 1, 1, 2, 2), {}, (2, 3, 5, 5)),
    "adj_gt_stride_p0": ((3, 4, 2, 2, 1, 1, 0, 0, 3, 2), {}, (2, 3, 4, 5)),
    "adj_gt_stride_pad": ((4, 3, 3, 3, 2, 2, 2, 1, 3, 4), {}, (1, 4, 6, 5)),
    "stride1_pad_gt_k": ((3, 2, 2, 2, 1, 1, 1, 1, 0, 0), {}, (2, 3, 6, 6)),
    "no_bias": ((3, 5, 3, 3, 2, 2, 1, 1), {"with_bias": False}, (2, 3, 4, 4)),
}


def _jax_side(args, kw, x):
    jm = jnn.SpatialFullConvolution(*args, **kw)
    jp, js = jm.init(jax.random.PRNGKey(0), sample_input=x)
    jy, vjp = jax.vjp(lambda p, v: jm.apply(p, js, v)[0], jp, jnp.asarray(x))
    dy = _x(jy.shape, seed=7)
    jgp, jdx = vjp(jnp.asarray(dy, jy.dtype))
    return jp, np.asarray(jy.astype(jnp.float32)), dy, np.asarray(jdx), _np_tree(jgp)


def _port_side(args, kw, x, jp, dy):
    pm = pnn.SpatialFullConvolution(*args, **kw, device="cpu")
    pm.init(sample_input=x)
    load_jax_params(pm, _np_tree(jp))
    xt = torch.from_numpy(x).requires_grad_(True)
    y, _ = pm.apply(pm.get_parameters(), {}, xt)
    names = [n for n, _ in pm.named_parameters()]
    grads = torch.autograd.grad(y, [xt] + [p for _, p in pm.named_parameters()],
                                torch.from_numpy(dy).to(y.dtype))
    return (y.detach().float().numpy(), grads[0].numpy(),
            {n: g.numpy() for n, g in zip(names, grads[1:])})


@pytest.mark.parametrize("case", sorted(CASES))
def test_full_convolution_matches_jax_f32(case):
    args, kw, shape = CASES[case]
    x = _x(shape)
    jp, jy, dy, jdx, jgp = _jax_side(args, kw, x)
    y, dx, grads = _port_side(args, kw, x, jp, dy)
    assert y.shape == jy.shape
    np.testing.assert_allclose(y, jy, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(dx, jdx, atol=ATOL, rtol=RTOL)
    assert set(grads) == set(jgp)
    for k in jgp:
        np.testing.assert_allclose(grads[k], jgp[k], atol=ATOL, rtol=RTOL, err_msg=k)


def _bf16_close(got, want, what):
    limit = BF16_STEP * np.abs(want).max() + BF16_STEP * np.abs(want)
    assert (np.abs(got - want) <= limit).all(), (what, np.abs(got - want).max())


@pytest.mark.parametrize("case", ["mask_head_2x2_s2", "3x3_s2_p1_adj1", "adj_gt_stride_pad"])
def test_full_convolution_bf16_policy_matches_jax(case):
    args, kw, shape = CASES[case]
    x = _x(shape)
    for engine in (JEngine, Engine):
        engine.set_compute_dtype("bfloat16")
    jp, jy, dy, jdx, jgp = _jax_side(args, kw, x)
    y, dx, grads = _port_side(args, kw, x, jp, dy)
    assert y.dtype == np.float32 and y.shape == jy.shape
    _bf16_close(y, jy, "y")
    _bf16_close(dx, jdx, "dx")
    for k in jgp:
        _bf16_close(grads[k], jgp[k], k)


def test_adj_at_or_above_stride_is_beyond_conv_transpose2d():
    """The case the crop-and-extend route exists for: torch refuses it."""
    x, w = torch.zeros(1, 2, 4, 4), torch.zeros(2, 3, 3, 3)
    with pytest.raises(RuntimeError):
        torch.nn.functional.conv_transpose2d(x, w, None, 2, 1, 2)
    y = precision.conv_transpose2d(x, w, (2, 2), (1, 1), (2, 3))
    assert tuple(y.shape) == (1, 3, 3 * 2 - 2 + 3 + 2, 3 * 2 - 2 + 3 + 3)


@pytest.mark.parametrize("case", sorted(CASES))
def test_infer_shape_matches_jax_and_forward(case):
    args, kw, shape = CASES[case]
    jspec = jnn.SpatialFullConvolution(*args, **kw).infer_shape(
        jax.ShapeDtypeStruct(shape, jnp.float32))
    pm = pnn.SpatialFullConvolution(*args, **kw, device="cpu")
    out = pm.infer_shape(spec(shape, torch.float32))
    assert tuple(out.shape) == tuple(jspec.shape) and out.dtype == torch.float32
    assert not list(pm.parameters())
    pm.init(sample_input=_x(shape))
    assert tuple(pm.forward(_x(shape)).shape) == tuple(out.shape)


@pytest.mark.parametrize("args,shape", [
    ((3, 4, 3, 3, 1, 1, 3, 3), (1, 3, 2, 2)),  # pad eats the whole output
    ((3, 4, 2, 2), (1, 5, 4, 4)),  # wrong input planes
    ((3, 4, 2, 2), (1, 3, 4)),  # not NCHW
])
def test_infer_shape_errors_match_jax(args, shape):
    with pytest.raises(ValueError) as je:
        jnn.SpatialFullConvolution(*args).set_name("deconv").infer_shape(
            jax.ShapeDtypeStruct(shape, jnp.float32))
    with pytest.raises(ValueError) as pe:
        pnn.SpatialFullConvolution(*args, device="cpu").set_name("deconv").infer_shape(
            spec(shape, torch.float32))
    assert str(pe.value) == str(je.value)


def test_declared_planes_checked_at_build():
    with pytest.raises(ValueError, match="declared 3 input planes, got 5"):
        pnn.SpatialFullConvolution(3, 4, 2, 2, device="cpu").init(sample_input=_x((1, 5, 4, 4)))


# ------------------------------------------------------------------ RoiPooling
ROIS = np.array([
    [0, 0, 0, 15, 11],      # the whole map of image 0
    [1, 2.5, 3.5, 9.5, 7.5],  # half-way corners: rounding half to even
    [1, 4, 4, 4, 4],        # a single cell
    [0, 9, 6, 3, 2],        # degenerate: x2 < x1, y2 < y1
    [1, 14, 10, 40, 30],    # across the map's edge
    [0, 30, 30, 40, 40],    # outside: every bin empty
    [1, 1, 2, 6, 3],        # wide and flat: bins of under one cell
], np.float32)


def _roi_case(scale, shape=(2, 3, 12, 16)):
    feats = _x(shape, seed=3)
    rois = ROIS.copy()
    rois[:, 1:] /= scale
    return feats, rois


@pytest.mark.parametrize("pooled,scale", [((2, 2), 1.0), ((3, 2), 1.0), ((4, 3), 0.5),
                                          ((7, 7), 1.0)])
def test_roi_pooling_matches_jax(pooled, scale):
    feats, rois = _roi_case(scale)
    jm = jnn.RoiPooling(*pooled, spatial_scale=scale)
    jy, vjp = jax.vjp(lambda f: jm.apply({}, {}, JT(f, jnp.asarray(rois)))[0],
                      jnp.asarray(feats))
    dy = _x(jy.shape, seed=9)
    (jdf,) = vjp(jnp.asarray(dy))
    pm = pnn.RoiPooling(*pooled, spatial_scale=scale, device="cpu")
    ft = torch.from_numpy(feats).requires_grad_(True)
    y = pm.forward(T(ft, torch.from_numpy(rois)))
    (df,) = torch.autograd.grad(y, [ft], torch.from_numpy(dy))
    np.testing.assert_array_equal(y.detach().numpy(), np.asarray(jy))
    np.testing.assert_array_equal(df.numpy(), np.asarray(jdf))
    # the outside roi's bins are all empty -> 0; the degenerate roi pools one cell
    assert (y[5] == 0).all()
    assert bool(torch.isfinite(y).all())


def test_roi_pooling_infer_shape_and_errors():
    pm = pnn.RoiPooling(3, 2, device="cpu")
    out = infer_module_shape(pm, [spec((2, 4, 8, 8), torch.float32), spec((5, 5), torch.float32)])
    assert tuple(out.shape) == (5, 4, 2, 3)
    jm = jnn.RoiPooling(3, 2)
    for bad in ([spec((2, 4, 8, 8), torch.float32)],
                [spec((2, 4, 8, 8), torch.float32), spec((5, 4), torch.float32)]):
        with pytest.raises(ValueError) as pe:
            pm.set_name("roi").infer_shape(bad)
        with pytest.raises(ValueError) as je:
            jm.set_name("roi").infer_shape([jax.ShapeDtypeStruct(tuple(s.shape), jnp.float32)
                                            for s in bad])
        assert str(pe.value) == str(je.value)
