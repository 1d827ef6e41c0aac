"""The port's structural layers against the JAX package's
(``bigdl_tpu/nn/structural.py``): every class forward and backward (input
gradient against ``jax.grad``) on the same seeded numpy input, in f32 and
bf16, through ``test_torch_activations.check_pair`` and its tolerances
(these layers only move values, so both dtypes agree to the bit in
practice); the 1-based dims and indices, ``Narrow``'s negative length,
``Index``'s ``jnp.take`` traps (a 1-based 0 wraps to the last entry, an
index past the end gives NaN and no gradient), ``Squeeze`` of a dim that
is not 1, and ``MaskedSelect``'s data-dependent shape (the port runs it and
differentiates it; the JAX package refuses to trace it)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bigdl_tpu.nn as jnn
from bigdl_tpu.utils.table import T as JT
from bigdl_tpu_torch import nn as pnn
from bigdl_tpu_torch.utils.table import T as PT

from test_torch_activations import _fp32_policy, check_pair  # noqa: F401 (fixture)


def _x(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _masked_steps():
    x = _x(3, 4, 5, seed=3)
    x[0, 1] = 0.0
    x[2, 3] = 0.0
    x[1, 0, :4] = 0.0  # one nonzero entry: kept
    return x


def _index_input():
    return [_x(5, 4, seed=4), np.array([[1, 3], [2, 5]], np.int64)]


def _index_dim2():
    return [_x(3, 6, 2, seed=5), np.array([4, 1, 6, 2], np.int64)]


# name -> (maker(nn, device kwargs), input maker)
CASES = {
    "View": (lambda nn, d: nn.View((12,), **d), lambda: _x(3, 4, 3)),
    "View_infer": (lambda nn, d: nn.View(2, -1, **d), lambda: _x(3, 4, 3)),
    "Squeeze": (lambda nn, d: nn.Squeeze(2, **d), lambda: _x(3, 1, 4)),
    "Squeeze_all": (lambda nn, d: nn.Squeeze(**d), lambda: _x(3, 1, 4, 1)),
    "Squeeze_batch_mode": (lambda nn, d: nn.Squeeze(1, batch_mode=True, **d),
                           lambda: _x(3, 1, 4)),
    "Unsqueeze": (lambda nn, d: nn.Unsqueeze(1, **d), lambda: _x(3, 4)),
    "Unsqueeze_2": (lambda nn, d: nn.Unsqueeze(2, **d), lambda: _x(3, 4, 5)),
    "Transpose": (lambda nn, d: nn.Transpose(((1, 2),), **d), lambda: _x(3, 4, 5)),
    "Transpose_two": (lambda nn, d: nn.Transpose([(2, 3), (1, 3)], **d), lambda: _x(3, 4, 5)),
    "Contiguous": (lambda nn, d: nn.Contiguous(**d), lambda: _x(3, 4)),
    "Narrow": (lambda nn, d: nn.Narrow(1, 1, 2, **d), lambda: _x(3, 5)),
    "Narrow_negative_length": (lambda nn, d: nn.Narrow(2, 2, -1, **d), lambda: _x(3, 5, 4)),
    "Narrow_negative_length_2": (lambda nn, d: nn.Narrow(2, 2, -2, **d), lambda: _x(3, 6, 4)),
    "Index": (lambda nn, d: nn.Index(1, **d), _index_input),
    "Index_dim2": (lambda nn, d: nn.Index(2, **d), _index_dim2),
    "Padding": (lambda nn, d: nn.Padding(1, 2, 2, **d), lambda: _x(3, 4)),
    "Padding_before_batched": (lambda nn, d: nn.Padding(2, -1, 2, 0.5, **d),
                               lambda: _x(3, 4, 5)),
    "SpatialZeroPadding": (lambda nn, d: nn.SpatialZeroPadding(1, 2, 0, 3, **d),
                           lambda: _x(2, 3, 4, 4)),
    "ZeroPadding2D": (lambda nn, d: nn.ZeroPadding2D((1, 2), **d), lambda: _x(2, 3, 4, 4)),
    "Masking": (lambda nn, d: nn.Masking(0.0, **d), _masked_steps),
    "InferReshape": (lambda nn, d: nn.InferReshape((-1, 2), **d), lambda: _x(3, 4)),
    "InferReshape_batch_mode": (lambda nn, d: nn.InferReshape((0, -1), batch_mode=True, **d),
                                lambda: _x(3, 4, 5)),
    "Flatten": (lambda nn, d: nn.Flatten(**d), lambda: _x(2, 3, 4)),
    "UpSampling1D": (lambda nn, d: nn.UpSampling1D(3, **d), lambda: _x(2, 5, 3)),
    "UpSampling2D": (lambda nn, d: nn.UpSampling2D((2, 3), **d), lambda: _x(1, 2, 4, 4)),
    "UpSampling3D": (lambda nn, d: nn.UpSampling3D((2, 1, 2), **d), lambda: _x(1, 2, 3, 3, 3)),
    "Cropping1D": (lambda nn, d: nn.Cropping1D((1, 2), **d), lambda: _x(2, 8, 3)),
    "Cropping2D": (lambda nn, d: nn.Cropping2D(((1, 1), (2, 1)), **d), lambda: _x(1, 2, 6, 7)),
    "Cropping3D": (lambda nn, d: nn.Cropping3D(((1, 0), (1, 1), (0, 2)), **d),
                   lambda: _x(1, 2, 4, 4, 5)),
    "Replicate": (lambda nn, d: nn.Replicate(3, **d), lambda: _x(2, 5)),
    "Replicate_dim2": (lambda nn, d: nn.Replicate(2, dim=2, **d), lambda: _x(2, 3, 4)),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_structural_matches_jax(name, dtype):
    make, data = CASES[name]
    x = data()
    # jax.grad takes no integer input: Index's gradient is held below
    check_pair(make(jnn, {}), make(pnn, {"device": "cpu"}), x, dtype, atol=0.0, rtol=0.0,
               grads=not name.startswith("Index"))


@pytest.mark.parametrize("data,dim", [(_index_input, 1), (_index_dim2, 2)])
def test_index_gradient_matches_jax(data, dim):
    src, idx = data()
    dy = _x(*np.asarray(jnn.Index(dim).forward(JT(jnp.asarray(src), jnp.asarray(idx)))).shape,
            seed=9)
    jg = jax.grad(lambda s: jnp.sum(jnn.Index(dim).apply({}, {}, JT(s, jnp.asarray(idx)))[0]
                                    * dy))(jnp.asarray(src))
    x = torch.from_numpy(src).requires_grad_(True)
    (pnn.Index(dim, device="cpu").forward(PT(x, torch.from_numpy(idx)))
     * torch.from_numpy(dy)).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jg), rtol=1e-6, atol=1e-6)


def _index_both(src, idx, dim=1):
    jm, pm = jnn.Index(dim), pnn.Index(dim, device="cpu")
    jy = np.asarray(jm.forward(JT(jnp.asarray(src), jnp.asarray(idx))))
    x = torch.from_numpy(src).requires_grad_(src.dtype.kind == "f")
    py = pm.forward(PT(x, torch.from_numpy(idx)))
    return jy, py, x


def test_index_follows_jnp_take_at_zero_and_past_the_end():
    src = np.arange(4, dtype=np.float32) * 10.0 + 1.0
    idx = np.array([0, 1, 4, 5, -1], np.int64)  # 1-based: 0 wraps, 5 is past the end
    jy, py, x = _index_both(src, idx)
    np.testing.assert_array_equal(py.detach().numpy(), jy)
    np.testing.assert_array_equal(jy, [31.0, 1.0, 31.0, np.nan, 21.0])
    py.nan_to_num().sum().backward()  # the filled entry passes no gradient
    jg = jax.grad(lambda s: jnp.nansum(jnn.Index(1).apply({}, {}, JT(s, jnp.asarray(idx)))[0]))(
        jnp.asarray(src))
    np.testing.assert_array_equal(x.grad.numpy(), np.asarray(jg))
    np.testing.assert_array_equal(x.grad.numpy(), [1.0, 0.0, 1.0, 2.0])


def test_index_of_an_integer_source_fills_with_the_smallest_value():
    src = np.arange(6, dtype=np.int32).reshape(2, 3)
    idx = np.array([3, 4], np.int64)
    jy, py, _ = _index_both(src, idx, dim=2)
    np.testing.assert_array_equal(py.numpy(), jy)
    assert py[0, 1] == np.iinfo(np.int32).min


def test_squeeze_of_a_dim_that_is_not_one_raises_in_both():
    x = _x(3, 2, 4)
    with pytest.raises(ValueError):
        jnn.Squeeze(2).forward(x)
    with pytest.raises(ValueError, match="cannot squeeze"):
        pnn.Squeeze(2, device="cpu").forward(x)


def test_masked_select_matches_jax_and_differentiates_eagerly():
    x = _x(3, 4, seed=7)
    mask = (x > 0.2).astype(np.uint8)
    jy = np.asarray(jnn.MaskedSelect().forward(JT(jnp.asarray(x), jnp.asarray(mask))))
    xt = torch.from_numpy(x).requires_grad_(True)
    py = pnn.MaskedSelect(device="cpu").forward(PT(xt, torch.from_numpy(mask)))
    np.testing.assert_array_equal(py.detach().numpy(), jy)
    assert py.shape == (int(mask.sum()),)
    py.sum().backward()  # the port's gradient reaches the selected entries
    np.testing.assert_array_equal(xt.grad.numpy(), mask.astype(np.float32))
    with pytest.raises(ValueError, match="traced"):  # the JAX package refuses a trace
        jax.grad(lambda v: jnp.sum(jnn.MaskedSelect().apply(
            {}, {}, JT(v, jnp.asarray(mask)))[0]))(jnp.asarray(x))
    with pytest.raises(ValueError, match="data-dependent"):  # and both refuse a shape
        pnn.MaskedSelect(device="cpu").infer_shape(None)


def test_view_contract_matches_jax():
    for sizes in [(5, -1), (-1, -1), (7,)]:
        with pytest.raises(ValueError) as je:
            jnn.View(*sizes).infer_shape(jax.ShapeDtypeStruct((2, 12), jnp.float32))
        with pytest.raises(ValueError) as pe:
            pnn.View(*sizes, device="cpu").infer_shape(torch.empty(2, 12, device="meta"))
        assert str(pe.value).split(":", 1)[1] == str(je.value).split(":", 1)[1]
