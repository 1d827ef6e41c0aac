"""The port's ``shift`` max-pool gradient (``maxpool_grad_shift``) against
the JAX package's, and its selection by ``BIGDL_MAXPOOL_GRAD_IMPL``.

* The seven geometries of ``tests/test_maxpool_grad.py::TestShiftImplParity``
  (2x2/s2, 3x3/s2, the stem's 3x3/s2/p1, 3x3/s1/p1, asymmetric 3x2/s(2,1),
  a ceil-mode overhang, stride > kernel) on continuous inputs, f32 and bf16,
  against the JAX function, and in f32 against the port's first-maximum
  plain version (with no ties the two gradients are the same function).
* Ties: a constant input sends ``dy`` to all four cells of a 2x2 window;
  post-ReLU inputs (many tied zeros) and a window holding a NaN (routes
  nothing), against the JAX function.
* ``SpatialMaxPooling``'s backward takes ``shift`` when the variable says
  so (read at each backward), the first-maximum route for ``sas``,
  ``xla`` and ``pallas``; an unknown value warns and takes the default.
* ``gpu``-marked: the shift on the card against the shift on the CPU, and
  against kernel #10 on tie-free input.

Inputs from numpy with a seed. Tolerances, fixed before the first run: f32
1e-6 absolute (the JAX test's own: the same adds in the same (a, b)
order); bf16 one bf16 step of the largest |dx| of the case (2^-8 of it):
both packages round each add to bf16 but XLA's CPU backend may keep an
add's f32 result through a fused chain, which moves a sum by at most one
step of its final magnitude.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu.ops.maxpool import maxpool_grad_shift as jshift
from bigdl_tpu_torch import nn as pnn
from bigdl_tpu_torch.ops import maxpool as port

GEOMETRIES = [
    ((2, 2), (2, 2), ((0, 0), (0, 0))),
    ((3, 3), (2, 2), ((0, 0), (0, 0))),
    ((3, 3), (2, 2), ((1, 1), (1, 1))),
    ((3, 3), (1, 1), ((1, 1), (1, 1))),
    ((3, 2), (2, 1), ((1, 0), (0, 1))),
    ((2, 2), (2, 2), ((0, 1), (0, 1))),
    ((2, 2), (3, 3), ((0, 0), (0, 0))),   # stride > kernel
]
IDS = ["2x2s2", "3x3s2", "3x3s2p1", "3x3s1p1", "3x2asym", "overhang", "stride>kernel"]


def _case(kernel, stride, padding, kind="normal", shape=(2, 3, 13, 11), seed=21):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    if kind == "relu":
        x = np.maximum(x, 0.0)
    ho, wo = port.pooled_size(shape[2:], kernel, stride, padding)
    dy = rng.standard_normal((*shape[:2], ho, wo)).astype(np.float32)
    return x, dy


def _both(x, dy, kernel, stride, padding, dtype):
    """(port, JAX) shift gradients of the same values in ``dtype``, as f32
    numpy arrays."""
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    got = port.maxpool_grad_shift(torch.from_numpy(x).to(tdt), torch.from_numpy(dy).to(tdt),
                                  kernel, stride, padding)
    want = jshift(jnp.asarray(x, jdt), jnp.asarray(dy, jdt), kernel, stride, padding)
    assert got.dtype == tdt and got.shape == x.shape
    return got.float().numpy(), np.asarray(want.astype(jnp.float32))


def _assert_close(got, want, dtype):
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    else:
        np.testing.assert_allclose(got, want, atol=2.0 ** -8 * np.abs(want).max(), rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kernel,stride,padding", GEOMETRIES, ids=IDS)
def test_shift_matches_jax(kernel, stride, padding, dtype):
    x, dy = _case(kernel, stride, padding)
    got, want = _both(x, dy, kernel, stride, padding, dtype)
    _assert_close(got, want, dtype)
    if dtype == "float32":  # no ties: the first-maximum gradient is the same function
        first = port.maxpool_grad_reference(torch.from_numpy(x), torch.from_numpy(dy), kernel,
                                            stride, padding)
        np.testing.assert_allclose(got, first.numpy(), atol=1e-6, rtol=0)


def test_tie_spreads_dy_to_every_tied_cell():
    """Constant input, non-overlapping 2x2 windows: every cell gets its
    window's dy (the first-maximum route gives it to the first cell only)."""
    x, dy = torch.zeros(1, 1, 4, 4), torch.ones(1, 1, 2, 2)
    geo = ((2, 2), (2, 2), ((0, 0), (0, 0)))
    np.testing.assert_array_equal(port.maxpool_grad_shift(x, dy, *geo).numpy(),
                                  np.ones((1, 1, 4, 4)))
    first = port.maxpool_grad_reference(x, dy, *geo).numpy()
    assert first.sum() == 4 and first[0, 0, ::2, ::2].sum() == 4


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kernel,stride,padding", GEOMETRIES[:4], ids=IDS[:4])
def test_shift_matches_jax_on_post_relu_ties(kernel, stride, padding, dtype):
    """Post-ReLU input: half the cells are exact zeros, so all-zero windows
    tie and overlapping windows sum several dy at one cell."""
    x, dy = _case(kernel, stride, padding, kind="relu", seed=5)
    got, want = _both(x, dy, kernel, stride, padding, dtype)
    _assert_close(got, want, dtype)
    n_first = (port.maxpool_grad_reference(torch.from_numpy(x), torch.from_numpy(dy), kernel,
                                           stride, padding).numpy() != 0).sum()
    assert (got != 0).sum() >= n_first
    if kernel == (2, 2):  # a sixteenth of the 2x2 windows are all zero: their ties spread
        assert (got != 0).sum() > n_first


def test_a_window_holding_nan_routes_nothing():
    x, dy = _case((2, 2), (2, 2), ((0, 0), (0, 0)), shape=(1, 2, 4, 4))
    x[0, 0, 1, 1] = np.nan
    got, want = _both(x, dy, (2, 2), (2, 2), ((0, 0), (0, 0)), "float32")
    np.testing.assert_array_equal(got, want)
    assert (got[0, 0, :2, :2] == 0).all() and (got[0, 0, 2:, 2:] != 0).any()


def _module_grad(x):
    """d(sum(SpatialMaxPooling(2x2/s2)(x) * w)) / dx on the CPU."""
    m = pnn.SpatialMaxPooling(2, 2, 2, 2, device="cpu")
    xt = torch.from_numpy(x).requires_grad_()
    y = m.forward(xt)
    w = torch.arange(1.0, y.numel() + 1).reshape(y.shape)
    (g,) = torch.autograd.grad((y * w).sum(), xt)
    return g.numpy()


def test_variable_selects_shift_in_the_module_backward(monkeypatch):
    """A constant plateau, where the two gradients differ: ``shift``
    spreads each window's dy over its four cells; ``sas``, ``xla``,
    ``pallas`` and no value route it to the first; the variable is read at
    each backward."""
    x = np.zeros((1, 1, 4, 4), np.float32)
    monkeypatch.setenv("BIGDL_MAXPOOL_GRAD_IMPL", "shift")
    assert port.grad_impl() == "shift"
    np.testing.assert_array_equal(_module_grad(x), np.repeat(np.repeat(
        np.arange(1.0, 5.0).reshape(1, 1, 2, 2), 2, axis=2), 2, axis=3))
    first = np.zeros((1, 1, 4, 4), np.float32)
    first[0, 0, ::2, ::2] = np.arange(1.0, 5.0).reshape(2, 2)
    for value in ("sas", "xla", "pallas", "SAS", ""):
        monkeypatch.setenv("BIGDL_MAXPOOL_GRAD_IMPL", value)
        np.testing.assert_array_equal(_module_grad(x), first, err_msg=value)
    monkeypatch.delenv("BIGDL_MAXPOOL_GRAD_IMPL")
    assert port.grad_impl() == "sas"
    np.testing.assert_array_equal(_module_grad(x), first)


def test_unknown_value_warns_and_takes_the_default(monkeypatch):
    monkeypatch.setenv("BIGDL_MAXPOOL_GRAD_IMPL", "shif")
    with pytest.warns(RuntimeWarning, match="not recognized"):
        assert port.grad_impl() == "sas"
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        monkeypatch.setenv("BIGDL_MAXPOOL_GRAD_IMPL", "xla")
        assert port.grad_impl() == "sas"


def test_shift_checks_its_geometry():
    with pytest.raises(ValueError, match="dy must be"):
        port.maxpool_grad_shift(torch.zeros(1, 1, 4, 4), torch.zeros(1, 1, 3, 3), (2, 2),
                                (2, 2), ((0, 0), (0, 0)))


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run on the card with "
                    "`python -m pytest -m gpu tests/test_torch_maxpool_shift.py`")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kernel,stride,padding", GEOMETRIES, ids=IDS)
def test_shift_on_card_matches_cpu_and_kernel(cuda_card, kernel, stride, padding, dtype):
    """The shift on the card against the shift on the CPU (post-ReLU ties
    in bf16: the same adds in the same order; exact in f32), and in f32 on
    tie-free input against kernel #10 (1e-6, its fp32 sums)."""
    tdt = getattr(torch, dtype)
    x, dy = _case(kernel, stride, padding, kind="relu" if dtype == "bfloat16" else "normal")
    xc, dyc = torch.from_numpy(x).to(tdt), torch.from_numpy(dy).to(tdt)
    before = port.launches
    got = port.maxpool_grad_shift(xc.cuda(), dyc.cuda(), kernel, stride, padding)
    assert port.launches == before
    want = port.maxpool_grad_shift(xc, dyc, kernel, stride, padding)
    np.testing.assert_array_equal(got.float().cpu().numpy(), want.float().numpy())
    if dtype == "float32":
        k = port.maxpool_grad(xc.cuda(), dyc.cuda(), kernel, stride, padding)
        np.testing.assert_allclose(got.cpu().numpy(), k.cpu().numpy(), atol=1e-6, rtol=0)


@pytest.mark.gpu
def test_module_under_shift_launches_no_kernel_on_card(cuda_card, monkeypatch):
    monkeypatch.setenv("BIGDL_MAXPOOL_GRAD_IMPL", "shift")
    m = pnn.SpatialMaxPooling(3, 3, 2, 2, 1, 1, device="cuda")
    x = torch.zeros(2, 4, 16, 16, device="cuda", requires_grad=True)
    before = port.launches
    m.forward(x).sum().backward()
    torch.cuda.synchronize()
    assert port.launches == before
    want = port.maxpool_grad_shift(torch.zeros(2, 4, 16, 16), torch.ones(2, 4, 8, 8), (3, 3),
                                   (2, 2), ((1, 1), (1, 1)))
    np.testing.assert_array_equal(x.grad.cpu().numpy(), want.numpy())
    assert want.max().item() == 4  # a cell under four windows gets all four
