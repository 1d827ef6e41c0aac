"""The port's max pool against the JAX package's: the backward's plain
version against the Pallas kernel (interpret mode) and XLA's
SelectAndScatter, and ``SpatialMaxPooling`` forward and input gradient
(through the port's autograd Function on the CPU) against ``jax.vjp``.

Inputs come from numpy with a seed; the geometries, ties, duplicates,
stride > kernel and bf16 cases are those of ``tests/test_maxpool_grad.py``.
Tolerances: f32 1e-6 absolute (each window's dy lands once; a position sums
at most four of them in fp32, in another order); bf16 1e-2 relative + 2e-2
absolute against the Pallas kernel, which sums overlapping windows in bf16
where the port sums in fp32 and rounds once (the JAX test's own tolerance).
The card-only case (kernel against plain version) is marked ``gpu``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bigdl_tpu.nn as jnn
from bigdl_tpu.ops.maxpool import _maxpool_grad_nchw
from bigdl_tpu.ops.maxpool import maxpool_grad_reference as jax_reference
from bigdl_tpu_torch.nn import SpatialMaxPooling
from bigdl_tpu_torch.ops import maxpool as port


def _case(n, c, h, w, kernel, stride, padding, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, c, h, w)).astype(np.float32)
    ho, wo = port.pooled_size((h, w), kernel, stride, padding)
    return x, rng.standard_normal((n, c, ho, wo)).astype(np.float32)


def _ties(kernel, stride, padding):
    x = np.zeros((1, 2, 8, 8), np.float32)  # every window element ties
    ho, wo = port.pooled_size((8, 8), kernel, stride, padding)
    return x, np.arange(2 * ho * wo, dtype=np.float32).reshape(1, 2, ho, wo) + 1


def _duplicates(kernel, stride, padding):
    rng = np.random.default_rng(3)
    x = rng.integers(0, 3, (2, 2, 10, 10)).astype(np.float32)
    ho, wo = port.pooled_size((10, 10), kernel, stride, padding)
    return x, rng.standard_normal((2, 2, ho, wo)).astype(np.float32)


NO_PAD = ((0, 0), (0, 0))
# (label, inputs, kernel, stride, padding, dtype)
CASES = [
    ("non-overlapping 2x2/s2", lambda k, s, p: _case(2, 3, 13, 11, k, s, p, 0),
     (2, 2), (2, 2), NO_PAD, "float32"),
    ("3x3/s2", lambda k, s, p: _case(2, 3, 13, 11, k, s, p, 0), (3, 3), (2, 2), NO_PAD,
     "float32"),
    ("resnet stem 3x3/s2/p1", lambda k, s, p: _case(2, 3, 13, 11, k, s, p, 0), (3, 3), (2, 2),
     ((1, 1), (1, 1)), "float32"),
    ("3x3/s1/p1", lambda k, s, p: _case(2, 3, 13, 11, k, s, p, 0), (3, 3), (1, 1),
     ((1, 1), (1, 1)), "float32"),
    ("asymmetric (3,2)/(2,1)", lambda k, s, p: _case(2, 3, 13, 11, k, s, p, 0), (3, 2), (2, 1),
     ((1, 0), (0, 1)), "float32"),
    ("ceil-mode overhang", lambda k, s, p: _case(2, 3, 13, 11, k, s, p, 0), (2, 2), (2, 2),
     ((0, 1), (0, 1)), "float32"),
    ("constant input ties", _ties, (3, 3), (2, 2), ((1, 1), (1, 1)), "float32"),
    ("integer duplicates 2x2/s2", _duplicates, (2, 2), (2, 2), NO_PAD, "float32"),
    ("integer duplicates 3x3/s2", _duplicates, (3, 3), (2, 2), NO_PAD, "float32"),
    ("stride > kernel", lambda k, s, p: _case(1, 1, 9, 9, k, s, p, 5), (2, 2), (3, 3), NO_PAD,
     "float32"),
    ("bf16 3x3/s2/p1", lambda k, s, p: _case(2, 4, 12, 12, k, s, p, 7), (3, 3), (2, 2),
     ((1, 1), (1, 1)), "bfloat16"),
    ("many planes", lambda k, s, p: _case(4, 64, 14, 14, k, s, p, 9), (3, 3), (2, 2),
     ((1, 1), (1, 1)), "float32"),
]


def _inputs(make, kernel, stride, padding, dtype):
    x, dy = make(kernel, stride, padding)
    if dtype == "bfloat16":  # both packages see the same bf16 values
        x = np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
        dy = np.array(jnp.asarray(dy, jnp.bfloat16).astype(jnp.float32))
    return x, dy


@pytest.mark.parametrize("label,make,kernel,stride,padding,dtype", CASES,
                         ids=[c[0] for c in CASES])
def test_plain_backward_matches_jax(label, make, kernel, stride, padding, dtype):
    x, dy = _inputs(make, kernel, stride, padding, dtype)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jx, jdy = jnp.asarray(x, jdt), jnp.asarray(dy, jdt)
    (ph, _), (pw, _) = padding
    pallas = _maxpool_grad_nchw(jx, jdy, kernel, stride, (ph, pw), dy.shape[2:],
                                interpret=True)
    xla = jax_reference(jx, jdy, kernel, stride, padding)
    got = port.maxpool_grad_reference(torch.from_numpy(x).to(tdt), torch.from_numpy(dy).to(tdt),
                                      kernel, stride, padding)
    assert got.dtype == tdt and got.shape == x.shape
    got = got.float().numpy()
    tol = dict(atol=1e-6) if dtype == "float32" else dict(rtol=1e-2, atol=2e-2)
    np.testing.assert_allclose(got, np.asarray(pallas, np.float32), **tol)
    np.testing.assert_allclose(got, np.asarray(xla, np.float32), **tol)
    if label == "stride > kernel":  # rows and columns no window covers get 0
        assert not got[..., 8, :].any() and not got[..., :, 8].any()


@pytest.mark.parametrize("args,ceil", [
    ((3, 3, 2, 2, 1, 1), False),   # the ResNet stem pool
    ((3, 3, 2, 2), True),          # ceil mode: 10 -> 5 (floor gives 4)
    ((2, 2, 2, 2, 1, 1), True),    # ceil mode with padding: the last-window rule
    ((3, 2, 2, 1, -1, -1), False),  # SAME
])
def test_spatial_max_pooling_matches_jax_vjp(args, ceil):
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 3, 10, 9)).astype(np.float32)
    jm, pm = jnn.SpatialMaxPooling(*args), SpatialMaxPooling(*args, device="cpu")
    if ceil:
        jm, pm = jm.ceil(), pm.ceil()
    jy, vjp = jax.vjp(lambda v: jm.apply({}, {}, v, training=True)[0], jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    py, _ = pm.apply({}, {}, xt, training=True)
    assert tuple(py.shape) == jy.shape
    np.testing.assert_array_equal(py.detach().numpy(), np.asarray(jy))
    dy = rng.standard_normal(jy.shape).astype(np.float32)
    (jdx,) = vjp(jnp.asarray(dy))
    (pdx,) = torch.autograd.grad(py, xt, torch.from_numpy(dy))
    np.testing.assert_allclose(pdx.numpy(), np.asarray(jdx), atol=1e-6)


def test_function_routes_cpu_tensors_through_the_plain_version(monkeypatch):
    """The autograd Function saves x only and, for CPU tensors, calls the
    plain version once per backward; no kernel launch is counted."""
    calls = []
    real = port.maxpool_grad_reference
    monkeypatch.setattr(port, "maxpool_grad_reference",
                        lambda *a: calls.append(a[2:]) or real(*a))
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((1, 2, 6, 6)).astype(
        np.float32)).requires_grad_(True)
    before = port.launches
    y = port.maxpool2d(x, (3, 3), (2, 2), ((1, 1), (1, 1)))
    assert [t.shape for t in y.grad_fn.saved_tensors] == [x.shape]
    y.sum().backward()
    assert calls == [((3, 3), (2, 2), ((1, 1), (1, 1)))] and port.launches == before
    assert float(x.grad.sum()) == y.numel()  # each window routes its dy once


def test_wrapper_takes_no_other_route():
    """Off the CPU the wrapper launches the kernel or raises: never the plain
    version (a ``meta`` tensor stands in for a device without the kernel)."""
    x = torch.empty((1, 1, 4, 4), device="meta")
    dy = torch.empty((1, 1, 2, 2), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        port.maxpool_grad(x, dy, (2, 2), (2, 2), NO_PAD)
    with pytest.raises(ValueError, match="dy must be"):
        port.maxpool_grad_reference(torch.zeros(1, 1, 4, 4), torch.zeros(1, 1, 3, 3), (2, 2),
                                    (2, 2), NO_PAD)


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode); run on the card with "
                    "`python -m pytest -m gpu tests/test_torch_maxpool.py`")


@pytest.mark.gpu
@pytest.mark.parametrize("label,make,kernel,stride,padding,dtype", CASES,
                         ids=[c[0] for c in CASES])
def test_kernel_matches_plain_on_card(cuda_card, label, make, kernel, stride, padding, dtype):
    x, dy = _inputs(make, kernel, stride, padding, dtype)
    tdt = getattr(torch, dtype)
    xc, dyc = torch.from_numpy(x).to("cuda", tdt), torch.from_numpy(dy).to("cuda", tdt)
    before = port.launches
    got = port.maxpool_grad(xc, dyc, kernel, stride, padding)
    torch.cuda.synchronize()
    assert port.launches == before + 1
    want = port.maxpool_grad_reference(xc, dyc, kernel, stride, padding)
    # f32: fp32 sums of at most four terms in another order; bf16: both round
    # the fp32 sum once, so at most one bf16 step apart
    tol = dict(atol=1e-6, rtol=1e-6) if dtype == "float32" else dict(atol=1e-6, rtol=2 ** -7)
    torch.testing.assert_close(got.float(), want.float(), **tol)
    assert torch.equal(got, port.maxpool_grad(xc, dyc, kernel, stride, padding))
