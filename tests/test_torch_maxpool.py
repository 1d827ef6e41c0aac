"""The port's max pool against the JAX package's: the backward's plain
version against the Pallas kernel (interpret mode) and XLA's
SelectAndScatter, and ``SpatialMaxPooling`` forward and input gradient
(through the port's autograd Function on the CPU) against ``jax.vjp``.

Inputs come from numpy with a seed; the geometries, ties, duplicates,
stride > kernel and bf16 cases are those of ``tests/test_maxpool_grad.py``,
plus Inception-v1's, LeNet-5's and VGG-for-CIFAR-10's pool geometries at
small batch and channels (3x3/s1/p1, ceil-mode 3x3/s2 with the overhang on
the high side only, 2x2/s2 on 24x24, 8x8, 4x4 and 2x2 planes).
Tolerances: f32 1e-6 absolute (each window's dy lands once; a position sums
at most nine of them (3x3/s1) in fp32, in another order); bf16 1e-2 relative + 2e-2
absolute against the Pallas kernel, which sums overlapping windows in bf16
where the port sums in fp32 and rounds once (the JAX test's own tolerance).
The card-only case (kernel against plain version) is marked ``gpu``; its
alignment cases (rows of 56 and 28 bytes, x and dy at a storage offset of
one element, a last plane group or row band left part-full, the stem at an
odd size, 2-wide planes at an offset) hold the kernel's 16-byte staging and stores, and its 3x3/s1
cases the traps of that instance (7-wide rows, offsets, row bands, NaN and
-inf inputs), in f32 on the CPU and both dtypes on the card. The forward's
pad-free route (symmetric padding of at most half the window through
``F.max_pool2d`` itself) is held against ``reduce_window`` too, on inputs
with -inf and NaN.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bigdl_tpu.nn as jnn
from bigdl_tpu.ops.maxpool import _maxpool_grad_nchw, _reduce_window_max
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
    # Inception-v1's pools at small batch and channels: the branch pools
    # (3x3/s1/p1, every position under up to 9 windows) at 28x28, 14x14 and 7x7, and
    # the ceil-mode 3x3/s2 pools, whose overhang is on the high side only
    ("inception branch pool 3x3/s1/p1 28x28", lambda k, s, p: _case(2, 6, 28, 28, k, s, p, 21),
     (3, 3), (1, 1), ((1, 1), (1, 1)), "float32"),
    ("inception branch pool 3x3/s1/p1 14x14 (21 planes)",
     lambda k, s, p: _case(3, 7, 14, 14, k, s, p, 28), (3, 3), (1, 1), ((1, 1), (1, 1)),
     "float32"),
    ("inception branch pool 3x3/s1/p1 7x7 bf16", lambda k, s, p: _case(2, 9, 7, 7, k, s, p, 22),
     (3, 3), (1, 1), ((1, 1), (1, 1)), "bfloat16"),
    ("inception ceil pool 3x3/s2 high overhang 14x14",
     lambda k, s, p: _case(2, 6, 14, 14, k, s, p, 23), (3, 3), (2, 2), ((0, 1), (0, 1)),
     "float32"),
    ("inception ceil pool 3x3/s2 high overhang 28x28 bf16",
     lambda k, s, p: _case(2, 4, 28, 28, k, s, p, 24), (3, 3), (2, 2), ((0, 1), (0, 1)),
     "bfloat16"),
    # LeNet-5's 2x2/s2 pools: 24x24 and 8x8 planes (pooled rows of 12 and 4)
    ("lenet pool1 2x2/s2 24x24", lambda k, s, p: _case(4, 6, 24, 24, k, s, p, 25), (2, 2),
     (2, 2), NO_PAD, "float32"),
    ("lenet pool2 2x2/s2 8x8", lambda k, s, p: _case(4, 12, 8, 8, k, s, p, 26), (2, 2), (2, 2),
     NO_PAD, "float32"),
    ("lenet pool2 2x2/s2 8x8 bf16", lambda k, s, p: _case(4, 12, 8, 8, k, s, p, 27), (2, 2),
     (2, 2), NO_PAD, "bfloat16"),
    # VGG-for-CIFAR-10's last two 2x2/s2 pools: 4x4 and 2x2 planes (pooled
    # rows of 2 and 1 elements, narrower than any 16-byte chunk)
    ("vgg-cifar pool13 2x2/s2 4x4", lambda k, s, p: _case(4, 16, 4, 4, k, s, p, 32), (2, 2),
     (2, 2), NO_PAD, "float32"),
    ("vgg-cifar pool17 2x2/s2 2x2 (one-wide pooled rows)",
     lambda k, s, p: _case(4, 16, 2, 2, k, s, p, 33), (2, 2), (2, 2), NO_PAD, "float32"),
    ("vgg-cifar pool17 2x2/s2 2x2 bf16", lambda k, s, p: _case(4, 16, 2, 2, k, s, p, 34),
     (2, 2), (2, 2), NO_PAD, "bfloat16"),
]

# Held on the card only (kernel against plain version): a bf16 3x3/s1 case
# with a part-full last plane group. Against the Pallas kernel, which sums
# up to nine windows' dy in bf16, the bf16 tolerance above (set for at most
# four) does not hold at this size; the f32 case of the same geometry is
# the CPU comparison.
CARD_CASES = [
    ("inception branch pool 3x3/s1/p1 14x14 bf16 (22 planes)",
     lambda k, s, p: _case(2, 11, 14, 14, k, s, p, 29), (3, 3), (1, 1), ((1, 1), (1, 1)),
     "bfloat16"),
]


STEM = ((3, 3), (2, 2), ((1, 1), (1, 1)))
VGG = ((2, 2), (2, 2), NO_PAD)
# The kernel's alignment traps, each in both dtypes: (label, (N, C, H, W),
# (kernel, stride, padding), storage offset of x and dy in elements)
ALIGNMENT_CASES = [
    ("VGG pool13 rows W=28, 16 planes (last group of 5 part-full)", (2, 8, 28, 28), VGG, 0),
    ("VGG pool17 rows W=14, 21 planes (last group of 20 part-full)", (3, 7, 14, 14), VGG, 0),
    ("stem at H=W=113 (odd; last row band part-full)", (1, 3, 113, 113), STEM, 0),
    ("W=28 at storage offset 1", (2, 3, 28, 28), VGG, 1),
    ("stem at storage offset 1", (2, 3, 64, 64), STEM, 1),
    ("W=2 (one-wide pooled rows) at storage offset 1, 35 planes", (5, 7, 2, 2), VGG, 1),
]
ALIGNMENT_PARAMS = [(*c, dt) for c in ALIGNMENT_CASES for dt in ("bfloat16", "float32")]
ALIGNMENT_IDS = [f"{c[0]}-{c[-1]}" for c in ALIGNMENT_PARAMS]

# The 3x3/s1 instance's traps (Inception-v1's branch pools, 3x3/s1/p1): 7-wide
# rows narrower than a 16-byte chunk, a last plane group left part-full, x
# and dy at a storage offset of one element, planes larger than an item (row
# bands that share window rows at their edges), NaN and -inf inputs (a NaN
# at a window's offset 0 keeps the window there; elsewhere it loses to every
# number). (label, (N, C, H, W), storage offset, input kind)
S1 = ((3, 3), (1, 1), ((1, 1), (1, 1)))
S1_CASES = [
    ("W=7, 21 planes (last group part-full)", (3, 7, 7, 7), 0, "normal"),
    ("W=28 at storage offset 1", (2, 3, 28, 28), 1, "normal"),
    ("W=7 at storage offset 1", (3, 5, 7, 7), 1, "normal"),
    ("100x100 planes (row bands)", (1, 2, 100, 100), 0, "normal"),
    ("W=28, NaN and -inf", (2, 3, 28, 28), 0, "nan"),
    ("W=7, NaN and -inf", (3, 7, 7, 7), 0, "nan"),
    ("W=28, -inf", (2, 3, 28, 28), 0, "neginf"),
    ("W=7, -inf", (3, 7, 7, 7), 0, "neginf"),
]


def _s1_case(shape, kind, seed=31):
    """x and dy of an S1_CASES entry; "nan": 5% NaN and 10% -inf cells,
    "neginf": 60% -inf cells (whole windows of -inf)."""
    x, dy = _case(*shape, *S1, seed)
    u = np.random.default_rng(seed + 1).random(x.shape)
    if kind == "nan":
        x[u < 0.05] = np.nan
        x[(u >= 0.05) & (u < 0.15)] = -np.inf
    elif kind == "neginf":
        x[u < 0.6] = -np.inf
    return x, dy


def _at_offset(a: np.ndarray, offset: int, dtype) -> torch.Tensor:
    """A contiguous tensor of a's values whose storage starts ``offset``
    elements earlier (its data_ptr is then not 16-byte aligned)."""
    flat = torch.from_numpy(np.concatenate([np.zeros(offset, np.float32), a.ravel()]))
    return flat.to(dtype)[offset:].view(a.shape)


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


@pytest.mark.parametrize("label,shape,geometry,offset,dtype", ALIGNMENT_PARAMS,
                         ids=ALIGNMENT_IDS)
def test_plain_backward_matches_jax_alignment_cases(label, shape, geometry, offset, dtype):
    """The card's alignment cases on the CPU: the plain version (on tensors at
    the same storage offset) against the Pallas kernel in interpret mode and
    XLA's SelectAndScatter, so the oracle covers every shape the card uses."""
    kernel, stride, padding = geometry
    x, dy = _inputs(lambda k, s, p: _case(*shape, k, s, p, 13), kernel, stride, padding, dtype)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jx, jdy = jnp.asarray(x, jdt), jnp.asarray(dy, jdt)
    (ph, _), (pw, _) = padding
    pallas = _maxpool_grad_nchw(jx, jdy, kernel, stride, (ph, pw), dy.shape[2:],
                                interpret=True)
    xla = jax_reference(jx, jdy, kernel, stride, padding)
    xt, dyt = _at_offset(x, offset, tdt), _at_offset(dy, offset, tdt)
    assert xt.is_contiguous() and xt.storage_offset() == offset
    got = port.maxpool_grad_reference(xt, dyt, kernel, stride, padding)
    assert got.dtype == tdt and got.shape == x.shape
    got = got.float().numpy()
    tol = dict(atol=1e-6) if dtype == "float32" else dict(rtol=1e-2, atol=2e-2)
    np.testing.assert_allclose(got, np.asarray(pallas, np.float32), **tol)
    np.testing.assert_allclose(got, np.asarray(xla, np.float32), **tol)


@pytest.mark.parametrize("label,shape,offset,kind", S1_CASES, ids=[c[0] for c in S1_CASES])
def test_plain_backward_matches_jax_s1_cases(label, shape, offset, kind):
    """The card's 3x3/s1 cases on the CPU, f32 (in bf16 the Pallas kernel sums
    up to nine windows' dy in bf16; the card holds bf16 against the plain
    version): the plain version against the Pallas kernel in interpret mode,
    and against XLA's SelectAndScatter where no NaN is (XLA routes a window
    that holds a NaN elsewhere)."""
    kernel, stride, padding = S1
    x, dy = _s1_case(shape, kind)
    jx, jdy = jnp.asarray(x), jnp.asarray(dy)
    pallas = _maxpool_grad_nchw(jx, jdy, kernel, stride, (1, 1), dy.shape[2:], interpret=True)
    got = port.maxpool_grad_reference(_at_offset(x, offset, torch.float32),
                                      _at_offset(dy, offset, torch.float32), kernel, stride,
                                      padding)
    assert got.dtype == torch.float32 and got.shape == x.shape
    got = got.numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, np.asarray(pallas), atol=1e-6)
    if kind != "nan":
        np.testing.assert_allclose(got, np.asarray(jax_reference(jx, jdy, *S1)), atol=1e-6)


# (kernel, stride, padding): pad-free route (2x2/s2/p0), F.max_pool2d's own
# padding (3x3/s2/p1, 2x2/s2/p1), explicit pad (p > k//2; a ceil overhang)
FORWARD_GEOMETRIES = [((2, 2), (2, 2), NO_PAD), ((3, 3), (2, 2), ((1, 1), (1, 1))),
                      ((2, 2), (2, 2), ((1, 1), (1, 1))), ((3, 3), (1, 1), ((2, 2), (2, 2))),
                      ((2, 2), (2, 2), ((0, 1), (0, 1)))]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kernel,stride,padding", FORWARD_GEOMETRIES,
                         ids=["2x2s2p0", "3x3s2p1", "2x2s2p1", "3x3s1p2", "2x2s2ceil"])
def test_forward_matches_jax_reduce_window(kernel, stride, padding, dtype):
    """maxpool_forward on each route against reduce_window(max), values only,
    on inputs with -inf and NaN (a window holding NaN gives NaN on both)."""
    rng = np.random.default_rng(17)
    x = rng.standard_normal((2, 3, 11, 10)).astype(np.float32)
    x[0, 0, :3, :3] = -np.inf  # a window of -inf only
    x[0, 1, 4, 5] = np.nan
    x[1, 2, 0, 0] = np.nan
    x[1, 0, 6:, 2] = -np.inf
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = np.asarray(_reduce_window_max(jnp.asarray(x, jdt), kernel, stride, padding),
                      np.float32)
    got = port.maxpool_forward(torch.from_numpy(x).to(tdt), kernel, stride, padding)
    assert got.dtype == tdt
    assert tuple(got.shape[2:]) == port.pooled_size(x.shape[2:], kernel, stride, padding)
    np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("padding,padded", [(NO_PAD, False), (((1, 1), (1, 1)), False),
                                            (((0, 1), (0, 1)), True),
                                            (((2, 2), (2, 2)), True)])
def test_forward_pads_only_where_max_pool2d_cannot(monkeypatch, padding, padded):
    """No -inf copy of x for a padding F.max_pool2d takes itself."""
    calls = []
    real = port._pad
    monkeypatch.setattr(port, "_pad", lambda *a: calls.append(a[1]) or real(*a))
    port.maxpool_forward(torch.zeros(1, 1, 9, 9), (3, 3), (2, 2), padding)
    assert calls == ([padding] if padded else [])


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
@pytest.mark.parametrize("label,make,kernel,stride,padding,dtype", CASES + CARD_CASES,
                         ids=[c[0] for c in CASES + CARD_CASES])
def test_kernel_matches_plain_on_card(cuda_card, label, make, kernel, stride, padding, dtype):
    x, dy = _inputs(make, kernel, stride, padding, dtype)
    tdt = getattr(torch, dtype)
    xc, dyc = torch.from_numpy(x).to("cuda", tdt), torch.from_numpy(dy).to("cuda", tdt)
    before = port.launches
    got = port.maxpool_grad(xc, dyc, kernel, stride, padding)
    torch.cuda.synchronize()
    assert port.launches == before + 1
    want = port.maxpool_grad_reference(xc, dyc, kernel, stride, padding)
    # f32: fp32 sums of at most nine terms (3x3/s1) in another order; bf16:
    # both round the fp32 sum once, so at most one bf16 step apart
    tol = dict(atol=1e-6, rtol=1e-6) if dtype == "float32" else dict(atol=1e-6, rtol=2 ** -7)
    torch.testing.assert_close(got.float(), want.float(), **tol)
    assert torch.equal(got, port.maxpool_grad(xc, dyc, kernel, stride, padding))


@pytest.mark.gpu
@pytest.mark.parametrize("label,shape,geometry,offset,dtype", ALIGNMENT_PARAMS,
                         ids=ALIGNMENT_IDS)
def test_kernel_matches_plain_on_card_alignment_cases(cuda_card, label, shape, geometry, offset,
                                                      dtype):
    kernel, stride, padding = geometry
    x, dy = _inputs(lambda k, s, p: _case(*shape, k, s, p, 13), kernel, stride, padding, dtype)
    tdt = getattr(torch, dtype)
    xc, dyc = _at_offset(x, offset, tdt).cuda(), _at_offset(dy, offset, tdt).cuda()
    if offset:  # .cuda() keeps neither the offset nor the misalignment: rebuild on the card
        xc = torch.cat([xc.new_zeros(offset), xc.ravel()])[offset:].view(x.shape)
        dyc = torch.cat([dyc.new_zeros(offset), dyc.ravel()])[offset:].view(dy.shape)
        assert xc.data_ptr() % 16 and dyc.data_ptr() % 16
    before = port.launches
    got = port.maxpool_grad(xc, dyc, kernel, stride, padding)
    torch.cuda.synchronize()
    assert port.launches == before + 1
    want = port.maxpool_grad_reference(xc, dyc, kernel, stride, padding)
    tol = dict(atol=1e-6, rtol=1e-6) if dtype == "float32" else dict(atol=1e-6, rtol=2 ** -7)
    torch.testing.assert_close(got.float(), want.float(), **tol)
    assert torch.equal(got, port.maxpool_grad(xc, dyc, kernel, stride, padding))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("label,shape,offset,kind", S1_CASES, ids=[c[0] for c in S1_CASES])
def test_kernel_matches_plain_on_card_s1_cases(cuda_card, label, shape, offset, kind, dtype):
    kernel, stride, padding = S1
    x, dy = _inputs(lambda *_: _s1_case(shape, kind), kernel, stride, padding, dtype)
    tdt = getattr(torch, dtype)
    xc, dyc = (torch.cat([t.new_zeros(offset), t.ravel()])[offset:].view(t.shape)
               for t in (torch.from_numpy(x).to("cuda", tdt), torch.from_numpy(dy).to("cuda", tdt)))
    if offset:
        assert xc.data_ptr() % 16 and dyc.data_ptr() % 16
    before = port.launches
    got = port.maxpool_grad(xc, dyc, kernel, stride, padding)
    torch.cuda.synchronize()
    assert port.launches == before + 1
    want = port.maxpool_grad_reference(xc, dyc, kernel, stride, padding)
    assert torch.isfinite(got).all()
    tol = dict(atol=1e-6, rtol=1e-6) if dtype == "float32" else dict(atol=1e-6, rtol=2 ** -7)
    torch.testing.assert_close(got.float(), want.float(), **tol)
    assert torch.equal(got, port.maxpool_grad(xc, dyc, kernel, stride, padding))
