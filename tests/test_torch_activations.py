"""The port's activations against the JAX package's: every class of
``bigdl_tpu/nn/activations.py`` forward and backward (input and parameter
gradients against ``jax.grad``) on the same seeded numpy input, in f32 and
bf16; the clip family's gradient at its exact bounds, GELU's tanh
approximation and ``RReLU``'s training draws.

Inputs are (4, 6, 5) values of std 3 with the traps planted: 0, ±1, ±2.5
(``HardSigmoid``'s bounds), 6, 1e-6 (``Threshold``'s default) and 30
(``SoftPlus`` far above β·x = 20). Tolerances: f32 outputs and gradients
1e-6 absolute plus 1e-5 relative (the same elementwise formula; XLA's and
ATen's exp, tanh and log1p may differ by a few units in the last place),
and for GELU's gradient also 2^-20 of the gradient's largest value (ATen
differentiates the tanh form in closed form, JAX the expression by
autodiff: terms that cancel, each rounded in f32). bf16: 2^-6 relative plus
2^-7 of the tensor's largest value, and in an input gradient 2^-6 of its
element's cotangent |dy|: torch rounds each intermediate op's result to
bf16 while XLA fuses the expression and rounds once, so the two part by a
bf16 step of the TERMS (0.5 in HardSigmoid's 0.2x + 0.5; dy and 1 - y² in
tanh's gradient), not of the result. The first run held bf16 at 2^-6
relative alone, which such cancellations broke.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bigdl_tpu.nn as jnn
from bigdl_tpu.utils.table import T as JT
from bigdl_tpu.utils.table import Table as JTable
from bigdl_tpu_torch import Engine
from bigdl_tpu_torch import nn as pnn
from bigdl_tpu_torch.utils.convert import load_jax_params
from bigdl_tpu_torch.utils.table import T as PT
from bigdl_tpu_torch.utils.table import Table as PTable

from test_torch_conv_bn import flat, np_tree

TOL = {"float32": (1e-6, 1e-5, 0.0), "bfloat16": (1e-5, 2.0 ** -6, 2.0 ** -7)}  # (atol, rtol,
# share of the tensor's largest magnitude)
PLANTED = [0.0, 1.0, -1.0, 2.5, -2.5, 6.0, 1e-6, 30.0, -30.0, 0.5]


@pytest.fixture(autouse=True)
def _fp32_policy():
    Engine.set_compute_dtype("float32")
    Engine.set_activation_dtype(None)
    yield
    Engine.set_compute_dtype(None)


# ------------------------------------------------------------ the helper
def to_jax(x, dtype="float32"):
    """numpy arrays (a list of them: a Table) as the JAX package's input."""
    if isinstance(x, list):
        return JT(*[to_jax(v, dtype) for v in x])
    return jnp.asarray(x, getattr(jnp, dtype)) if x.dtype.kind == "f" else jnp.asarray(x)


def to_port(x, dtype="float32"):
    if isinstance(x, list):
        return PT(*[to_port(v, dtype) for v in x])
    t = torch.from_numpy(np.ascontiguousarray(x))
    return t.to(getattr(torch, dtype)) if t.is_floating_point() else t


def leaves(y):
    """A (nested) Table's tensors in order; a tensor alone."""
    if isinstance(y, (JTable, PTable, list, tuple)):
        return [v for e in y for v in leaves(e)]
    return [y]


def _close(got, want, atol, rtol, what, share=0.0, extra=0.0):
    """|got - want| <= atol + rtol·|want| + share·max|want| + extra (an
    array of per-element allowances, or 0)."""
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    assert got.shape == want.shape, (what, got.shape, want.shape)
    finite = np.isfinite(want)
    top = float(np.abs(want[finite]).max()) if finite.any() else 0.0
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want), err_msg=what)
    ok = np.isnan(want) | (got == want) | (
        np.abs(got - want) <= atol + rtol * np.abs(want) + share * top + extra)
    assert ok.all(), (f"{what}: {int((~ok).sum())} of {ok.size} beyond the limit; worst "
                      f"|diff| {np.nanmax(np.abs(got - want)):.3g}")


def check_pair(jm, pm, x, dtype="float32", atol=None, rtol=None, seed=0, training=False,
               grads=True, grad_share=None, dy_share=0.0, jit=False):
    """Build both modules on ``x`` (the port's weights carried from the JAX
    module's), run each forward, and hold the outputs, their dtypes and the
    gradients of sum(y·dy) for the input and every parameter (``TOL`` of
    the dtype unless given; an elementwise layer's input gradient also
    ``dy_share``·|dy| of its own element). The JAX side runs op by op
    unless ``jit``: under jit XLA may contract 0.2·x + 0.5 into one fused
    multiply-add, so HardSigmoid's bound -2.5 no longer lands on exactly 0,
    while the port, like eager JAX, rounds the product first. Returns the
    port's outputs."""
    d_atol, d_rtol, share = TOL[dtype]
    atol = d_atol if atol is None else atol
    rtol = d_rtol if rtol is None else rtol
    grad_share = share if grad_share is None else grad_share
    jx, px = to_jax(x, dtype), to_port(x, dtype)
    jp, js = jm.init(jax.random.PRNGKey(seed), sample_input=jx)
    pm.init(sample_input=px)
    if flat(np_tree(jp)):
        load_jax_params(pm, np_tree(jp))
    def fwd(p, v):
        return jm.apply(p, js, v, training=training)[0]

    wrap = jax.jit if jit else (lambda f: f)
    fwd = wrap(fwd)
    jys = leaves(fwd(jp, jx))
    rng = np.random.default_rng(seed + 1)
    dys = [rng.standard_normal(y.shape).astype(np.float32) for y in jys]
    pxs = [v.requires_grad_(True) for v in leaves(px) if v.is_floating_point()]
    pys = leaves(pm.apply(pm.get_parameters(), pm.get_state(), px, training=training)[0])
    assert len(pys) == len(jys)
    for i, (py, jy) in enumerate(zip(pys, jys)):
        assert str(py.dtype).split(".")[-1] == str(jy.dtype), (i, py.dtype, jy.dtype)
        _close(py, jy, atol, rtol, f"output {i}", share)
    if not grads:
        return pys

    def jloss(p, v):
        return sum(jnp.sum(y.astype(jnp.float32) * dy) for y, dy in zip(leaves(fwd(p, v)), dys))

    jgp, jgx = wrap(jax.grad(jloss, argnums=(0, 1)))(jp, jx)
    loss = sum((py.float() * torch.from_numpy(dy)).sum() for py, dy in zip(pys, dys))
    loss.backward()
    jgxs = [g for g in leaves(jgx) if jnp.issubdtype(g.dtype, jnp.floating)]
    for i, (v, g) in enumerate(zip(pxs, jgxs)):
        extra = dy_share * np.abs(dys[i]) if dy_share and dys[i].shape == g.shape else 0.0
        got = v.grad if v.grad is not None else torch.zeros_like(v)  # an entry left unused
        _close(got, g, atol, rtol, f"input gradient {i}", grad_share, extra)
    want = flat(np_tree(jgp))
    got = {k: p.grad for k, p in pm.named_parameters()}
    assert set(got) == set(want)
    for k in want:
        _close(got[k], want[k], atol, rtol, f"gradient of {k}", grad_share)
    return pys


def planted_input(shape=(4, 6, 5), seed=0, scale=3.0):
    x = (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)
    x.reshape(-1)[:len(PLANTED)] = PLANTED
    return x


# ------------------------------------------------------------ activations
ACTIVATIONS = {
    "ReLU": lambda nn, d: nn.ReLU(**d),
    "ReLU6": lambda nn, d: nn.ReLU6(**d),
    "Threshold": lambda nn, d: nn.Threshold(**d),
    "Threshold_v": lambda nn, d: nn.Threshold(0.5, -2.0, **d),
    "Tanh": lambda nn, d: nn.Tanh(**d),
    "Sigmoid": lambda nn, d: nn.Sigmoid(**d),
    "HardSigmoid": lambda nn, d: nn.HardSigmoid(**d),
    "HardTanh": lambda nn, d: nn.HardTanh(**d),
    "HardTanh_range": lambda nn, d: nn.HardTanh(-2.5, 6.0, **d),
    "ELU": lambda nn, d: nn.ELU(0.7, **d),
    "SELU": lambda nn, d: nn.SELU(**d),
    "LeakyReLU": lambda nn, d: nn.LeakyReLU(0.1, **d),
    "PReLU_shared": lambda nn, d: nn.PReLU(**d),
    "PReLU_channels": lambda nn, d: nn.PReLU(6, **d),
    "RReLU_eval": lambda nn, d: nn.RReLU(**d),
    "SoftMax": lambda nn, d: nn.SoftMax(**d),
    "LogSoftMax": lambda nn, d: nn.LogSoftMax(**d),
    "SoftPlus": lambda nn, d: nn.SoftPlus(**d),
    "SoftPlus_beta": lambda nn, d: nn.SoftPlus(2.0, **d),
    "SoftSign": lambda nn, d: nn.SoftSign(**d),
    "SoftMin": lambda nn, d: nn.SoftMin(**d),
    "GELU": lambda nn, d: nn.GELU(**d),
    "Swish": lambda nn, d: nn.Swish(**d),
    "ThresholdedReLU": lambda nn, d: nn.ThresholdedReLU(**d),
    "SReLU": lambda nn, d: nn.SReLU(**d),
    "SReLU_shared": lambda nn, d: nn.SReLU((2,), **d),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(ACTIVATIONS))
def test_activation_matches_jax(name, dtype):
    make = ACTIVATIONS[name]
    x = planted_input()
    if name.startswith("SReLU"):  # move t_left below 0 and a_left off 0, as training would
        x[0, 0, 0] = -0.0
    grad_share = 2.0 ** -20 if (name == "GELU" and dtype == "float32") else None
    check_pair(make(jnn, {}), make(pnn, {"device": "cpu"}), x, dtype, grad_share=grad_share,
               dy_share=2.0 ** -6 if dtype == "bfloat16" else 0.0)


def test_clip_family_takes_half_the_gradient_at_exact_bounds():
    """jnp.clip's gradient is 1/2 at a bound (torch.clamp's would be 1)."""
    cases = [("ReLU6", (), [0.0, 6.0], 0.5), ("HardTanh", (), [-1.0, 1.0], 0.5),
             ("HardTanh", (-2.0, 3.0), [-2.0, 3.0], 0.5), ("HardSigmoid", (), [-2.5, 2.5], 0.1),
             ("ReLU", (), [0.0], 0.5)]
    for name, args, bounds, want in cases:
        jm, pm = getattr(jnn, name)(*args), getattr(pnn, name)(*args, device="cpu")
        jg = jax.grad(lambda v: jnp.sum(jm.apply({}, {}, v)[0]))(jnp.asarray(bounds))
        x = torch.tensor(bounds, requires_grad=True)
        pm.apply({}, {}, x)[0].sum().backward()
        np.testing.assert_array_equal(np.asarray(jg), np.full(len(bounds), want, np.float32))
        np.testing.assert_array_equal(x.grad.numpy(), np.asarray(jg), err_msg=name)


def test_gelu_is_the_tanh_approximation():
    y = pnn.GELU(device="cpu").apply({}, {}, torch.tensor([1.0]))[0]
    want = float(jnn.GELU().apply({}, {}, jnp.asarray([1.0]))[0][0])
    assert abs(want - 0.841192) < 1e-6 and abs(y.item() - want) < 1e-6
    assert abs(y.item() - 0.841345) > 1e-4  # the exact GELU


def test_softplus_has_no_threshold():
    """Above beta*x = 20 torch's F.softplus returns x; jax.nn.softplus keeps
    log(1 + exp(beta*x)) / beta, visible at beta = 0.5, x = 42."""
    x = torch.tensor([42.0, 40.5])
    got = pnn.SoftPlus(0.5, device="cpu").apply({}, {}, x)[0]
    want = np.asarray(jnn.SoftPlus(0.5).apply({}, {}, jnp.asarray(x.numpy()))[0])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


def test_rrelu_training_draws():
    """Training slopes lie in [lower, upper] with their mean near the middle,
    and repeat under one generator seed; positives pass unchanged; eval is
    the mean slope (held against JAX above)."""
    x = -np.abs(np.random.default_rng(3).standard_normal((64, 256))).astype(np.float32) - 0.1
    x[0, :8] = np.abs(x[0, :8])
    m = pnn.RReLU(0.1, 0.3, device="cpu")
    xt = torch.from_numpy(x)
    y1 = m.apply({}, {}, xt, training=True, rng=torch.Generator().manual_seed(5))[0]
    y2 = m.apply({}, {}, xt, training=True, rng=torch.Generator().manual_seed(5))[0]
    y3 = m.apply({}, {}, xt, training=True, rng=torch.Generator().manual_seed(6))[0]
    torch.testing.assert_close(y1, y2, rtol=0, atol=0)
    assert not torch.equal(y1, y3)
    np.testing.assert_array_equal(y1[0, :8].numpy(), x[0, :8])
    slopes = (y1 / xt)[x < 0].numpy()
    assert slopes.min() >= 0.1 - 1e-6 and slopes.max() <= 0.3 + 1e-6
    assert abs(slopes.mean() - 0.2) < 2e-3  # 16k draws of U(0.1, 0.3): std of the mean 4.5e-4
    y_eval = m.apply({}, {}, xt, training=False)[0]
    torch.testing.assert_close(y_eval, torch.where(xt >= 0, xt, 0.2 * xt))


def test_prelu_and_srelu_errors():
    with pytest.raises(ValueError, match="expected 4 channels"):
        pnn.PReLU(4, device="cpu").init(sample_input=np.zeros((2, 3, 5), np.float32))
    with pytest.raises(ValueError, match="shared axis 3 out of range"):
        pnn.SReLU((3,), device="cpu").init(sample_input=np.zeros((2, 3, 5), np.float32))
