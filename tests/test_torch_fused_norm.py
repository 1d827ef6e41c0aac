"""The port's fused LayerNorm and RMSNorm against the JAX package's: the
plain versions of the forward and backward (what a CPU tensor runs) against
the Pallas kernels in interpret mode (``jax.vjp`` of
``bigdl_tpu.ops.fused_norm.fused_layer_norm`` / ``fused_rms_norm``) and
against the JAX ``layer_norm_reference`` / ``rms_norm_reference`` chains,
f32 and bf16, on ragged shapes and ill-conditioned rows; the modules'
routes with the fused-kernel switch off and on; and, marked ``gpu``, each
CUDA kernel against its plain version on the card.

Inputs come from numpy with a seed; bf16 inputs are bf16-representable, so
both packages see the same values; w and b are fp32 masters. Allowances
(per element of y and dx, per entry of dw and db), fixed before the first
run from the dtype and H:
- fp32 arithmetic in another order: ``1e-6 + 1e-5·`` the magnitude of the
  terms that make up the value (``|x̂·w| + |b|`` for LayerNorm's y, the
  summands for the column sums);
- LayerNorm's mean: two fp32 sums of H values in other orders may differ by
  about ``4·sqrt(H)·2^-24·max|x|`` (four standard deviations of the
  rounding noise of H terms); multiplied by r this moves x̂, and through x̂
  y (by ``|w|·δx̂``), dx (by ``r·δx̂·(|m2| + |x̂|·mean|g|)``) and dw (by
  ``Σ|dy|·δx̂``). The term matters where |mean| ≫ std (mean 1e3, std 1e-2,
  the case that needs the two-pass statistic) and for constant rows;
- a bf16 output (RMSNorm's y, every dx of a bf16 x): one bf16 step,
  ``2^-7·|ref|``, since both sides round an fp32 value once.

The JAX-vs-port arrays come from one fresh child process (this file run as
a script), as in ``test_torch_fused_epilogue.py``; the allowances and checks
run here.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu.ops import fused_norm as jax_norm
from bigdl_tpu.utils.engine import Engine as JEngine
from bigdl_tpu_torch import Engine
from bigdl_tpu_torch import nn as pnn
from bigdl_tpu_torch.ops import fused_norm as port

EPS = {"ln": 1e-5, "rms": 1e-6}
DTYPES = ["float32", "bfloat16"]
# shape, data kind: rows not a multiple of 8, H not a multiple of any vector
# width (97, 1000), 3-D inputs, ill-conditioned and constant rows
SHAPES = {
    "ragged": ((37, 200), "normal"),
    "3d": ((2, 5, 64), "normal"),
    "h1000": ((17, 1000), "normal"),
    "h97": ((9, 97), "normal"),
    "offset": ((16, 256), "offset"),      # mean 1e3, std 1e-2
    "constant": ((8, 64), "constant"),    # var = 0; row 0 all zeros
}
MEAN_NOISE = 4 * 2.0 ** -24  # times sqrt(H)·max|x|
BF16_STEP = 2.0 ** -7


@pytest.fixture(autouse=True)
def _restore_switches():
    """Both packages' switches and the port's policy are process-wide."""
    j_prev, p_prev = JEngine._state.fused_kernels, Engine._fused_kernels
    Engine.set_compute_dtype("float32")
    yield
    Engine.set_compute_dtype(None)
    JEngine._state.fused_kernels = j_prev
    Engine._fused_kernels = p_prev


def _bf16_exact(a):
    return np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def _inputs(kind, shape, data, dtype, seed):
    """x, w, b, dy as f32 numpy (x, and RMSNorm's dy, bf16-exact for bf16)."""
    rng = np.random.default_rng(seed)
    h = shape[-1]
    if data == "offset":
        x = 1e3 + 1e-2 * rng.standard_normal(shape)
    elif data == "constant":
        x = np.broadcast_to(rng.standard_normal(shape[:-1] + (1,)), shape).copy()
        x.reshape(-1, h)[0] = 0.0
    else:
        x = 0.5 + 2 * rng.standard_normal(shape)
    x = x.astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(h)).astype(np.float32)
    b = (0.1 * rng.standard_normal(h)).astype(np.float32)
    dy = rng.standard_normal(shape).astype(np.float32)
    if dtype == "bfloat16":
        x = _bf16_exact(x)
        if kind == "rms":
            dy = _bf16_exact(dy)
    return x, w, b, dy


def _cases():
    """key -> (kind, shape, data, dtype, seed)."""
    out = {}
    for kind in ("ln", "rms"):
        for name, (shape, data) in SHAPES.items():
            for dtype in DTYPES:
                if name == "offset" and (kind == "rms" or dtype == "bfloat16"):
                    continue  # bf16 cannot hold 1e3 + 1e-2·n; RMSNorm does not centre
                out[f"{kind}-{name}-{dtype}"] = (kind, shape, data, dtype,
                                                 len(out) + 3)
    return out


def _jax(kind, x, w, b, dy, dtype):
    """Pallas kernels (interpret mode) and the JAX reference chains."""
    jdt = getattr(jnp, dtype)
    xj = jnp.asarray(x, jdt)
    if kind == "ln":
        y, vjp = jax.vjp(lambda v, g, c: jax_norm.fused_layer_norm(v, g, c, EPS["ln"]), xj,
                         jnp.asarray(w), jnp.asarray(b))
        grads = vjp(jnp.asarray(dy, y.dtype))
        chain = jax_norm.layer_norm_reference(xj, jnp.asarray(w), jnp.asarray(b), EPS["ln"])
    else:
        y, vjp = jax.vjp(lambda v, g: jax_norm.fused_rms_norm(v, g, EPS["rms"]), xj,
                         jnp.asarray(w))
        grads = vjp(jnp.asarray(dy, y.dtype))
        chain = jax_norm.rms_norm_reference(xj, jnp.asarray(w), EPS["rms"])
    dtypes = [str(a.dtype) for a in (y, *grads)]
    return [np.asarray(a, np.float32) for a in (y, *grads, chain)], dtypes


def _port(kind, x, w, b, dy, dtype):
    """The port's autograd Functions on CPU tensors (the plain versions)."""
    tdt = getattr(torch, dtype)
    xt = torch.from_numpy(x).to(tdt).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    bt = torch.from_numpy(b).requires_grad_(True)
    if kind == "ln":
        y = port.fused_layer_norm(xt, wt, bt, EPS["ln"])
        params = (xt, wt, bt)
    else:
        y = port.fused_rms_norm(xt, wt, EPS["rms"])
        params = (xt, wt)
    y.backward(torch.from_numpy(dy).to(y.dtype))
    dtypes = [str(t.dtype).replace("torch.", "") for t in (y, *(p.grad for p in params))]
    return [t.detach().float().numpy() for t in (y, *(p.grad for p in params))], dtypes


def _run_parity_cases(out_path):
    """Both packages on every case, saved as ``{key}/{jax|port}/{i}`` and the
    output and gradient dtypes as ``{key}/{side}/dtypes``."""
    arrays = {}
    for key, (kind, shape, data, dtype, seed) in _cases().items():
        x, w, b, dy = _inputs(kind, shape, data, dtype, seed)
        for side, fn in (("jax", _jax), ("port", _port)):
            outs, dtypes = fn(kind, x, w, b, dy, dtype)
            for i, a in enumerate(outs):
                arrays[f"{key}/{side}/{i}"] = a
            arrays[f"{key}/{side}/dtypes"] = np.array(dtypes)
    np.savez(out_path, **arrays)


@pytest.fixture(scope="module")
def parity(tmp_path_factory):
    """``{key: {"jax": [...], "port": [...], "jax_dtypes": [...], ...}}``
    from a fresh process: y, the gradients, then (JAX) the reference chain."""
    out = tmp_path_factory.mktemp("norm_parity") / "parity.npz"
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run([sys.executable, os.path.abspath(__file__), str(out)],
                       capture_output=True, text=True, env=env, cwd=root, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    res = {}
    with np.load(out) as f:
        for key, (kind, *_rest) in _cases().items():
            n_jax = 5 if kind == "ln" else 4
            res[key] = {"jax": [f[f"{key}/jax/{i}"] for i in range(n_jax)],
                        "port": [f[f"{key}/port/{i}"] for i in range(n_jax - 1)],
                        "jax_dtypes": list(f[f"{key}/jax/dtypes"]),
                        "port_dtypes": list(f[f"{key}/port/dtypes"])}
    return res


def allowances(kind, x, w, b, dy, dtype):
    """Allowances of y, dx, dw (and db for LayerNorm), in float64 numpy."""
    x, w, b, dy = (np.asarray(a, np.float64) for a in (x, w, b, dy))
    h = x.shape[-1]
    x2, d2 = x.reshape(-1, h), dy.reshape(-1, h)
    step = BF16_STEP if dtype == "bfloat16" else 0.0
    if kind == "ln":
        eps = EPS["ln"]
        xc = x2 - x2.mean(-1, keepdims=True)
        r = 1 / np.sqrt((xc * xc).mean(-1, keepdims=True) + eps)
        xh = xc * r
        dxh = MEAN_NOISE * np.sqrt(h) * np.abs(x2).max(-1, keepdims=True) * r  # δx̂
        g = d2 * w
        m1 = g.mean(-1, keepdims=True)
        m2 = (g * xh).mean(-1, keepdims=True)
        dx = r * (g - m1 - xh * m2)
        a_y = 1e-6 + 1e-5 * (np.abs(xh * w) + np.abs(b)) + np.abs(w) * dxh
        a_dx = (1e-6 + 1e-5 * r * (np.abs(g) + np.abs(m1) + np.abs(xh * m2)) + step * np.abs(dx)
                + r * dxh * (np.abs(m2) + np.abs(xh) * np.abs(g).mean(-1, keepdims=True)))
        a_dw = 1e-6 + (1e-5 * np.abs(d2 * xh) + np.abs(d2) * dxh).sum(0)
        a_db = 1e-6 + 1e-5 * np.abs(d2).sum(0)
        return [a.reshape(s) for a, s in ((a_y, x.shape), (a_dx, x.shape))] + [a_dw, a_db]
    eps = EPS["rms"]
    r = 1 / np.sqrt((x2 * x2).mean(-1, keepdims=True) + eps)
    y = x2 * r * w
    g = d2 * w
    dot = (g * x2).sum(-1, keepdims=True)
    dx = r * g - x2 * r ** 3 * dot / h
    a_y = 1e-6 + (1e-5 + step) * np.abs(y)
    a_dx = 1e-6 + 1e-5 * r * (np.abs(g) + np.abs(x2) * r * r * np.abs(g * x2).sum(
        -1, keepdims=True) / h) + step * np.abs(dx)
    a_dw = 1e-6 + 1e-5 * np.abs(d2 * x2 * r).sum(0)
    return [a_y.reshape(x.shape), a_dx.reshape(x.shape), a_dw]


def _check(got, want, allow, what):
    assert got.shape == want.shape, f"{what}: shape {got.shape} vs {want.shape}"
    excess = np.abs(got.astype(np.float64) - want) - allow
    assert excess.max() <= 0, (f"{what}: {(excess > 0).sum()} of {excess.size} over, worst by "
                               f"{excess.max():.3e}")


@pytest.mark.parametrize("key", sorted(_cases()))
def test_plain_versions_match_jax_kernels(parity, key):
    kind, shape, data, dtype, seed = _cases()[key]
    x, w, b, dy = _inputs(kind, shape, data, dtype, seed)
    got, want = parity[key]["port"], parity[key]["jax"]
    names = ["y", "dx", "dw", "db"] if kind == "ln" else ["y", "dx", "dw"]
    for what, g, w_, a in zip(names, got, want, allowances(kind, x, w, b, dy, dtype)):
        _check(g, w_, a, f"{key} {what}")


@pytest.mark.parametrize("key", sorted(_cases()))
def test_output_and_gradient_dtypes(parity, key):
    """LayerNorm: y fp32 for every x; RMSNorm: y in x's dtype; dx in x's
    dtype; dw, db in the fp32 master's — in both packages."""
    kind, _, _, dtype, _ = _cases()[key]
    want = (["float32", dtype, "float32", "float32"] if kind == "ln"
            else [dtype, dtype, "float32"])
    assert parity[key]["port_dtypes"] == want
    assert parity[key]["jax_dtypes"] == want


@pytest.mark.parametrize("key", sorted(k for k in _cases() if k.endswith("float32")))
def test_plain_forward_matches_jax_reference_chain(parity, key):
    """At f32 the kernels' function is the modules' switch-off chain."""
    kind, shape, data, dtype, seed = _cases()[key]
    x, w, b, dy = _inputs(kind, shape, data, dtype, seed)
    _check(parity[key]["port"][0], parity[key]["jax"][-1],
           allowances(kind, x, w, b, dy, dtype)[0], f"{key} y vs reference chain")


def test_two_pass_statistic_on_offset_rows():
    """mean 1e3, std 1e-2: the two-pass variance keeps the rows' spread (a
    one-pass E[x²] - mean² in fp32 would lose it: E[x²] ~ 1e6 has a 0.06 ulp)."""
    x, w, b, _ = _inputs("ln", (16, 256), "offset", "float32", 0)
    y = port.layer_norm_reference(torch.from_numpy(x), torch.ones(256), torch.zeros(256))
    var = torch.from_numpy(x).double().var(-1, unbiased=False)
    want = torch.sqrt(var / (var + EPS["ln"]))  # y's spread in exact arithmetic
    got = y.double().std(-1, unbiased=False)
    assert torch.all((got - want).abs() < 1e-3), (got, want)


def test_constant_rows_give_eps_rstd():
    """var = 0: LayerNorm gives y = b and dx = eps^-½·(g - mean(g)); a zero
    row gives RMSNorm y = 0 and dx = eps^-½·g."""
    h = 64
    w = torch.linspace(0.5, 1.5, h)
    b = torch.linspace(-1, 1, h)
    x = torch.zeros(3, h)
    dy = torch.randn(3, h, generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(port.layer_norm_reference(x, w, b), b.expand(3, h))
    dx, _, db = port.layer_norm_bwd_reference(x, w, dy)
    g = dy * w
    torch.testing.assert_close(dx, (g - g.mean(-1, keepdim=True)) * 1e-5 ** -0.5, rtol=1e-5,
                               atol=1e-4)
    torch.testing.assert_close(db, dy.sum(0))
    assert not port.rms_norm_reference(x, w).any()
    torch.testing.assert_close(port.rms_norm_bwd_reference(x, w, dy)[0], g * 1e-6 ** -0.5,
                               rtol=1e-5, atol=1e-3)


# ------------------------------------------------------------------ modules
def _norm_module(kind, h):
    return (pnn.LayerNormalization(h, device="cpu") if kind == "ln"
            else pnn.RMSNorm(h, device="cpu"))


def _jax_chain_in_torch(kind, x, w, b):
    """The JAX package's switch-off chains, written out in torch ops."""
    if kind == "ln":
        mean = torch.mean(x, dim=-1, keepdim=True)
        var = torch.var(x, dim=-1, keepdim=True, correction=0)
        return (x - mean) * torch.rsqrt(var + EPS["ln"]) * w + b
    xf = x.float()
    ms = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + EPS["rms"]) * w).to(x.dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", ["ln", "rms"])
def test_switch_off_runs_the_jax_chain_exactly(kind, dtype, monkeypatch):
    """Switch off: the module runs the JAX chain op for op (LayerNorm's
    statistics in x's dtype) and no fused route."""
    import bigdl_tpu_torch.nn.normalization as normalization

    monkeypatch.setattr(normalization, "fused_layer_norm", None)
    monkeypatch.setattr(normalization, "fused_rms_norm", None)
    Engine.set_fused_kernels(False)
    x, w, b, _ = _inputs(kind, (6, 40), "normal", dtype, 1)
    m = _norm_module(kind, 40)
    m.init(sample_input=np.zeros((1, 40), np.float32))
    with torch.no_grad():
        for p, v in zip(m.parameters(), (w, b)):
            p.copy_(torch.from_numpy(v))
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    y = m.forward(xt)
    want = _jax_chain_in_torch(kind, xt, torch.from_numpy(w), torch.from_numpy(b))
    assert y.dtype == want.dtype and torch.equal(y, want)


def _jax_module(kind, h, switch, x, w, b):
    import bigdl_tpu.nn as jnn

    JEngine.set_fused_kernels(switch)
    m = jnn.LayerNormalization(h) if kind == "ln" else jnn.RMSNorm(h)
    m.init(jax.random.PRNGKey(0), sample_input=jnp.asarray(x))
    params = {"weight": jnp.asarray(w)}
    if kind == "ln":
        params["bias"] = jnp.asarray(b)

    def loss(p, v):
        y, _ = m.apply(p, {}, v, training=True)
        return jnp.sum(y.astype(jnp.float32) * jnp.linspace(-1, 1, y.size).reshape(y.shape))

    y, _ = m.apply(params, {}, x)
    grads = jax.grad(loss, argnums=(0, 1))(params, x)
    return y, grads


@pytest.mark.parametrize("switch", [False, True], ids=["switch-off", "switch-on"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", ["ln", "rms"])
def test_modules_match_jax_modules(kind, dtype, switch):
    """The port's module against the JAX module, the same switch setting in
    both (the JAX kernels in interpret mode): output and the gradients of a
    weighted sum of it. f32: 1e-5; bf16: a bf16 step of each value, since
    the two packages' bf16 chains round their statistics at other places."""
    h = 48
    x, w, b, _ = _inputs(kind, (2, 7, h), "normal", dtype, 2)
    jdt = getattr(jnp, dtype)
    jy, (jg, jdx) = _jax_module(kind, h, switch, jnp.asarray(x, jdt), w, b)
    Engine.set_fused_kernels(switch)
    m = _norm_module(kind, h)
    m.init(sample_input=np.zeros((1, h), np.float32))
    with torch.no_grad():
        for p, v in zip(m.parameters(), (w, b)):
            p.copy_(torch.from_numpy(v))
    xt = torch.from_numpy(x).to(getattr(torch, dtype)).requires_grad_(True)
    y = m.forward(xt)
    assert str(y.dtype).replace("torch.", "") == str(jy.dtype)
    (y.float() * torch.linspace(-1, 1, y.numel()).reshape(y.shape)).sum().backward()
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == "float32" else dict(rtol=2 ** -6, atol=2e-2)
    np.testing.assert_allclose(y.detach().float().numpy(), np.asarray(jy, np.float32), **tol)
    np.testing.assert_allclose(xt.grad.float().numpy(), np.asarray(jdx, np.float32), **tol)
    # dw, db sum 14 rows: at bf16, a bf16 step of each summed term
    ptol = dict(rtol=1e-4, atol=1e-4) if dtype == "float32" else dict(rtol=2e-2, atol=2e-2)
    for name, p in m.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(jg[name], np.float32), **ptol)


@pytest.mark.parametrize("kind", ["ln", "rms"])
def test_switch_on_and_off_agree(kind):
    """f32: both routes compute the same function (fp32 sums in another
    order); bf16 LayerNorm: the switch-off statistics are bf16, so the
    routes differ by up to a few bf16 steps, and only there."""
    h = 64
    for dtype, tol in (("float32", 1e-5), ("bfloat16", 2 ** -5)):
        x, w, b, _ = _inputs(kind, (5, h), "normal", dtype, 4)
        xt = torch.from_numpy(x).to(getattr(torch, dtype))
        outs = []
        for switch in (False, True):
            Engine.set_fused_kernels(switch)
            m = _norm_module(kind, h)
            m.init(sample_input=np.zeros((1, h), np.float32))
            with torch.no_grad():
                for p, v in zip(m.parameters(), (w, b)):
                    p.copy_(torch.from_numpy(v))
            outs.append(m.forward(xt).float())
        torch.testing.assert_close(outs[1], outs[0], rtol=tol, atol=tol)


def test_hidden_size_is_checked():
    for cls in (pnn.LayerNormalization, pnn.RMSNorm):
        m = cls(8, device="cpu")
        with pytest.raises(ValueError, match="hidden size 8"):
            m.init(sample_input=np.zeros((2, 9), np.float32))
        m = cls(device="cpu")
        m.init(sample_input=np.zeros((2, 9), np.float32))
        assert m.hidden_size == 9
        with pytest.raises(ValueError, match="hidden size 9"):
            m.forward(np.zeros((2, 10), np.float32))


def test_parameters_and_eps_are_the_jax_modules():
    import bigdl_tpu.nn as jnn

    ln, rms = pnn.LayerNormalization(device="cpu"), pnn.RMSNorm(device="cpu")
    assert (ln.eps, rms.eps) == (jnn.LayerNormalization().eps, jnn.RMSNorm().eps) == (1e-5, 1e-6)
    ln.init(sample_input=np.zeros((1, 5), np.float32))
    rms.init(sample_input=np.zeros((1, 5), np.float32))
    assert sorted(ln.get_parameters()) == ["bias", "weight"]
    assert sorted(rms.get_parameters()) == ["weight"]
    assert torch.equal(ln.weight, torch.ones(5)) and torch.equal(ln.bias, torch.zeros(5))


def test_functions_save_x_and_w_only():
    x = torch.randn(4, 16, requires_grad=True)
    w, b = torch.ones(16, requires_grad=True), torch.zeros(16, requires_grad=True)
    for y in (port.fused_layer_norm(x, w, b), port.fused_rms_norm(x, w)):
        assert [t.shape for t in y.grad_fn.saved_tensors] == [x.shape, w.shape]


def test_row_tile_depends_on_the_shape_only():
    for rows in (1, 7, 8, 100, 16384, 10 ** 7):
        tile = port.norm_row_tile(rows)
        assert tile % 8 == 0 and -(-rows // tile) <= 264
    assert port.norm_row_tile(16384) == 64


def test_wrappers_take_no_other_route():
    """Off the CPU the wrappers launch a kernel or raise (a ``meta`` tensor
    stands in for a device without the kernels); bad arguments raise."""
    x, w = torch.empty((4, 8), device="meta"), torch.empty((8,), device="meta")
    for call in (lambda: port.layer_norm_fwd(x, w, w), lambda: port.layer_norm_bwd(x, w, x),
                 lambda: port.rms_norm_fwd(x, w), lambda: port.rms_norm_bwd(x, w, x)):
        with pytest.raises(ValueError, match="CUDA"):
            call()
    with pytest.raises(ValueError, match="weight"):
        port.fused_layer_norm(torch.zeros(2, 3), torch.ones(4), torch.zeros(3))
    with pytest.raises(ValueError, match="bias"):
        port.fused_layer_norm(torch.zeros(2, 3), torch.ones(3), torch.zeros(4))
    with pytest.raises(ValueError, match="dy"):
        port.rms_norm_bwd(torch.zeros(2, 3), torch.ones(3), torch.zeros(3, 2))


def test_switch_on_cpu_launches_nothing():
    counts = (port.launches_layer_norm_fwd, port.launches_layer_norm_bwd,
              port.launches_rms_norm_fwd, port.launches_rms_norm_bwd)
    Engine.set_fused_kernels(True)
    for kind in ("ln", "rms"):
        m = _norm_module(kind, 8)
        m.init(sample_input=np.zeros((1, 8), np.float32))
        x = torch.randn(3, 8, requires_grad=True)
        m.apply(m.get_parameters(), {}, x, training=True)[0].sum().backward()
    assert (port.launches_layer_norm_fwd, port.launches_layer_norm_bwd,
            port.launches_rms_norm_fwd, port.launches_rms_norm_bwd) == counts


# ------------------------------------------------------------------ the card
@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode); run on the card with "
                    "`python -m pytest -m gpu tests/test_torch_fused_norm.py`")


CARD_CASES = {**{k: v for k, v in _cases().items()},
              "ln-wide-bfloat16": ("ln", (300, 4096), "normal", "bfloat16", 40),
              "rms-wide-bfloat16": ("rms", (300, 4096), "normal", "bfloat16", 41),
              "ln-h8192-float32": ("ln", (20, 8192), "normal", "float32", 42)}


@pytest.mark.gpu
@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "unaligned"])
@pytest.mark.parametrize("key", sorted(CARD_CASES))
def test_kernels_match_plain_on_card(cuda_card, key, offset):
    kind, shape, data, dtype, seed = CARD_CASES[key]
    x, w, b, dy = _inputs(kind, shape, data, dtype, seed)
    tdt = getattr(torch, dtype)

    def on_card(a, dt):  # ``offset`` elements of storage offset: unaligned pointers
        flat = torch.zeros(a.size + offset, dtype=dt, device="cuda")
        flat[offset:] = torch.from_numpy(a).reshape(-1).to(dt)
        return flat[offset:].view(a.shape)

    xc, wc, bc = on_card(x, tdt), torch.from_numpy(w).cuda(), torch.from_numpy(b).cuda()
    dyc = on_card(dy, tdt if kind == "rms" else torch.float32)
    if kind == "ln":
        got = [port.layer_norm_fwd(xc, wc, bc), *port.layer_norm_bwd(xc, wc, dyc)]
        again = port.layer_norm_bwd(xc, wc, dyc)
        ref = [port.layer_norm_reference(xc, wc, bc), *port.layer_norm_bwd_reference(xc, wc, dyc)]
    else:
        got = [port.rms_norm_fwd(xc, wc), *port.rms_norm_bwd(xc, wc, dyc)]
        again = port.rms_norm_bwd(xc, wc, dyc)
        ref = [port.rms_norm_reference(xc, wc), *port.rms_norm_bwd_reference(xc, wc, dyc)]
    torch.cuda.synchronize()
    for what, g, r, a in zip(("y", "dx", "dw", "db"), got, ref,
                             allowances(kind, x, w, b, dy, dtype)):
        assert g.dtype == r.dtype, what
        _check(g.float().cpu().numpy(), r.double().cpu().numpy(), a, f"card {key} {what}")
    assert all(torch.equal(p, q) for p, q in zip(again, got[1:]))


if __name__ == "__main__":  # the child process of the ``parity`` fixture
    jax.config.update("jax_platforms", "cpu")
    _run_parity_cases(sys.argv[1])
