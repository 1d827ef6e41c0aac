"""The port's fused bias + activation epilogue against the JAX package's:
the plain versions of the forward and backward (what a CPU tensor runs)
against the Pallas kernels in interpret mode (``jax.vjp`` of
``bigdl_tpu.ops.fused_epilogue.fused_bias_act``), every activation, both
layouts, f32 and bf16, on ragged shapes; the ReLU-at-zero rule; the
fused-kernel switch (``Engine.set_fused_kernels`` / ``BIGDL_FUSED_KERNELS``)
and its routes; and, marked ``gpu``, each CUDA kernel against its plain
version on the card.

Inputs come from numpy with a seed; bf16 inputs are bf16-representable, so
both packages see the same values. The bias is the fp32 master bias.
Tolerances, per element (|err| <= allowance):
- f32 ``y`` and ``dx``: ``1e-6 + 1e-5·|ref|``, plus the tanh term below;
- bf16 ``y`` and ``dx``: one bf16 step, ``2^-7·|ref|``, plus the f32
  allowance (both round an fp32 value once);
- ``db``: ``1e-5·Σ|dz|`` over the summed elements (fp32 sums in another
  order), plus the summed tanh terms.
The tanh term: XLA's tanh on the CPU (a rational approximation) and the C
library's (the port's, on the CPU and in the kernel) may differ by a few
units in the last place of t = tanh(·), and GELU's and tanh's derivatives
amplify that: dx = dy·g(t) with |∂g/∂t| = |0.5 - z·t·du| for GELU and 2|t|
for tanh, which reaches ~30 at |z| ~ 5. So each element's allowance adds
``4·2^-24·|dy|·|∂g/∂t|`` for ``dx`` (and ``4·2^-24·|∂y/∂t|`` for ``y``).

Both packages' results on the parity cases come from one fresh child
process (this file run as a script), so that process-wide state left by
other test files on the same worker (JAX config, XLA flags, compile caches,
torch settings) cannot reach the comparison; the allowances and checks run
here. The child records what it ran with (its environment, its
``jax.config`` values, torch's thread count and CPU capability) and runs
torch on one thread: torch's CPU ``tanh`` over 2048 or more float32
elements is split across its OpenMP threads, and now and then one
thread's share came back ~4e-5 off in relative terms (tanh(5.03) = 1.0),
which no allowance for the arithmetic covers. Each side is first held
alone against a float64 numpy oracle with the same allowances, so that a
failure names the side that moved; a failing case keeps the child's
arrays and record under ``build/test_failures/``.
"""

import json
import math
import os
import shutil
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu.ops.fused_epilogue import fused_bias_act as jax_fused_bias_act
from bigdl_tpu.utils.engine import Engine as JEngine
from bigdl_tpu_torch import Engine
from bigdl_tpu_torch import nn as pnn
from bigdl_tpu_torch.ops import fused_epilogue as port
from bigdl_tpu_torch.utils import precision

ACTS = [None, "relu", "gelu", "tanh"]
DTYPES = ["float32", "bfloat16"]
# (x shape, axis): rows not a multiple of 8, H not a multiple of 128, H·W odd
LAYOUTS = {"feature": ((37, 200), -1), "row": ((3, 5, 7, 9), 1)}
TANH_ULPS = 4 * 2.0 ** -24
GELU_C = math.sqrt(2 / math.pi)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _restore_switches():
    """Both packages' switches are process-wide: put them back after each test."""
    j_prev, p_prev = JEngine._state.fused_kernels, Engine._fused_kernels
    yield
    JEngine._state.fused_kernels = j_prev
    Engine._fused_kernels = p_prev


def _bf16_exact(a):
    return np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def _inputs(shape, axis, dtype, seed, zeros=False):
    rng = np.random.default_rng(seed)
    c = shape[-1] if axis == -1 else shape[1]
    x = 2 * rng.standard_normal(shape).astype(np.float32)
    b = rng.standard_normal(c).astype(np.float32)
    dy = rng.standard_normal(shape).astype(np.float32)
    if dtype == "bfloat16":
        x, dy, b = _bf16_exact(x), _bf16_exact(dy), _bf16_exact(b)
    if zeros:  # z == 0 exactly at every third element
        bb = np.broadcast_to(b if axis == -1 else b.reshape((1, -1) + (1,) * (len(shape) - 2)),
                             shape)
        x = np.where(np.arange(x.size).reshape(shape) % 3 == 0, -bb, x).astype(np.float32)
    return x, b, dy


def _jax(x, b, dy, act, axis, dtype):
    jdt = getattr(jnp, dtype)
    y, vjp = jax.vjp(lambda v, w: jax_fused_bias_act(v, w, act, axis), jnp.asarray(x, jdt),
                     jnp.asarray(b))
    dx, db = vjp(jnp.asarray(dy, jdt))
    return [np.asarray(a, np.float32) for a in (y, dx, db)]


def _port(x, b, dy, act, axis, dtype):
    tdt = getattr(torch, dtype)
    xt = torch.from_numpy(x).to(tdt).requires_grad_(True)
    bt = torch.from_numpy(b).requires_grad_(True)
    y = port.fused_bias_act(xt, bt, act, axis)
    y.backward(torch.from_numpy(dy).to(tdt))
    assert y.dtype == tdt and xt.grad.dtype == tdt and bt.grad.dtype == torch.float32
    return [t.detach().float().numpy() for t in (y, xt.grad, bt.grad)]


def _parity_cases():
    """Every JAX-vs-port case: key -> (act, layout, dtype, seed, z == 0 at every third)."""
    cases = {f"{act}-{layout}-{dtype}": (act, layout, dtype, ACTS.index(act), False)
             for act in ACTS for layout in sorted(LAYOUTS) for dtype in DTYPES}
    cases.update({f"relu-at-zero-{layout}-{dtype}": ("relu", layout, dtype, 11, True)
                  for layout in sorted(LAYOUTS) for dtype in DTYPES})
    return cases


def _run_parity_cases(out_path):
    """Both packages on every parity case, saved to ``out_path`` as
    ``{key}/{jax|port}/{y|dx|db}`` (what the child process runs)."""
    arrays = {}
    for key, (act, layout, dtype, seed, zeros) in _parity_cases().items():
        shape, axis = LAYOUTS[layout]
        x, b, dy = _inputs(shape, axis, dtype, seed, zeros)
        for side, fn in (("jax", _jax), ("port", _port)):
            for what, a in zip(("y", "dx", "db"), fn(x, b, dy, act, axis, dtype)):
                arrays[f"{key}/{side}/{what}"] = a
    np.savez(out_path, **arrays)
    with open(str(out_path) + ".json", "w") as f:
        json.dump(_process_record(), f, indent=1, sort_keys=True, default=repr)


def _process_record():
    """What the child computed with: its environment, ``jax.config``,
    torch's threads and CPU capability, the versions."""
    return {"env": dict(os.environ), "jax_config": dict(jax.config.values),
            "jax_backend": jax.default_backend(), "jax": jax.__version__,
            "torch": torch.__version__, "torch_threads": torch.get_num_threads(),
            "torch_cpu_capability": torch.backends.cpu.get_cpu_capability(),
            "numpy": np.__version__, "pid": os.getpid(), "cpus": os.cpu_count()}


@pytest.fixture(scope="module")
def parity(tmp_path_factory):
    """``({key: (port [y, dx, db], jax [y, dx, db])}, path of the child's arrays)``
    from a fresh process."""
    out = tmp_path_factory.mktemp("epilogue_parity") / "parity.npz"
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run([sys.executable, os.path.abspath(__file__), str(out)],
                       capture_output=True, text=True, env=env, cwd=ROOT, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    with np.load(out) as f:
        arrays = {key: tuple([f[f"{key}/{side}/{what}"] for what in ("y", "dx", "db")]
                             for side in ("port", "jax"))
                  for key in _parity_cases()}
    return arrays, out


def _keep(out, key):
    """Copy the child's arrays and record where a failing case can be read
    after the run; returns the directory."""
    dest = os.path.join(ROOT, "build", "test_failures",
                        f"epilogue_parity_{key}_{time.strftime('%Y%m%d-%H%M%S')}_{os.getpid()}")
    os.makedirs(dest, exist_ok=True)
    for src in (str(out), str(out) + ".json"):
        shutil.copy(src, dest)
    return dest


def _oracle(x, b, dy, act, axis):
    """``(y, dx, db)`` in float64 numpy: what both sides approximate."""
    return _allowances(x, b, dy, act, axis, "float32", oracle=True)


def _allowances(x, b, dy, act, axis, dtype, oracle=False):
    """Per-element allowances of y and dx and per-bias allowances of db
    (with ``oracle``, the float64 values instead)."""
    bshape = b.shape if axis == -1 else (1, -1) + (1,) * (x.ndim - 2)
    z = x.astype(np.float64) + b.reshape(bshape)
    if act == "gelu":
        u = GELU_C * (z + 0.044715 * z ** 3)
        t = np.tanh(u)
        du = GELU_C * (1 + 3 * 0.044715 * z * z)
        dy_dt, dg_dt = np.abs(0.5 * z), np.abs(0.5 - z * t * du)
        g = 0.5 * (1 + t) + 0.5 * z * (1 - t * t) * du
    elif act == "tanh":
        t = np.tanh(z)
        dy_dt, dg_dt, g = np.ones_like(z), np.abs(2 * t), 1 - t * t
    else:
        dy_dt = dg_dt = np.zeros_like(z)
        g = (z > 0).astype(np.float64) if act == "relu" else np.ones_like(z)
    dz = dy * g
    y_ref = {None: z, "relu": np.maximum(z, 0), "tanh": np.tanh(z)}.get(act)
    if y_ref is None:
        y_ref = 0.5 * z * (1 + np.tanh(GELU_C * (z + 0.044715 * z ** 3)))
    if oracle:
        db = dz.reshape(-1, b.size).sum(0) if axis == -1 else \
            dz.reshape(x.shape[0], b.size, -1).sum((0, 2))
        return y_ref, dz, db
    tanh_y, tanh_dx = TANH_ULPS * dy_dt, TANH_ULPS * np.abs(dy) * dg_dt
    step = 2.0 ** -7 if dtype == "bfloat16" else 0.0
    a_y = 1e-6 + (1e-5 + step) * np.abs(y_ref) + tanh_y
    a_dx = 1e-6 + (1e-5 + step) * np.abs(dz) + tanh_dx
    per = 1e-5 * np.abs(dz) + tanh_dx
    a_db = per.reshape(-1, b.size).sum(0) if axis == -1 else \
        per.reshape(x.shape[0], b.size, -1).sum((0, 2))
    return a_y, a_dx, a_db


def _check(got, want, allow, what):
    excess = np.abs(got - want) - allow
    assert excess.max() <= 0, f"{what}: {(excess > 0).sum()} elements over, worst by " \
                              f"{excess.max():.3e}"


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("act", ACTS, ids=[str(a) for a in ACTS])
def test_plain_versions_match_jax_kernels(parity, act, layout, dtype):
    arrays, out = parity
    shape, axis = LAYOUTS[layout]
    x, b, dy = _inputs(shape, axis, dtype, seed=ACTS.index(act))
    key = f"{act}-{layout}-{dtype}"
    got, want = arrays[key]
    allow = _allowances(x, b, dy, act, axis, dtype)
    exact = _oracle(x, b, dy, act, axis)
    try:
        for side, vals in (("port", got), ("jax", want)):  # which side moved, if one did
            for what, v, e, a in zip(("y", "dx", "db"), vals, exact, allow):
                assert v.shape == e.shape, f"{side} {what}"
                _check(v, e, a, f"{side} against the float64 oracle, {key} {what}")
        for what, g, w, a in zip(("y", "dx", "db"), got, want, allow):
            _check(g, w, a, f"{key} {what}")
    except AssertionError as e:
        raise AssertionError(f"{e}; the child's arrays and record are kept in "
                             f"{_keep(out, key)}") from None


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_relu_derivative_is_zero_at_zero(parity, layout, dtype):
    """z == 0 exactly: y = 0 and dx = 0 in both packages (the kernels' rule,
    not the half gradient of max(z, 0))."""
    shape, axis = LAYOUTS[layout]
    x, b, dy = _inputs(shape, axis, dtype, seed=11, zeros=True)
    at_zero = np.arange(x.size).reshape(shape) % 3 == 0
    got, want = parity[0][f"relu-at-zero-{layout}-{dtype}"]
    for w, g in zip(want[:2], got[:2]):
        assert not w[at_zero].any() and not g[at_zero].any()
    for what, g, w, a in zip(("y", "dx", "db"), got, want,
                             _allowances(x, b, dy, "relu", axis, dtype)):
        _check(g, w, a, f"relu-at-zero {layout} {dtype} {what}")


def test_db_comes_back_in_the_bias_dtype():
    x, b, dy = _inputs((6, 40), -1, "bfloat16", seed=3)
    jdb = jax.vjp(lambda v, w: jax_fused_bias_act(v, w, "tanh", -1),
                  jnp.asarray(x, jnp.bfloat16), jnp.asarray(b, jnp.bfloat16))[1](
        jnp.asarray(dy, jnp.bfloat16))[1]
    _, db = port.fused_bias_act_bwd(torch.from_numpy(x).bfloat16(),
                                    torch.from_numpy(b).bfloat16(),
                                    torch.from_numpy(dy).bfloat16(), "tanh", -1)
    assert db.dtype == torch.bfloat16 and jdb.dtype == jnp.bfloat16
    np.testing.assert_allclose(db.float().numpy(), np.asarray(jdb, np.float32), rtol=2 ** -7,
                               atol=1e-5)


def test_fused_bias_act_saves_x_and_bias_only():
    x = torch.randn(4, 3, 5, 5, requires_grad=True)
    b = torch.randn(3, requires_grad=True)
    y = port.fused_bias_act(x, b, "relu", 1)
    assert [t.shape for t in y.grad_fn.saved_tensors] == [x.shape, b.shape]


def test_feature_row_tile_depends_on_the_shape_only():
    for rows, cols in ((64, 4096), (16384, 2048), (37, 200), (1, 1), (10 ** 7, 3)):
        tile = port.feature_row_tile(rows, cols)
        assert tile % 8 == 0 and tile >= 8 and -(-rows // tile) <= 65535
    assert port.feature_row_tile(64, 4096) == 8  # fc6: every 8 rows a block
    assert port.feature_row_tile(16384, 2048) == 128


def test_wrappers_take_no_other_route():
    """Off the CPU the wrappers launch a kernel or raise (a ``meta`` tensor
    stands in for a device without the kernels); bad arguments raise."""
    x, b = torch.empty((4, 8), device="meta"), torch.empty((8,), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        port.fused_bias_act_fwd(x, b, "relu", -1)
    with pytest.raises(ValueError, match="CUDA"):
        port.fused_bias_act_bwd(x, b, x, "relu", -1)
    with pytest.raises(ValueError, match="activation"):
        port.fused_bias_act(torch.zeros(2, 3), torch.zeros(3), "swish", -1)
    with pytest.raises(ValueError, match="axis"):
        port.fused_bias_act(torch.zeros(2, 3, 4), torch.zeros(3), "relu", 0)
    with pytest.raises(ValueError, match="entries"):
        port.fused_bias_act(torch.zeros(2, 3, 4, 4), torch.zeros(4), "relu", 1)


# ------------------------------------------------------------------ the switch
def test_switch_defaults_to_the_env_flag(monkeypatch):
    Engine.set_fused_kernels(None)
    for value, on in (("1", True), ("true", True), ("YES", True), ("on", True), ("0", False),
                      ("off", False), ("", False)):
        monkeypatch.setenv("BIGDL_FUSED_KERNELS", value)
        assert Engine.fused_kernels() is on
    monkeypatch.delenv("BIGDL_FUSED_KERNELS")
    assert Engine.fused_kernels() is False
    monkeypatch.setenv("BIGDL_FUSED_KERNELS", "1")
    Engine.set_fused_kernels(False)  # an explicit setting wins over the env
    assert Engine.fused_kernels() is False
    Engine.set_fused_kernels(None)
    assert Engine.fused_kernels() is True


def test_switch_never_touches_the_jax_engine():
    before = JEngine.fused_kernels()
    Engine.set_fused_kernels(not before)
    assert Engine.fused_kernels() is (not before) and JEngine.fused_kernels() is before
    JEngine.set_fused_kernels(not before)
    Engine.set_fused_kernels(before)
    assert Engine.fused_kernels() is before and JEngine.fused_kernels() is (not before)


def _layers():
    lin = pnn.Linear(12, 7, activation="gelu", device="cpu")
    conv = pnn.SpatialConvolution(3, 4, 3, 3, 1, 1, 1, 1, activation="relu", device="cpu")
    lin.init(sample_input=np.zeros((5, 12), np.float32))
    conv.init(sample_input=np.zeros((2, 3, 6, 6), np.float32))
    return ((lin, np.random.default_rng(0).standard_normal((5, 12)).astype(np.float32)),
            (conv, np.random.default_rng(1).standard_normal((2, 3, 6, 6)).astype(np.float32)))


def test_switch_on_cpu_runs_the_plain_versions_and_launches_nothing(monkeypatch):
    calls = []
    for name in ("fused_bias_act_reference", "fused_bias_act_bwd_reference"):
        real = getattr(port, name)
        monkeypatch.setattr(port, name,
                            lambda *a, _real=real, _n=name: calls.append((_n, a[-1])) or _real(*a))
    counts = (port.launches_fwd, port.launches_bwd_feature, port.launches_bwd_row)
    Engine.set_compute_dtype("float32")
    layers = _layers()
    try:
        for switch in (False, True):
            Engine.set_fused_kernels(switch)
            outs = []
            for layer, x in layers:
                xt = torch.from_numpy(x).requires_grad_(True)
                y, _ = layer.apply(layer.get_parameters(), {}, xt, training=True)
                y.sum().backward()
                outs.append((y.detach(), xt.grad))
            if not switch:
                assert calls == []
                plain = outs
        assert calls == [("fused_bias_act_reference", -1), ("fused_bias_act_bwd_reference", -1),
                         ("fused_bias_act_reference", 1), ("fused_bias_act_bwd_reference", 1)]
    finally:
        Engine.set_compute_dtype(None)
    assert (port.launches_fwd, port.launches_bwd_feature, port.launches_bwd_row) == counts
    for (y0, g0), (y1, g1) in zip(plain, outs):  # both routes compute the same function
        torch.testing.assert_close(y1, y0, atol=1e-6, rtol=1e-5)
        torch.testing.assert_close(g1, g0, atol=1e-6, rtol=1e-5)


def test_switch_off_keeps_the_plain_path_exactly():
    """With the switch off (or no activation, or no bias) the epilogue is
    ``act(bias_add(y, b))`` in torch ops, bit for bit."""
    Engine.set_fused_kernels(False)
    y = torch.randn(4, 6, 3, 3).bfloat16()
    b = torch.randn(6)
    want = torch.maximum(y + b.bfloat16().reshape(1, -1, 1, 1), torch.zeros((), dtype=y.dtype))
    assert torch.equal(precision.channel_bias_act(y, b, "relu"), want)
    Engine.set_fused_kernels(True)
    assert torch.equal(precision.channel_bias_act(y, b, None), y + b.bfloat16().reshape(
        1, -1, 1, 1))
    assert torch.equal(precision.bias_act(y, None, "tanh"), torch.tanh(y))


# ------------------------------------------------------------------ the card
@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode); run on the card with "
                    "`python -m pytest -m gpu tests/test_torch_fused_epilogue.py`")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("act", ACTS, ids=[str(a) for a in ACTS])
def test_kernels_match_plain_on_card(cuda_card, act, layout, dtype):
    shape, axis = LAYOUTS[layout]
    x, b, dy = _inputs(shape, axis, dtype, seed=5)
    tdt = getattr(torch, dtype)
    xc, bc, dyc = (torch.from_numpy(a).to("cuda") for a in (x, b, dy))
    xc, dyc = xc.to(tdt), dyc.to(tdt)
    counts = (port.launches_fwd, port.launches_bwd_feature, port.launches_bwd_row)
    y = port.fused_bias_act_fwd(xc, bc, act, axis)
    dx, db = port.fused_bias_act_bwd(xc, bc, dyc, act, axis)
    torch.cuda.synchronize()
    bwd = (1, 0) if layout == "feature" else (0, 1)
    assert (port.launches_fwd, port.launches_bwd_feature, port.launches_bwd_row) == (
        counts[0] + 1, counts[1] + bwd[0], counts[2] + bwd[1])
    y_ref = port.fused_bias_act_reference(xc, bc, act, axis)
    dx_ref, db_ref = port.fused_bias_act_bwd_reference(xc, bc, dyc, act, axis)
    # the same allowances: ATen's tanh and the kernel's tanhf may differ too
    for what, got, ref, a in zip(("y", "dx", "db"), (y, dx, db), (y_ref, dx_ref, db_ref),
                                 _allowances(x, b, dy, act, axis, dtype)):
        _check(got.float().cpu().numpy(), ref.float().cpu().numpy(), a, f"card {what}")
    again = port.fused_bias_act_bwd(xc, bc, dyc, act, axis)
    assert torch.equal(again[0], dx) and torch.equal(again[1], db)


if __name__ == "__main__":  # the child process of the ``parity`` fixture
    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(1)  # see the module docstring: one thread's tanh share drifted
    _run_parity_cases(sys.argv[1])
