"""The port's LeNet-5 slice against the JAX package's: ``Tanh``; LeNet-5's
parameter paths, forward, and 3 ``LocalOptimizer`` SGD steps (lr 0.01,
momentum 0.9, ``ClassNLLCriterion``, BASELINE config 1's recipe) from the
JAX model's weights carried over; and ``models.parity_config``'s draws
against ``bench.py::_parity_config``'s for configs 1, 3 and 4.

Inputs from numpy with a seed, f32 on the CPU. Tolerances, fixed before the
first run: ``Tanh`` 1e-6 absolute in f32, and in its gradient 1e-6 plus
what 8 units of 2^-24 in y become through 1 - y² (2|y|·|dy|·8·2^-24: XLA's
CPU tanh is a rational approximation a few units in the last place from
torch's, and 1 - y² cancels near |y| = 1; this allowance was added after
the first run, whose 1e-6 forgot it); in bf16 one bf16 step of y (2^-7
relative), and for the gradient two steps plus |dy|·2^-7: JAX computes
(dy + dy·y)·(1 - y) in bf16, rounding dy·y to a bf16 step of |dy| before
dy + dy·y cancels near y = -1 (times 1 - y <= 2), where torch's backward
rounds once (the first run's half a step, 2^-8, forgot the cancellation);
LeNet-5
log-probabilities 1e-5 absolute (the same f32 products summed in another
order through four layers); after 3 steps, losses 1e-5 absolute, every
parameter 1e-5 absolute and the whole update within 1e-3 relative L2 (a
smooth network: no ReLU gate can open on one side only). The draws are
equal exactly.

``sgd_steps`` is shared with ``test_torch_inception.py`` and
``test_torch_recurrent.py``.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bigdl_tpu.nn as jnn
import bigdl_tpu.optim as joptim
from bigdl_tpu.dataset.dataset import DataSet as JDataSet
from bigdl_tpu.models import LeNet5 as JLeNet5
from bigdl_tpu.utils.engine import Engine as JEngine
from bigdl_tpu.utils.random import RandomGenerator as JRandom
from bigdl_tpu_torch import Engine, RandomGenerator
from bigdl_tpu_torch.dataset import DataSet
from bigdl_tpu_torch.models import LeNet5, parity_config
from bigdl_tpu_torch.nn import ClassNLLCriterion, Tanh
from bigdl_tpu_torch.optim import SGD, LocalOptimizer, Trigger
from bigdl_tpu_torch.utils.convert import load_jax_params

from test_torch_conv_bn import flat, np_tree

SEED = 3


@pytest.fixture(autouse=True, scope="module")
def _engine_isolation():
    """The JAX LocalOptimizer here runs on one device (see test_torch_training.py)."""
    JEngine.reset()
    yield
    JEngine.reset()


@pytest.fixture(autouse=True)
def _fp32_policy():
    Engine.set_compute_dtype("float32")
    Engine.set_activation_dtype(None)
    yield
    Engine.set_compute_dtype(None)


class _Recording(joptim.LocalOptimizer):
    """The JAX LocalOptimizer, keeping each logged (one-step-late) loss."""

    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        self.losses = []

    def _log_iteration(self, state, loss, records, wall, throughput):
        self.losses.append(float(loss))


def sgd_steps(jax_model, port_model, x, y, batch, steps=3, seed=SEED):
    """``steps`` LocalOptimizer SGD steps (lr 0.01, momentum 0.9, ClassNLL) of
    the JAX model and of the port's from the JAX model's initial weights,
    over the same records in the same epoch order (one global seed)."""
    JRandom.set_seed(seed)
    jp, _ = jax_model.init(jax.random.PRNGKey(seed), sample_input=x[:batch])
    init = np_tree(jp)
    jopt = _Recording(jax_model, JDataSet.array(x, y, batch_size=batch), jnn.ClassNLLCriterion())
    jopt.set_optim_method(joptim.SGD(learningrate=0.01, momentum=0.9))
    jopt.set_end_when(joptim.Trigger.max_iteration(steps)).optimize()

    RandomGenerator.set_seed(seed)
    port_model.init(sample_input=x[:batch])
    load_jax_params(port_model, init)
    opt = LocalOptimizer(port_model, DataSet.array(x, y, batch_size=batch), ClassNLLCriterion())
    opt.set_optim_method(SGD(learningrate=0.01, momentum=0.9))
    opt.set_end_when(Trigger.max_iteration(steps)).optimize()
    return dict(init=flat(init), jax_losses=jopt.losses,
                losses=[h["loss"] for h in opt.history],
                jax_params=flat(np_tree(jax_model.get_parameters())),
                params=flat(port_model.get_parameters()))


def update_distance(run) -> float:
    """||port - JAX|| over the JAX update's norm, across all parameters."""
    p, q, p0 = run["params"], run["jax_params"], run["init"]
    assert set(p) == set(q)
    dist = np.sqrt(sum(np.sum((p[k] - q[k]) ** 2) for k in q))
    return dist / np.sqrt(sum(np.sum((q[k] - p0[k]) ** 2) for k in q))


# ------------------------------------------------------------------ Tanh
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tanh_matches_jax(dtype):
    rng = np.random.default_rng(0)
    x = (3 * rng.standard_normal((4, 33))).astype(np.float32)
    dy = rng.standard_normal((4, 33)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jy, vjp = jax.vjp(lambda v: jnn.Tanh().apply({}, {}, v)[0], jnp.asarray(x, jdt))
    (jdx,) = vjp(jnp.asarray(dy, jdt))
    xt = torch.from_numpy(x).to(tdt).requires_grad_(True)
    py, _ = Tanh(device="cpu").apply({}, {}, xt)
    (pdx,) = torch.autograd.grad(py, xt, torch.from_numpy(dy).to(tdt))
    assert py.dtype == tdt and pdx.dtype == tdt
    want_y, want_dx = np.asarray(jy, np.float32), np.asarray(jdx, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(py.detach().numpy(), want_y, atol=1e-6)
        allow = 1e-6 + 2 * np.abs(want_y) * np.abs(dy) * 8 * 2.0 ** -24
        assert (np.abs(pdx.numpy() - want_dx) <= allow).all()
    else:
        np.testing.assert_allclose(py.detach().float().numpy(), want_y, rtol=2 ** -7, atol=1e-6)
        allow = 1e-6 + 2.0 ** -6 * np.abs(want_dx) + 2.0 ** -7 * np.abs(dy)
        assert (np.abs(pdx.float().numpy() - want_dx) <= allow).all()


# --------------------------------------------------------------- LeNet-5
def _lenet_data(n, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, 784)).astype(np.float32), rng.integers(0, 10, n)


def test_lenet_paths_and_forward_match_jax():
    x, _ = _lenet_data(4)
    jm = JLeNet5(10)
    jp, js = jm.init(jax.random.PRNGKey(0), sample_input=x)
    pm = LeNet5(10, device="cpu")
    pm.init(sample_input=x)
    want = {k: v.shape for k, v in flat(np_tree(jp)).items()}
    assert {k: tuple(v.shape) for k, v in pm.named_parameters()} == want
    assert [m.name() for m in pm] == [m.name() for m in jm.modules]
    load_jax_params(pm, np_tree(jp))
    for training in (True, False):
        jy, _ = jm.apply(jp, js, jnp.asarray(x), training=training)
        py, _ = pm.apply(pm.get_parameters(), pm.get_state(), torch.from_numpy(x),
                         training=training)
        np.testing.assert_allclose(py.detach().numpy(), np.asarray(jy), atol=1e-5)


def test_lenet_trains_like_jax():
    x, y = _lenet_data(16, seed=1)
    run = sgd_steps(JLeNet5(10), LeNet5(10, device="cpu"), x, y, batch=8)
    assert len(run["losses"]) == len(run["jax_losses"]) == 3
    np.testing.assert_allclose(run["losses"], run["jax_losses"], atol=1e-5)
    for k, v in run["jax_params"].items():
        np.testing.assert_allclose(run["params"][k], v, atol=1e-5, err_msg=k)
    assert update_distance(run) <= 1e-3


# --------------------------------------------------------- parity_config
def _bench():
    spec = importlib.util.spec_from_file_location(
        "bench_for_parity", Path(__file__).resolve().parents[1] / "bench.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("batch", [None, 3], ids=["bench_batch", "batch3"])
@pytest.mark.parametrize("name", ["lenet", "inception", "bilstm"])
def test_parity_config_draws_match_bench(monkeypatch, name, batch):
    """The same model (module names), batch, inputs and labels as the JAX
    bench's ``_parity_config`` (whose batch comes from BENCH_CFG_BATCH)."""
    for var in ("BENCH_CFG_BATCH", "BENCH_SEQ_LEN", "BENCH_LSTM_HIDDEN"):
        monkeypatch.delenv(var, raising=False)
    if batch is not None:
        monkeypatch.setenv("BENCH_CFG_BATCH", str(batch))
    jm, jx, jt, jbatch = _bench()._parity_config(name)
    pm, px, pt, pbatch = parity_config(name, batch, device="cpu")
    assert pbatch == jbatch == (batch or len(jx))
    assert px.dtype == jx.dtype and pt.dtype == jt.dtype
    np.testing.assert_array_equal(px, jx)
    np.testing.assert_array_equal(pt, jt)
    assert [m.name() for m in pm] == [m.name() for m in jm.modules]
    assert not pm.is_built()


@pytest.mark.parametrize("name", ["vgg", "widedeep"])
def test_parity_config_refuses_other_configs(name):
    with pytest.raises(ValueError, match=name):
        parity_config(name, device="cpu")
