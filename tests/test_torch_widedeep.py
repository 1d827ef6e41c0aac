"""The port's Wide&Deep (BASELINE config 5) against the JAX package's, with
the JAX weights carried over (``load_jax_params``): parameter paths,
log-probabilities, the ClassNLL loss and the gradient tree in f32; the
output dtypes under the bf16 policy; 3 ``LocalOptimizer`` SGD steps (lr
0.01, momentum 0.9, the bench's recipe) over ``load_criteo``'s synthetic
log in both packages; a ragged evaluation tail (10 records, batch 4)
against the JAX package's per-batch forward of the same records (its own
``evaluate`` pads the sparse column's entries as rows and raises); a
ragged train batch holding a ``SparseTensor`` dropped; a checkpointed run
resumed to the bit; ``parity_config("widedeep")`` against
``bench.py::_parity_config``.

The model runs at its default widths (wide 5000, embeddings (100, 100,
50) x 16, 13 numeric, MLP 64-32, 2 classes) on small batches. Tolerances,
fixed before the first run: f32 log-probabilities and loss 1e-6 absolute +
1e-5 relative (the same f32 products summed in another order through
three layers); the gradient tree 1e-6 absolute + 1e-5 relative per entry;
after 3 steps, losses 1e-5, every parameter 1e-5 absolute and the whole
update within 1e-3 relative L2 (as the LeNet-5 steps); under the bf16
policy the log-probabilities within 2^-5 of JAX's, four bf16 steps at
magnitude 1 (a bf16 MLP in two implementations, each rounding its
products once); the resumed run equal to the bit (CPU).
"""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bigdl_tpu.nn as jnn
import bigdl_tpu.optim as joptim
from bigdl_tpu.dataset.criteo import load_criteo as jload_criteo
from bigdl_tpu.dataset.dataset import DataSet as JDataSet
from bigdl_tpu.models import WideAndDeep as JWideAndDeep
from bigdl_tpu.utils.engine import Engine as JEngine
from bigdl_tpu.utils.random import RandomGenerator as JRandom
from bigdl_tpu_torch import Engine, RandomGenerator
from bigdl_tpu_torch.dataset import DataSet, LocalTableDataSet, load_criteo
from bigdl_tpu_torch.models import WideAndDeep, parity_config
from bigdl_tpu_torch.nn import ClassNLLCriterion
from bigdl_tpu_torch.optim import SGD, Evaluator, LocalOptimizer, Loss, Top1Accuracy, Trigger
from bigdl_tpu_torch.tensor import SparseTensor
from bigdl_tpu_torch.utils.convert import load_jax_params

from test_torch_conv_bn import flat, np_tree
from test_torch_lenet import _bench

SEED = 3
TOL = dict(atol=1e-6, rtol=1e-5)


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


def _pair(n, seed=0):
    """Both packages' synthetic logs of ``n`` records and models, the port's
    carrying the JAX model's initial weights."""
    (jt, jy), (pt, py) = (f(None, n=n, seed=seed) for f in (jload_criteo, load_criteo))
    jm = JWideAndDeep(2)
    jp, js = jm.init(jax.random.PRNGKey(SEED), sample_input=jt)
    pm = WideAndDeep(2, device="cpu")
    pm.init(sample_input=pt)
    load_jax_params(pm, np_tree(jp))
    return (jt, jy, jm, jp, js), (pt, py, pm)


def test_widedeep_forward_and_gradients_match_jax():
    (jt, jy, jm, jp, js), (pt, py, pm) = _pair(24)
    want = {k: v.shape for k, v in flat(np_tree(jp)).items()}
    assert {k: tuple(v.shape) for k, v in pm.named_parameters()} == want
    assert [m.name() for m in pm] == [m.name() for m in jm.modules]

    def jloss(p):
        y, _ = jm.apply(p, js, jt, training=True)
        return jnn.ClassNLLCriterion()._apply(y, jnp.asarray(jy)), y

    (jl, jout), jg = jax.value_and_grad(jloss, has_aux=True)(jp)
    out, _ = pm.apply(pm.get_parameters(), pm.get_state(), pm._as_input(pt), training=True)
    loss = ClassNLLCriterion()._apply(out, torch.from_numpy(py))
    loss.backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(loss.item(), float(jl), **TOL)
    got, want = flat(pm.get_grad_parameters()), flat(np_tree(jg))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], **TOL, err_msg=k)
    assert np.abs(got["wide_linear.weight"]).sum() > 0  # the sparse product's gradient flows


def test_widedeep_bf16_policy_matches_jax():
    """The wide logit (SparseLinear, no cast) and the output stay float32
    in both packages; the deep MLP runs in bf16."""
    (jt, _, jm, jp, js), (pt, _, pm) = _pair(16, seed=1)
    prev = (JEngine._state.compute_dtype, JEngine._state.activation_dtype)
    for engine in (JEngine, Engine):
        engine.set_compute_dtype("bfloat16")
        engine.set_activation_dtype("bfloat16")
    try:
        jout = jm.apply(jp, js, jt)[0]
        jwide = jm.modules[0].apply(jp["wide_linear"], {}, jt[1])[0]
        jdeep_out = jm.modules[-1].modules[-1].apply(
            jp["deep_mlp"]["deep_out"], {}, jnp.ones((16, 32)))[0]
        x = pm._as_input(pt)
        out = pm.apply(pm.get_parameters(), pm.get_state(), x)[0]
        wide = pm[0].apply(pm.get_parameters()["wide_linear"], {}, x[1])[0]
        deep_out = pm[-1][-1].apply(pm.get_parameters()["deep_mlp"]["deep_out"], {},
                                    torch.ones(16, 32))[0]
    finally:
        JEngine._state.compute_dtype, JEngine._state.activation_dtype = prev
        Engine.set_activation_dtype(None)
    assert jout.dtype == jwide.dtype == jnp.float32 and jdeep_out.dtype == jnp.bfloat16
    assert out.dtype == wide.dtype == torch.float32 and deep_out.dtype == torch.bfloat16
    np.testing.assert_allclose(wide.detach().numpy(), np.asarray(jwide), **TOL)
    want = np.asarray(jout)
    assert np.abs(out.detach().numpy() - want).max() <= 2.0 ** -5 * max(1.0, np.abs(want).max())


def test_widedeep_trains_like_jax():
    (jt, jy, jm, jp, _), (pt, py, pm) = _pair(48, seed=2)
    init = flat(np_tree(jp))
    JRandom.set_seed(SEED)
    jopt = _Recording(jm, JDataSet.array(jt, jy, batch_size=16), jnn.ClassNLLCriterion())
    jopt.set_optim_method(joptim.SGD(learningrate=0.01, momentum=0.9))
    jopt.set_end_when(joptim.Trigger.max_iteration(3)).optimize()
    RandomGenerator.set_seed(SEED)
    opt = LocalOptimizer(pm, DataSet.array(pt, py, batch_size=16), ClassNLLCriterion())
    opt.set_optim_method(SGD(learningrate=0.01, momentum=0.9))
    opt.set_end_when(Trigger.max_iteration(3)).optimize()
    losses = [h["loss"] for h in opt.history]
    assert len(losses) == len(jopt.losses) == 3
    np.testing.assert_allclose(losses, jopt.losses, atol=1e-5)
    got, want = flat(pm.get_parameters()), flat(np_tree(jm.get_parameters()))
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, atol=1e-5, err_msg=k)
    dist = np.sqrt(sum(np.sum((got[k] - want[k]) ** 2) for k in want))
    assert dist <= 1e-3 * np.sqrt(sum(np.sum((want[k] - init[k]) ** 2) for k in want))


def _jax_forward_per_batch(jm, jp, js, jt, jy, batch):
    """The JAX model's eval forward of each of the dataset's batches at its
    own rows (no padding), concatenated."""
    outs = [np.asarray(jm.apply(jp, js, b.get_input())[0])
            for b in JDataSet.array(jt, jy, batch_size=batch).data(train=False)]
    return np.concatenate(outs)


def test_ragged_eval_tail_runs_at_its_own_rows():
    (jt, jy, jm, jp, js), (pt, py, pm) = _pair(10, seed=4)
    want = _jax_forward_per_batch(jm, jp, js, jt, jy, 4)
    ds = DataSet.array(pt, py, batch_size=4)
    assert [b.size() for b in ds.data(train=False)] == [4, 4, 2]
    got = pm.predict(ds, batch_size=4)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # re-chunked (the dataset's batches in chunks of 3: the SparseTensor
    # sliced by rows) and the Table itself in chunks of 4
    for data, batch in ((ds, 3), (pt, 4)):
        np.testing.assert_allclose(pm.predict(data, batch_size=batch).numpy(), want, **TOL)
    res = Evaluator(pm).evaluate(ds, [Top1Accuracy(), Loss(ClassNLLCriterion())])
    top1, n = res["Top1Accuracy"].result()
    assert n == 10 and top1 == np.mean(np.argmax(want, -1) == py)
    loss, n = res["Loss"].result()
    # Loss averages the per-batch mean losses weighted by their rows
    nll = -want[np.arange(10), py]
    assert n == 10
    np.testing.assert_allclose(loss, nll.mean(), **TOL)


class _TailTableDataSet(LocalTableDataSet):
    """Yields each epoch's ragged last batch in training too."""

    def data(self, train):
        return super().data(train=False)


def test_ragged_train_batch_holding_a_sparse_tensor_is_dropped():
    """20 records at batch 8: the port's step drops the 4-record tail that
    this dataset yields (it cannot be row-padded), and trains like the JAX
    optimizer, whose dataset drops it."""
    (jt, jy, jm, _, _), (pt, py, pm) = _pair(20, seed=5)
    JRandom.set_seed(SEED)
    jopt = _Recording(jm, JDataSet.array(jt, jy, batch_size=8), jnn.ClassNLLCriterion())
    jopt.set_optim_method(joptim.SGD(learningrate=0.01, momentum=0.9))
    jopt.set_end_when(joptim.Trigger.max_epoch(2)).optimize()
    RandomGenerator.set_seed(SEED)
    opt = LocalOptimizer(pm, _TailTableDataSet(pt, py, batch_size=8), ClassNLLCriterion())
    opt.set_optim_method(SGD(learningrate=0.01, momentum=0.9))
    opt.set_end_when(Trigger.max_epoch(2)).optimize()
    assert [h["records"] for h in opt.history] == [8] * 4
    np.testing.assert_allclose([h["loss"] for h in opt.history], jopt.losses, atol=1e-5)
    got, want = flat(pm.get_parameters()), flat(np_tree(jm.get_parameters()))
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, atol=1e-5, err_msg=k)


def test_micro_batches_on_table_inputs_raise():
    _, (pt, py, pm) = _pair(8)
    opt = LocalOptimizer(pm, DataSet.array(pt, py, batch_size=8), ClassNLLCriterion())
    opt.set_micro_batches(2).set_end_when(Trigger.max_iteration(1))
    with pytest.raises(NotImplementedError, match="Table"):
        opt.optimize()


def _train(pt, py, iters, ckpt, resume=None):
    RandomGenerator.set_seed(SEED)
    model = WideAndDeep(2, device="cpu")
    model.init(sample_input=pt)
    opt = LocalOptimizer(model, DataSet.array(pt, py, batch_size=8), ClassNLLCriterion())
    opt.set_optim_method(SGD(learningrate=0.01, momentum=0.9))
    opt.set_checkpoint(ckpt, Trigger.several_iteration(2))
    if resume is not None:
        opt.resume(resume)
    opt.set_end_when(Trigger.max_iteration(iters)).optimize()
    return opt, model


def test_checkpointed_run_resumes_to_the_bit(tmp_path):
    pt, py = load_criteo(None, n=40, seed=6)
    full, model = _train(pt, py, 4, str(tmp_path / "full"))
    src, dst = tmp_path / "full", tmp_path / "step3"
    os.makedirs(dst)
    for name in os.listdir(src):
        if ".3." in name:  # neval 3: after two iterations
            shutil.copy(src / name, dst / name)
    resumed, model2 = _train(pt, py, 4, str(tmp_path / "again"), resume=str(dst))
    assert [h["loss"] for h in resumed.history] == [h["loss"] for h in full.history[2:]]
    for (k, a), (_, b) in zip(model.named_parameters(), model2.named_parameters()):
        assert torch.equal(a, b), k


def test_parity_config_widedeep_draws_match_bench(monkeypatch):
    """The same model (module names), batch, Table and labels as the JAX
    bench's ``_parity_config("widedeep")``, at its batch 2048 and at 3."""
    for batch in (None, 3):
        monkeypatch.delenv("BENCH_CFG_BATCH", raising=False)
        if batch is not None:
            monkeypatch.setenv("BENCH_CFG_BATCH", str(batch))
        jm, jx, jt, jbatch = _bench()._parity_config("widedeep")
        pm, px, pt, pbatch = parity_config("widedeep", batch, device="cpu")
        assert pbatch == jbatch == (batch or 2048)
        assert isinstance(px[1], SparseTensor) and px[1].shape == jx[1].shape == (pbatch, 5000)
        for a, b in ((px[1].row_indices, jx[1].row_indices), (px[1].col_indices,
                                                               jx[1].col_indices),
                     (px[1].values, jx[1].values)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        np.testing.assert_array_equal(px[2], jx[2])
        np.testing.assert_array_equal(pt, jt)
        assert [m.name() for m in pm] == [m.name() for m in jm.modules]
        assert not pm.is_built()
