"""The port's training slice against the JAX package's: ``LocalOptimizer``
over the Transformer-LM, and the module's gradient surface.

Small LM (2 layers, hidden 64, 4 heads, vocab 101, T=33), f32 on the CPU,
the JAX model's initial weights carried over with ``load_jax_params``; ids
and targets from numpy with a seed; the same global seed in both packages,
so both visit the records in the same epoch order. 8 records at batch 4 for
3 iterations cross an epoch boundary. Tolerance 1e-4 absolute and relative
on the per-step losses and the final parameters: both sides compute the
same f32 products and updates but sum them in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bigdl_tpu.nn as jnn
import bigdl_tpu.optim as joptim
from bigdl_tpu.dataset.dataset import DataSet as JDataSet
from bigdl_tpu.utils.random import RandomGenerator as JRandom
from bigdl_tpu_torch import Engine, RandomGenerator
from bigdl_tpu_torch.dataset import DataSet, MiniBatch
from bigdl_tpu_torch.dataset.dataset import SampleToMiniBatch, _epoch_order
from bigdl_tpu_torch.nn import CrossEntropyCriterion, Transformer
from bigdl_tpu_torch.ops import flash_attention as fa
from bigdl_tpu_torch.optim import SGD, LocalOptimizer, Trigger
from bigdl_tpu_torch.utils.convert import load_jax_params

ATOL = RTOL = 1e-4
CFG = dict(vocab_size=101, hidden_size=64, num_heads=4, filter_size=128,
           num_hidden_layers=2, postprocess_dropout=0.0, attention_dropout=0.0,
           relu_dropout=0.0, mode="lm")
N, T, BATCH, SEED = 8, 33, 4, 7


@pytest.fixture(autouse=True, scope="module")
def _engine_isolation():
    """The JAX LocalOptimizer here runs on one device: reset the JAX Engine
    around the module so it neither inherits nor leaks a multi-device
    topology from another file on the same worker."""
    from bigdl_tpu.utils.engine import Engine as JEngine

    JEngine.reset()
    yield
    JEngine.reset()


@pytest.fixture(autouse=True)
def _fp32_policy():
    Engine.set_compute_dtype("float32")
    yield
    Engine.set_compute_dtype(None)


def _data(seed=0):
    rs = np.random.RandomState(seed)
    ids = rs.randint(1, CFG["vocab_size"], (N, T)).astype(np.int32)
    targets = rs.randint(0, CFG["vocab_size"], (N, T)).astype(np.int32)
    return ids, targets


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v)
    return out


class _RecordingJaxOptimizer(joptim.LocalOptimizer):
    """The JAX LocalOptimizer, keeping each logged (one-step-late) loss."""

    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        self.losses = []

    def _log_iteration(self, state, loss, records, wall, throughput):
        self.losses.append(float(loss))


def _jax_run(ids, targets, method, iters):
    JRandom.set_seed(SEED)
    jm = jnn.Transformer(**CFG)
    jm.init(jax.random.PRNGKey(0), sample_input=jnp.asarray(ids[:BATCH]))
    init = _np_tree(jm.get_parameters())
    opt = _RecordingJaxOptimizer(jm, JDataSet.array(ids, targets, batch_size=BATCH),
                                 jnn.CrossEntropyCriterion())
    opt.set_optim_method(method).set_end_when(joptim.Trigger.max_iteration(iters))
    opt.optimize()
    return init, opt.losses, _np_tree(jm.get_parameters())


def _port_run(ids, targets, init, method, iters):
    RandomGenerator.set_seed(SEED)
    pm = Transformer(**CFG, device="cpu")
    pm.init(sample_input=ids[:BATCH])
    load_jax_params(pm, init)
    opt = LocalOptimizer(pm, DataSet.array(ids, targets, batch_size=BATCH),
                         CrossEntropyCriterion())
    opt.set_optim_method(method).set_end_when(Trigger.max_iteration(iters))
    assert opt.optimize() is pm
    return opt, pm


@pytest.mark.parametrize("impl", ["auto", "flash"])
def test_local_optimizer_matches_jax(impl, monkeypatch):
    ids, targets = _data()
    init, j_losses, j_params = _jax_run(
        ids, targets, joptim.SGD(learningrate=0.1, momentum=0.9), 3)
    bwd_calls = []
    real_bwd = fa.flash_attention_bwd
    monkeypatch.setattr(fa, "flash_attention_bwd",
                        lambda *a, **k: bwd_calls.append(1) or real_bwd(*a, **k))
    if impl == "flash":
        monkeypatch.setenv("BIGDL_ATTN_IMPL", "flash")
    opt, pm = _port_run(ids, targets, init, SGD(learningrate=0.1, momentum=0.9), 3)

    assert [h["neval"] for h in opt.history] == [1, 2, 3]
    assert [h["epoch"] for h in opt.history] == [1, 1, 2]
    assert opt.optim_method.state["neval"] == 4 and opt.optim_method.state["epoch"] == 2
    np.testing.assert_allclose([h["loss"] for h in opt.history], j_losses,
                               atol=ATOL, rtol=RTOL)
    want = _flat(j_params)
    got = {k: v.detach().numpy() for k, v in pm.named_parameters()}
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=ATOL, rtol=RTOL, err_msg=k)
    # the flash route's backward runs once per layer and iteration; auto stays dense on CPU
    assert len(bwd_calls) == (3 * CFG["num_hidden_layers"] if impl == "flash" else 0)


def test_local_optimizer_decay_and_epochs_match_jax():
    """Learning-rate decay and weight decay with an exclusion, over two
    whole epochs (end_when = max_epoch)."""
    ids, targets = _data(seed=1)
    kw = dict(learningrate=0.05, learningrate_decay=0.1, weightdecay=1e-3, momentum=0.5,
              weightdecay_exclude=("_b",))
    init, j_losses, j_params = _jax_run(ids, targets, joptim.SGD(**kw), 4)
    opt, pm = _port_run(ids, targets, init, SGD(**kw), 4)
    assert [h["lr"] for h in opt.history] == pytest.approx(
        [0.05 / (1 + i * 0.1) for i in range(4)])
    np.testing.assert_allclose([h["loss"] for h in opt.history], j_losses,
                               atol=ATOL, rtol=RTOL)
    want = _flat(j_params)
    for k, v in pm.named_parameters():
        np.testing.assert_allclose(v.detach().numpy(), want[k], atol=ATOL, rtol=RTOL,
                                   err_msg=k)


def test_max_epoch_and_every_epoch_triggers():
    ids, targets = _data()
    RandomGenerator.set_seed(SEED)
    pm = Transformer(**CFG, device="cpu")
    opt = LocalOptimizer(pm, DataSet.array(ids, targets, batch_size=BATCH),
                         CrossEntropyCriterion())
    opt.set_optim_method(SGD(learningrate=0.1)).set_end_when(Trigger.max_epoch(2))
    opt.optimize()  # builds the model from the first batch
    assert pm.is_built()
    assert [h["epoch"] for h in opt.history] == [1, 1, 2, 2]
    assert opt.optim_method.state["epoch"] == 3
    every = Trigger.every_epoch()
    assert not every({"epoch": 2}) and every({"epoch": 2, "_epoch_done": True})
    assert not every({"epoch": 2, "_epoch_done": True})
    several = Trigger.several_iteration(2)
    assert [several({"neval": n}) for n in (1, 2, 3, 5)] == [False, False, True, True]


def test_unported_optimizer_options_raise():
    ids, targets = _data()
    pm = Transformer(**CFG, device="cpu")
    ds = DataSet.array(ids, targets, batch_size=BATCH)
    LocalOptimizer(pm, ds, CrossEntropyCriterion(), donate=False)  # ported now
    # set_elastic arms; optimize() refuses it (no remesh path), as in JAX
    with pytest.raises(ValueError, match="resharding-capable"):
        LocalOptimizer(pm, ds, CrossEntropyCriterion()).set_elastic().optimize()
    with pytest.raises(TypeError):
        LocalOptimizer(pm, ds, CrossEntropyCriterion(), bogus=1)
    LocalOptimizer(pm, ds, CrossEntropyCriterion(), validate=True)  # the default is fine
    chained = DataSet.array(ids, targets, transformer=SampleToMiniBatch(BATCH))
    assert next(iter(chained.data(train=True))).size() == BATCH  # chains are ported now
    with pytest.raises(ValueError, match="no full training batch"):
        LocalOptimizer(pm, DataSet.array(ids[:2], targets[:2], batch_size=BATCH),
                       CrossEntropyCriterion()).optimize()


@pytest.mark.parametrize("epoch", [1, 2, 5, None])
def test_epoch_order_and_batches_match_jax(epoch):
    ids, targets = _data()
    JRandom.set_seed(SEED)
    RandomGenerator.set_seed(SEED)
    jds = JDataSet.array(ids, targets, batch_size=3)
    pds = DataSet.array(ids, targets, batch_size=3)
    jds.shuffle(epoch)
    pds.shuffle(epoch)
    for train in (True, False):
        jb, pb = list(jds.data(train)), list(pds.data(train))
        assert len(jb) == len(pb) == (2 if train else 3)
        for a, b in zip(jb, pb):
            assert isinstance(b, MiniBatch) and b.size() == a.size()
            np.testing.assert_array_equal(b.get_input(), np.asarray(a.get_input()))
            np.testing.assert_array_equal(b.get_target(), np.asarray(a.get_target()))
    if epoch is not None:
        np.testing.assert_array_equal(_epoch_order(8, epoch), np.random.default_rng(
            (SEED, epoch)).permutation(8))


def test_module_backward_matches_jax():
    """forward + criterion backward + module backward: the input-free LM's
    parameter gradients equal the JAX package's (accumulated twice)."""
    ids, targets = _data()
    jm = jnn.Transformer(**CFG)
    jm.init(jax.random.PRNGKey(0), sample_input=jnp.asarray(ids[:BATCH]))
    pm = Transformer(**CFG, device="cpu")
    pm.init(sample_input=ids[:BATCH])
    load_jax_params(pm, _np_tree(jm.get_parameters()))
    x, t = ids[:BATCH], targets[:BATCH]

    jcrit, pcrit = jnn.CrossEntropyCriterion(), CrossEntropyCriterion()
    jm.training()
    jm.zero_grad_parameters()
    jy = jm.forward(jnp.asarray(x))
    jcrit.forward(jy, jnp.asarray(t))
    jg = jcrit.backward(jy, jnp.asarray(t))
    jm.backward(jnp.asarray(x), jg)
    jm.backward(jnp.asarray(x), jg)

    pm.train()
    pm.zero_grad_parameters()
    py = pm.forward(x)
    np.testing.assert_allclose(pcrit.forward(py, t).item(), float(jcrit.output),
                               atol=ATOL, rtol=RTOL)
    pg = pcrit.backward(py, t)
    np.testing.assert_allclose(pg.numpy(), np.asarray(jg), atol=1e-6, rtol=RTOL)
    assert pm.backward(x, pg) is None  # integer ids have no gradient
    pm.backward(x, pg)
    want = _flat(_np_tree(jm.get_grad_parameters()))
    got = _flat(pm.get_grad_parameters())
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=ATOL, rtol=RTOL, err_msg=k)
    pm.zero_grad_parameters()
    assert all(not g.any() for g in _flat(pm.get_grad_parameters()).values())


def test_feed_forward_backward_returns_input_grad_with_dropout():
    """backward reuses the generator of the preceding train-mode forward: the
    input gradient uses the same dropout mask as the forward did."""
    from bigdl_tpu_torch.nn import FeedForwardNetwork

    x = torch.from_numpy(np.random.RandomState(3).randn(2, 5, 16).astype(np.float32))
    m = FeedForwardNetwork(16, 32, relu_dropout=0.5, device="cpu")
    m.init(sample_input=x)
    m.train()
    y = m.forward(x)
    gy = torch.ones_like(y)
    gx = m.backward(x, gy)
    xr = x.clone().requires_grad_(True)
    rng = torch.Generator()
    rng.set_state(m._last_rng_state)
    yr, _ = m.apply(m.get_parameters(), m.get_state(), xr, training=True, rng=rng)
    torch.testing.assert_close(yr.detach(), y.detach())
    (want,) = torch.autograd.grad(yr, xr, gy)
    torch.testing.assert_close(gx, want)


def _bad_model(nn, **d):
    """tests/test_analysis.py's seeded bug: 5 features into a Linear of 7."""
    return nn.Sequential(nn.Linear(10, 5, **d).set_name("fc_in"),
                         nn.Linear(7, 3, **d).set_name("fc_bad"), nn.LogSoftMax(**d), **d)


def test_a_wrong_width_stops_before_the_first_step_in_both_packages():
    from bigdl_tpu.analysis import ShapeInferenceError as JShapeInferenceError
    from bigdl_tpu_torch import nn as pnn
    from bigdl_tpu_torch.analysis import ShapeInferenceError

    x, y = np.zeros((8, 10), np.float32), np.ones((8,), np.int64)
    jm = _bad_model(jnn)
    jopt = joptim.LocalOptimizer(jm, JDataSet.array(x, y, batch_size=4), jnn.ClassNLLCriterion())
    with pytest.raises(JShapeInferenceError, match=r"fc_bad.*expected last dim 7, got 5") as je:
        jopt.optimize()
    pm = _bad_model(pnn, device="cpu")
    opt = LocalOptimizer(pm, DataSet.array(x, y, batch_size=4), pnn.ClassNLLCriterion())
    with pytest.raises(ShapeInferenceError, match=r"fc_bad.*expected last dim 7, got 5") as pe:
        opt.optimize()
    assert pe.value.module_path[1:] == je.value.module_path[1:] == ("Linear(fc_bad)",)
    assert not pm.is_built() and not jm.is_built() and not opt.history
    # validate=False skips the passes: the fault surfaces inside the build
    opt = LocalOptimizer(_bad_model(pnn, device="cpu"), DataSet.array(x, y, batch_size=4),
                         pnn.ClassNLLCriterion(), validate=False)
    with pytest.raises(ValueError) as ei:
        opt.optimize()
    assert not isinstance(ei.value, ShapeInferenceError)


def test_validate_false_trains_as_validate_true():
    ids, targets = _data()
    runs = []
    for validate in (True, False):
        RandomGenerator.set_seed(SEED)
        pm = Transformer(**CFG, device="cpu")
        opt = LocalOptimizer(pm, DataSet.array(ids, targets, batch_size=BATCH),
                             CrossEntropyCriterion(), validate=validate)
        opt.set_optim_method(SGD(learningrate=0.1)).set_end_when(Trigger.max_iteration(2))
        opt.optimize()
        runs.append([h["loss"] for h in opt.history])
    assert runs[0] == runs[1] and len(runs[0]) == 2
