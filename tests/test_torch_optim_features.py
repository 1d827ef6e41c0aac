"""The port's ``LocalOptimizer`` options against the JAX package's: gradient
clipping (constant, L2 norm, both), micro-batches (n=2, BN running
statistics included: ghost batch norm), and the ragged train tail (padded
and masked out of the loss on an MLP, dropped on a BN model, and both with
micro-batches); plus the triggers ``min_loss``/``max_score``/``and_`` and
``RandomGenerator.restore``.

Small MLPs (6 -> 16 -> 3, with or without ``BatchNormalization``), f32 on
the CPU, data from numpy with a seed, the JAX model's initial weights and
BN state carried over, the same global seed in both packages (the same
epoch order). A dataset that yields its epoch's ragged tail in training
(the JAX package's ``SampleToMiniBatch`` chain; a ``LocalArrayDataSet``
subclass here) feeds the ragged cases. Tolerance 1e-5 absolute and
relative on the per-step losses, the final parameters and the BN state:
the same f32 arithmetic summed in another order (the clipping norm adds
its leaves in another order too).
"""

import shutil

import numpy as np
import pytest
import torch

import bigdl_tpu.nn as jnn
import bigdl_tpu.optim as joptim
from bigdl_tpu.dataset.dataset import LocalArrayDataSet as JLocalArrayDataSet
from bigdl_tpu.dataset.dataset import SampleToMiniBatch
from bigdl_tpu.utils.random import RandomGenerator as JRandom
from bigdl_tpu_torch import Engine, RandomGenerator
from bigdl_tpu_torch import nn as pnn
from bigdl_tpu_torch import optim as poptim
from bigdl_tpu_torch.dataset import LocalArrayDataSet, MiniBatch

from test_torch_conv_bn import flat, np_tree
from test_torch_validation import _RecordingJax, carried_pair

TOL = 1e-5
SEED = 3


@pytest.fixture(autouse=True, scope="module")
def _engine_isolation():
    """The JAX optimizer here runs on one device (see test_torch_training.py)."""
    from bigdl_tpu.utils.engine import Engine as JEngine

    JEngine.reset()
    yield
    JEngine.reset()


@pytest.fixture(autouse=True)
def _fp32_policy():
    Engine.set_compute_dtype("float32")
    yield
    Engine.set_compute_dtype(None)


def mlp(nn, d, bn=False):
    layers = [nn.Linear(6, 16, **d)]
    if bn:
        layers.append(nn.BatchNormalization(16, **d))
    layers += [nn.ReLU(**d), nn.Linear(16, 3, **d), nn.LogSoftMax(**d)]
    return nn.Sequential(*layers, **d)


def mlp_bn(nn, d):
    return mlp(nn, d, bn=True)


class _TailDataSet(LocalArrayDataSet):
    """Yields each epoch's ragged last batch in training too."""

    def data(self, train):
        for start in range(0, len(self._order), self.batch_size):
            idx = self._order[start:start + self.batch_size]
            yield MiniBatch(self.features[idx], self.labels[idx])


def _data(n, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, 6)).astype(np.float32), rng.integers(0, 3, n)


def _run_both(build, n=24, tail=False, epochs=2, configure=lambda opt: None):
    """The same training in both packages; returns (jax optimizer, port
    optimizer, jax model, port model)."""
    x, y = _data(n, 7)
    jm, pm = carried_pair(build, x[:8])
    JRandom.set_seed(SEED)
    jds = (JLocalArrayDataSet(x, y, transformer=SampleToMiniBatch(8), batch_size=8) if tail
           else JLocalArrayDataSet(x, y, batch_size=8))
    jopt = _RecordingJax(jm, jds, jnn.ClassNLLCriterion())
    jopt.set_optim_method(joptim.SGD(learningrate=0.2, momentum=0.9))
    configure(jopt)
    jopt.set_end_when(joptim.Trigger.max_epoch(epochs)).optimize()
    RandomGenerator.set_seed(SEED)
    pds = _TailDataSet(x, y, batch_size=8) if tail else LocalArrayDataSet(x, y, batch_size=8)
    popt = poptim.LocalOptimizer(pm, pds, pnn.ClassNLLCriterion())
    popt.set_optim_method(poptim.SGD(learningrate=0.2, momentum=0.9))
    configure(popt)
    popt.set_end_when(poptim.Trigger.max_epoch(epochs)).optimize()
    return jopt, popt, jm, pm


def _assert_same_training(jopt, popt, jm, pm):
    np.testing.assert_allclose([h["loss"] for h in popt.history], jopt.losses, atol=TOL,
                               rtol=TOL)
    assert popt.optim_method.state["neval"] == jopt.optim_method.state["neval"]
    for got, want in ((flat(pm.get_parameters()), flat(np_tree(jm.get_parameters()))),
                      (flat(pm.get_state()), flat(np_tree(jm.get_state())))):
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], atol=TOL, rtol=TOL, err_msg=k)


_CLIPS = {
    "constant": lambda o: o.set_constant_gradient_clipping(-0.02, 0.02),
    "l2": lambda o: o.set_gradient_clipping_by_l2_norm(0.05),
    "both": lambda o: o.set_constant_gradient_clipping(-0.02, 0.02)
                       .set_gradient_clipping_by_l2_norm(0.05),
}


@pytest.mark.parametrize("kind", sorted(_CLIPS))
def test_gradient_clipping_matches_jax(kind):
    jopt, popt, jm, pm = _run_both(mlp, configure=_CLIPS[kind])
    _assert_same_training(jopt, popt, jm, pm)
    # the clip is active: unclipped training goes elsewhere
    _, free, _, pm_free = _run_both(mlp)
    assert max(abs(a - b) for a, b in zip(flat(pm.get_parameters())["Linear_0.weight"].ravel(),
                                          flat(pm_free.get_parameters())["Linear_0.weight"].ravel())
               ) > 1e-3


def test_clipping_scales_by_the_global_norm():
    """``_clip_grads`` on a known tree: constant clip first, then one L2
    norm over all leaves (with +1e-12), never scaling up."""
    opt = poptim.LocalOptimizer(mlp(pnn, {"device": "cpu"}), None, pnn.ClassNLLCriterion())
    g = {"a": {"w": torch.tensor([3.0, -4.0])}, "b": torch.tensor([12.0])}
    opt.set_gradient_clipping_by_l2_norm(6.5)
    out = opt._clip_grads(g)
    np.testing.assert_allclose(out["a"]["w"].numpy(), [1.5, -2.0], rtol=1e-6)
    np.testing.assert_allclose(out["b"].numpy(), [6.0], rtol=1e-6)
    opt.set_gradient_clipping_by_l2_norm(100.0)
    assert torch.equal(opt._clip_grads(g)["b"], g["b"])
    opt.set_constant_gradient_clipping(-1.0, 1.0)
    np.testing.assert_allclose(opt._clip_grads(g)["a"]["w"].numpy(), [1.0, -1.0])


@pytest.mark.parametrize("build", [mlp, mlp_bn], ids=["mlp", "bn"])
def test_micro_batches_match_jax(build):
    """n=2: one update from the two slices' mean gradient; with BN, the
    running statistics advance twice a step (ghost batch norm)."""
    jopt, popt, jm, pm = _run_both(build, configure=lambda o: o.set_micro_batches(2))
    _assert_same_training(jopt, popt, jm, pm)
    assert popt.optim_method.state["neval"] == 7
    if build is mlp_bn:
        _, _, _, pm1 = _run_both(build)
        key = "BatchNormalization_1.running_mean"
        assert not np.allclose(flat(pm.get_state())[key], flat(pm1.get_state())[key])


def test_micro_batches_reject_an_indivisible_batch():
    x, y = _data(8, 1)
    opt = poptim.LocalOptimizer(mlp(pnn, {"device": "cpu"}), LocalArrayDataSet(x, y, batch_size=8),
                                pnn.ClassNLLCriterion()).set_micro_batches(3)
    with pytest.raises(ValueError, match="not divisible"):
        opt.optimize()
    with pytest.raises(ValueError, match=">= 1"):
        opt.set_micro_batches(0)


@pytest.mark.parametrize("micro", [1, 2])
def test_ragged_tail_is_masked_on_an_mlp(micro):
    """20 records at batch 8: the 4-row tail is padded to 8 and masked, so
    each of 3 epochs trains 3 steps (with micro-batches of 4, the tail's
    second slice is all padding and weighs 0)."""
    jopt, popt, jm, pm = _run_both(mlp, n=20, tail=True, epochs=3,
                                   configure=lambda o: o.set_micro_batches(micro))
    assert popt._mask_ragged and jopt._mask_ragged
    assert popt.optim_method.state["neval"] == 10 and [h["records"] for h in popt.history] == [
        8, 8, 4] * 3
    _assert_same_training(jopt, popt, jm, pm)


def test_masked_loss_equals_the_loss_of_the_real_rows():
    x, y = _data(8, 2)
    pm = mlp(pnn, {"device": "cpu"})
    pm.init(sample_input=torch.from_numpy(x))
    opt = poptim.LocalOptimizer(pm, None, pnn.ClassNLLCriterion())
    with torch.no_grad():
        out = pm.forward(x)
    padded = torch.cat([out[:5], out[:1].expand(3, 3)])
    t = torch.from_numpy(np.concatenate([y[:5], y[:1].repeat(3)]))
    torch.testing.assert_close(opt._masked_loss(padded, t, 5.0),
                               pnn.ClassNLLCriterion()._apply(out[:5], y[:5]), rtol=0, atol=0)


def test_only_a_padded_batch_takes_the_masked_loss(monkeypatch):
    """A full batch takes the criterion's own loss; only the padded tail
    the masked form (both equal on a full batch)."""
    x, y = _data(20, 7)
    RandomGenerator.set_seed(SEED)
    pm = mlp(pnn, {"device": "cpu"})
    opt = poptim.LocalOptimizer(pm, _TailDataSet(x, y, batch_size=8), pnn.ClassNLLCriterion())
    masked = []
    real = opt._masked_loss
    monkeypatch.setattr(opt, "_masked_loss", lambda y_, t_, n_: masked.append(n_) or real(
        y_, t_, n_))
    opt.set_end_when(poptim.Trigger.max_epoch(2)).optimize()
    assert opt._mask_ragged and masked == [4.0, 4.0]
    assert [h["records"] for h in opt.history] == [8, 8, 4] * 2


def _tail_run(build, iters, ckpt, resume=False):
    x, y = _data(20, 7)
    RandomGenerator.set_seed(SEED)
    pm = build(pnn, {"device": "cpu"})
    pm.init(sample_input=torch.from_numpy(x[:8]))
    if not resume:  # both runs start from the same weights
        RandomGenerator.set_seed(SEED)
    opt = poptim.LocalOptimizer(pm, _TailDataSet(x, y, batch_size=8), pnn.ClassNLLCriterion())
    opt.set_optim_method(poptim.SGD(learningrate=0.2, momentum=0.9))
    opt.set_checkpoint(ckpt, poptim.Trigger.several_iteration(1))
    if resume:
        opt.resume()
    opt.set_end_when(poptim.Trigger.max_iteration(iters)).optimize()
    return opt, pm


@pytest.mark.parametrize("build", [mlp, mlp_bn], ids=["masked", "dropped"])
def test_resume_just_before_a_ragged_tail_continues_the_run(build, tmp_path):
    """A checkpoint after an epoch's two full batches, resumed: the first
    batch the resumed loop sees is the 4-row tail, yet the step's rows stay
    the dataset's first batch's (8), so the tail is padded and masked (MLP)
    or dropped (BN), as in the uninterrupted run, bit for bit."""
    full_dir, cut_dir = str(tmp_path / "full"), str(tmp_path / "cut")
    full, pm_full = _tail_run(build, 6, full_dir)
    _tail_run(build, 2, cut_dir)
    shutil.rmtree(full_dir)
    res, pm_res = _tail_run(build, 6, cut_dir, resume=True)
    assert res._step_rows == 8
    assert [h["records"] for h in res.history] == [h["records"] for h in full.history][2:]
    assert [h["loss"] for h in res.history] == [h["loss"] for h in full.history][2:]
    assert res.optim_method.state["neval"] == full.optim_method.state["neval"] == 7
    for got, want in ((flat(pm_res.get_parameters()), flat(pm_full.get_parameters())),
                      (flat(pm_res.get_state()), flat(pm_full.get_state()))):
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("micro", [1, 2])
def test_ragged_tail_is_dropped_on_a_bn_model(micro):
    """Pads would reach BN's batch statistics: the tail is dropped, 2 steps an epoch."""
    jopt, popt, jm, pm = _run_both(mlp_bn, n=20, tail=True, epochs=3,
                                   configure=lambda o: o.set_micro_batches(micro))
    assert not popt._mask_ragged and not jopt._mask_ragged
    assert popt.optim_method.state["neval"] == 7
    _assert_same_training(jopt, popt, jm, pm)


def test_triggers_match_jax():
    tables = [{}, {"loss": 0.5}, {"loss": 0.05}, {"score": 0.7}, {"score": 0.95},
              {"loss": 0.05, "score": 0.95, "neval": 11}, {"neval": 3, "score": 0.99}]
    for tr in (joptim.Trigger, poptim.Trigger):
        tr.fired = [
            [bool(t(s)) for s in tables]
            for t in (tr.min_loss(0.1), tr.max_score(0.9),
                      tr.and_(tr.max_score(0.9), tr.max_iteration(10)),
                      tr.and_(tr.min_loss(0.1), tr.max_score(0.9)), tr.and_())]
    assert poptim.Trigger.fired == joptim.Trigger.fired
    assert poptim.Trigger.fired[2] == [False] * 5 + [True, False]
    del poptim.Trigger.fired, joptim.Trigger.fired


def test_random_generator_restore_continues_the_stream():
    RandomGenerator.set_seed(21)
    RandomGenerator.generator()
    seed, counter = RandomGenerator.get_seed(), RandomGenerator._counter
    want = torch.rand(3, generator=RandomGenerator.generator())
    np_want = RandomGenerator.numpy_rng().random()
    RandomGenerator.set_seed(99)
    RandomGenerator.generator()
    RandomGenerator.restore(seed, counter)
    assert torch.equal(torch.rand(3, generator=RandomGenerator.generator()), want)
    RandomGenerator.restore(seed, counter)  # the host numpy stream restarts from the seed
    assert RandomGenerator.numpy_rng().random() == np.random.default_rng(21).random()
    assert np_want == np.random.default_rng(21).random()
    JRandom.restore(21, 5)  # the JAX package's hook takes the same (seed, counter)
    assert (JRandom.get_seed(), JRandom._counter) == (21, 5)
