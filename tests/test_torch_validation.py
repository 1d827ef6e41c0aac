"""The port's validation slice against the JAX package's: each
``ValidationMethod`` on the same numpy outputs and targets, ``+`` merging and
``repr`` of the results, ``Evaluator`` / ``model.evaluate`` / ``validate`` on
a dataset with a ragged tail, and ``LocalOptimizer.set_validation`` over a
short training run, with the JAX model's initial weights and BN state
carried over and the same global seed in both packages.

Tolerances: counts (``Top1Accuracy``, ``Top5Accuracy``, ``HitRatio``,
``TreeNNAccuracy`` numerators, every count) exactly: both packages decide
each record the same way on the same values, ties included (first maximum
for top-1, a stable ascending sort for top-5, bf16 logits with planted ties
among them). Float numerators (``Loss``, ``MAE``, ``NDCG``) 1e-5 relative:
the same f32 arithmetic summed in another order. The training run's
``score`` and ``n_validations`` sequences are equal, its losses within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bigdl_tpu.nn as jnn
import bigdl_tpu.optim as joptim
from bigdl_tpu.dataset.dataset import DataSet as JDataSet
from bigdl_tpu.optim.local_optimizer import validate as jvalidate
from bigdl_tpu.utils.random import RandomGenerator as JRandom
from bigdl_tpu_torch import Engine, RandomGenerator
from bigdl_tpu_torch import nn as pnn
from bigdl_tpu_torch import optim as poptim
from bigdl_tpu_torch.dataset import DataSet, MiniBatch, pad_minibatch
from bigdl_tpu_torch.utils.convert import load_jax_params, load_jax_state

from test_torch_conv_bn import np_tree

RTOL = 1e-5
SEED = 5


@pytest.fixture(autouse=True, scope="module")
def _engine_isolation():
    """The JAX optimizer and evaluator here run on one device (see
    test_torch_training.py)."""
    from bigdl_tpu.utils.engine import Engine as JEngine

    JEngine.reset()
    yield
    JEngine.reset()


@pytest.fixture(autouse=True)
def _fp32_policy():
    Engine.set_compute_dtype("float32")
    yield
    Engine.set_compute_dtype(None)


def cnn(nn, d):
    """A small conv -> BN -> ReLU -> max-pool -> Linear -> LogSoftMax net
    over (3, 8, 8) images, 5 classes; ``d`` holds the port's device."""
    return nn.Sequential(
        nn.SpatialConvolution(3, 4, 3, 3, 1, 1, 1, 1, **d), nn.SpatialBatchNormalization(4, **d),
        nn.ReLU(**d), nn.SpatialMaxPooling(2, 2, 2, 2, **d), nn.Reshape([64], **d),
        nn.Linear(64, 5, **d), nn.LogSoftMax(**d), **d)


def images(n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, 3, 8, 8)).astype(np.float32),
            rng.integers(0, 5, n).astype(np.int64))


def carried_pair(build, x):
    """The JAX model built on ``x`` and the port's with its weights and state."""
    jm = build(jnn, {})
    jp, js = jm.init(jax.random.PRNGKey(0), sample_input=x)
    pm = build(pnn, {"device": "cpu"})
    pm.init(sample_input=torch.from_numpy(x))
    load_jax_params(pm, np_tree(jp))
    load_jax_state(pm, np_tree(js))
    return jm, pm


def numerators(results):
    """{name: (numerator, count)} of a results dict."""
    return {k: (getattr(r, "correct", getattr(r, "loss_sum", None)), r.count)
            for k, r in results.items()}


def assert_results_equal(port, jax_, float_names=("Loss", "MAE", "NDCG")):
    assert list(port) == list(jax_)
    p, j = numerators(port), numerators(jax_)
    for name in j:
        assert p[name][1] == j[name][1], name
        if name in float_names:
            np.testing.assert_allclose(p[name][0], j[name][0], rtol=RTOL, err_msg=name)
        else:
            assert p[name][0] == j[name][0], (name, p[name], j[name])


# ------------------------------------------------------------ the methods
def _scores(shape, seed, ties):
    """Scores with planted ties: rows of equal values, and rows whose top
    values repeat across the top-5 boundary and the maximum."""
    s = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    if ties:
        s[0] = 0.5                                   # a row of one value
        s[1, [1, 4, 6, 7, 8, 9]] = 3.0               # six-way tie for the top five
        s[2, [0, 2]] = 4.0                           # tie for the maximum
        s[3, :] = np.round(s[3], 1)                  # many small ties
        s[4, [2, 5, 8]] = 2.5
        s[4, [0, 3]] = 2.75                          # top two tied, then a three-way tie
    return s


def _targets(n, c, seed):
    t = np.random.default_rng(seed + 1).integers(0, c, n)
    t[:5] = [9, 9, 2, 0, 5]  # on the tied positions above
    return t


def _method_pairs():
    return [
        ("top1", lambda m: m.Top1Accuracy()),
        ("top5", lambda m: m.Top5Accuracy()),
        ("loss", lambda m: m.Loss(jnn.ClassNLLCriterion() if m is joptim
                                  else pnn.ClassNLLCriterion())),
        ("tree", lambda m: m.TreeNNAccuracy()),
    ]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("name,make", _method_pairs(), ids=[n for n, _ in _method_pairs()])
def test_classification_methods_match_jax(name, make, ties, dtype):
    s = _scores((40, 10), 3, ties)
    if name == "loss":
        s = np.array(jax.nn.log_softmax(s, axis=-1))
    t = _targets(40, 10, 3)
    jout = jnp.asarray(s, jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    pout = torch.from_numpy(s).to(torch.bfloat16 if dtype == "bfloat16" else torch.float32)
    jres, pres = make(joptim)(jout, t), make(poptim)(pout, t)
    assert type(pres).__name__ == type(jres).__name__
    assert_results_equal({name: pres}, {name: jres}, float_names=("loss",))


def test_top5_takes_higher_indices_among_ties():
    """The stable ascending sort's last five: among equal scores the higher
    class indices are in the top five, as ``jnp.argsort`` has them."""
    s = np.zeros((3, 10), np.float32)
    s[1, [1, 4, 6, 7, 8, 9]] = 3.0
    out = torch.from_numpy(s).to(torch.bfloat16)
    hits = [poptim.Top5Accuracy()(out[i:i + 1], np.array([c])).correct
            for i, c in ((0, 5), (0, 4), (1, 1), (1, 4))]
    assert hits == [1.0, 0.0, 0.0, 1.0]


def test_tree_nn_accuracy_scores_the_root_node():
    s = np.random.default_rng(4).standard_normal((6, 3, 4)).astype(np.float32)
    t = np.argmax(s[:, 0], -1)
    t[:2] = (t[:2] + 1) % 4
    r = poptim.TreeNNAccuracy()(torch.from_numpy(s), t)
    assert (r.correct, r.count) == (4.0, 6)
    assert_results_equal({"t": r}, {"t": joptim.TreeNNAccuracy()(jnp.asarray(s), t)})


@pytest.mark.parametrize("k", [1, 5, 10])
def test_ranking_methods_match_jax(k):
    """HitRatio and NDCG over (1 positive + 20 negatives) score rows, with
    negatives tied to the positive (a tie does not outrank it)."""
    s = np.random.default_rng(k).standard_normal((12, 21)).astype(np.float32)
    s[:4, 3:6] = s[:4, :1]
    t = np.zeros(12, np.int64)  # unused: the positive is column 0
    j = {"HitRatio": joptim.HitRatio(k, 20)(jnp.asarray(s), t),
         "NDCG": joptim.NDCG(k, 20)(jnp.asarray(s), t)}
    p = {"HitRatio": poptim.HitRatio(k, 20)(torch.from_numpy(s), t),
         "NDCG": poptim.NDCG(k, 20)(torch.from_numpy(s), t)}
    assert_results_equal(p, j)


def test_mae_matches_jax():
    rng = np.random.default_rng(6)
    y, t = rng.standard_normal((9, 4)).astype(np.float32), rng.standard_normal((9, 4))
    assert_results_equal({"MAE": poptim.MAE()(torch.from_numpy(y), t.astype(np.float32))},
                         {"MAE": joptim.MAE()(jnp.asarray(y), t.astype(np.float32))})


def test_results_merge_and_repr_like_jax():
    pa = poptim.AccuracyResult(3, 8, "Top1Accuracy") + poptim.AccuracyResult(2, 5, "Top1Accuracy")
    ja = joptim.AccuracyResult(3, 8, "Top1Accuracy") + joptim.AccuracyResult(2, 5, "Top1Accuracy")
    pl = poptim.LossResult(1.5, 4) + poptim.LossResult(2.25, 6)
    jl = joptim.LossResult(1.5, 4) + joptim.LossResult(2.25, 6)
    assert (pa.result(), repr(pa)) == (ja.result(), repr(ja)) == ((5 / 13, 13),
                                                                    "Top1Accuracy: 0.3846 (5/13)")
    assert (pl.result(), repr(pl)) == (jl.result(), repr(jl)) == ((0.375, 10), "Loss: 0.3750 (n=10)")
    assert repr(poptim.Top5Accuracy()) == repr(joptim.Top5Accuracy()) == "Top5Accuracy"


def test_methods_run_on_the_outputs_device_and_hand_back_scalars():
    out = torch.randn(6, 7)
    num, cnt = poptim.Top5Accuracy().metric(out, torch.zeros(6, dtype=torch.int64))
    assert num.dim() == 0 and num.device == out.device and isinstance(cnt, int)


# ------------------------------------------------ evaluation over a dataset
def _methods(m, nn_):
    return [m.Top1Accuracy(), m.Top5Accuracy(), m.Loss(nn_.ClassNLLCriterion())]


def test_evaluator_matches_jax_on_a_ragged_tail():
    """21 records at batch 8: the tail of 5 is padded to 8 and sliced back.
    ``model.evaluate``, ``Evaluator`` and ``validate`` against the JAX
    package's ``evaluate`` and ``validate``."""
    x, y = images(21, 1)
    jm, pm = carried_pair(cnn, x[:8])
    jres = jm.evaluate(JDataSet.array(x, y, batch_size=8), _methods(joptim, jnn))
    pres = pm.evaluate(DataSet.array(x, y, batch_size=8), _methods(poptim, pnn))
    assert not pm.training
    assert_results_equal(pres, jres)
    assert [r.count for r in pres.values()] == [21, 21, 21]
    ev = poptim.Evaluator(pm)
    assert_results_equal(ev.evaluate(DataSet.array(x, y, batch_size=8), _methods(poptim, pnn)),
                         jres)
    jv = jvalidate(jm, jm.get_parameters(), jm.get_state(), JDataSet.array(x, y, batch_size=8),
                   _methods(joptim, jnn))
    pv = poptim.validate(pm, pm.get_parameters(), pm.get_state(),
                         DataSet.array(x, y, batch_size=8), _methods(poptim, pnn))
    assert_results_equal(pv, jv)
    assert_results_equal(pv, pres, float_names=())  # one sweep, the same bits


def test_padded_tail_equals_an_unpadded_forward():
    """The tail's counters from the padded sweep equal the methods on an
    unpadded eval forward of the 5 tail records, exactly."""
    x, y = images(21, 2)
    _, pm = carried_pair(cnn, x[:8])
    tail = poptim.Evaluator(pm).evaluate(DataSet.array(x[16:], y[16:], batch_size=5),
                                         _methods(poptim, pnn))
    full = poptim.Evaluator(pm).evaluate(DataSet.array(x, y, batch_size=8),
                                         _methods(poptim, pnn))
    head = poptim.Evaluator(pm).evaluate(DataSet.array(x[:16], y[:16], batch_size=8),
                                         _methods(poptim, pnn))
    with torch.inference_mode():
        out = pm.apply(pm.get_parameters(), pm.get_state(), torch.from_numpy(x[16:]))[0]
    direct = {m.name: m(out, y[16:]) for m in _methods(poptim, pnn)}
    assert_results_equal(tail, direct, float_names=())
    for name in full:
        merged = head[name] + tail[name]
        assert (merged.count, numerators({0: merged})[0][0]) == (
            full[name].count, numerators({0: full[name]})[0][0]), name


def test_pad_minibatch_repeats_row_zero_and_refuses_unbatched_leaves():
    x, y = np.arange(12.0).reshape(3, 4), np.array([1, 2, 3])
    padded, n = pad_minibatch(MiniBatch(x, y), 5)
    assert n == 3 and padded.size() == 5
    np.testing.assert_array_equal(padded.get_input()[3:], np.stack([x[0], x[0]]))
    np.testing.assert_array_equal(padded.get_target(), [1, 2, 3, 1, 1])
    tp, _ = pad_minibatch(MiniBatch(torch.from_numpy(x), [torch.from_numpy(y)]), 4)
    assert tp.get_input().shape == (4, 4) and tp.get_target()[0].tolist() == [1, 2, 3, 1]
    assert pad_minibatch(MiniBatch(x, np.float32(1.0)), 5) is None
    assert pad_minibatch(MiniBatch(x, y), 3)[0].get_input() is x


def test_evaluator_never_shares_a_step_between_differently_parameterised_methods():
    """HitRatio(k=1) and HitRatio(k=21) have one name; each sweep uses its own."""
    s = np.random.default_rng(8).standard_normal((10, 21)).astype(np.float32)
    model = pnn.Identity(device="cpu")
    model.init(sample_input=torch.from_numpy(s))
    ev = poptim.Evaluator(model)
    ds = DataSet.array(s, np.zeros(10, np.int64), batch_size=4)
    r1 = ev.evaluate(ds, [poptim.HitRatio(1, 20)])["HitRatio"]
    r21 = ev.evaluate(ds, [poptim.HitRatio(21, 20)])["HitRatio"]
    assert r21.correct == 10 and r1.correct < 10


def test_evaluate_batch_size_is_not_ported():
    """``batch_size`` sizes the predictor, as in the JAX package: the sweep
    runs the dataset's batches, so the result is the one without it."""
    x, y = images(4, 3)
    _, pm = carried_pair(cnn, x)
    ds = DataSet.array(x, y, batch_size=2)
    got = pm.evaluate(ds, [poptim.Top1Accuracy()], batch_size=4)
    assert_results_equal(got, pm.evaluate(ds, [poptim.Top1Accuracy()]))
    assert not pm.training  # the no-argument part still switched to eval mode


def test_predict_and_predict_class():
    x, y = images(10, 3)
    jm, pm = carried_pair(cnn, x[:4])
    jm.evaluate()
    pm.evaluate()
    np.testing.assert_allclose(pm.predict(x, batch_size=4).numpy(),
                               np.asarray(jm.predict(x, batch_size=4)), atol=1e-5)
    np.testing.assert_array_equal(pm.predict_class(DataSet.array(x, y, batch_size=3)).numpy(),
                                  jm.predict_class(x))
    assert pm.predict_class(x).min() >= 1  # 1-based


# ------------------------------------------------------ training with validation
class _RecordingJax(joptim.LocalOptimizer):
    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        self.events, self.losses = [], []

    def _log_iteration(self, state, loss, records, wall, throughput):
        self.losses.append(float(loss))

    def _run_validation(self, get_params, get_model_state):
        res = super()._run_validation(get_params, get_model_state)
        if res is not None:
            st = self.optim_method.state
            self.events.append((st["neval"], st["epoch"], st["score"], st["n_validations"], res))
        return res


class _RecordingPort(poptim.LocalOptimizer):
    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        self.events = []

    def _run_validation(self):
        res = super()._run_validation()
        if res is not None:
            st = self.optim_method.state
            self.events.append((st["neval"], st["epoch"], st["score"], st["n_validations"], res))
        return res


def test_set_validation_matches_jax():
    """24 records at batch 8 (3 iterations an epoch), 2 epochs, validation
    on a 21-record set every 2 iterations: it fires after iterations 2, 4
    and 6 and again at the second epoch's end (the trigger reads ``neval``,
    which the epoch end leaves at 7), as in the JAX package."""
    x, y = images(24, 4)
    vx, vy = images(21, 5)
    jm, pm = carried_pair(cnn, x[:8])
    runs = []
    for opt_cls, optim_mod, nn_, ds, m, rnd in (
            (_RecordingJax, joptim, jnn, JDataSet, jm, JRandom),
            (_RecordingPort, poptim, pnn, DataSet, pm, RandomGenerator)):
        rnd.set_seed(SEED)
        opt = opt_cls(m, ds.array(x, y, batch_size=8), nn_.ClassNLLCriterion())
        opt.set_optim_method(optim_mod.SGD(learningrate=0.1, momentum=0.9))
        opt.set_validation(optim_mod.Trigger.several_iteration(2),
                           ds.array(vx, vy, batch_size=8), _methods(optim_mod, nn_))
        opt.set_end_when(optim_mod.Trigger.max_epoch(2)).optimize()
        runs.append(opt)
    jopt, popt = runs
    np.testing.assert_allclose([h["loss"] for h in popt.history], jopt.losses, rtol=RTOL)
    assert [e[:4] for e in popt.events] == [e[:4] for e in jopt.events]
    assert [e[0] for e in popt.events] == [3, 5, 7, 7] and popt.events[-1][3] == 4
    for pe, je in zip(popt.events, jopt.events):
        assert_results_equal(pe[4], je[4])
    # max_score reads the score validation wrote
    assert poptim.Trigger.max_score(popt.events[-1][2] - 0.01)(popt.optim_method.state)
