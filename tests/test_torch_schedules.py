"""The port's learning-rate schedules against the JAX package's.

* Every schedule's rate over ``neval`` 1..N (and ``epoch`` for the epoch
  schedules) from the same state table in both packages: equal floats
  (both run the same Python float arithmetic on the host).
* ``Plateau`` across validation events (a score repeated, improving,
  stalling; cooldown; ``min_lr``), ``SequentialSchedule`` across its legs
  (each leg's ``_schedule_offset``; ``Cosine`` and ``Warmup`` inside a
  chain): the rates and the state keys they write are the JAX package's.
* Through ``LocalOptimizer`` (a small conv net, SGD, the JAX model's
  weights carried over): ``EpochStep`` reads ``epoch`` where the JAX loop
  advances it, and ``Plateau`` ticks on ``n_validations``: the rate of
  every iteration equal, the losses within 1e-3 (f32 summed in another
  order, as ``test_torch_checkpoint.py``).
* A checkpoint written by the JAX package with a ``SequentialSchedule``
  whose last leg is a ``Plateau`` is resumed by the port, and the reverse:
  ``_schedule_offset`` and ``_plateau_seen_event`` are in both packages'
  state files, and each resume continues as the writer's own package's
  resume of it does (rates equal, losses within 1e-3). ``Plateau``'s best
  score, wait and rate are not checkpointed in either package, so both
  resumes start them afresh.
"""

import json
import math
import os

import numpy as np
import pytest

import bigdl_tpu.nn as jnn
import bigdl_tpu.optim as joptim
import bigdl_tpu.optim.schedules as jsched
from bigdl_tpu.dataset.dataset import DataSet as JDataSet
from bigdl_tpu.utils.random import RandomGenerator as JRandom
from bigdl_tpu_torch import Engine, RandomGenerator
from bigdl_tpu_torch import nn as pnn
from bigdl_tpu_torch import optim as poptim
from bigdl_tpu_torch.dataset import DataSet
from bigdl_tpu_torch.optim import schedules as psched

from test_torch_checkpoint import _only_step
from test_torch_validation import carried_pair, cnn, images

ATOL = 1e-3
SEED = 9


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


class _Method:
    """The two attributes a schedule reads from its method."""

    def __init__(self, lr=0.1, decay=0.0):
        self.learningrate, self.learningrate_decay = lr, decay


def _decay(epoch):
    return (epoch - 1) // 2


# (name, args): every schedule class, some twice with other options
SCHEDULES = [
    ("Default", ()),
    ("Step", (3,)), ("Step", (2, 0.5)),
    ("MultiStep", ([2, 5, 9],)), ("MultiStep", ([0, 4], 0.3)),
    ("EpochStep", (2,)), ("EpochStep", (1, 0.5)),
    ("EpochDecay", (_decay,)),
    ("Poly", (2.0, 10)), ("Poly", (0.5, 7)),
    ("Cosine", (8,)), ("Cosine", (5, 0.01)),
    ("Exponential", (4, 0.5)), ("Exponential", (3, 0.7, True)),
    ("NaturalExp", (3, 0.2)),
    ("Warmup", (0.05,)),
    ("LinearWarmup", (4, "MultiStep")), ("LinearWarmup", (3, "Poly")), ("LinearWarmup", (0, "Step")),
]


def _make(mod, name, args):
    if name == "LinearWarmup":
        after = {"MultiStep": lambda: mod.MultiStep([6, 9], 0.1),
                 "Poly": lambda: mod.Poly(2.0, 12), "Step": lambda: mod.Step(2)}[args[1]]()
        return mod.LinearWarmup(args[0], after)
    return getattr(mod, name)(*args)


@pytest.mark.parametrize("name,args", SCHEDULES,
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(SCHEDULES)])
def test_schedule_matches_jax(name, args):
    js, ps = _make(jsched, name, args), _make(psched, name, args)
    for decay in (0.0, 0.25):
        m = _Method(0.1, decay)
        for neval in range(1, 16):
            for epoch in (1, 2, 3, 5):
                jstate, pstate = {"neval": neval, "epoch": epoch}, {"neval": neval, "epoch": epoch}
                got, want = ps.update(m, pstate), js.update(m, jstate)
                assert got == want, (neval, epoch, got, want)
                assert pstate == jstate


def test_poly_and_multistep_closed_forms():
    m = _Method(0.4)
    assert [psched.Poly(2.0, 4).update(m, {"neval": n}) for n in range(1, 7)] == [
        0.4, 0.4 * 0.75 ** 2, 0.4 * 0.5 ** 2, 0.4 * 0.25 ** 2, 0.0, 0.0]
    assert [psched.MultiStep([2, 3]).update(m, {"neval": n}) for n in range(1, 6)] == [
        0.4, 0.4, 0.4 * 0.1, 0.4 * 0.1 ** 2, 0.4 * 0.1 ** 2]
    with pytest.raises(ValueError):
        psched.Cosine(0)
    with pytest.raises(ValueError):
        psched.LinearWarmup(-1, psched.Default())


# a validation score per event (None: an iteration without a new validation)
SCORES = [None, 1.0, None, 0.9, 0.95, 0.95, None, 0.95, 0.8, 0.85, 0.85, 0.85, 0.85, 0.7, None,
          0.9, 0.9, 0.9, 0.9, 0.9]


@pytest.mark.parametrize("kw", [dict(), dict(factor=0.5, patience=2),
                                dict(factor=0.5, patience=1, cooldown=2, min_lr=0.02),
                                dict(mode="max", factor=0.5, patience=2, epsilon=0.01),
                                dict(monitor="loss", factor=0.2, patience=1)])
def test_plateau_across_validation_events(kw):
    """Both packages' Plateau fed the same state tables: a score arrives with
    each validation event (``n_validations`` bumped), repeats between them
    and at stalls; the rate and ``_plateau_seen_event`` agree everywhere."""
    js, ps = jsched.Plateau(**kw), psched.Plateau(**kw)
    m = _Method(0.1)
    jstate, pstate, events, rates = {"neval": 1}, {"neval": 1}, 0, []
    key = kw.get("monitor", "score")
    for neval, score in enumerate(SCORES, 1):
        if score is not None:
            events += 1
            for st in (jstate, pstate):
                st.update({key: score, "n_validations": events})
        for st in (jstate, pstate):
            st["neval"] = neval
        got, want = ps.update(m, pstate), js.update(m, jstate)
        assert got == want, (neval, got, want)
        assert pstate == jstate
        rates.append(got)
    assert (ps._best, ps._wait, ps._cooldown_left, ps._lr) == (
        js._best, js._wait, js._cooldown_left, js._lr)
    if kw.get("patience", 10) <= 2:
        assert min(rates) < 0.1  # the schedule did reduce


def _chain(mod):
    return (mod.SequentialSchedule(3)
            .add(mod.Warmup(0.02), 3)
            .add(mod.Cosine(4, 0.005), 5)
            .add(mod.MultiStep([10, 12], 0.5), 4)
            .add(mod.Poly(1.0, 30), 6))


def test_sequential_schedule_across_legs():
    """Warmup, Cosine, MultiStep and Poly legs: each leg's offset in the
    state table, Cosine and Warmup counted from their leg's start, the last
    leg on for ever; the rates and offsets are the JAX package's."""
    js, ps = _chain(jsched), _chain(psched)
    m = _Method(0.1)
    offsets = []
    for neval in range(1, 26):
        jstate, pstate = {"neval": neval}, {"neval": neval}
        got, want = ps.update(m, pstate), js.update(m, jstate)
        assert got == want, (neval, got, want)
        assert pstate == jstate
        offsets.append(pstate["_schedule_offset"])
    assert offsets == [0] * 3 + [3] * 5 + [8] * 4 + [12] * 13
    # Cosine starts its leg at the base rate and ends it at min_lr + ...
    assert ps.update(m, {"neval": 4}) == 0.1
    assert psched.SequentialSchedule().update(m, {"neval": 3}) == 0.1  # no legs: base rate


def _train(pkg, model, x, y, iters, schedule, val_every=None, ckpt=None, every=3, resume=None):
    """``iters`` iterations of SGD (lr 0.1, momentum 0.9) at batch 8 under
    ``schedule``, validating (Top-1) every ``val_every`` iterations;
    returns the optimizer and the rate of each iteration."""
    x_val, y_val = images(16, 99)
    if pkg == "jax":
        JRandom.set_seed(SEED)
        opt = joptim.LocalOptimizer(model, JDataSet.array(x, y, batch_size=8),
                                    jnn.ClassNLLCriterion())
        om, trig, val_ds = joptim, joptim.Trigger, JDataSet.array(x_val, y_val, batch_size=8)
    else:
        RandomGenerator.set_seed(SEED)
        opt = poptim.LocalOptimizer(model, DataSet.array(x, y, batch_size=8),
                                    pnn.ClassNLLCriterion())
        om, trig, val_ds = poptim, poptim.Trigger, DataSet.array(x_val, y_val, batch_size=8)
    method = om.SGD(learningrate=0.1, momentum=0.9, leaningrate_schedule=schedule)
    rates = []
    get_lr = method.get_learning_rate
    method.get_learning_rate = lambda: rates.append(get_lr()) or rates[-1]
    opt.set_optim_method(method)
    if val_every is not None:
        opt.set_validation(trig.several_iteration(val_every), val_ds, [om.Top1Accuracy()])
    if ckpt is not None:
        opt.set_checkpoint(ckpt, trig.several_iteration(every))
    if resume is not None:
        opt.resume(resume)
    losses = []
    if pkg == "jax":
        opt._log_iteration = lambda state, loss, *a: losses.append(float(loss))
    opt.set_end_when(trig.max_iteration(iters)).optimize()
    if pkg != "jax":
        losses = [h["loss"] for h in opt.history]
    return opt, rates, losses


@pytest.mark.parametrize("kind", ["epoch_step", "plateau"])
def test_schedules_through_local_optimizer_match_jax(kind):
    """15 iterations over 3 epochs of 5: EpochStep(1, 0.5) halves the rate
    at each epoch; Plateau(mode max, patience 1, factor 0.5) ticks on the
    validations every 2 iterations."""
    x, y = images(40, 21)
    jm, pm = carried_pair(cnn, x[:8])

    def sched(mod):
        if kind == "epoch_step":
            return mod.EpochStep(1, 0.5)
        return mod.Plateau("score", factor=0.5, patience=1, mode="max")

    val = None if kind == "epoch_step" else 2
    jopt, jrates, jlosses = _train("jax", jm, x, y, 15, sched(jsched), val)
    popt, prates, plosses = _train("port", pm, x, y, 15, sched(psched), val)
    assert prates == jrates and len(prates) == 15
    assert len(set(prates)) > 1
    if kind == "epoch_step":
        assert prates == [0.1] * 5 + [0.05] * 5 + [0.025] * 5
    np.testing.assert_allclose(plosses, jlosses, atol=ATOL)
    for k in ("neval", "epoch", "n_validations", "_plateau_seen_event"):
        assert popt.optim_method.state.get(k) == jopt.optim_method.state.get(k), k


def _plateau_chain(mod):
    return (mod.SequentialSchedule()
            .add(mod.Warmup(0.01), 3)
            .add(mod.Plateau("score", factor=0.5, patience=1, mode="max"), 100))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_with_schedule_state_crosses_packages(tmp_path, writer):
    """The writer trains 9 iterations (5 an epoch) with validation every 2
    and checkpoints every 3; each package resumes from its step-7
    checkpoint (mid epoch 2, past the Warmup leg, after 3 validations) and
    trains to 9; the reader's resume continues as the writer's own does."""
    x, y = images(40, 22)
    reader = "port" if writer == "jax" else "jax"
    wm = carried_pair(cnn, x[:8])[0 if writer == "jax" else 1]
    mod = {"jax": jsched, "port": psched}
    d = str(tmp_path / "w")
    _train(writer, wm, x, y, 9, _plateau_chain(mod[writer]), val_every=2, ckpt=d)
    with open(os.path.join(d, "state.7.json")) as f:
        host = json.load(f)
    # written after iteration 6: its validation (the third) not yet seen by the schedule
    assert host["_schedule_offset"] == 3 and host["_plateau_seen_event"] == 2
    assert host["n_validations"] == 3 and host["neval"] == 7
    src = _only_step(d, 7, tmp_path / "w7")
    jm, pm = carried_pair(cnn, x[:8])
    runs = {pkg: _train(pkg, m, x, y, 9, _plateau_chain(mod[pkg]), val_every=2, resume=src)
            for pkg, m in (("jax", jm), ("port", pm))}
    (wopt, wrates, wlosses), (ropt, rrates, rlosses) = runs[writer], runs[reader]
    assert rrates == wrates and len(rrates) == 3  # iterations 7-9
    np.testing.assert_allclose(rlosses, wlosses, atol=ATOL)
    for k in ("neval", "epoch", "n_validations", "_plateau_seen_event", "_schedule_offset"):
        assert ropt.optim_method.state[k] == wopt.optim_method.state[k], k
    assert math.isfinite(rlosses[-1])
