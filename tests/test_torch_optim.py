"""The port's optimization methods against the JAX package's ``update``.

A small two-level parameter tree and 4 steps of gradients, all from numpy
with a seed; the JAX side's pure update and the port's in-place update see
the same values and the same learning rate per step (the ``Default``
schedule with decay). Tolerance: f32, 1e-6 absolute and 1e-5 relative (the
same elementwise arithmetic, rounded in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bigdl_tpu.optim as joptim
from bigdl_tpu_torch.optim import SGD, Adam, Default
from bigdl_tpu_torch.optim.optim_method import _leaves

ATOL, RTOL = 1e-6, 1e-5
STEPS = 4


def _tree(seed):
    rs = np.random.RandomState(seed)
    return {"block0": {"fc_w": rs.randn(3, 4).astype(np.float32),
                       "fc_b": rs.randn(3).astype(np.float32)},
            "head_w": rs.randn(2, 3).astype(np.float32)}


def _map(fn, tree):
    return {k: (_map(fn, v) if isinstance(v, dict) else fn(v)) for k, v in tree.items()}


def _run(jmethod, pmethod):
    params = _tree(0)
    jp = _map(jnp.asarray, params)
    pp = _map(torch.from_numpy, _map(np.copy, params))
    jslots, pslots = jmethod.init_slots(jp), pmethod.init_slots(pp)
    for step in range(1, STEPS + 1):
        grads = _tree(step)
        jlr, plr = jmethod.get_learning_rate(), pmethod.get_learning_rate()
        assert plr == pytest.approx(jlr)
        jp, jslots = jmethod.update(_map(jnp.asarray, grads), jp, jslots,
                                    jnp.asarray(jlr), jnp.asarray(step))
        out, _ = pmethod.update(_map(torch.from_numpy, grads), pp, pslots, plr, step)
        assert out is pp  # in place
        for m in (jmethod, pmethod):
            m.state["neval"] += 1
    want = {jax.tree_util.keystr(k): v
            for k, v in jax.tree_util.tree_flatten_with_path(jp)[0]}
    for path, got in _leaves(pp):
        np.testing.assert_allclose(got.numpy(), np.asarray(want[path]), atol=ATOL,
                                   rtol=RTOL, err_msg=path)
    return pslots


@pytest.mark.parametrize("kw", [
    dict(learningrate=0.1),
    dict(learningrate=0.1, momentum=0.9),  # dampening defaults to the momentum
    dict(learningrate=0.1, momentum=0.9, dampening=0.0, nesterov=True),
    dict(learningrate=0.1, momentum=0.5, weightdecay=0.01),
    dict(learningrate=0.1, momentum=0.5, weightdecay=0.01, weightdecay_exclude=("_b",)),
    dict(learningrate=0.2, learningrate_decay=0.3, momentum=0.9),
])
def test_sgd_matches_jax(kw):
    slots = _run(joptim.SGD(**kw), SGD(**kw))
    assert ("velocity" in slots) == (kw.get("momentum", 0) > 0)


@pytest.mark.parametrize("kw", [dict(learningrate=0.01),
                                dict(learningrate=0.05, learningrate_decay=0.2, beta1=0.8)])
def test_adam_matches_jax(kw):
    slots = _run(joptim.Adam(**kw), Adam(**kw))
    assert set(slots) == {"m", "v"}


def test_weightdecay_exclude_matches_keystr_paths():
    paths = [p for p, _ in _leaves(_tree(0))]
    assert paths == ["['block0']['fc_w']", "['block0']['fc_b']", "['head_w']"]
    want = [jax.tree_util.keystr(k) for k, _ in jax.tree_util.tree_flatten_with_path(
        _map(jnp.asarray, _tree(0)))[0]]
    assert sorted(paths) == sorted(want)


def test_default_schedule_and_state_table():
    m = SGD(learningrate=0.5, learningrate_decay=0.25)
    assert m.state == {"epoch": 1, "neval": 1}
    assert m.get_learning_rate() == 0.5
    m.update_state(neval=5)
    assert m.get_learning_rate() == pytest.approx(0.5 / 2.0)
    assert Default().update(m, {"neval": 3}) == pytest.approx(0.5 / 1.5)
    with pytest.raises(ValueError, match="nesterov"):
        SGD(momentum=0.9, nesterov=True)
