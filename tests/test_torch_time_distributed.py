"""The port's ``TimeDistributedCriterion`` against the JAX package's loop
over time steps: the one-call form (the inner criterion's ``unreduced``)
and the loop the port keeps for inner criteria without one, loss and
gradient of the (N, T, C) scores, with and without ``size_average`` on
both levels, padded targets and label smoothing.

Scores and targets from numpy with a seed, f32. Tolerance 1e-6 relative
(1e-6 absolute on the gradient): the same per-step sums, taken in another
order within each step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bigdl_tpu.nn as jnn
from bigdl_tpu_torch import nn as pnn

N, T, C = 4, 7, 10

INNER = {
    # name: (JAX inner, port inner, does the port take the one-call form)
    "ce-mean": (lambda m: m.CrossEntropyCriterion(), True),
    "ce-sum": (lambda m: m.CrossEntropyCriterion(size_average=False), True),
    "ce-smoothing": (lambda m: m.CrossEntropyCriterion(label_smoothing=0.1), True),
    "ce-weights-smoothing": (
        lambda m: m.CrossEntropyCriterion(weights=np.linspace(0.5, 2, C).astype(np.float32),
                                          label_smoothing=0.1), False),
    "nll-padding": (lambda m: m.ClassNLLCriterion(padding_value=3), True),
    "nll-weights-sum": (
        lambda m: m.ClassNLLCriterion(weights=np.linspace(0.5, 2, C).astype(np.float32),
                                      size_average=False), True),
}


def _data(seed):
    rng = np.random.default_rng(seed)
    scores = rng.standard_normal((N, T, C)).astype(np.float32)
    target = rng.integers(0, C, (N, T)).astype(np.int32)
    target[:, 2] = 3  # a step whose every row is padding for "nll-padding"
    return scores, target


def _jax(inner, size_average, scores, target):
    crit = jnn.TimeDistributedCriterion(inner, size_average=size_average)
    loss, grad = jax.value_and_grad(lambda s: crit._apply(s, jnp.asarray(target)))(
        jnp.asarray(scores))
    return float(loss), np.asarray(grad)


@pytest.mark.parametrize("size_average", [True, False], ids=["mean-steps", "sum-steps"])
@pytest.mark.parametrize("name", sorted(INNER))
def test_matches_the_jax_loop(name, size_average, monkeypatch):
    make, one_call = INNER[name]
    scores, target = _data(sorted(INNER).index(name))
    inner = make(pnn)
    if name.startswith("nll"):  # ClassNLL takes log-probabilities
        scores = np.array(jax.nn.log_softmax(jnp.asarray(scores), -1))
    want_loss, want_grad = _jax(make(jnn), size_average, scores, target)
    crit = pnn.TimeDistributedCriterion(inner, size_average=size_average)
    calls = []
    real = type(inner)._apply
    monkeypatch.setattr(type(inner), "_apply",
                        lambda self, *a: calls.append(1) or real(self, *a))
    x = torch.from_numpy(scores).requires_grad_(True)
    loss = crit.forward(x, target)
    loss.backward()
    assert len(calls) == (0 if one_call else T)  # one call, or the loop over T
    np.testing.assert_allclose(loss.item(), want_loss, rtol=1e-6)
    np.testing.assert_allclose(x.grad.numpy(), want_grad, rtol=1e-6, atol=1e-6)


def test_both_forms_agree():
    scores, target = _data(9)
    x = torch.from_numpy(scores)
    crit = pnn.TimeDistributedCriterion(pnn.CrossEntropyCriterion(), size_average=True)
    one_call = crit.forward(x, target)
    crit._steps = lambda *a: None  # force the loop
    loop = crit.forward(x, target)
    torch.testing.assert_close(one_call, loop, rtol=1e-6, atol=0)


def test_backward_gives_the_score_gradient():
    scores, target = _data(10)
    crit = pnn.TimeDistributedCriterion(pnn.CrossEntropyCriterion())
    g = crit.backward(torch.from_numpy(scores), target)
    _, want = _jax(jnn.CrossEntropyCriterion(), False, scores, target)
    np.testing.assert_allclose(g.numpy(), want, rtol=1e-6, atol=1e-6)
