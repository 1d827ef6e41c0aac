"""The port's criterions against the JAX package's: loss and input gradient.

Scores and labels come from numpy with a seed and go to both packages.
Tolerance: f32, 1e-5 absolute and relative on the loss, 1e-6 absolute on the
gradient (log-softmax and a mean of the same values, summed in another
order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bigdl_tpu.nn as jnn
from bigdl_tpu_torch.nn import ClassNLLCriterion, CrossEntropyCriterion

ATOL = RTOL = 1e-5
GRAD_ATOL = 1e-6
C = 7


def _scores(shape=(6, C), seed=0, log_prob=True):
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    if log_prob:  # log-softmax rows, as ClassNLL expects
        x = x - np.log(np.exp(x).sum(-1, keepdims=True))
    return x


def _labels(shape=(6,), seed=1, lo=0, hi=C):
    return np.random.RandomState(seed).randint(lo, hi, shape).astype(np.int32)


def _check(jcrit, pcrit, x, t):
    want_loss = float(jcrit.forward(jnp.asarray(x), jnp.asarray(t)))
    want_grad = np.asarray(jcrit.backward(jnp.asarray(x), jnp.asarray(t)))
    xt = torch.from_numpy(x)
    got_loss = pcrit.forward(xt, t)
    assert got_loss.dim() == 0 and got_loss.dtype == torch.float32
    np.testing.assert_allclose(got_loss.item(), want_loss, atol=ATOL, rtol=RTOL)
    got_grad = pcrit.backward(xt, t)
    assert pcrit.grad_input is got_grad and got_grad.shape == x.shape
    np.testing.assert_allclose(got_grad.numpy(), want_grad, atol=GRAD_ATOL, rtol=RTOL)


@pytest.mark.parametrize("size_average", [True, False])
@pytest.mark.parametrize("weighted", [False, True])
def test_class_nll_matches_jax(size_average, weighted):
    w = np.linspace(0.5, 2.0, C).astype(np.float32) if weighted else None
    x, t = _scores(), _labels()
    _check(jnn.ClassNLLCriterion(weights=None if w is None else jnp.asarray(w),
                                 size_average=size_average),
           ClassNLLCriterion(weights=w, size_average=size_average), x, t)


def test_class_nll_padding_and_one_based():
    x = _scores()
    t = np.array([1, 3, 0, 7, 0, 2], np.int32)  # 1-based labels; 0 marks padding
    _check(jnn.ClassNLLCriterion(one_based_label=True, padding_value=0),
           ClassNLLCriterion(one_based_label=True, padding_value=0), x, t)


def test_class_nll_probabilities_input():
    x = np.exp(_scores(seed=4))
    t = _labels(seed=5)
    _check(jnn.ClassNLLCriterion(log_prob_as_input=False),
           ClassNLLCriterion(log_prob_as_input=False), x, t)


@pytest.mark.parametrize("bad", [-1, C])
def test_class_nll_out_of_range_label_gives_nan(bad):
    x, t = _scores(), _labels()
    t[2] = bad
    want = float(jnn.ClassNLLCriterion().forward(jnp.asarray(x), jnp.asarray(t)))
    got = ClassNLLCriterion().forward(torch.from_numpy(x), t)
    assert np.isnan(want) and torch.isnan(got)


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
@pytest.mark.parametrize("size_average", [True, False])
def test_cross_entropy_matches_jax(smoothing, size_average):
    x, t = _scores(log_prob=False, seed=2), _labels(seed=3)
    _check(jnn.CrossEntropyCriterion(size_average=size_average, label_smoothing=smoothing),
           CrossEntropyCriterion(size_average=size_average, label_smoothing=smoothing),
           x, t)


@pytest.mark.parametrize("smoothing", [0.0, 0.2])
def test_cross_entropy_sequence_targets(smoothing):
    """(N, T) targets against (N, T, C) scores, as the language model trains."""
    x = _scores((3, 5, C), seed=6, log_prob=False)
    t = _labels((3, 5), seed=7)
    _check(jnn.CrossEntropyCriterion(label_smoothing=smoothing),
           CrossEntropyCriterion(label_smoothing=smoothing), x, t)


def test_cross_entropy_weighted_and_unreduced():
    w = np.linspace(2.0, 0.5, C).astype(np.float32)
    x, t = _scores(log_prob=False, seed=8), _labels(seed=9)
    jc, pc = jnn.CrossEntropyCriterion(weights=jnp.asarray(w)), CrossEntropyCriterion(weights=w)
    _check(jc, pc, x, t)
    jper, jden = jc.unreduced(jnp.asarray(x), jnp.asarray(t))
    pper, pden = pc.unreduced(torch.from_numpy(x), t)
    np.testing.assert_allclose(pper.numpy(), np.asarray(jper), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(pden.numpy(), np.asarray(jden), atol=ATOL, rtol=RTOL)
    assert pc.supports_unreduced()
    smoothed = CrossEntropyCriterion(weights=w, label_smoothing=0.1)
    assert not smoothed.supports_unreduced() and smoothed.unreduced(x, t) is None


def test_bf16_scores_give_an_fp32_loss():
    x = torch.from_numpy(_scores(log_prob=False)).to(torch.bfloat16)
    loss = CrossEntropyCriterion()(x, _labels())
    assert loss.dtype == torch.float32
    want = torch.nn.functional.cross_entropy(x.float(), torch.from_numpy(_labels()).long())
    torch.testing.assert_close(loss, want)
