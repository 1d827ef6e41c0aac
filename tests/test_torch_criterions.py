"""The port's criterions against the JAX package's, for every criterion of
``bigdl_tpu/nn/criterion.py`` that the port did not have
(``ClassNLLCriterion``, ``CrossEntropyCriterion``, ``MSECriterion`` and
``TimeDistributedCriterion`` are held in ``test_torch_criterion.py``): the
loss and the input gradient (each entry's, for a table input) on the same
seeded numpy scores and targets, with the traps planted: probabilities of
exactly 0 and 1 into ``BCECriterion`` (``log(p + 1e-12)``, not
``F.binary_cross_entropy``'s clamp at -100), a logit of exactly 0,
zero-padded 1-based multi-label targets (a row with none, a row whose
index after its first 0 must not count), 1-based simplex classes;
``unreduced`` of ``AbsCriterion`` and ``SmoothL1Criterion``.

Tolerance, fixed before the first run, as ``test_torch_criterion.py``'s:
f32, 1e-5 absolute and relative on the loss, 1e-6 absolute plus 1e-5
relative on the gradient (the same values summed in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bigdl_tpu.nn as jnn
from bigdl_tpu.utils.table import T as JT
from bigdl_tpu_torch import nn as pnn
from bigdl_tpu_torch.utils.table import T as PT
from bigdl_tpu_torch.utils.table import Table as PTable

from test_torch_activations import leaves, to_jax, to_port

N, C = 6, 5


def _rng(seed):
    return np.random.default_rng(seed)


def _scores(shape=(N, C), seed=0):
    return _rng(seed).standard_normal(shape).astype(np.float32)


def _probs(shape=(N, C), seed=0):
    p = _rng(seed).random(shape).astype(np.float32)
    p.reshape(-1)[:4] = [0.0, 1.0, 0.0, 1.0]  # with targets 1, 0, 0, 1 below
    return p


def _bits(shape=(N, C), seed=1):
    t = (_rng(seed).random(shape) > 0.5).astype(np.float32)
    t.reshape(-1)[:4] = [1.0, 0.0, 0.0, 1.0]
    return t


def _signs(n=N, seed=2):
    return np.where(_rng(seed).random(n) > 0.5, 1, -1).astype(np.float32)


def _log_probs(seed=3):
    x = _scores(seed=seed)
    return x - np.log(np.exp(x).sum(-1, keepdims=True))


def _dist(seed=4):
    t = _rng(seed).random((N, C)).astype(np.float32)
    t[:, 0] = 0.0  # zero target mass: the t > 0 branch
    return t / t.sum(-1, keepdims=True)


def _zero_logit():
    x = _scores(seed=5)
    x[0, 0] = 0.0
    return x


MULTI_LABEL = np.array([[3, 1, 0, 0], [2, 0, 4, 0], [0, 0, 0, 0], [5, 4, 3, 2],
                        [1, 1, 0, 0], [4, 0, 0, 0]], np.int64)

# name -> (constructor over a package, input maker, target maker)
CRITERIA = {
    "AbsCriterion": (lambda nn: nn.AbsCriterion(), _scores, lambda: _scores(seed=9)),
    "AbsCriterion_sum": (lambda nn: nn.AbsCriterion(False), _scores, lambda: _scores(seed=9)),
    "SmoothL1Criterion": (lambda nn: nn.SmoothL1Criterion(), lambda: 2 * _scores(),
                          lambda: _scores(seed=9)),
    "SmoothL1Criterion_sum": (lambda nn: nn.SmoothL1Criterion(False), lambda: 2 * _scores(),
                              lambda: _scores(seed=9)),
    "BCECriterion": (lambda nn: nn.BCECriterion(), _probs, _bits),
    "BCECriterion_weighted_sum": (
        lambda nn: nn.BCECriterion(np.linspace(0.5, 2.0, C).astype(np.float32), False),
        _probs, _bits),
    "BCECriterionWithLogits": (lambda nn: nn.BCECriterionWithLogits(), _zero_logit, _bits),
    "DistKLDivCriterion": (lambda nn: nn.DistKLDivCriterion(), _log_probs, _dist),
    "DistKLDivCriterion_sum": (lambda nn: nn.DistKLDivCriterion(False), _log_probs, _dist),
    "MarginRankingCriterion": (lambda nn: nn.MarginRankingCriterion(0.5),
                               lambda: [_scores((N,), 6), _scores((N,), 7)], _signs),
    "HingeEmbeddingCriterion": (lambda nn: nn.HingeEmbeddingCriterion(1.5),
                                lambda: np.abs(2 * _scores((N,), 8)), _signs),
    "CosineEmbeddingCriterion": (lambda nn: nn.CosineEmbeddingCriterion(0.2),
                                 lambda: [_scores(seed=10), _scores(seed=11)], _signs),
    "MultiLabelSoftMarginCriterion": (lambda nn: nn.MultiLabelSoftMarginCriterion(),
                                      _zero_logit, _bits),
    "MultiLabelSoftMarginCriterion_weighted": (
        lambda nn: nn.MultiLabelSoftMarginCriterion(np.arange(1, C + 1, dtype=np.float32)),
        _scores, _bits),
    "L1Cost": (lambda nn: nn.L1Cost(), _zero_logit, lambda: _scores(seed=9)),
    "ParallelCriterion": (
        lambda nn: nn.ParallelCriterion().add(nn.AbsCriterion(), 0.5).add(nn.MSECriterion(), 2.0),
        lambda: [_scores(seed=12), _scores((N, 3), 13)],
        lambda: [_scores(seed=14), _scores((N, 3), 15)]),
    "ParallelCriterion_repeat": (
        lambda nn: nn.ParallelCriterion(True).add(nn.SmoothL1Criterion()).add(nn.AbsCriterion(),
                                                                                0.3),
        lambda: [_scores(seed=12), _scores(seed=13)], lambda: _scores(seed=14)),
    "MultiCriterion": (
        lambda nn: nn.MultiCriterion().add(nn.MSECriterion(), 0.7).add(nn.AbsCriterion()),
        _scores, lambda: _scores(seed=9)),
    "MarginCriterion": (lambda nn: nn.MarginCriterion(), lambda: _scores((N,), 16), _signs),
    "MarginCriterion_squared_sum": (lambda nn: nn.MarginCriterion(0.8, False, True),
                                    lambda: _scores((N,), 16), _signs),
    "MultiLabelMarginCriterion": (lambda nn: nn.MultiLabelMarginCriterion(), _scores,
                                  lambda: MULTI_LABEL),
    "DiceCoefficientCriterion": (lambda nn: nn.DiceCoefficientCriterion(),
                                 lambda: _probs((N, 4, 4), 17), lambda: _bits((N, 4, 4), 18)),
    "DiceCoefficientCriterion_sum": (lambda nn: nn.DiceCoefficientCriterion(False, 0.5),
                                     lambda: _probs((N, 4, 4), 17), lambda: _bits((N, 4, 4), 18)),
    "ClassSimplexCriterion": (lambda nn: nn.ClassSimplexCriterion(C), _scores,
                              lambda: np.array([1, 5, 3, 2, 5, 4], np.int64)),
}


def _target_jax(t):
    return JT(*[jnp.asarray(v) for v in t]) if isinstance(t, list) else jnp.asarray(t)


def _target_port(t):
    return PT(*[torch.from_numpy(v) for v in t]) if isinstance(t, list) else t


@pytest.mark.parametrize("name", sorted(CRITERIA))
def test_criterion_matches_jax(name):
    make, data, target = CRITERIA[name]
    x, t = data(), target()
    jc, pc = make(jnn), make(pnn)
    want = float(jc.forward(to_jax(x), _target_jax(t)))
    want_grad = leaves(jc.backward(to_jax(x), _target_jax(t)))
    got = pc.forward(to_port(x), _target_port(t))
    assert got.dim() == 0 and got.dtype == torch.float32
    np.testing.assert_allclose(got.item(), want, atol=1e-5, rtol=1e-5)
    got_grad = pc.backward(to_port(x), _target_port(t))
    assert pc.grad_input is got_grad
    assert isinstance(got_grad, PTable) == isinstance(x, list)
    got_grad = leaves(got_grad)
    assert len(got_grad) == len(want_grad)
    for g, w in zip(got_grad, want_grad):
        assert np.isfinite(g.numpy()).all()
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6, rtol=1e-5)


def test_bce_logs_zero_and_one_with_an_epsilon():
    """p = 0 against t = 1 costs -log(1e-12) = 27.63, where
    F.binary_cross_entropy would clamp the log at -100."""
    p, t = np.array([[0.0, 1.0]], np.float32), np.array([[1.0, 0.0]], np.float32)
    got = pnn.BCECriterion(size_average=False).forward(torch.from_numpy(p), t)
    want = float(jnn.BCECriterion(size_average=False).forward(jnp.asarray(p), jnp.asarray(t)))
    np.testing.assert_allclose(got.item(), want, rtol=1e-6)
    np.testing.assert_allclose(got.item(), -2 * np.log(np.float32(1e-12)), rtol=1e-5)


@pytest.mark.parametrize("name", ["AbsCriterion", "SmoothL1Criterion"])
def test_unreduced_matches_jax(name):
    x, t = 2 * _scores(), _scores(seed=9)
    jc, pc = getattr(jnn, name)(), getattr(pnn, name)()
    assert pc.supports_unreduced()
    jper, jden = jc.unreduced(jnp.asarray(x), jnp.asarray(t))
    pper, pden = pc.unreduced(torch.from_numpy(x), t)
    np.testing.assert_allclose(pper.numpy(), np.asarray(jper), atol=1e-6, rtol=1e-6)
    np.testing.assert_array_equal(pden.numpy(), np.asarray(jden))
    np.testing.assert_allclose(pper.sum().item() / pden.sum().item(),
                               pc.forward(torch.from_numpy(x), t).item(), rtol=1e-6)


def test_criterion_errors():
    with pytest.raises(ValueError, match="n_classes >= 2"):
        pnn.ClassSimplexCriterion(1)
    s = pnn.criterion.simplex_coordinates(4).numpy()
    np.testing.assert_allclose(np.linalg.norm(s, axis=1), np.ones(4), rtol=1e-6)
    d = [np.linalg.norm(s[i] - s[j]) for i in range(4) for j in range(i + 1, 4)]
    np.testing.assert_allclose(d, np.full(6, d[0]), rtol=1e-6)  # equidistant vertices
