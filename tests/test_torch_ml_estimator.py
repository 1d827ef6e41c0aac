"""The port's ``DLEstimator`` / ``DLClassifier`` (``bigdl_tpu_torch.ml``)
against the JAX package's, on the cases of ``tests/test_ml_pipeline.py``:
each model built in the JAX package, its initial weights carried into the
port's (``load_jax_params``), both fitted on the same numpy data with the
same seed (the same epoch orders), on the CPU (``device="cpu"``).

Tolerances, float32: the fitted parameters within 1e-5 absolute and
relative (the same SGD / Adam steps, each product summed in another
order); the class predictions and scores equal; ``predict_proba`` and the
regression's predictions within 1e-5.
"""

import jax
import numpy as np
import pytest
import torch

import bigdl_tpu.nn as jnn
from bigdl_tpu.ml import DLClassifier as JDLClassifier
from bigdl_tpu.ml import DLEstimator as JDLEstimator
from bigdl_tpu.optim.optim_method import Adam as JAdam
from bigdl_tpu.utils.random import RandomGenerator as JRandom
from bigdl_tpu_torch import nn as pnn
from bigdl_tpu_torch.ml import DLClassifier, DLClassifierModel, DLEstimator, DLModel
from bigdl_tpu_torch.optim import Adam
from bigdl_tpu_torch.utils.convert import load_jax_params
from bigdl_tpu_torch.utils.random import RandomGenerator

from test_torch_conv_bn import flat, np_tree

TOL = dict(atol=1e-5, rtol=1e-5)
SEED = 61


@pytest.fixture(autouse=True, scope="module")
def _engine_isolation():
    """The JAX optimizer here runs on one device (see test_torch_training.py)."""
    from bigdl_tpu.utils.engine import Engine as JEngine

    JEngine.reset()
    yield
    JEngine.reset()


def _blobs(n=128, seed=0):
    """Two well-separated gaussian blobs (the JAX test's)."""
    rng = np.random.default_rng(seed)
    x0 = rng.normal(-2.0, 0.5, (n // 2, 4)).astype(np.float32)
    x1 = rng.normal(2.0, 0.5, (n - n // 2, 4)).astype(np.float32)
    x = np.concatenate([x0, x1])
    y = np.concatenate([np.zeros(n // 2), np.ones(n - n // 2)]).astype(np.int32)
    perm = rng.permutation(n)
    return x[perm], y[perm]


def _mlp(nn, d):
    return nn.Sequential(nn.Linear(4, 8, **d), nn.ReLU(**d), nn.Linear(8, 2, **d),
                         nn.LogSoftMax(**d), **d)


def _pair(build, sample):
    """The JAX model built on ``sample`` and the port's carrying its weights."""
    jm = build(jnn, {})
    jp, _ = jm.init(jax.random.PRNGKey(SEED), sample_input=sample)
    pm = build(pnn, {"device": "cpu"})
    pm.init(sample_input=torch.from_numpy(sample))
    load_jax_params(pm, np_tree(jp))
    return jm, pm


def _fit_both(jest, pest, x, y):
    JRandom.set_seed(SEED)
    jfit = jest.fit(x, y)
    RandomGenerator.set_seed(SEED)
    pfit = pest.fit(x, y)
    got, want = flat(pfit.model.get_parameters()), flat(np_tree(jfit.model.get_parameters()))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **TOL)
    return jfit, pfit


def test_fit_predict_score_match_jax():
    x, y = _blobs()
    jm, pm = _pair(_mlp, x[:2])
    kw = dict(batch_size=16, max_epoch=20, learning_rate=0.1)
    jfit, pfit = _fit_both(JDLClassifier(jm, jnn.ClassNLLCriterion(), **kw),
                           DLClassifier(pm, pnn.ClassNLLCriterion(), device="cpu", **kw), x, y)
    assert isinstance(pfit, DLClassifierModel)
    assert pfit.score(x, y) == jfit.score(x, y) > 0.95
    preds = pfit.predict(x[:5])
    assert preds.shape == (5,) and set(preds) <= {0, 1}
    np.testing.assert_array_equal(preds, np.asarray(jfit.predict(x[:5])))
    proba = pfit.predict_proba(x[:5])
    np.testing.assert_allclose(proba, np.asarray(jfit.predict_proba(x[:5])), **TOL)
    np.testing.assert_allclose(proba.sum(1), 1.0, rtol=1e-5)
    assert next(pfit.model.parameters()).device.type == "cpu"


def test_feature_size_reshape_matches_jax():
    """Flat rows reshaped by ``feature_size``, as the reference's featureSize."""
    x, y = _blobs(64, seed=1)

    def build(nn, d):
        return nn.Sequential(nn.Reshape((4,), **d), nn.Linear(4, 2, **d),
                             nn.LogSoftMax(**d), **d)

    jm, pm = _pair(build, x[:2].reshape(2, 2, 2))
    kw = dict(feature_size=(4,), batch_size=16, max_epoch=3, learning_rate=0.1)
    jfit, pfit = _fit_both(JDLClassifier(jm, jnn.ClassNLLCriterion(), **kw),
                           DLClassifier(pm, pnn.ClassNLLCriterion(), device="cpu", **kw),
                           x.reshape(64, 2, 2), y)
    got = pfit.predict(x.reshape(64, 2, 2))
    assert got.shape == (64,)
    np.testing.assert_array_equal(got, np.asarray(jfit.predict(x.reshape(64, 2, 2))))


def test_sklearn_params_protocol_matches_jax():
    jest = JDLClassifier(jnn.Linear(4, 2), jnn.ClassNLLCriterion())
    est = DLClassifier(pnn.Linear(4, 2, device="cpu"), pnn.ClassNLLCriterion())
    params = est.get_params()
    assert set(params) == set(jest.get_params()) | {"device"}
    assert params["batch_size"] == jest.get_params()["batch_size"] == 32
    assert est.set_params(batch_size=8, max_epoch=1, device="cpu") is est
    assert est.batch_size == 8 and est.device == "cpu"
    for e in (est, jest):
        with pytest.raises(ValueError, match="unknown parameter 'bogus'"):
            e.set_params(bogus=1)
        with pytest.raises(RuntimeError, match="is not fitted yet"):
            e.predict(np.zeros((1, 4), np.float32))


def test_regression_fit_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((96, 3)).astype(np.float32)
    y = x @ np.float32([[1.5], [-2.0], [0.5]]) + 0.3

    def build(nn, d):
        return nn.Linear(3, 1, **d)

    jm, pm = _pair(build, x[:2])
    kw = dict(batch_size=16, max_epoch=30)
    jfit, pfit = _fit_both(JDLEstimator(jm, jnn.MSECriterion(),
                                        optim_method=JAdam(learningrate=0.05), **kw),
                           DLEstimator(pm, pnn.MSECriterion(), optim_method=Adam(learningrate=0.05),
                                       device="cpu", **kw), x, y)
    assert isinstance(pfit, DLModel)
    pred = pfit.predict(x)
    assert float(np.mean((pred - y) ** 2)) < 0.05
    np.testing.assert_allclose(pred, np.asarray(jfit.predict(x)), **TOL)
    np.testing.assert_allclose(pfit.transform(x), pred)  # transform == predict


def test_sklearn_pipeline_matches_jax():
    """Both estimators driven from a real sklearn ``Pipeline``."""
    pytest.importorskip("sklearn")
    from sklearn.pipeline import Pipeline
    from sklearn.preprocessing import StandardScaler

    x, y = _blobs(96, seed=3)
    jm, pm = _pair(_mlp, x[:2])
    kw = dict(batch_size=16, max_epoch=15, learning_rate=0.1)
    scores = []
    for est, rng in ((JDLClassifier(jm, jnn.ClassNLLCriterion(), **kw), JRandom),
                     (DLClassifier(pm, pnn.ClassNLLCriterion(), device="cpu", **kw),
                      RandomGenerator)):
        rng.set_seed(SEED)
        pipe = Pipeline([("scale", StandardScaler()), ("net", est)])
        scores.append(pipe.fit(x, y).score(x, y))
    assert scores[1] == scores[0] > 0.9
