"""The port's ``LocalOptimizer`` training a ResNet against the JAX package's:
ResNet-18 (ImageNet variant, conv7 stem, 10 classes), 4 records of
(3, 64, 64) f32 images and labels from numpy with a seed, batch 2, SGD
(lr 0.1, momentum 0.9), ``ClassNLLCriterion`` on the raw logits, 3 iterations
across an epoch boundary; the JAX model's initial weights and BN state
carried over, the same global seed in both packages (the same epoch order).

At 32x32 the last stage's train-mode BN normalises two values per channel
and the two trajectories part at the first step (see test_torch_resnet.py);
at 64x64 they agree to 1e-4. Tolerances (f32, summation order through 18
layers, and ReLU gates near zero that may open in one package only): losses
1e-3 absolute; parameters 1e-3 absolute, and the port's total update within
2e-2 relative L2 of the JAX one; BN state 1e-3 absolute + 1e-3 relative.
"""

import jax
import numpy as np
import pytest

import bigdl_tpu.nn as jnn
import bigdl_tpu.optim as joptim
from bigdl_tpu.dataset.dataset import DataSet as JDataSet
from bigdl_tpu.models import ResNet as JResNet
from bigdl_tpu.utils.random import RandomGenerator as JRandom
from bigdl_tpu_torch import Engine, RandomGenerator
from bigdl_tpu_torch.dataset import DataSet
from bigdl_tpu_torch.models import ResNet
from bigdl_tpu_torch.nn import ClassNLLCriterion
from bigdl_tpu_torch.optim import SGD, LocalOptimizer, Trigger
from bigdl_tpu_torch.utils.convert import load_jax_params, load_jax_state

from test_torch_conv_bn import flat, np_tree

SEED = 7


@pytest.fixture(autouse=True, scope="module")
def _engine_isolation():
    """The JAX LocalOptimizer here runs on one device (see test_torch_training.py)."""
    from bigdl_tpu.utils.engine import Engine as JEngine

    JEngine.reset()
    yield
    JEngine.reset()


@pytest.fixture(autouse=True)
def _fp32_policy():
    Engine.set_compute_dtype("float32")
    yield
    Engine.set_compute_dtype(None)


class _RecordingJaxOptimizer(joptim.LocalOptimizer):
    """The JAX LocalOptimizer, keeping each logged (one-step-late) loss."""

    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        self.losses = []

    def _log_iteration(self, state, loss, records, wall, throughput):
        self.losses.append(float(loss))


def test_local_optimizer_trains_resnet_like_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 3, 64, 64)).astype(np.float32)
    y = rng.integers(0, 10, 4)

    JRandom.set_seed(SEED)
    jm = JResNet(18, class_num=10)
    jp, js = jm.init(jax.random.PRNGKey(0), sample_input=x[:2])
    init_params, init_state = np_tree(jp), np_tree(js)
    jopt = _RecordingJaxOptimizer(jm, JDataSet.array(x, y, batch_size=2),
                                  jnn.ClassNLLCriterion())
    jopt.set_optim_method(joptim.SGD(learningrate=0.1, momentum=0.9))
    jopt.set_end_when(joptim.Trigger.max_iteration(3)).optimize()

    RandomGenerator.set_seed(SEED)
    pm = ResNet(18, class_num=10, device="cpu")
    pm.init(sample_input=x[:2])
    load_jax_params(pm, init_params)
    load_jax_state(pm, init_state)
    states = []
    real_set_state = pm.set_state
    pm.set_state = lambda s: states.append(flat(s)) or real_set_state(s)
    opt = LocalOptimizer(pm, DataSet.array(x, y, batch_size=2), ClassNLLCriterion())
    opt.set_optim_method(SGD(learningrate=0.1, momentum=0.9))
    assert opt.set_end_when(Trigger.max_iteration(3)).optimize() is pm

    assert [h["epoch"] for h in opt.history] == [1, 1, 2]
    np.testing.assert_allclose([h["loss"] for h in opt.history], jopt.losses, atol=1e-3)
    # the BN statistics advance once per iteration, each time to new values
    assert len(states) == 3
    key = "res2a_main.res2a_a.res2a_a_bn.running_mean"
    assert not np.array_equal(states[0][key], states[1][key])

    want_p, got_p, p0 = flat(np_tree(jm.get_parameters())), flat(pm.get_parameters()), \
        flat(init_params)
    assert set(got_p) == set(want_p)
    for k in want_p:
        np.testing.assert_allclose(got_p[k], want_p[k], atol=1e-3, err_msg=k)
    dist = np.sqrt(sum(np.sum((got_p[k] - want_p[k]) ** 2) for k in want_p))
    step = np.sqrt(sum(np.sum((want_p[k] - p0[k]) ** 2) for k in want_p))
    assert dist <= 2e-2 * step
    want_s, got_s = flat(np_tree(jm.get_state())), flat(pm.get_state())
    assert set(got_s) == set(want_s)
    for k in want_s:
        np.testing.assert_allclose(got_s[k], want_s[k], atol=1e-3, rtol=1e-3, err_msg=k)
