"""The port's VGG models against the JAX package's, with the JAX weights
carried over (``load_jax_params`` / ``load_jax_state``):

(a) ``VggForCifar10(has_dropout=False)`` at 32x32, batch 2: train-mode and
    eval-mode log-probabilities and the new BN state;
(b) ``Vgg_16`` and ``Vgg_19``: parameter paths, shapes and dtypes, and the
    JAX ``Vgg_16`` tree loading into both the port's ``Vgg_16`` and the
    declared-epilogue VGG-16 (whose ReLU modules are gone), built on the
    ``meta`` device (no forward computes anything);
(c) a narrow declared-epilogue VGG (every conv and hidden fc built with
    ``activation="relu"``), the fused-kernel switch on in both packages
    (the JAX Pallas kernels in interpret mode, the port's plain versions):
    log-probabilities, the ClassNLL loss and the gradient tree, then 3
    ``LocalOptimizer`` SGD steps (lr 0.01, momentum 0.9);
(d) the same narrow model with the switch off in JAX, built as ``Vgg_16``
    is (separate ``ReLU`` modules), against the port's declared epilogues
    with the switch on: the epilogue route computes VGG's function;
(e) BASELINE config 2, ``VggForCifar10(10, has_dropout=False)`` at full
    width on ``parity_config("vgg")``'s draws: 3 ``LocalOptimizer`` SGD
    steps at batch 16 (the fc head's train-mode BN sees 16 values a
    channel; the last pool's rows are one element wide).

Inputs from numpy with a seed, f32, dropout off (the two packages draw
different masks). Tolerances, fixed before the first run (f32; the same
products summed in another order through a few layers; the conv/fc
epilogue sums db in another order): log-probabilities and loss 1e-5
absolute (1e-4 for (a), BN over 32x32 maps with 2 records and 16 layers);
BN state 1e-4 absolute + 1e-4 relative; the gradient tree within 1e-4 of
its norm by relative L2 (ReLU gates near zero may open in one package
only, as in ``test_torch_resnet.py``); after 3 steps, losses 1e-4, every
parameter 1e-4 absolute and the whole update within 1e-3 relative L2.

(e) has limits of its own, set after its first run (at batch 8, with the
limits above) showed the trajectories part for a reason the others do
not meet: sixteen conv/BN layers leave the two packages' f32 activations
up to ~3e-5 apart at the deep pools, and a 2x2 window whose two largest
values lie that close routes its dy to another cell in each package (one
such window at pool13 moves the step-1 gradient of every layer below it
by 5e-3 relative L2, measured at batch 16; both the JAX package and the
port route to the first maximum, so this is f32 noise, not a semantic
difference). SGD at lr 0.01, momentum 0.9 carries those moves: over four
seeds at batch 16 the readings were step-1 losses within 3.4e-6, steps
2-3 within 1.5e-3 relative, parameters within 1.2e-3 and the update
within 0.048-0.114 relative L2. So: step 1 1e-5 (the same weights, a
forward only), steps 2-3 5e-3 relative, every parameter 5e-3 absolute,
the update 0.25 relative L2 (a semantic fault, such as momentum without
dampening or a wrong BN gradient, moves it by 0.5 or more).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bigdl_tpu.nn as jnn
import bigdl_tpu.optim as joptim
from bigdl_tpu.dataset.dataset import DataSet as JDataSet
from bigdl_tpu.models.vgg import VggForCifar10 as JVggForCifar10
from bigdl_tpu.models.vgg import Vgg_16 as JVgg_16
from bigdl_tpu.models.vgg import Vgg_19 as JVgg_19
from bigdl_tpu.models.vgg import _VGG16
from bigdl_tpu.utils.engine import Engine as JEngine
from bigdl_tpu.utils.random import RandomGenerator as JRandom
from bigdl_tpu_torch import Engine, RandomGenerator
from bigdl_tpu_torch import nn as pnn
from bigdl_tpu_torch.dataset import DataSet
from bigdl_tpu_torch.models import Vgg_16, Vgg_19, VggForCifar10, parity_config
from bigdl_tpu_torch.nn import ClassNLLCriterion
from bigdl_tpu_torch.ops import fused_epilogue
from bigdl_tpu_torch.optim import SGD, LocalOptimizer, Trigger
from bigdl_tpu_torch.utils.convert import load_jax_params, load_jax_state

from test_torch_conv_bn import flat, np_tree
from test_torch_lenet import sgd_steps, update_distance

NARROW = [8, "M", 16, "M"]  # 16x16 -> 4x4 maps of 16 channels
SEED = 5


@pytest.fixture(autouse=True, scope="module")
def _engine_isolation():
    """The JAX LocalOptimizer here runs on one device (see test_torch_training.py)."""
    JEngine.reset()
    yield
    JEngine.reset()


@pytest.fixture(autouse=True)
def _policy_and_switches():
    """f32 in the port; both packages' fused-kernel switches put back after
    each test (they are process-wide)."""
    j_prev, p_prev = JEngine._state.fused_kernels, Engine._fused_kernels
    Engine.set_compute_dtype("float32")
    Engine.set_activation_dtype(None)
    yield
    Engine.set_compute_dtype(None)
    JEngine._state.fused_kernels = j_prev
    Engine._fused_kernels = p_prev


def declared_vgg(nn, cfg, hidden, class_num, has_dropout=False, **kw):
    """VGG with its ReLUs declared as the convs' and hidden fcs' epilogues
    (``activation="relu"``): the twin of ``chip_smoke.py``'s builder, for
    either package's ``nn`` (``kw`` is the port's ``device``)."""
    seq, c_in, spatial = nn.Sequential(**kw), 3, None
    for i, v in enumerate(cfg):
        if v == "M":
            seq.add(nn.SpatialMaxPooling(2, 2, 2, 2, **kw).set_name(f"pool{i}"))
        else:
            seq.add(nn.SpatialConvolution(c_in, v, 3, 3, 1, 1, 1, 1, activation="relu", **kw)
                    .set_name(f"conv{i}"))
            c_in = v
    spatial = hidden[0]
    seq.add(nn.Reshape([spatial], **kw).set_name("flatten"))
    for fc, n_in, n_out in (("fc6", spatial, hidden[1]), ("fc7", hidden[1], hidden[1])):
        seq.add(nn.Linear(n_in, n_out, activation="relu", **kw).set_name(fc))
        if has_dropout:
            seq.add(nn.Dropout(0.5, **kw).set_name(f"drop{fc[2:]}"))
    seq.add(nn.Linear(hidden[1], class_num, **kw).set_name("fc8"))
    seq.add(nn.LogSoftMax(**kw).set_name("logsoftmax"))
    return seq


def unfused_jax_vgg(cfg, hidden, class_num):
    """The same network built as the JAX ``Vgg_16`` is: ``ReLU`` modules."""
    from bigdl_tpu.models.vgg import _features

    seq = _features(cfg, batch_norm=False)
    seq.add(jnn.Reshape([hidden[0]]).set_name("flatten"))
    for fc, n_in in (("fc6", hidden[0]), ("fc7", hidden[1])):
        seq.add(jnn.Linear(n_in, hidden[1]).set_name(fc))
        seq.add(jnn.ReLU().set_name(f"{fc}_relu"))
    seq.add(jnn.Linear(hidden[1], class_num).set_name("fc8"))
    seq.add(jnn.LogSoftMax().set_name("logsoftmax"))
    return seq


def _data(n, hw, classes, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, 3, hw, hw)).astype(np.float32),
            rng.integers(0, classes, n))


# --------------------------------------------------------------------- (a)
def test_vgg_for_cifar10_matches_jax():
    x, _ = _data(2, 32, 10)
    jm = JVggForCifar10(has_dropout=False)
    jp, js = jm.init(jax.random.PRNGKey(0), sample_input=x)
    pm = VggForCifar10(has_dropout=False, device="cpu")
    pm.init(sample_input=x)
    load_jax_params(pm, np_tree(jp))
    load_jax_state(pm, np_tree(js))
    assert [m.name() for m in pm] == [m.name() for m in jm.modules]
    for training in (True, False):
        jy, jns = jm.apply(jp, js, jnp.asarray(x), training=training, rng=None)
        py, pns = pm.apply(pm.get_parameters(), pm.get_state(), torch.from_numpy(x),
                           training=training)
        np.testing.assert_allclose(py.detach().numpy(), np.asarray(jy), atol=1e-4)
        want, got = flat(np_tree(jns)), flat(pns)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], atol=1e-4, rtol=1e-4, err_msg=k)


# --------------------------------------------------------------------- (b)
@pytest.mark.parametrize("jax_model,port_model", [(JVgg_16, Vgg_16), (JVgg_19, Vgg_19)],
                         ids=["vgg16", "vgg19"])
def test_imagenet_vgg_parameter_tree_matches_jax(jax_model, port_model):
    x = np.zeros((1, 3, 224, 224), np.float32)
    jm = jax_model()
    jp, js = jm.init(jax.random.PRNGKey(0), sample_input=x)
    want = {k: (v.shape, str(v.dtype)) for k, v in flat(np_tree(jp)).items()}
    pm = port_model(device="meta")
    pm.init(sample_input=x)
    got = {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
           for k, v in pm.named_parameters()}
    assert got == want
    assert [m.name() for m in pm] == [m.name() for m in jm.modules]
    assert flat(pm.get_state()) == {} and flat(np_tree(js)) == {}
    if jax_model is JVgg_16:  # the JAX tree loads into both port builds
        tree = np_tree(jp)
        load_jax_params(pm, tree)
        declared = declared_vgg(pnn, _VGG16, (512 * 7 * 7, 4096), 1000, has_dropout=True,
                                device="meta")
        declared.init(sample_input=x)
        load_jax_params(declared, tree)
        load_jax_state(declared, np_tree(js))
        assert {k for k, _ in declared.named_parameters()} == set(want)


# --------------------------------------------------------------------- (c), (d)
def _jax_run(jm, x, y, steps):
    """Loss, log-probabilities and gradients of one f32 train step, then the
    parameters after ``steps`` LocalOptimizer SGD steps; and the initial weights."""
    JRandom.set_seed(SEED)
    jp, js = jm.init(jax.random.PRNGKey(SEED), sample_input=x[:4])
    init = np_tree(jp)
    crit = jnn.ClassNLLCriterion()

    def loss_fn(p):
        out, _ = jm.apply(p, js, jnp.asarray(x[:4]), training=True, rng=None)
        return crit._apply(out, jnp.asarray(y[:4])), out

    (loss, out), grads = jax.value_and_grad(loss_fn, has_aux=True)(jp)
    losses = []

    class Recording(joptim.LocalOptimizer):
        def _log_iteration(self, state, loss, records, wall, throughput):
            losses.append(float(loss))

    opt = Recording(jm, JDataSet.array(x, y, batch_size=4), jnn.ClassNLLCriterion())
    opt.set_optim_method(joptim.SGD(learningrate=0.01, momentum=0.9))
    opt.set_end_when(joptim.Trigger.max_iteration(steps)).optimize()
    return dict(init=init, loss=float(loss), out=np.asarray(out), grads=flat(np_tree(grads)),
                losses=losses, params=flat(np_tree(jm.get_parameters())))


def _port_run(init, x, y, steps):
    RandomGenerator.set_seed(SEED)
    pm = declared_vgg(pnn, NARROW, (16 * 4 * 4, 32), 10, device="cpu")
    pm.init(sample_input=x[:4])
    load_jax_params(pm, init)
    out, _ = pm.apply(pm.get_parameters(), pm.get_state(), torch.from_numpy(x[:4]),
                      training=True)
    loss = ClassNLLCriterion()._apply(out, y[:4])
    loss.backward()
    grads = {k: p.grad.numpy().copy() for k, p in pm.named_parameters()}
    pm.zero_grad(set_to_none=True)
    opt = LocalOptimizer(pm, DataSet.array(x, y, batch_size=4), ClassNLLCriterion())
    opt.set_optim_method(SGD(learningrate=0.01, momentum=0.9))
    opt.set_end_when(Trigger.max_iteration(steps)).optimize()
    return dict(loss=loss.item(), out=out.detach().numpy(), grads=grads,
                losses=[h["loss"] for h in opt.history], params=flat(pm.get_parameters()))


def _compare(want, got):
    assert abs(got["loss"] - want["loss"]) <= 1e-5
    np.testing.assert_allclose(got["out"], want["out"], atol=1e-5)
    g, w = got["grads"], want["grads"]
    assert set(g) == set(w)
    dist = np.sqrt(sum(np.sum((g[k] - w[k]) ** 2) for k in w))
    assert dist <= 1e-4 * np.sqrt(sum(np.sum(v ** 2) for v in w.values()))
    np.testing.assert_allclose(got["losses"], want["losses"], atol=1e-4)
    p, q, p0 = got["params"], want["params"], flat(want["init"])
    assert set(p) == set(q)
    for k in q:
        np.testing.assert_allclose(p[k], q[k], atol=1e-4, err_msg=k)
    update = np.sqrt(sum(np.sum((q[k] - p0[k]) ** 2) for k in q))
    assert np.sqrt(sum(np.sum((p[k] - q[k]) ** 2) for k in q)) <= 1e-3 * update


@pytest.mark.parametrize("jax_switch", [True, False], ids=["jax_fused", "jax_unfused"])
def test_declared_epilogue_vgg_trains_like_jax(jax_switch):
    x, y = _data(8, 16, 10, seed=1)
    JEngine.set_fused_kernels(jax_switch)
    Engine.set_fused_kernels(True)
    hidden = (16 * 4 * 4, 32)
    jm = declared_vgg(jnn, NARROW, hidden, 10) if jax_switch else \
        unfused_jax_vgg(NARROW, hidden, 10)
    want = _jax_run(jm, x, y, steps=3)
    counts = (fused_epilogue.launches_fwd, fused_epilogue.launches_bwd_feature,
              fused_epilogue.launches_bwd_row)
    got = _port_run(want["init"], x, y, steps=3)
    assert (fused_epilogue.launches_fwd, fused_epilogue.launches_bwd_feature,
            fused_epilogue.launches_bwd_row) == counts  # CPU tensors: plain versions only
    assert len(got["losses"]) == len(want["losses"]) == 3
    _compare(want, got)


# --------------------------------------------------------------------- (e)
def test_vgg_for_cifar10_parity_config_trains_like_jax():
    _, x, y, _ = parity_config("vgg", 48, device="cpu")
    run = sgd_steps(JVggForCifar10(10, has_dropout=False),
                    VggForCifar10(10, has_dropout=False, device="cpu"), x, y, batch=16)
    (first, *rest), (jfirst, *jrest) = run["losses"], run["jax_losses"]
    assert len(rest) == len(jrest) == 2
    assert abs(first - jfirst) <= 1e-5
    np.testing.assert_allclose(rest, jrest, rtol=5e-3)
    for k, v in run["jax_params"].items():
        np.testing.assert_allclose(run["params"][k], v, atol=5e-3, err_msg=k)
    assert update_distance(run) <= 0.25
