"""The port's regularizers against the JAX package's: each regularizer's
penalty and gradient, each layer's ``regularization_loss`` (``Linear``,
``SparseLinear`` through it, ``SpatialConvolution``, ``LookupTable``,
``LSTM``), a module tree's ``regularization_loss_tree`` (nested
containers, a ``Recurrent`` and a ``BiRecurrent``), and ``LocalOptimizer``
training a regularized MLP against the JAX ``LocalOptimizer`` (a padded
ragged tail, micro-batches): the logged losses carry the penalty once.

Weights from numpy with a seed (the JAX modules' carried over). Tolerances:
a penalty and its gradient 1e-6 relative (f32 sums of a few hundred terms
in another order); the training runs as ``test_torch_optim_features.py``
holds them, 1e-5 absolute and relative on the losses, parameters and BN
state.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bigdl_tpu.nn as jnn
import bigdl_tpu.optim.regularizer as jreg
from bigdl_tpu_torch import Engine
from bigdl_tpu_torch import nn as pnn
from bigdl_tpu_torch.optim import regularizer as preg
from bigdl_tpu_torch.utils.convert import load_jax_params

from test_torch_conv_bn import flat, np_tree
from test_torch_optim_features import _assert_same_training, _run_both

RTOL = 1e-6


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


REGS = [("L1L2Regularizer", (0.01, 0.02)), ("L1L2Regularizer", (0.0, 0.3)),
        ("L1L2Regularizer", (0.2, 0.0)), ("L1L2Regularizer", ()), ("L1Regularizer", (0.05,)),
        ("L2Regularizer", (0.1,))]


@pytest.mark.parametrize("name,args", REGS, ids=[f"{n}{a}" for n, a in REGS])
def test_regularizer_matches_jax(name, args):
    w = np.random.default_rng(0).standard_normal((7, 5)).astype(np.float32)
    jr, pr = getattr(jreg, name)(*args), getattr(preg, name)(*args)
    want = jr(jnp.asarray(w))
    wt = torch.from_numpy(w).requires_grad_()
    got = pr(wt)
    if not isinstance(got, torch.Tensor):  # both coefficients zero: the float 0.0
        assert got == want == 0.0
        return
    np.testing.assert_allclose(got.item(), float(want), rtol=RTOL)
    (g,) = torch.autograd.grad(got, wt)
    np.testing.assert_allclose(g.numpy(), np.asarray(jax.grad(jr)(jnp.asarray(w))), rtol=RTOL,
                               atol=1e-7)


def test_l2_term_is_half_l2_sum_of_squares():
    w = torch.tensor([1.0, -2.0, 3.0])
    assert preg.L2Regularizer(0.1)(w).item() == pytest.approx(0.5 * 0.1 * 14.0)
    assert preg.L1Regularizer(0.1)(w).item() == pytest.approx(0.6)


def test_l1_gradient_at_zero_is_the_jax_packages():
    """``jnp.abs``'s gradient at 0 is +1 (torch.abs's is 0); the port's L1
    term takes the JAX package's, also on -0.0."""
    w = np.array([0.0, -0.0, 2.0, -3.0], np.float32)
    wt = torch.from_numpy(w).requires_grad_()
    (g,) = torch.autograd.grad(preg.L1Regularizer(0.5)(wt), wt)
    np.testing.assert_array_equal(
        g.numpy(), np.asarray(jax.grad(jreg.L1Regularizer(0.5))(jnp.asarray(w))))
    np.testing.assert_array_equal(g.numpy(), [0.5, 0.5, 0.5, -0.5])


def _regs(nn):
    return jreg if nn is jnn else preg


def _lstm_cell(nn, d):
    r = _regs(nn)
    return nn.LSTM(5, 4, w_regularizer=r.L2Regularizer(0.1), u_regularizer=r.L1Regularizer(0.02),
                   b_regularizer=r.L1L2Regularizer(0.01, 0.03), **d)


LAYERS = {
    "Linear": (lambda nn, d: nn.Linear(6, 4, w_regularizer=_regs(nn).L1L2Regularizer(0.01, 0.02),
                                       b_regularizer=_regs(nn).L2Regularizer(0.5), **d),
               (3, 6), "float"),
    "Linear-no-bias": (lambda nn, d: nn.Linear(6, 4, with_bias=False,
                                               w_regularizer=_regs(nn).L1Regularizer(0.1),
                                               b_regularizer=_regs(nn).L2Regularizer(0.5), **d),
                       (3, 6), "float"),
    "SparseLinear": (lambda nn, d: nn.SparseLinear(6, 4, w_regularizer=_regs(nn).L2Regularizer(
        0.2), **d), (3, 6), "float"),
    "SpatialConvolution": (lambda nn, d: nn.SpatialConvolution(
        3, 4, 3, 3, w_regularizer=_regs(nn).L1L2Regularizer(0.01, 0.02),
        b_regularizer=_regs(nn).L1Regularizer(0.3), **d), (2, 3, 6, 6), "float"),
    "LookupTable": (lambda nn, d: nn.LookupTable(9, 5, w_regularizer=_regs(nn).L2Regularizer(
        0.05), **d), (2, 4), "ids"),
    "LSTM": (_lstm_cell, (3, 5), "float"),
}


def _sample(shape, kind):
    rng = np.random.default_rng(1)
    if kind == "ids":
        return rng.integers(0, 9, shape).astype(np.int32)
    return rng.standard_normal(shape).astype(np.float32)


def _pair(build, x):
    jm = build(jnn, {})
    jp, _ = jm.init(jax.random.PRNGKey(3), sample_input=x)
    pm = build(pnn, {"device": "cpu"})
    pm.init(sample_input=torch.from_numpy(x))
    load_jax_params(pm, np_tree(jp))
    return jm, jp, pm


def _assert_penalty_matches(jm, jp, pm):
    want = jm.regularization_loss_tree(jp)
    got = pm.regularization_loss_tree(pm.get_parameters())
    np.testing.assert_allclose(got.item(), float(want), rtol=RTOL)
    jgrad = flat(np_tree(jax.grad(lambda p: jm.regularization_loss_tree(p))(jp)))
    leaves = dict(pm.named_parameters())
    grads = dict(zip(leaves, torch.autograd.grad(got, list(leaves.values()), allow_unused=True)))
    for k, want_g in jgrad.items():
        g = grads[k]
        g = np.zeros_like(want_g) if g is None else g.numpy()
        np.testing.assert_allclose(g, want_g, rtol=RTOL, atol=1e-7, err_msg=k)
    return got.item()


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layer_regularization_loss_matches_jax(name):
    build, shape, kind = LAYERS[name]
    jm, jp, pm = _pair(build, _sample(shape, kind))
    np.testing.assert_allclose(pm.regularization_loss(pm.get_parameters()).item(),
                               float(jm.regularization_loss(jp)), rtol=RTOL)
    assert _assert_penalty_matches(jm, jp, pm) > 0


def test_layers_without_regularizers_add_nothing():
    m = pnn.Linear(3, 2, device="cpu")
    m.init(sample_input=torch.zeros(1, 3))
    assert m.regularization_loss(m.get_parameters()) == 0.0
    assert pnn.ReLU(device="cpu").regularization_loss_tree({}) == 0.0


def _tree(nn, d):
    r = _regs(nn)
    inner = nn.Sequential(
        nn.SpatialConvolution(3, 4, 3, 3, 1, 1, 1, 1, w_regularizer=r.L2Regularizer(0.1), **d),
        nn.ReLU(**d), nn.SpatialConvolution(4, 2, 3, 3, b_regularizer=r.L1Regularizer(0.2), **d),
        **d)
    return nn.Sequential(inner, nn.Reshape([2 * 4 * 4], **d),
                         nn.Linear(32, 5, w_regularizer=r.L1L2Regularizer(0.01, 0.02), **d),
                         nn.Tanh(**d), nn.Linear(5, 3, **d), **d)


def _rnn_tree(nn, d):
    r = _regs(nn)
    return nn.Sequential(
        nn.LookupTable(9, 5, w_regularizer=r.L1Regularizer(0.01), **d),
        nn.BiRecurrent(_lstm_cell(nn, d), **d),
        nn.Recurrent(nn.LSTM(4, 3, w_regularizer=r.L2Regularizer(0.3), **d), **d),
        nn.Select(2, -1, **d),
        nn.Linear(3, 2, b_regularizer=r.L2Regularizer(1.0), **d), **d)


@pytest.mark.parametrize("build,shape,kind", [(_tree, (2, 3, 6, 6), "float"),
                                              (_rnn_tree, (2, 4), "ids")],
                         ids=["conv-tree", "rnn-tree"])
def test_module_tree_sums_its_layers(build, shape, kind):
    """Nested Sequentials, a BiRecurrent (whose reverse cell is a copy with
    the same regularizers) and a Recurrent: the tree's penalty and its
    gradient on every parameter equal the JAX package's, and equal the sum
    of the layers' own."""
    jm, jp, pm = _pair(build, _sample(shape, kind))
    total = _assert_penalty_matches(jm, jp, pm)
    layers = [m for m in pm.modules() if hasattr(m, "regularization_loss")]
    own = 0.0
    for m in layers:
        own = own + m.regularization_loss(m.get_parameters())
    assert total == pytest.approx(own.item(), rel=1e-6) and total > 0


def reg_mlp(nn, d):
    r = _regs(nn)
    return nn.Sequential(nn.Linear(6, 16, w_regularizer=r.L1L2Regularizer(0.01, 0.05),
                                   b_regularizer=r.L2Regularizer(0.1), **d),
                         nn.ReLU(**d),
                         nn.Linear(16, 3, w_regularizer=r.L1Regularizer(0.02), **d),
                         nn.LogSoftMax(**d), **d)


@pytest.mark.parametrize("micro", [1, 2])
@pytest.mark.parametrize("tail", [False, True], ids=["full", "padded-tail"])
def test_local_optimizer_trains_a_regularized_mlp_like_jax(tail, micro):
    """The penalty joins the loss in both packages: each logged loss (the
    criterion's plus the penalty), the parameters after 3 epochs. 20
    records at batch 8 with ``tail`` (each epoch's 4-row tail padded to 8
    and masked: the penalty is added once), else 24."""
    jopt, popt, jm, pm = _run_both(reg_mlp, n=20 if tail else 24, tail=tail, epochs=3,
                                   configure=lambda o: o.set_micro_batches(micro))
    _assert_same_training(jopt, popt, jm, pm)
    if tail:
        assert [h["records"] for h in popt.history] == [8, 8, 4] * 3


def test_logged_loss_is_criterion_plus_penalty():
    """One step: the logged loss minus the criterion's loss of the same
    forward equals the penalty at the step's starting weights."""
    from bigdl_tpu_torch import optim as poptim
    from bigdl_tpu_torch.dataset import LocalArrayDataSet

    rng = np.random.default_rng(4)
    x, y = rng.standard_normal((8, 6)).astype(np.float32), rng.integers(0, 3, 8)
    pm = reg_mlp(pnn, {"device": "cpu"})
    pm.init(sample_input=torch.from_numpy(x))
    with torch.no_grad():
        crit = pnn.ClassNLLCriterion()._apply(pm.forward(x), torch.from_numpy(y)).item()
        pen = float(pm.regularization_loss_tree(pm.get_parameters()))
    opt = poptim.LocalOptimizer(pm, LocalArrayDataSet(x, y, batch_size=8),
                                pnn.ClassNLLCriterion())
    opt.set_optim_method(poptim.SGD(learningrate=0.1)).set_end_when(
        poptim.Trigger.max_iteration(1)).optimize()
    assert pen > 0.05
    assert opt.history[0]["loss"] - crit == pytest.approx(pen, rel=1e-5)


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run on the card with "
                    "`python -m pytest -m gpu tests/test_torch_regularizer.py`")


@pytest.mark.gpu
def test_regularized_training_on_card_matches_cpu(cuda_card):
    """3 SGD steps of the regularized MLP on the card against the same on
    the CPU (f32, TF32 off): the logged losses, penalty included, within
    1e-5 (f32 sums in another order)."""
    from bigdl_tpu_torch import RandomGenerator
    from bigdl_tpu_torch import optim as poptim
    from bigdl_tpu_torch.dataset import LocalArrayDataSet

    rng = np.random.default_rng(6)
    x, y = rng.standard_normal((24, 6)).astype(np.float32), rng.integers(0, 3, 24)
    losses = {}
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for dev in ("cpu", "cuda"):
            RandomGenerator.set_seed(2)
            m = reg_mlp(pnn, {"device": "cpu"})
            m.init(sample_input=torch.from_numpy(x))
            m.to(dev)
            opt = poptim.LocalOptimizer(m, LocalArrayDataSet(x, y, batch_size=8),
                                        pnn.ClassNLLCriterion())
            opt.set_optim_method(poptim.SGD(learningrate=0.1, momentum=0.9)).set_end_when(
                poptim.Trigger.max_iteration(3)).optimize()
            losses[dev] = [h["loss"] for h in opt.history]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-5, atol=1e-5)
