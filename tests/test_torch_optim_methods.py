"""The port's other optimization methods against the JAX package's
``update``: ``ParallelAdam``, ``Adagrad``, ``Adadelta``, ``Adamax``,
``RMSprop``, ``Ftrl``, ``Lamb`` and ``LarsSGD``, each over 5 steps on one
two-level parameter tree, parametrised over its options (weight decay,
exclusions, ``trust``, ``Ftrl``'s l1/l2 and power, a leaf whose gradient is
all zero for ``Adamax``), plus the eager ``optimize(feval, params)``.

Parameters and gradients from numpy with a seed; both packages see the same
values and the same learning rate each step (the ``Default`` schedule, with
decay where the method has one). Tolerance: f32, 1e-6 absolute and 1e-5
relative: the same elementwise arithmetic rounded in another order, and
the per-leaf norms of ``Lamb``/``LarsSGD`` summed in another order. The
methods with bias corrections (``ParallelAdam``, ``Adamax``, ``Lamb``) get
``BIAS_ATOL`` more: the JAX package takes ``1 - beta**t`` in float32 from a
float32 ``beta``, the port in Python floats, and float32's 0.999 is
1.3e-8 off, which is 1.3e-5 of ``1 - 0.999`` (t = 1); through the square
root that moves a step (at most ~lr) by 6.5e-6 of itself, so 5 steps may
part by 5 · lr · 1.3e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bigdl_tpu.optim as joptim
from bigdl_tpu_torch import optim as poptim
from bigdl_tpu_torch.optim.optim_method import _leaves

ATOL, RTOL = 1e-6, 1e-5
STEPS = 5
ZERO_LEAF = "['block0']['fc_b']"
BIAS_CORRECTED = ("Adam", "ParallelAdam", "Adamax", "Lamb")


def _bias_atol(method) -> float:
    """BIAS_ATOL for the method's first learning rate (see the docstring)."""
    if type(method).__name__ not in BIAS_CORRECTED:
        return 0.0
    return STEPS * method.learningrate * 1.3e-5


def _tree(seed, zero_leaf=False):
    rs = np.random.RandomState(seed)
    tree = {"block0": {"fc_w": rs.randn(3, 4).astype(np.float32),
                       "fc_b": rs.randn(3).astype(np.float32),
                       "conv_bn": {"weight": rs.randn(5).astype(np.float32)}},
            "head_w": rs.randn(2, 3).astype(np.float32)}
    if zero_leaf:
        tree["block0"]["fc_b"][:] = 0.0
    return tree


def _map(fn, tree):
    return {k: (_map(fn, v) if isinstance(v, dict) else fn(v)) for k, v in tree.items()}


def _jax_leaves(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _run(jmethod, pmethod, zero_grad_leaf=False):
    """5 steps in both packages from the same parameters and gradients;
    returns the port's parameters and slots. With ``zero_grad_leaf`` the
    leaf ``['block0']['fc_b']`` gets an all-zero gradient and is left out of
    the comparison (see the Adamax test)."""
    params = _tree(0)
    jp = _map(jnp.asarray, params)
    pp = _map(torch.from_numpy, _map(np.copy, params))
    jslots, pslots = jmethod.init_slots(jp), pmethod.init_slots(pp)
    for step in range(1, STEPS + 1):
        grads = _tree(step, zero_leaf=zero_grad_leaf)
        jlr, plr = jmethod.get_learning_rate(), pmethod.get_learning_rate()
        assert plr == pytest.approx(jlr)
        jp, jslots = jmethod.update(_map(jnp.asarray, grads), jp, jslots,
                                    jnp.asarray(jlr), jnp.asarray(step))
        out, _ = pmethod.update(_map(torch.from_numpy, grads), pp, pslots, plr, step)
        assert out is pp  # in place
        for m in (jmethod, pmethod):
            m.state["neval"] += 1
    atol = ATOL + _bias_atol(pmethod)
    for name, want_tree, got_tree in [("params", jp, pp)] + [
            (k, jslots[k], pslots[k]) for k in jslots]:
        want = _jax_leaves(want_tree)
        got = dict(_leaves(got_tree))
        assert set(got) == set(want), name
        for path, g in got.items():
            if zero_grad_leaf and path == ZERO_LEAF:
                continue
            np.testing.assert_allclose(g.numpy(), want[path], atol=atol, rtol=RTOL,
                                       err_msg=f"{name} {path}")
    return pp, pslots


CASES = [
    ("ParallelAdam", dict(learningrate=0.01)),
    ("ParallelAdam", dict(learningrate=0.05, learningrate_decay=0.2, beta1=0.8)),
    ("Adagrad", dict(learningrate=0.1)),
    ("Adagrad", dict(learningrate=0.1, learningrate_decay=0.1, weightdecay=0.01)),
    ("Adadelta", dict()),
    ("Adadelta", dict(decayrate=0.5, epsilon=1e-6)),
    ("Adamax", dict()),
    ("Adamax", dict(learningrate=0.01, beta1=0.5, beta2=0.9, epsilon=1e-8)),
    ("RMSprop", dict()),
    ("RMSprop", dict(learningrate=0.05, learningrate_decay=0.3, decayrate=0.9,
                     epsilon=1e-6)),
    ("Ftrl", dict(learningrate=0.1)),
    ("Ftrl", dict(learningrate=0.1, l1_regularization_strength=0.5,
                  l2_regularization_strength=0.2)),
    ("Ftrl", dict(learningrate=0.05, learningrate_power=-0.7, initial_accumulator_value=0.5,
                  l1_regularization_strength=0.01)),
    ("Lamb", dict(learningrate=0.01)),
    ("Lamb", dict(learningrate=0.01, weightdecay=0.1)),
    ("Lamb", dict(learningrate=0.02, learningrate_decay=0.1, beta1=0.8, weightdecay=0.1,
                  weightdecay_exclude=("_bn", "_b'"))),
    ("LarsSGD", dict(learningrate=0.1)),
    ("LarsSGD", dict(trust=0.02, learningrate=0.5, momentum=0.9)),
    ("LarsSGD", dict(trust=0.01, learningrate=0.5, momentum=0.9, weightdecay=0.01)),
    ("LarsSGD", dict(trust=0.5, learningrate=0.1, momentum=0.9, dampening=0.0, nesterov=True,
                     weightdecay=0.05, weightdecay_exclude=("_bn",))),
]


@pytest.mark.parametrize("name,kw", CASES, ids=[f"{n}-{i}" for i, (n, _) in enumerate(CASES)])
def test_method_matches_jax(name, kw):
    jm, pm = getattr(joptim, name)(**kw), getattr(poptim, name)(**kw)
    assert pm.elementwise == jm.elementwise
    _, slots = _run(jm, pm)
    assert set(slots) == set(jm.init_slots(_map(jnp.asarray, _tree(0))))


@pytest.mark.parametrize("kw", [dict(), dict(learningrate=0.01, beta1=0.5)])
def test_adamax_zero_gradient_leaf_stays_finite(kw):
    """A leaf whose gradient is all zero: ``u`` holds the float32
    subnormal 1e-38 (``|0| + epsilon``), so ``m / u`` is 0/1e-38 = 0 and the
    leaf stays where it was; every other leaf as in the JAX package. (The
    JAX package's CPU backend flushes subnormals to zero, so there ``u`` is
    0 and the leaf becomes 0/0 = NaN: that leaf is not compared.)"""
    pp, slots = _run(joptim.Adamax(**kw), poptim.Adamax(**kw), zero_grad_leaf=True)
    b = pp["block0"]["fc_b"]
    assert torch.isfinite(b).all()
    np.testing.assert_array_equal(b.numpy(), _tree(0)["block0"]["fc_b"])
    assert (slots["u"]["block0"]["fc_b"] > 0).all()


def test_adadelta_fixes_the_rate_and_ftrl_starts_its_accumulator():
    assert poptim.Adadelta().learningrate == 1.0 == joptim.Adadelta().learningrate
    slots = poptim.Ftrl(initial_accumulator_value=0.25).init_slots(
        _map(torch.from_numpy, _tree(0)))
    assert all((v == 0.25).all() for _, v in _leaves(slots["accum"]))
    assert all((v == 0).all() for _, v in _leaves(slots["linear"]))
    assert issubclass(poptim.ParallelAdam, poptim.Adam)


def test_lars_decay_comes_after_the_trust_ratio():
    """LarsSGD scales the gradient by its trust ratio and THEN runs SGD's
    update, whose weight decay is added unscaled: one step from p with
    gradient g is p - lr * (r*g + wd*p)."""
    p = {"w": torch.tensor([3.0, 4.0])}
    g = {"w": torch.tensor([0.6, 0.8])}
    m = poptim.LarsSGD(trust=0.1, learningrate=0.5, weightdecay=0.2)
    m.update(g, p, m.init_slots(p), 0.5, 1)
    r = 0.1 * 5.0 / (1.0 + 0.2 * 5.0 + 1e-12)
    want = np.array([3.0, 4.0]) - 0.5 * (r * np.array([0.6, 0.8]) + 0.2 * np.array([3.0, 4.0]))
    np.testing.assert_allclose(p["w"].numpy(), want, rtol=1e-6)


@pytest.mark.parametrize("name,kw", [("Adagrad", dict(learningrate=0.1)),
                                     ("Lamb", dict(learningrate=0.01, weightdecay=0.1))])
def test_eager_optimize_matches_jax(name, kw):
    """``optimize(feval, params)``: one step a call, ``neval`` advanced, the
    slots kept on the method; a quadratic's loss and gradient in both."""
    target = _tree(7)

    def jfeval(params):
        d = jax.tree_util.tree_map(lambda p, t: p - t, params, _map(jnp.asarray, target))
        return (sum(jnp.sum(v * v) for v in jax.tree_util.tree_leaves(d)),
                jax.tree_util.tree_map(lambda v: 2 * v, d))

    def pfeval(params):
        d = {k: v for k, v in _leaves(params)}
        t = dict(_leaves(_map(torch.from_numpy, target)))
        loss = sum(torch.sum((d[k] - t[k]) ** 2) for k in d)
        return loss, _map_paths(params, lambda path, v: 2 * (v - t[path]))

    jm, pm = getattr(joptim, name)(**kw), getattr(poptim, name)(**kw)
    jp, pp = _map(jnp.asarray, _tree(0)), _map(torch.from_numpy, _tree(0))
    for _ in range(3):
        jp, jloss = jm.optimize(jfeval, jp)
        pp, ploss = pm.optimize(pfeval, pp)
        np.testing.assert_allclose(float(ploss), float(jloss), rtol=RTOL)
    assert pm.state["neval"] == jm.state["neval"] == 4
    want = _jax_leaves(jp)
    for path, got in _leaves(pp):
        np.testing.assert_allclose(got.numpy(), want[path], atol=ATOL + _bias_atol(pm),
                                   rtol=RTOL, err_msg=path)


def _map_paths(tree, fn, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}[{k!r}]"
        out[k] = _map_paths(v, fn, path) if isinstance(v, dict) else fn(path, v)
    return out


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run on the card with "
                    "`python -m pytest -m gpu tests/test_torch_optim_methods.py`")


@pytest.mark.gpu
@pytest.mark.parametrize("name,kw", CASES, ids=[f"{n}-{i}" for i, (n, _) in enumerate(CASES)])
def test_method_on_card_matches_cpu(cuda_card, name, kw):
    """5 steps on the card against the same 5 on the CPU (f32): the same
    elementwise ops; norms and rounding of another order only."""
    cpu_m, card_m = getattr(poptim, name)(**kw), getattr(poptim, name)(**kw)
    cp = _map(torch.from_numpy, _tree(0))
    gp = _map(lambda t: t.cuda(), _map(torch.from_numpy, _tree(0)))
    cs, gs = cpu_m.init_slots(cp), card_m.init_slots(gp)
    for step in range(1, STEPS + 1):
        g = _map(torch.from_numpy, _tree(step, zero_leaf=name == "Adamax"))
        cpu_m.update(g, cp, cs, cpu_m.get_learning_rate(), step)
        card_m.update(_map(lambda t: t.cuda(), g), gp, gs, card_m.get_learning_rate(), step)
        for m in (cpu_m, card_m):
            m.state["neval"] += 1
    want = dict(_leaves(cp))
    for path, got in _leaves(gp):
        assert torch.isfinite(got).all(), path
        np.testing.assert_allclose(got.cpu().numpy(), want[path].numpy(), atol=ATOL, rtol=RTOL,
                                   err_msg=path)


def test_leaf_norms_are_float64_sums_rounded_once():
    """Lamb's and LARS's per-leaf norms: one float64 sum rounded to the
    leaf's dtype, so the CPU and the card agree whatever the leaf's size
    (a 2.4 M-element leaf, a 3x3x512x512 convolution's)."""
    from bigdl_tpu_torch.optim.optim_method import _norm

    x = torch.from_numpy(np.random.default_rng(3).standard_normal(2_359_296).astype(np.float32))
    got = _norm(x)
    assert got.dtype == torch.float32
    assert got.item() == np.float32(np.sqrt(np.sum(x.numpy().astype(np.float64) ** 2)))
