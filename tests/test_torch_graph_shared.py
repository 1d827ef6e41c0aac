"""Graphs with shared modules: the port's ``Graph`` against the JAX package's.

A module wired at several nodes registers once, as one child with one
parameter set; its gradient is the sum over its sites; every site reads
the module's pre-forward state and the last site's new state is kept.

* the JAX serializer test's tied ``Linear`` graph (one encoder at two
  nodes, summed): forward and gradients;
* a Siamese CIFAR ``ResNet(8)`` trunk at two nodes of an outer graph, with
  ``CosineEmbeddingCriterion(margin=0.5)`` on ±1 targets: the train-mode
  forward, the loss, every parameter gradient and the BN state after one
  training forward, then 3 ``LocalOptimizer`` SGD steps (lr 0.01, momentum
  0.9) against the JAX ``LocalOptimizer``'s.

Inputs from numpy with a seed, weights the JAX model's copied over, f32 on
the CPU. Tolerances, fixed before the first run: outputs, losses, gradients
and BN statistics 1e-5 absolute plus 1e-4 relative (the same f32 products
summed in another order through eight conv/BN layers, BN normalising by
batch statistics); after 3 steps, losses 1e-5 absolute, every parameter
1e-5 absolute and the whole update within 1e-3 relative L2 (as the other
ResNet parity tests).
"""

import gc
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bigdl_tpu.nn as jnn
import bigdl_tpu.optim as joptim
from bigdl_tpu.dataset.dataset import DataSet as JDataSet
from bigdl_tpu.models import ResNet as JResNet
from bigdl_tpu.utils.random import RandomGenerator as JRandom
from bigdl_tpu.utils.table import T as JT
from bigdl_tpu_torch import RandomGenerator
from bigdl_tpu_torch.utils.table import T
from bigdl_tpu_torch import nn as pnn
from bigdl_tpu_torch.dataset import DataSet
from bigdl_tpu_torch.models import ResNet
from bigdl_tpu_torch.optim import SGD, LocalOptimizer, Trigger
from bigdl_tpu_torch.utils.convert import load_jax_params, load_jax_state

from test_torch_conv_bn import flat, np_tree
from test_torch_lenet import _Recording, update_distance
from test_torch_lenet import _engine_isolation, _fp32_policy  # noqa: F401 (fixtures)

ATOL, RTOL = 1e-5, 1e-4
SEED = 7


def _tied(nn, **d):
    """The JAX serializer test's graph: one Linear at two nodes, summed."""
    inp_a, inp_b = nn.Input(), nn.Input()
    enc = nn.Linear(6, 4, **d).set_name("enc")
    merged = nn.CAddTable(**d).set_name("sum").inputs(enc.inputs(inp_a), enc.inputs(inp_b))
    return nn.Graph([inp_a, inp_b], merged, **d)


def siamese(nn, trunk, **d):
    """``trunk`` at two nodes of an outer graph: Table(a, b) -> Table(emb_a, emb_b)."""
    in_a, in_b = nn.Input(), nn.Input()
    return nn.Graph([in_a, in_b], [trunk.inputs(in_a), trunk.inputs(in_b)], **d)


def _pairs(n, seed=0):
    rng = np.random.default_rng(seed)
    xa = rng.standard_normal((n, 3, 16, 16)).astype(np.float32)
    xb = rng.standard_normal((n, 3, 16, 16)).astype(np.float32)
    return xa, xb, np.where(rng.random(n) < 0.5, 1.0, -1.0).astype(np.float32)


def _models():
    jm = siamese(jnn, JResNet(8, class_num=10, dataset="cifar10").set_name("tower"))
    pm = siamese(pnn, ResNet(8, class_num=10, dataset="cifar10", device="cpu")
                 .set_name("tower"), device="cpu")
    return jm, pm


def _grads_and_state(jm, pm, xa, xb, y):
    """Train-mode forward, loss, parameter gradients and new state of both."""
    jp, js = jm.init(jax.random.PRNGKey(SEED), sample_input=JT(xa, xb))
    pm.init(sample_input=T(torch.from_numpy(xa), torch.from_numpy(xb)))
    load_jax_params(pm, np_tree(jp))
    load_jax_state(pm, np_tree(js))
    jcrit, pcrit = jnn.CosineEmbeddingCriterion(margin=0.5), pnn.CosineEmbeddingCriterion(0.5)

    def jloss(p):
        out, ns = jm.apply(p, js, JT(jnp.asarray(xa), jnp.asarray(xb)), training=True)
        return jcrit._apply(out, jnp.asarray(y)), (out, ns)

    (jl, (jout, jns)), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jp)
    out, ns = pm.apply(pm.get_parameters(), pm.get_state(),
                       T(torch.from_numpy(xa), torch.from_numpy(xb)), training=True)
    loss = pcrit._apply(out, torch.from_numpy(y))
    names = [k for k, _ in pm.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in pm.named_parameters()])
    return (dict(out=[np.asarray(o) for o in jout], loss=float(jl), grads=flat(np_tree(jg)),
                 state=flat(np_tree(jns))),
            dict(out=[o.detach().numpy() for o in out], loss=float(loss.detach()),
                 grads={n: g.numpy() for n, g in zip(names, grads)}, state=flat(ns)))


def test_tied_linear_graph_matches_jax():
    rng = np.random.default_rng(51)
    xa, xb = rng.standard_normal((3, 6)).astype(np.float32), rng.standard_normal(
        (3, 6)).astype(np.float32)
    jg, pg = _tied(jnn), _tied(pnn, device="cpu")
    jp, js = jg.init(jax.random.PRNGKey(0), sample_input=JT(xa, xb))
    pg.init(sample_input=T(torch.from_numpy(xa), torch.from_numpy(xb)))
    load_jax_params(pg, np_tree(jp))
    assert [m.name() for m in pg.children()] == ["enc", "sum"]  # one registered child
    assert [n for n, _ in pg.named_parameters()] == ["enc.weight", "enc.bias"]

    def jf(p):
        return jnp.sum(jg.apply(p, js, JT(jnp.asarray(xa), jnp.asarray(xb)))[0] ** 2)

    jl, jgrad = jax.value_and_grad(jf)(jp)
    y, _ = pg.apply(pg.get_parameters(), pg.get_state(),
                    T(torch.from_numpy(xa), torch.from_numpy(xb)))
    loss = torch.sum(y ** 2)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl), atol=ATOL, rtol=RTOL)
    for k, v in flat(np_tree(jgrad)).items():
        np.testing.assert_allclose(flat(pg.get_grad_parameters())[k], v, atol=ATOL, rtol=RTOL,
                                   err_msg=k)
    # the shared gradient is the sum of the two sites' gradients
    w = pg.get_parameters()["enc"]["weight"]
    gx = torch.autograd.grad(torch.sum((torch.from_numpy(xa) @ w.t()
                                        + torch.from_numpy(xb) @ w.t()
                                        + 2 * pg.get_parameters()["enc"]["bias"]) ** 2), w)[0]
    np.testing.assert_allclose(w.grad.numpy(), gx.numpy(), atol=1e-6, rtol=1e-6)


def test_siamese_resnet_forward_gradients_and_bn_state_match_jax():
    xa, xb, y = _pairs(4, seed=1)
    jm, pm = _models()
    j, p = _grads_and_state(jm, pm, xa, xb, y)
    # one registered trunk, one parameter set
    assert [m.name() for m in pm.children()] == ["tower"]
    lone = ResNet(8, class_num=10, dataset="cifar10", device="cpu")
    lone.init(sample_input=torch.from_numpy(xa))
    assert pm.n_parameters() == lone.n_parameters()
    for a, b in zip(p["out"], j["out"]):
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(p["loss"], j["loss"], atol=ATOL, rtol=RTOL)
    assert set(p["grads"]) == set(j["grads"])
    for k, v in j["grads"].items():
        np.testing.assert_allclose(p["grads"][k], v, atol=ATOL, rtol=RTOL, err_msg=k)
    # BN state: the second site's update of the pre-forward statistics
    assert set(p["state"]) == set(j["state"]) and p["state"]
    for k, v in j["state"].items():
        np.testing.assert_allclose(p["state"][k], v, atol=ATOL, rtol=RTOL, err_msg=k)
    tower = pm[0]
    _, s2 = tower.apply(pm.get_parameters()["tower"], pm.get_state()["tower"],
                        torch.from_numpy(xb), training=True)
    for k, v in flat(s2).items():
        np.testing.assert_array_equal(p["state"]["tower." + k], v)


def test_siamese_resnet_three_sgd_steps_match_jax():
    xa, xb, y = _pairs(16, seed=2)
    jm, pm = _models()
    JRandom.set_seed(SEED)
    jp, _ = jm.init(jax.random.PRNGKey(SEED), sample_input=JT(xa[:8], xb[:8]))
    init = np_tree(jp)
    jopt = _Recording(jm, JDataSet.array(JT(xa, xb), y, batch_size=8),
                      jnn.CosineEmbeddingCriterion(margin=0.5))
    jopt.set_optim_method(joptim.SGD(learningrate=0.01, momentum=0.9))
    jopt.set_end_when(joptim.Trigger.max_iteration(3)).optimize()

    RandomGenerator.set_seed(SEED)
    pm.init(sample_input=T(torch.from_numpy(xa[:8]), torch.from_numpy(xb[:8])))
    load_jax_params(pm, init)
    opt = LocalOptimizer(pm, DataSet.array(T(xa, xb), y, batch_size=8),
                         pnn.CosineEmbeddingCriterion(margin=0.5))
    opt.set_optim_method(SGD(learningrate=0.01, momentum=0.9))
    opt.set_end_when(Trigger.max_iteration(3)).optimize()
    run = dict(init=flat(init), jax_params=flat(np_tree(jm.get_parameters())),
               params=flat(pm.get_parameters()))
    losses = [h["loss"] for h in opt.history]
    assert len(losses) == len(jopt.losses) == 3 and np.isfinite(losses).all()
    np.testing.assert_allclose(losses, jopt.losses, atol=1e-5)
    for k, v in run["jax_params"].items():
        np.testing.assert_allclose(run["params"][k], v, atol=1e-5, err_msg=k)
    assert update_distance(run) <= 1e-3


def test_dropped_graph_frees_its_weights_without_the_collector():
    """Children are weak references: no parent <-> child cycle holds a
    dropped graph's weights until the cyclic collector runs."""
    gc.disable()
    try:
        g = _tied(pnn, device="cpu")
        g.init(sample_input=T(torch.zeros(2, 6), torch.zeros(2, 6)))
        ref = weakref.ref(g.get_parameters()["enc"]["weight"])
        del g
        assert ref() is None
    finally:
        gc.enable()


@pytest.mark.parametrize("validate", [True, False])
def test_a_module_at_two_nodes_is_accepted(validate):
    inp_a, inp_b = pnn.Input(), pnn.Input()
    enc = pnn.Linear(6, 4, device="cpu")
    g = pnn.Graph([inp_a, inp_b], pnn.CAddTable(device="cpu").inputs(
        enc.inputs(inp_a), enc.inputs(inp_b)), validate=validate, device="cpu")
    assert len(list(g.children())) == 2
    assert g.forward([np.ones((2, 6), np.float32)] * 2).shape == (2, 4)
