"""``AbstractModule``'s Torch-style methods, forward hooks, ``Echo`` and
``clone``/``reset`` in the port, against the JAX package where both run
the same thing:

* ``register_forward_hook``: ``hook(module, x, y)`` fires at the root,
  inside a ``Sequential``, at a ``Graph`` node and in ``LocalOptimizer``'s
  step, where a returned dict joins the module's state: a stashed
  activation mean equals the JAX package's stash after the same SGD step
  from the same weights (1e-6) and the mean recomputed from the batch;
  ``remove()`` restores the forward in LIFO order, the outputs unchanged;
* ``update_grad_input`` and ``acc_grad_parameters`` against the JAX
  package's (1e-6), ``update_grad_input`` leaving ``.grad`` untouched;
* ``get_name``, ``get_parameters_table``, ``set_parameters``,
  ``set_grad_parameters``, ``is_training``;
* ``clone`` of a ``Graph``: new weights in the clone move its output and
  not the original's, and the clone's nodes refer to each other only;
* ``reset``: the parameters are dropped and re-sampled at the next forward;
* the decision on ``parameters()`` and ``training()``: torch's names stay
  torch's (a generator of Parameters; a bool), the JAX counterparts are
  ``get_parameters``/``get_grad_parameters`` and ``train()``;
* ``Echo`` prints on every call.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bigdl_tpu.nn as jnn
import bigdl_tpu.optim as joptim
from bigdl_tpu.dataset.dataset import DataSet as JDataSet
from bigdl_tpu.utils.random import RandomGenerator as JRandom
from bigdl_tpu_torch import RandomGenerator
from bigdl_tpu_torch import nn as pnn
from bigdl_tpu_torch import optim as poptim
from bigdl_tpu_torch.dataset import DataSet
from bigdl_tpu_torch.utils.convert import load_jax_params

from test_torch_activations import _fp32_policy  # noqa: F401 (fixture)
from test_torch_conv_bn import flat, np_tree

D = {"device": "cpu"}


def _x(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _mlp(nn, **d):
    return nn.Sequential(nn.Linear(6, 5, **d).set_name("fc1"), nn.ReLU(**d),
                         nn.Linear(5, 3, **d).set_name("fc2"), nn.LogSoftMax(**d), **d)


def _pair(x):
    jm, pm = _mlp(jnn), _mlp(pnn, **D)
    jp, _ = jm.init(jax.random.PRNGKey(0), sample_input=jnp.asarray(x))
    pm.init(sample_input=torch.from_numpy(x))
    load_jax_params(pm, np_tree(jp))
    return jm, pm


def _mean_hook(module, x, y):
    return {"act_mean": y.mean()}


def test_hook_fires_inside_a_sequential_and_merges_into_the_state():
    x = _x(4, 6)
    _, pm = _pair(x)
    seen = []
    handle = pm[0].register_forward_hook(lambda m, xx, y: (seen.append((m, y)),
                                                           _mean_hook(m, xx, y))[1])
    pm.train()
    y = pm.forward(torch.from_numpy(x))
    assert len(seen) == 1 and seen[0][0] is pm[0]
    h = torch.from_numpy(x) @ pm[0].weight.detach().t() + pm[0].bias.detach()
    torch.testing.assert_close(pm[0].get_state()["act_mean"], h.mean())
    assert "act_mean" in pm.get_state()["fc1"]
    handle.remove()
    pm.forward(torch.from_numpy(x))
    assert len(seen) == 1
    torch.testing.assert_close(pm.forward(torch.from_numpy(x)), y)


def test_hook_fires_at_a_graph_node():
    inp = pnn.Input()
    a = pnn.Linear(4, 3, **D).set_name("a")
    out = pnn.Tanh(**D).inputs(a.inputs(inp))
    g = pnn.Graph(inp, out, **D)
    x = torch.from_numpy(_x(2, 4, seed=1))
    g.init(sample_input=x)
    seen = []
    a.register_forward_hook(lambda m, xx, y: seen.append(tuple(y.shape)))
    g.forward(x)
    assert seen == [(2, 3)]


def test_hook_in_local_optimizer_step_matches_jax():
    """The hook's stash after one SGD step from the same weights, in both."""
    x, y = _x(8, 6, seed=2), np.random.default_rng(2).integers(0, 3, 8)
    jm, pm = _pair(x)
    jm[0]._state = {"act_mean": jnp.zeros(())}  # zero-seeded: the JAX jit's contract
    jm[0].register_forward_hook(_mean_hook)
    pm[0].register_forward_hook(_mean_hook)
    w0 = pm[0].weight.detach().clone()
    b0 = pm[0].bias.detach().clone()
    JRandom.set_seed(0)
    jopt = joptim.LocalOptimizer(jm, JDataSet.array(x, y, batch_size=8), jnn.ClassNLLCriterion())
    jopt.set_optim_method(joptim.SGD(learningrate=0.1))
    jopt.set_end_when(joptim.Trigger.max_iteration(1)).optimize()
    RandomGenerator.set_seed(0)
    opt = poptim.LocalOptimizer(pm, DataSet.array(x, y, batch_size=8), pnn.ClassNLLCriterion())
    opt.set_optim_method(poptim.SGD(learningrate=0.1))
    opt.set_end_when(poptim.Trigger.max_iteration(1)).optimize()
    got = float(pm[0].get_state()["act_mean"])
    assert got == pytest.approx(float((torch.from_numpy(x) @ w0.t() + b0).mean()), abs=1e-6)
    assert got == pytest.approx(float(jm[0].get_state()["act_mean"]), abs=1e-6)
    for k, v in flat(np_tree(jm.get_parameters())).items():
        np.testing.assert_allclose(flat(pm.get_parameters())[k], v, atol=1e-6)


def test_hooks_come_off_in_lifo_order():
    x = torch.from_numpy(_x(3, 6, seed=3))
    _, pm = _pair(x.numpy())
    pm.evaluate()
    y0 = pm.forward(x)
    calls = []
    h1 = pm[2].register_forward_hook(lambda m, a, b: calls.append(1))
    h2 = pm[2].register_forward_hook(lambda m, a, b: calls.append(2))
    pm.forward(x)
    assert calls == [1, 2]
    h1.remove()  # wrapped by h2: does nothing
    pm.forward(x)
    assert calls == [1, 2, 1, 2]
    h2.remove()
    pm.forward(x)
    assert calls == [1, 2, 1, 2, 1]
    h1.remove()
    calls.clear()
    torch.testing.assert_close(pm.forward(x), y0, rtol=0, atol=0)
    assert calls == [] and "_apply_params" not in pm[2].__dict__


def test_update_grad_input_and_acc_grad_parameters_match_jax():
    x = _x(4, 6, seed=4)
    jm, pm = _pair(x)
    dy = _x(4, 3, seed=5)
    jm.evaluate()
    pm.evaluate()
    jm.forward(jnp.asarray(x))
    pm.forward(torch.from_numpy(x))
    pm.zero_grad_parameters()
    gx = pm.update_grad_input(torch.from_numpy(x), torch.from_numpy(dy))
    np.testing.assert_allclose(gx.numpy(), np.asarray(jm.update_grad_input(x, dy)), atol=1e-6)
    assert all(float(p.grad.abs().sum()) == 0.0 for p in pm.parameters())
    pm.acc_grad_parameters(torch.from_numpy(x), torch.from_numpy(dy))
    pm.acc_grad_parameters(torch.from_numpy(x), torch.from_numpy(dy))
    jm.zero_grad_parameters()
    jm.acc_grad_parameters(x, dy)
    jm.acc_grad_parameters(x, dy)
    want = flat(np_tree(jm.get_grad_parameters()))
    got = flat(pm.get_grad_parameters())
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, atol=1e-6, err_msg=k)


def test_names_tables_and_setters_match_jax():
    x = _x(4, 6, seed=6)
    jm, pm = _pair(x)
    assert pm.get_name() == pm.name() and pm[0].get_name() == "fc1"
    jt, pt = jm.get_parameters_table(), pm.get_parameters_table()
    assert sorted(pt) == sorted(jt) == ["fc1", "fc2"]
    assert {k: sorted(v) for k, v in pt.items()} == {k: sorted(v) for k, v in jt.items()}
    new = {k: {n: np.asarray(a) + 1.0 for n, a in v.items()} for k, v in
           np_tree(jm.get_parameters()).items()}
    pm.set_parameters(new)
    jm.set_parameters({k: {n: jnp.asarray(a) for n, a in v.items()} for k, v in new.items()})
    pm.evaluate()
    jm.evaluate()
    np.testing.assert_allclose(pm.forward(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(jm.forward(jnp.asarray(x))), atol=1e-6, rtol=1e-5)
    grads = {k: {n: np.full(a.shape, 0.5, np.float32) for n, a in v.items()}
             for k, v in new.items()}
    pm.set_grad_parameters(grads)
    assert all(float(g.sum()) == 0.5 * g.size for g in flat(pm.get_grad_parameters()).values())
    with pytest.raises(KeyError, match="paths differ"):
        pm.set_parameters({"fc1": new["fc1"]})
    with pytest.raises(ValueError, match="shape"):
        pm[0].set_parameters({"weight": np.zeros((2, 2), np.float32), "bias": new["fc1"]["bias"]})
    pm.train()
    jm.training()
    assert pm.is_training() is True and jm.is_training() is True
    pm.evaluate()
    assert pm.is_training() is False


def test_parameters_and_training_keep_torch_meanings():
    """The decision: torch's ``parameters()`` and ``training`` stay torch's."""
    _, pm = _pair(_x(2, 6))
    ps = list(pm.parameters())
    assert all(isinstance(p, torch.nn.Parameter) for p in ps) and len(ps) == 4
    assert isinstance(pm.training, bool) and not callable(pm.training)
    assert pm.train() is pm and pm.training is True
    jm = _mlp(jnn)
    jm.init(jax.random.PRNGKey(0), sample_input=jnp.ones((2, 6)))
    w, g = jm.parameters()  # the JAX pair; the port's counterparts:
    assert len(w) == len(g) == len(flat(pm.get_parameters())) == len(
        flat(pm.get_grad_parameters()))
    import bigdl_tpu_torch.nn.module as pmod

    for words in ("get_parameters()", "get_grad_parameters()", "``train()``"):
        assert words in pmod.__doc__


def test_clone_of_a_graph_is_independent():
    inp = pnn.Input()
    a = pnn.Linear(4, 3, **D).set_name("a")
    b = pnn.Linear(4, 3, **D).set_name("b")
    out = pnn.CAddTable(**D).inputs(a.inputs(inp), pnn.ReLU(**D).inputs(b.inputs(inp)))
    g = pnn.Graph(inp, out, **D)
    x = torch.from_numpy(_x(2, 4, seed=7))
    g.init(sample_input=x)
    g.evaluate()
    y0 = g.forward(x).detach().clone()
    c = g.clone()
    with torch.no_grad():
        for p in c.parameters():
            p.add_(1.0)
    torch.testing.assert_close(g.forward(x), y0, rtol=0, atol=0)
    assert not torch.allclose(c.forward(x), y0)
    originals = {id(n) for n in g._topo}
    for n in c._topo:
        assert id(n) not in originals and id(n.module) not in {id(m.module) for m in g._topo}
        assert all(id(ch) not in originals for ch in n.children)
        assert all(id(p) not in originals for p in n.parents)
    assert {ch.module.name() for ch in c.input_nodes[0].children} == {"a", "b"}


def test_reset_resamples_at_the_next_forward():
    x = torch.from_numpy(_x(3, 6, seed=8))
    RandomGenerator.set_seed(1)
    m = _mlp(pnn, **D)
    m.forward(x)
    w0 = m[0].weight.detach().clone()
    m.reset()
    assert not m.is_built() and not m[0].is_built() and not list(m.parameters())
    RandomGenerator.set_seed(2)
    m.forward(x)
    assert m.is_built() and m[0].weight.shape == w0.shape
    assert not torch.equal(m[0].weight.detach(), w0)
    RandomGenerator.set_seed(1)
    again = _mlp(pnn, **D)
    again.forward(x)
    torch.testing.assert_close(again[0].weight.detach(), w0, rtol=0, atol=0)


def test_echo_prints_on_every_call(capsys):
    e = pnn.Echo(**D).set_name("probe")
    x = torch.zeros(2, 3)
    assert e.forward(x) is x
    e.forward(x)
    out = capsys.readouterr().out
    assert out.count("[probe] (2, 3)") == 2
    jy = jnn.Echo().set_name("probe").forward(np.zeros((2, 3), np.float32))
    assert "[probe] (2, 3)" in capsys.readouterr().out and jy.shape == (2, 3)
