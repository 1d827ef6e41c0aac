"""``nn.Remat`` (``nn/remat.py``) on the CPU: the port's checkpointing
wrapper changes no number. For every policy name, with a ``Dropout`` inside
the wrapped module and one after it, outputs, parameter and input gradients
and the caller's generator state are the unwrapped module's to the bit; the
wrapped module really runs again in the backward; its state update is
applied once; the same holds inside ``PipelinedBlocks`` and over
``LocalOptimizer`` steps. Against the JAX package: a ``PipelinedBlocks`` of
``Remat`` stages (3 stages of LN -> Linear -> ReLU -> Linear) gives the JAX
stack's loss and gradients within 1e-5 of the largest |value| (f32 sums in
another order), and the policies' names and refusals are the JAX module's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bigdl_tpu.nn as jnn
from bigdl_tpu.nn import remat as jremat
from bigdl_tpu.utils.random import RandomGenerator as JRandom
from bigdl_tpu_torch import Engine, RandomGenerator
from bigdl_tpu_torch import nn as pnn
from bigdl_tpu_torch.dataset import DataSet
from bigdl_tpu_torch.nn import remat as premat
from bigdl_tpu_torch.optim import SGD, LocalOptimizer, Trigger
from bigdl_tpu_torch.utils.convert import load_jax_params
from torch.utils.checkpoint import CheckpointPolicy

CPU = {"device": "cpu"}
POLICIES = [None, *premat._POLICIES]


@pytest.fixture(autouse=True)
def _fp32_policy():
    Engine.set_compute_dtype("float32")
    Engine.set_activation_dtype(None)
    yield
    Engine.set_compute_dtype(None)


def _inner():
    return pnn.Sequential(pnn.Linear(6, 8, **CPU), pnn.ReLU(**CPU), pnn.Dropout(0.4, **CPU),
                          pnn.Linear(8, 6, **CPU), **CPU)


def _model(policy, wrap):
    body = pnn.Remat(_inner(), policy=policy, **CPU) if wrap else _inner()
    return pnn.Sequential(body, pnn.Dropout(0.3, **CPU), pnn.Linear(6, 3, **CPU), **CPU)


def _copy_weights(dst, src):
    with torch.no_grad():
        for p, q in zip(dst.parameters(), src.parameters()):
            p.copy_(q)


def _run(model, x, seed=7):
    g = torch.Generator().manual_seed(seed)
    xt = x.clone().requires_grad_()
    y, state = model.apply(model.get_parameters(), model.get_state(), xt, training=True, rng=g)
    (y * torch.linspace(-1, 1, y.numel()).reshape(y.shape)).sum().backward()
    return (y.detach(), [p.grad.clone() for p in model.parameters()], xt.grad.clone(),
            g.get_state(), state)


@pytest.mark.parametrize("policy", POLICIES, ids=str)
def test_remat_is_bit_identical_to_the_unwrapped_module(policy):
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((5, 6)).astype(np.float32))
    RandomGenerator.set_seed(3)
    ref = _model(policy, wrap=False)
    ref.init(sample_input=x)
    wrapped = _model(policy, wrap=True)
    wrapped.init(sample_input=x)
    _copy_weights(wrapped, ref)
    a, b = _run(ref, x), _run(wrapped, x)
    assert torch.equal(a[0], b[0])
    assert all(torch.equal(p, q) for p, q in zip(a[1], b[1]))
    assert torch.equal(a[2], b[2])
    assert torch.equal(a[3], b[3])  # the caller's generator moved on alike
    with torch.no_grad():  # and the masks were drawn: eval mode gives other outputs
        assert not torch.equal(a[0], ref.apply(ref.get_parameters(), ref.get_state(), x)[0])


@pytest.mark.parametrize("policy", POLICIES, ids=str)
def test_the_wrapped_module_runs_again_in_the_backward(policy):
    """Once more in the backward, but under ``everything_saveable`` (all
    kept: nothing to recompute) and without a gradient."""
    x = torch.ones(3, 6)
    RandomGenerator.set_seed(4)
    m = pnn.Remat(_inner(), policy=policy, **CPU)
    m.init(sample_input=x)
    calls = []
    child = m[0]
    orig = child._apply_params
    child._apply_params = lambda *a: (calls.append(torch.is_grad_enabled()), orig(*a))[1]
    y, _ = m.apply(m.get_parameters(), m.get_state(), x, training=True,
                   rng=torch.Generator().manual_seed(1))
    assert len(calls) == 1
    y.sum().backward()
    again = 0 if policy == "everything_saveable" else 1
    assert len(calls) == 1 + again
    with torch.no_grad():
        m.apply(m.get_parameters(), m.get_state(), x)
    assert len(calls) == 2 + again


def test_state_update_is_the_forwards_applied_once():
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((8, 4)).astype(np.float32))
    RandomGenerator.set_seed(5)
    ref = pnn.Sequential(pnn.Linear(4, 4, **CPU), pnn.BatchNormalization(4, **CPU), **CPU)
    ref.init(sample_input=x)
    wrapped = pnn.Remat(pnn.Sequential(pnn.Linear(4, 4, **CPU),
                                       pnn.BatchNormalization(4, **CPU), **CPU), **CPU)
    wrapped.init(sample_input=x)
    _copy_weights(wrapped, ref)
    a, b = _run(ref, x), _run(wrapped, x)
    sa = a[4]
    sb = b[4][wrapped[0].name()]
    for layer in sa:
        for k in sa[layer]:
            assert torch.equal(sa[layer][k], sb[layer][k])
    assert all(torch.equal(p, q) for p, q in zip(a[1], b[1]))


def _stage(nn, dev, dropout=0.0):
    layers = [nn.LayerNormalization(6, **dev), nn.Linear(6, 12, **dev), nn.ReLU(**dev)]
    if dropout:
        layers.append(nn.Dropout(dropout, **dev))
    layers.append(nn.Linear(12, 6, **dev))
    return nn.Sequential(*layers, **dev)


@pytest.mark.parametrize("policy", [None, "dots_saveable"], ids=str)
def test_inside_pipelined_blocks_bit_identical_to_the_unwrapped_stack(policy):
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((4, 5, 6)).astype(np.float32))
    RandomGenerator.set_seed(6)
    ref = pnn.PipelinedBlocks(_stage(pnn, CPU, 0.25), 3, **CPU)
    ref.init(sample_input=x)
    wrapped = pnn.PipelinedBlocks(pnn.Remat(_stage(pnn, CPU, 0.25), policy=policy, **CPU), 3,
                                  **CPU)
    wrapped.init(sample_input=x)
    _copy_weights(wrapped, ref)
    a, b = _run(ref, x), _run(wrapped, x)
    assert torch.equal(a[0], b[0]) and torch.equal(a[2], b[2]) and torch.equal(a[3], b[3])
    assert all(torch.equal(p, q) for p, q in zip(a[1], b[1]))


def test_pipelined_remat_stages_match_the_jax_stack():
    x = np.random.default_rng(3).standard_normal((4, 5, 6)).astype(np.float32)
    JRandom.set_seed(7)
    jm = jnn.PipelinedBlocks(jnn.Remat(_stage(jnn, {}), policy="dots_saveable"), 3)
    jp, js = jm.init(sample_input=jnp.asarray(x))
    pm = pnn.PipelinedBlocks(pnn.Remat(_stage(pnn, CPU), policy="dots_saveable", **CPU), 3,
                             **CPU)
    pm.init(sample_input=x)
    load_jax_params(pm, jax.tree_util.tree_map(np.asarray, jp))

    def jloss(p):
        y = jm.apply(p, js, jnp.asarray(x), training=True, rng=None)[0]
        return jnp.sum(y * y), y

    (jl, jy), jg = jax.value_and_grad(jloss, has_aux=True)(jp)
    y, _ = pm.apply(pm.get_parameters(), pm.get_state(), torch.from_numpy(x), training=True)
    loss = (y * y).sum()
    loss.backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), rtol=0,
                               atol=1e-5 * np.abs(np.asarray(jy)).max())
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    flat = {}
    jax.tree_util.tree_map_with_path(
        lambda path, v: flat.__setitem__(".".join(str(k.key) for k in path), np.asarray(v)), jg)
    for name, p in pm.named_parameters():
        want = flat[name]
        np.testing.assert_allclose(p.grad.numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max(), err_msg=name)


def test_local_optimizer_steps_equal_the_unwrapped_model():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((16, 6)).astype(np.float32)
    y = rng.integers(0, 3, 16)
    models = []
    for wrap in (False, True):
        RandomGenerator.set_seed(8)
        m = _model("dots_saveable", wrap)
        m.add(pnn.LogSoftMax(**CPU))
        m.init(sample_input=x[:4])
        models.append(m)
    _copy_weights(models[1], models[0])
    runs = []
    for m in models:
        o = LocalOptimizer(m, DataSet.array(x, y, batch_size=4), pnn.ClassNLLCriterion())
        o.set_optim_method(SGD(learningrate=0.1, momentum=0.9))
        RandomGenerator.set_seed(9)
        o.set_end_when(Trigger.max_iteration(4)).optimize()
        runs.append(([h["loss"] for h in o.history], [p.detach().clone() for p in m.parameters()]))
    assert runs[0][0] == runs[1][0]
    assert all(torch.equal(p, q) for p, q in zip(runs[0][1], runs[1][1]))


def test_policies_save_what_the_jax_names_save():
    mm, bmm, conv, add = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
                          torch.ops.aten.convolution.default, torch.ops.aten.add.Tensor)
    a2, b1, b3 = torch.zeros(2, 2), torch.zeros(1, 2, 2), torch.zeros(3, 2, 2)
    save, recompute = CheckpointPolicy.MUST_SAVE, CheckpointPolicy.PREFER_RECOMPUTE
    table = {
        "dots_saveable": (save, save, save, save, recompute),
        "checkpoint_dots": (save, save, save, save, recompute),
        "dots_with_no_batch_dims_saveable": (save, save, recompute, recompute, recompute),
        "checkpoint_dots_with_no_batch_dims": (save, save, recompute, recompute, recompute),
    }
    assert sorted(premat._POLICIES) == sorted(jremat._POLICIES)
    assert sorted(table) == sorted(premat._POLICY_FNS)
    for name, want in table.items():
        fn = premat._POLICY_FNS[name]
        got = (fn(None, mm, a2, a2), fn(None, bmm, b1, b1), fn(None, bmm, b3, b3),
               fn(None, conv, a2, a2), fn(None, add, a2, a2))
        assert got == want, name


def test_refusals_and_shape_contract_follow_jax():
    with pytest.raises(ValueError, match="unknown checkpoint policy") as pe:
        pnn.Remat(pnn.ReLU(**CPU), policy="save_only_these_names", **CPU)
    with pytest.raises(ValueError, match="unknown checkpoint policy") as je:
        jnn.Remat(jnn.ReLU(), policy="save_only_these_names")
    assert str(pe.value) == str(je.value)
    m = pnn.Remat(pnn.Linear(4, 3, **CPU), **CPU)
    with pytest.raises(ValueError, match="exactly ONE"):
        m.add(pnn.ReLU(**CPU))
    spec = m.infer_shape(torch.empty((2, 4), device="meta"))
    assert tuple(spec.shape) == (2, 3) and spec.device.type == "meta"
    with pytest.raises(ValueError, match="expected last dim 4"):
        m.infer_shape(torch.empty((2, 5), device="meta"))
