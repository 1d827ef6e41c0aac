"""The port's mixture of experts against the JAX package's, on the CPU:
``parallel/moe.py`` (``_route``, ``moe_capacity``, ``moe_ffn_reference``),
``nn/moe.py`` (``MoE`` on its dense path, its load-balancing loss), the loss's
fold into ``LocalOptimizer`` (``auxiliary_loss_tree``) and the ragged-tail
rule it brings, and ``examples/moe_train.py``.

Inputs and weights from numpy with a seed, the JAX layer's weights carried
into the port. Tolerances, fixed before the first run:

* routing (expert ids, slots, kept entries) equal exactly, with planted
  ties (all-zero tokens, equal logits) and entries past the capacity;
* gate weights 1e-6 (XLA's and torch's softmax differ by ulps);
* the layer's output, load-balancing loss and every gradient 1e-5 of the
  largest |value| (f32 products summed in another order through the
  dispatch and the batched experts);
* 3 ``LocalOptimizer`` steps: losses 1e-5, parameters 1e-5, the update
  within 1e-3 relative L2 (``test_torch_ncf.py``'s limits).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bigdl_tpu.nn as jnn
from bigdl_tpu.parallel import moe as jmoe
from bigdl_tpu.utils.random import RandomGenerator as JRandom
from bigdl_tpu_torch import nn as pnn
from bigdl_tpu_torch.examples import moe_train
from torch_mesh_worker import spawn_module_case
from bigdl_tpu_torch.nn.moe import _expert_ffn
from bigdl_tpu_torch.parallel import moe as pmoe
from bigdl_tpu_torch.utils.convert import load_jax_params

from test_torch_ncf import _engine_isolation, _fp32_policy, assert_trained_alike, train_both  # noqa: F401

REL = 1e-5


def _close(got, want, rel=REL, what=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-30), err_msg=what)


def _tokens(shape, seed, zero_rows=3):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    x.reshape(-1, shape[-1])[:zero_rows] = 0.0  # exact ties among the router logits
    return x


@pytest.mark.parametrize("k", [1, 2, 3])
def test_route_equals_jax_with_ties_and_drops(k):
    rng = np.random.default_rng(k)
    logits = rng.standard_normal((12, 5)).astype(np.float32)
    logits[:3] = 0.0            # all-zero tokens: five-way ties
    logits[3:6, 1:4] = 2.5      # three-way ties at the top
    for capacity in (1, 2, 12):
        a = jmoe._route(jnp.asarray(logits), 5, capacity, k)
        b = pmoe._route(torch.from_numpy(logits), 5, capacity, k)
        for name, ja, pa in zip(("expert_id", "slot", "keep"), a[:3], b[:3]):
            np.testing.assert_array_equal(pa.numpy(), np.asarray(ja), err_msg=name)
        _close(b[3].numpy(), a[3], 1e-6, "w")
        assert not b[2].all() or capacity == 12


@pytest.mark.parametrize("t,e,cf,k", [(8, 4, 1.25, 1), (32, 4, 2.0, 2), (2048, 8, 1.5, 1),
                                      (5, 3, 0.1, 1), (30, 4, 1.0, 3)])
def test_moe_capacity_equals_jax(t, e, cf, k):
    assert pmoe.moe_capacity(t, e, cf, k) == jmoe.moe_capacity(t, e, cf, k)


def _pair(kw, x):
    JRandom.set_seed(11)
    jm = jnn.MoE(**kw)
    jp, js = jm.init(sample_input=jnp.asarray(x))
    pm = pnn.MoE(**kw, device="cpu")
    pm.init(sample_input=x)
    load_jax_params(pm, jax.tree_util.tree_map(np.asarray, jp))
    return jm, jp, js, pm


CASES = {
    "top1_relu_drops": dict(n_experts=4, ffn_size=10, capacity_factor=0.75),
    "top2_gelu_drops": dict(n_experts=4, ffn_size=12, capacity_factor=0.75, router_top_k=2,
                            activation="gelu"),
    "top2_silu_roomy": dict(n_experts=3, ffn_size=8, capacity_factor=4.0, router_top_k=2,
                            activation="silu"),
    "top1_tanh_no_aux": dict(n_experts=2, ffn_size=6, activation="tanh", aux_loss_coeff=0.0),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_moe_forward_gradient_and_aux_loss_match_jax(name):
    kw = CASES[name]
    x = _tokens((4, 6, 8), seed=len(name))
    jm, jp, js, pm = _pair(kw, x)
    w = np.random.default_rng(9).standard_normal((4, 6, 8)).astype(np.float32)

    def jloss(p, xx):
        y, s = jm.apply(p, js, xx, training=True, rng=None)
        return jnp.sum(y * w) + jm.auxiliary_loss_tree(s), (y, s)

    (jl, (jy, jst)), (jg, jgx) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jp, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    y, st = pm.apply(pm.get_parameters(), pm.get_state(), xt, training=True)
    loss = (y * torch.from_numpy(w)).sum() + pm.auxiliary_loss_tree(st)
    loss.backward()
    assert sorted(st) == sorted(jst)
    _close(y.detach().numpy(), jy, what="y")
    _close(loss.item(), jl, what="loss")
    if kw.get("aux_loss_coeff", 0.01):
        _close(st["_aux_loss"].item(), jst["_aux_loss"], what="aux")
    _close(xt.grad.numpy(), jgx, what="dx")
    for key, p in pm.named_parameters():
        _close(p.grad.numpy(), jg[key], what=key)


def test_eval_forward_leaves_the_state_and_drops_pass_through_as_zeros():
    kw = CASES["top1_relu_drops"]
    x = _tokens((4, 6, 8), seed=1)
    jm, jp, js, pm = _pair(kw, x)
    with torch.no_grad():
        y, st = pm.apply(pm.get_parameters(), pm.get_state(), torch.from_numpy(x))
    jy, jst = jm.apply(jp, js, jnp.asarray(x), training=False, rng=None)
    _close(y.numpy(), jy)
    assert float(st["_aux_loss"]) == float(jst["_aux_loss"]) == 0.0
    # capacity 2 of 6 tokens a shard and expert: some tokens are dropped, and
    # a dropped token's row is exactly zero in both packages
    zero = (np.abs(np.asarray(jy)).reshape(-1, 8).max(1) == 0)
    assert zero.any()
    assert (np.abs(y.numpy()).reshape(-1, 8).max(1) == 0).tolist() == zero.tolist()


@pytest.mark.parametrize("k", [1, 2])
def test_reference_oracle_equals_the_dense_path_and_jax_oracle(k):
    kw = dict(n_experts=4, ffn_size=10, capacity_factor=1.0, router_top_k=k, activation="relu")
    x = _tokens((24, 8), seed=20 + k)
    jm, jp, js, pm = _pair(kw, x)
    p = pm.get_parameters()
    experts = {n: p[n] for n in ("w1", "b1", "w2", "b2")}
    with torch.no_grad():
        ref = pmoe.moe_ffn_reference(p["router_w"], experts,
                                     lambda q, h: _expert_ffn(q, h, "relu"),
                                     torch.from_numpy(x), 4, 1.0, k)
        dense = pm.apply(p, pm.get_state(), torch.from_numpy(x))[0]
    jref = jmoe.moe_ffn_reference(jp["router_w"], {n: jp[n] for n in experts},
                                  lambda q, h: jax.nn.relu(h @ q["w1"] + q["b1"]) @ q["w2"]
                                  + q["b2"], jnp.asarray(x), 4, 1.0, k)
    _close(dense.numpy(), ref.numpy(), 1e-6)
    _close(ref.numpy(), jref)
    with pytest.raises(ValueError, match="not divisible"):
        pmoe.moe_ffn_reference(p["router_w"], experts, None, torch.zeros(6, 8), 4)


def test_contract_errors_and_the_expert_parallel_path_raise(tmp_path):
    with pytest.raises(ValueError, match="n_experts must be >= 2"):
        pnn.MoE(1, device="cpu")
    with pytest.raises(ValueError, match="activation"):
        pnn.MoE(2, activation="swish", device="cpu")
    with pytest.raises(ValueError, match="router_top_k"):
        pnn.MoE(2, router_top_k=3, device="cpu")
    m = pnn.MoE(4, ffn_size=8, device="cpu")
    spec = torch.empty((3, 5, 8), device="meta")
    jm = jnn.MoE(4, ffn_size=8)
    with pytest.raises(ValueError, match="not divisible") as pe:
        m.infer_shape(spec)
    with pytest.raises(ValueError, match="not divisible") as je:
        jm.infer_shape(jax.ShapeDtypeStruct((3, 5, 8), jnp.float32))
    assert str(pe.value).split(":", 1)[1] == str(je.value).split(":", 1)[1]
    assert tuple(m.infer_shape(torch.empty((4, 5, 8), device="meta")).shape) == (4, 5, 8)
    # the expert-parallel path runs (it raised before it was ported): on
    # 4 spawned ranks its output equals the dense path's within 1e-5
    assert m.set_mesh(None) is m
    got = spawn_module_case(4, dict(name="moe", fn="module_moe", mesh={"expert": 4}, k=1),
                            str(tmp_path))
    np.testing.assert_allclose(got[0]["par.y"], got[0]["dense.y"], atol=1e-5)


def _bench_moe(nn, dev):
    return nn.Sequential(nn.Linear(8, 8, **dev), nn.MoE(4, ffn_size=16, capacity_factor=2.0,
                                                         **dev),
                         nn.Linear(8, 5, **dev), nn.LogSoftMax(**dev), **dev)


@pytest.mark.parametrize("k", [1, 2])
def test_local_optimizer_folds_the_aux_loss_as_jax_does(k):
    """The bench's MoE model, narrow: Linear -> MoE -> Linear -> LogSoftMax,
    ClassNLL, SGD, 3 steps through both packages' LocalOptimizer."""
    def model(nn, dev):
        m = _bench_moe(nn, dev)
        m[1].router_top_k = k
        return m

    rng = np.random.default_rng(30 + k)
    x = rng.standard_normal((24, 8)).astype(np.float32)
    x[:2] = 0.0
    y = rng.integers(0, 5, 24)
    run = train_both(model(jnn, {}), model(pnn, {"device": "cpu"}), x, y, batch=8,
                     criterion=lambda nn: nn.ClassNLLCriterion(),
                     method=lambda o: o.SGD(learningrate=0.5, momentum=0.9))
    assert_trained_alike(run)


def test_aux_loss_keeps_a_ragged_tail_out_of_the_step_as_jax_does():
    """The router's statistics couple the rows of a batch: a ragged last batch
    is dropped, never padded into them (both packages), and the step sees
    only full batches."""
    rng = np.random.default_rng(40)
    x = rng.standard_normal((20, 8)).astype(np.float32)
    y = rng.integers(0, 5, 20)
    run = train_both(_bench_moe(jnn, {}), _bench_moe(pnn, {"device": "cpu"}), x, y, batch=8,
                     criterion=lambda nn: nn.ClassNLLCriterion(),
                     method=lambda o: o.SGD(learningrate=0.1), steps=4)
    assert run["records"] == [8, 8, 8, 8]
    assert_trained_alike(run, steps=4)


def test_moe_example_trains_on_the_dense_path():
    """The example now trains expert-parallel (4 spawned ranks, as its JAX
    main); the same run on the layer's dense path in this process gives
    the same losses (within 1e-5) and the same bigram recovery."""
    argv = ["--platform", "cpu", "--max-epoch", "1", "--synthetic-size", "3000",
            "--router-top-k", "2"]
    run = moe_train.main(argv)
    mesh_losses = [h["loss"] for h in run.results["ranks"][0]["history"]]
    dense = moe_train.build(moe_train.parser().parse_args(argv))
    model = dense.optimizer.optimize()
    losses = [h["loss"] for h in dense.optimizer.history]
    assert len(losses) == 2 and np.isfinite(losses).all()
    np.testing.assert_allclose(mesh_losses, losses, atol=1e-5)
    share = moe_train.probe_recovery(model, 64, 4)[0]
    assert 0.0 <= run.results["bigram_recovery"] <= 1.0
    assert abs(share - run.results["bigram_recovery"]) < 1e-9
    moe = next(m for m in model.walk() if isinstance(m, pnn.MoE))
    assert moe.expert_parallel is False and moe._mesh is None
