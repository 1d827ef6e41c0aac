"""The port's ``PipelinedBlocks`` against the JAX package's, on its
sequential path: the stage-stacked parameter layout and its paths, the
forward and the gradients with the JAX parameters carried over (stacked
leaves included), ``remat_stages`` keeping every bit, and the build errors.

The stage is the pipeline example's pre-norm block (LayerNormalization ->
FeedForwardNetwork -> CAddTable residual, an ``nn.Graph``), f32, inputs from
numpy with a seed. Tolerance 1e-5 absolute and relative: the same f32
products summed in another order through 3 stages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bigdl_tpu.nn as jnn
from bigdl_tpu_torch import Engine
from bigdl_tpu_torch import nn as pnn
from bigdl_tpu_torch.utils.convert import load_jax_params

H, S = 16, 3
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _fp32_policy():
    Engine.set_compute_dtype("float32")
    yield
    Engine.set_compute_dtype(None)


def block(nn, h=H, **dev):
    """The pipeline example's stage: pre-norm position-wise residual block."""
    inp = nn.Input()
    ln = nn.LayerNormalization(h, **dev).inputs(inp)
    ffn = nn.FeedForwardNetwork(h, filter_size=4 * h, **dev).inputs(ln)
    add = nn.CAddTable(**dev).inputs(inp, ffn)
    return nn.Graph(inp, add, **dev)


def _x(seed=0, shape=(3, 5, H)):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _jax_stack(remat=False):
    m = jnn.PipelinedBlocks(block(jnn), S, remat_stages=remat)
    m.init(jax.random.PRNGKey(1), sample_input=jnp.asarray(_x()))
    return m


def _port_stack(params=None, remat=False):
    m = pnn.PipelinedBlocks(block(pnn, device="cpu"), S, remat_stages=remat, device="cpu")
    m.init(sample_input=_x())
    if params is not None:
        load_jax_params(m, params)
    return m


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def test_stacked_layout_and_paths_are_the_jax_packages():
    jm, pm = _jax_stack(), _port_stack()
    jshapes = {jax.tree_util.keystr(p): a.shape
               for p, a in jax.tree_util.tree_leaves_with_path(jm.get_parameters())}
    pshapes = {"".join(f"['{k}']" for k in name.split(".")): tuple(p.shape)
               for name, p in pm.named_parameters()}
    assert pshapes == jshapes
    assert pshapes["['stages']['FeedForwardNetwork_1']['filter_w']"] == (S, 4 * H, H)
    assert pshapes["['stages']['LayerNormalization_0']['weight']"] == (S, H)
    assert pm.get_parameters()["stages"]["CAddTable_2"] == {}
    # one tensor per leaf: an optimizer sees S stages as one parameter
    assert len(list(pm.parameters())) == 6
    # S independent initialisations
    w = pm.get_parameters()["stages"]["FeedForwardNetwork_1"]["filter_w"]
    assert not torch.equal(w[0], w[1]) and not torch.equal(w[1], w[2])


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_forward_and_gradients_match_jax(remat):
    jm = _jax_stack(remat)
    params = _np_tree(jm.get_parameters())
    x = _x(1)
    cot = np.random.default_rng(2).standard_normal(x.shape).astype(np.float32)

    def loss(p, v):
        y, _ = jm.apply(p, {}, v, training=True)
        return jnp.sum(y * cot)

    jy, _ = jm.apply(params, {}, jnp.asarray(x))
    jgp, jgx = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(x))
    pm = _port_stack(params, remat)
    pm.train()
    xt = torch.from_numpy(x).requires_grad_(True)
    y, _ = pm.apply(pm.get_parameters(), {}, xt, training=True)
    (y * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), **TOL)
    jg = {".".join(k.key for k in p): np.asarray(a)
          for p, a in jax.tree_util.tree_leaves_with_path(jgp)}
    for name, p in pm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), jg[name], **TOL, err_msg=name)


def test_remat_keeps_every_bit():
    params = _np_tree(_jax_stack().get_parameters())
    outs = []
    for remat in (False, True):
        pm = _port_stack(params, remat)
        xt = torch.from_numpy(_x(3)).requires_grad_(True)
        y, _ = pm.apply(pm.get_parameters(), {}, xt, training=True)
        (y * y).sum().backward()
        outs.append([y.detach(), xt.grad] + [p.grad for p in pm.parameters()])
    assert all(torch.equal(a, b) for a, b in zip(*outs))


def test_every_stage_gets_the_same_random_stream():
    """Dropout inside the stage: every stage draws the masks the first does
    (the JAX package hands every stage the same key), reproducibly."""
    from bigdl_tpu_torch.utils.random import RandomGenerator

    inp = pnn.Input()
    drop = pnn.Dropout(0.5, device="cpu").inputs(inp)
    stack = pnn.PipelinedBlocks(pnn.Graph(inp, drop, device="cpu"), 2, device="cpu")
    ones = torch.ones(4, 64)
    stack.init(sample_input=ones)
    RandomGenerator.set_seed(5)
    y1, _ = stack.apply(stack.get_parameters(), {}, ones, training=True,
                        rng=RandomGenerator.generator())
    # the same mask twice: kept units scaled by 2 twice, dropped ones 0
    assert set(torch.unique(y1).tolist()) == {0.0, 4.0}
    RandomGenerator.set_seed(5)
    y2, _ = stack.apply(stack.get_parameters(), {}, ones, training=True,
                        rng=RandomGenerator.generator())
    assert torch.equal(y1, y2)


def test_pipeline_parallel_without_a_mesh_runs_sequentially():
    params = _np_tree(_jax_stack().get_parameters())
    pm = _port_stack(params)
    pp = pnn.PipelinedBlocks(block(pnn, device="cpu"), S, pipeline_parallel=True, n_micro=2,
                             device="cpu")
    pp.init(sample_input=_x())
    load_jax_params(pp, params)
    x = torch.from_numpy(_x(4))
    assert torch.equal(pp.forward(x), pm.forward(x))
    with pytest.raises(NotImplementedError, match="parallel/pipeline"):
        pp.set_mesh(object())


def test_build_errors():
    with pytest.raises(TypeError, match="module"):
        pnn.PipelinedBlocks(lambda v: v, 2, device="cpu")
    with pytest.raises(ValueError, match="n_stages"):
        pnn.PipelinedBlocks(block(pnn, device="cpu"), 1, device="cpu")
    stateful = pnn.PipelinedBlocks(pnn.BatchNormalization(H, device="cpu"), 2, device="cpu")
    with pytest.raises(ValueError, match="stateless"):
        stateful.init(sample_input=np.zeros((4, H), np.float32))
    reshaping = pnn.PipelinedBlocks(pnn.Linear(H, 2 * H, device="cpu"), 2, device="cpu")
    with pytest.raises(ValueError, match="shape-preserving"):
        reshaping.init(sample_input=np.zeros((4, H), np.float32))
    built = pnn.Linear(H, H, device="cpu")
    built.init(sample_input=np.zeros((1, H), np.float32))
    with pytest.raises(ValueError, match="unbuilt"):
        pnn.PipelinedBlocks(built, 2, device="cpu").init(
            sample_input=np.zeros((1, H), np.float32))
    # the JAX package refuses the same stages
    for stage in (jnn.BatchNormalization(H), jnn.Linear(H, 2 * H)):
        with pytest.raises(ValueError):
            jnn.PipelinedBlocks(stage, 2).init(jax.random.PRNGKey(0),
                                               sample_input=jnp.zeros((4, H)))


def test_conversions_move_the_stack():
    pm = _port_stack()
    pm.double()
    assert all(p.dtype == torch.float64 for p in pm.parameters())
    w = pm.get_parameters()["stages"]["FeedForwardNetwork_1"]["filter_w"]
    assert w is pm.stages.FeedForwardNetwork_1.filter_w and w.dtype == torch.float64
    y = pm.forward(torch.from_numpy(_x()).double())
    assert y.dtype == torch.float64
