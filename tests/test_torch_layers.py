"""The port's flagship layers and containers against the JAX package's:
``SpatialAveragePooling``, ``Reshape``, ``SpaceToDepth``, ``CAddTable``,
``ReLU``, ``LogSoftMax``, ``Linear``, ``Sequential`` and ``Graph``
(topological order, the multi-parent ``Table``, naming, parameter paths),
and the initialisers ``MsraFiller`` and ``RandomUniform``.

Inputs from numpy with a seed, f32 on the CPU, outputs and gradients
compared with ``run_pair`` of ``test_torch_conv_bn.py`` at its 1e-5
tolerance (the same arithmetic summed in another order). The bf16 average
pool is held at 1e-2: the JAX package sums the window in bf16, the port in
fp32 rounded once.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bigdl_tpu.nn as jnn
from bigdl_tpu_torch import Engine
from bigdl_tpu_torch import nn as pnn
from bigdl_tpu_torch.utils.table import T

from test_torch_conv_bn import assert_pair, np_tree, run_pair


@pytest.fixture(autouse=True)
def _fp32_policy():
    Engine.set_compute_dtype("float32")
    yield
    Engine.set_compute_dtype(None)


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("args,kw,shape", [
    ((7, 7), dict(global_pooling=True), (2, 3, 5, 6)),
    ((3, 3, 2, 2), dict(ceil_mode=True), (2, 3, 10, 9)),
    ((3, 3, 2, 2, 1, 1), dict(count_include_pad=False), (2, 3, 9, 9)),
    ((3, 3, 2, 2, 1, 1), dict(count_include_pad=True, ceil_mode=True), (2, 3, 10, 10)),
    ((2, 3, 2, 1, -1, -1), {}, (2, 3, 7, 8)),
    ((2, 2), dict(divide=False), (2, 3, 6, 6)),
])
def test_spatial_average_pooling_matches_jax(args, kw, shape):
    j, p = run_pair(jnn.SpatialAveragePooling(*args, **kw),
                    pnn.SpatialAveragePooling(*args, **kw, device="cpu"), _x(shape), True)
    assert_pair(j, p)


def test_spatial_average_pooling_bf16():
    """bf16 stays bf16; the port's fp32 window sum is within bf16 rounding
    of the JAX package's bf16 sum."""
    x = np.array(jnp.asarray(_x((2, 4, 7, 7), 1), jnp.bfloat16).astype(jnp.float32))
    jm = jnn.SpatialAveragePooling(7, 7, global_pooling=True)
    pm = pnn.SpatialAveragePooling(7, 7, global_pooling=True, device="cpu")
    jy = jm.apply({}, {}, jnp.asarray(x, jnp.bfloat16))[0]
    py = pm.apply({}, {}, torch.from_numpy(x).bfloat16())[0]
    assert py.dtype == torch.bfloat16 and py.shape == (2, 4, 1, 1)
    exact = x.reshape(2, 4, -1).mean(-1)[..., None, None]
    np.testing.assert_allclose(py.float().numpy(), np.asarray(jy, np.float32), atol=1e-2,
                               rtol=1e-2)
    np.testing.assert_allclose(py.float().numpy(), exact, atol=4e-3, rtol=2 ** -8)


@pytest.mark.parametrize("make", [
    lambda d: (jnn.Reshape([12]), pnn.Reshape([12], **d)),
    lambda d: (jnn.Reshape([2, 12], batch_mode=False), pnn.Reshape([2, 12], batch_mode=False, **d)),
    lambda d: (jnn.SpaceToDepth(2), pnn.SpaceToDepth(2, **d)),
    lambda d: (jnn.ReLU(), pnn.ReLU(**d)),
    lambda d: (jnn.LogSoftMax(), pnn.LogSoftMax(**d)),
    lambda d: (jnn.Linear(2, 5), pnn.Linear(2, 5, **d)),
    lambda d: (jnn.Linear(2, 5, activation="relu"), pnn.Linear(2, 5, activation="relu", **d)),
    lambda d: (jnn.Linear(2, 5, with_bias=False, activation="tanh"),
               pnn.Linear(2, 5, with_bias=False, activation="tanh", **d)),
], ids=["reshape", "reshape-nobatch", "space-to-depth", "relu", "logsoftmax", "linear",
        "linear-relu", "linear-tanh-nobias"])
def test_layers_match_jax(make):
    jm, pm = make({"device": "cpu"})
    x = _x((2, 3, 2, 2), 2)
    x[0, 0, 0, :] = 0.0  # exact zeros: ReLU's tie takes half the gradient in both
    j, p = run_pair(jm, pm, x, True)
    assert_pair(j, p)


def test_cadd_table_sums_a_table():
    a, b, c = (torch.from_numpy(_x((2, 3), s)) for s in range(3))
    m = pnn.CAddTable(device="cpu")
    torch.testing.assert_close(m.forward(T(a, b, c)), a + b + c)
    torch.testing.assert_close(m.forward([a, b]), a + b)


def test_initializers_draw_their_distributions():
    """MsraFiller(False): N(0, 2/fanIn); RandomUniform(): U(±1/sqrt(fanIn));
    RandomUniform(lo, hi) within its bounds (200k draws: the sample std is
    within 1% of the target with room to spare)."""
    g = torch.Generator().manual_seed(0)
    w = pnn.MsraFiller(False)(g, (400, 500), 50, 80)
    assert abs(w.std().item() / (2 / 50) ** 0.5 - 1) < 0.01 and abs(w.mean().item()) < 1e-3
    w = pnn.MsraFiller(True)(g, (400, 500), 50, 150)
    assert abs(w.std().item() / (2 / 100) ** 0.5 - 1) < 0.01
    u = pnn.RandomUniform()(g, (400, 500), 25, 3)
    assert u.abs().max().item() <= 0.2 and u.abs().max().item() > 0.199
    u = pnn.RandomUniform(-1.0, 3.0)(g, (1000,), 1, 1)
    assert u.min().item() >= -1.0 and u.max().item() <= 3.0


def _sequential_pair():
    j = jnn.Sequential(jnn.Linear(4, 6), jnn.ReLU(), jnn.Linear(6, 3).set_name("head"))
    p = pnn.Sequential(pnn.Linear(4, 6, device="cpu"), pnn.ReLU(device="cpu"),
                       pnn.Linear(6, 3, device="cpu").set_name("head"), device="cpu")
    return j, p


def test_sequential_names_paths_and_output_match_jax():
    jm, pm = _sequential_pair()
    j, p = run_pair(jm, pm, _x((5, 4), 3), True)
    assert_pair(j, p)
    assert [m.name() for m in pm] == [m.name() for m in jm.modules] == [
        "Linear_0", "ReLU_1", "head"]
    assert [k for k, _ in pm.named_parameters()] == [
        "Linear_0.weight", "Linear_0.bias", "head.weight", "head.bias"]
    assert pm.get_state() == {"Linear_0": {}, "ReLU_1": {}, "head": {}}
    assert pm.n_parameters() == jm.n_parameters() == 4 * 6 + 6 + 6 * 3 + 3
    with pytest.raises(ValueError, match="duplicate"):
        pm.add(pnn.ReLU(device="cpu").set_name("head"))


def _graph(nn, d):
    """x -> a -> (b, c) -> add(b, c) -> out, plus a skip of a into the add."""
    inp = nn.Input()
    a = nn.Linear(4, 6, **d).set_name("a").inputs(inp)
    b = nn.Sequential(nn.Linear(6, 6, **d), nn.ReLU(**d), **d).set_name("b").inputs(a)
    c = nn.Linear(6, 6, **d).set_name("c").inputs(a)
    add = nn.CAddTable(**d).set_name("add").inputs(b, c, a)
    out = nn.Linear(6, 2, **d).set_name("out").inputs(add)
    return nn.Graph(inp, out, **d)


def test_graph_matches_jax():
    jm, pm = _graph(jnn, {}), _graph(pnn, {"device": "cpu"})
    j, p = run_pair(jm, pm, _x((3, 4), 4), True)
    assert_pair(j, p)
    order = [n.module.name() for n in pm._topo if n not in pm.input_nodes]
    assert order == [m.name() for m in jm.modules]
    assert order.index("a") < order.index("b") < order.index("add") < order.index("out")
    assert order.index("c") < order.index("add")
    assert set(dict(pm.named_parameters())) == {
        "a.weight", "a.bias", "b.Linear_0.weight", "b.Linear_0.bias", "c.weight", "c.bias",
        "out.weight", "out.bias"}
    assert pm.b is pm[order.index("b")]  # children are registered submodules


def test_graph_errors():
    d = {"device": "cpu"}
    inp = pnn.Input()
    a = pnn.Linear(2, 2, **d).inputs(inp)
    b = pnn.Linear(2, 2, **d).inputs(a)
    a.parents.append(b)  # a <- b <- a
    with pytest.raises(ValueError, match="cycle"):
        pnn.Graph(inp, b, **d)
    inp, other = pnn.Input(), pnn.Input()
    with pytest.raises(ValueError, match="not connected"):
        pnn.Graph([inp, other], pnn.ReLU(**d).inputs(inp), **d)
    shared = pnn.Linear(2, 2, **d)
    inp = pnn.Input()
    g = pnn.Graph(inp, shared.inputs(shared.inputs(inp)), **d)  # a module at two nodes
    assert list(g.children()) == [shared]
    g = pnn.Graph(inp, pnn.ReLU(**d).inputs(inp), **d)
    with pytest.raises(ValueError, match="expects 1 inputs"):
        g.forward(T(torch.zeros(2), torch.zeros(2)))


def test_container_build_leaves_running_statistics_untouched():
    """Building a container runs its children in eval mode under no_grad:
    the BN running statistics stay at their initial values."""
    x = torch.from_numpy(_x((4, 3, 5, 5), 5) * 4 + 2)
    seq = pnn.Sequential(pnn.SpatialBatchNormalization(3, device="cpu"),
                         pnn.SpatialBatchNormalization(3, device="cpu"), device="cpu")
    seq.init(sample_input=x)
    for s in seq.get_state().values():
        assert not s["running_mean"].any() and (s["running_var"] == 1).all()
    seq.train()
    seq.forward(x)
    assert seq.get_state()["SpatialBatchNormalization_0"]["running_mean"].abs().sum() > 0
