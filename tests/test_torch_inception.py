"""The port's Inception-v1 slice against the JAX package's: ``Concat`` (each
dim, the JAX result type, its error text), ``SpatialCrossMapLRN`` (f32, and
the output dtype under the bf16 policy), one narrow ``_inception_module``
trained 3 ``LocalOptimizer`` SGD steps, and the whole ``Inception_v1``
(dropout off) at batch 2 of 224x224: parameter paths, the f32 forward and
its 13 max-pool geometries, and the bf16 policy node by node.

Weights carried over with ``load_jax_params``; inputs from numpy with a
seed, f32 on the CPU. Tolerances, fixed before the first run:
- ``Concat``: exact (a copy of elements) in outputs and gradients;
- LRN in f32: 1e-5 relative + 1e-6 absolute in y and dx (a window of at
  most 5 squares summed in another order, and libm's pow against XLA's);
- LRN in bf16: the JAX package rounds the square, the window sum, the
  scaled sum, k + it, the power and the quotient to bf16 (each 2^-9
  relative, 2^-6 together at most), the port computes in fp32 and rounds
  once: 2^-5 relative + 1e-6;
- the narrow module after 3 steps: losses 1e-4, every parameter 1e-4
  absolute and the whole update within 1e-3 relative L2 (as the narrow VGG
  of ``test_torch_vgg.py``: ReLU gates near zero);
- the whole model in f32: log-probabilities 1e-4 absolute (the same f32
  products summed in another order through 22 layers);
- under the bf16 policy each top-level node fed the JAX node's inputs:
  within 1e-2 relative L2 and 5e-2 of its largest value, as the ResNet's
  nodes in ``test_torch_resnet.py`` (a node sums bf16-rounded products in
  another order; the LRN rounds once in the port).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bigdl_tpu.nn as jnn
from bigdl_tpu.models.inception import Inception_v1 as JInception_v1
from bigdl_tpu.models.inception import _inception_module as j_inception_module
from bigdl_tpu.nn.module import infer_module_shape
from bigdl_tpu.utils.engine import Engine as JEngine
from bigdl_tpu_torch import Engine
from bigdl_tpu_torch import nn as pnn
from bigdl_tpu_torch.models import Inception_v1
from bigdl_tpu_torch.models.inception import _inception_module
from bigdl_tpu_torch.nn import pooling
from bigdl_tpu_torch.utils.convert import load_jax_params

from test_torch_conv_bn import flat, np_tree
from test_torch_lenet import sgd_steps, update_distance

SHAPE = (2, 3, 224, 224)


@pytest.fixture(autouse=True, scope="module")
def _engine_isolation():
    """The JAX LocalOptimizer here runs on one device (see test_torch_training.py)."""
    JEngine.reset()
    yield
    JEngine.reset()


@pytest.fixture(autouse=True)
def _fp32_policy():
    Engine.set_compute_dtype("float32")
    Engine.set_activation_dtype(None)
    yield
    Engine.set_compute_dtype(None)


def _images():
    return np.random.default_rng(0).standard_normal(SHAPE).astype(np.float32)


@pytest.fixture(scope="module")
def jax_ref():
    """The JAX Inception-v1 (dropout off), its weights and its f32 log-probabilities."""
    jm = JInception_v1(1000, has_dropout=False)
    jp, js = jm.init(jax.random.PRNGKey(0), sample_input=_images())
    y = jm.apply(jp, js, jnp.asarray(_images()), training=True)[0]
    return dict(model=jm, params=jp, state=js, np_params=np_tree(jp), logprobs=np.asarray(y))


def _port(ref):
    pm = Inception_v1(1000, has_dropout=False, device="cpu")
    pm.init(sample_input=_images()[:1])
    load_jax_params(pm, ref["np_params"])  # no key left over on either side
    return pm


# ---------------------------------------------------------------- Concat
def _branches(nn, **kw):
    return [nn.Identity(**kw).set_name("id"), nn.ReLU(**kw).set_name("relu"),
            nn.Identity(**kw).set_name("id_again")]


@pytest.mark.parametrize("dimension", [1, 2, 3, 4])
def test_concat_matches_jax(dimension):
    rng = np.random.default_rng(dimension)
    x = rng.standard_normal((2, 3, 4, 5)).astype(np.float32)
    jm, pm = jnn.Concat(dimension), pnn.Concat(dimension, device="cpu")
    for b in _branches(jnn):
        jm.add(b)
    for b in _branches(pnn, device="cpu"):
        pm.add(b)
    jp, js = jm.init(jax.random.PRNGKey(0), sample_input=x)
    pm.init(sample_input=x)
    jy, vjp = jax.vjp(lambda v: jm.apply(jp, js, v)[0], jnp.asarray(x))
    dy = rng.standard_normal(jy.shape).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_(True)
    py, _ = pm.apply(pm.get_parameters(), pm.get_state(), xt)
    np.testing.assert_array_equal(py.detach().numpy(), np.asarray(jy))
    (pdx,) = torch.autograd.grad(py, xt, torch.from_numpy(dy))
    np.testing.assert_array_equal(pdx.numpy(), np.asarray(vjp(jnp.asarray(dy))[0]))


def test_concat_keeps_the_jax_result_type():
    """bf16 branches stay bf16; a bf16 and an f32 branch give f32."""
    x = np.random.default_rng(0).standard_normal((2, 6)).astype(np.float32)
    for second, want in ((jnn.Identity, jnp.bfloat16), (jnn.LogSoftMax, jnp.float32)):
        jm = jnn.Concat(2)
        jm.add(jnn.Identity().set_name("a"))
        jm.add(second().set_name("b"))
        pm = pnn.Concat(2, device="cpu")
        pm.add(pnn.Identity(device="cpu").set_name("a"))
        pm.add(getattr(pnn, second.__name__)(device="cpu").set_name("b"))
        jx = jnp.asarray(x, jnp.bfloat16)
        jp, js = jm.init(jax.random.PRNGKey(0), sample_input=jx)
        jy = jm.apply(jp, js, jx)[0]
        pm.init(sample_input=torch.from_numpy(x).to(torch.bfloat16))
        py, _ = pm.apply(pm.get_parameters(), pm.get_state(),
                         torch.from_numpy(x).to(torch.bfloat16))
        assert jy.dtype == want
        assert py.dtype == (torch.bfloat16 if want == jnp.bfloat16 else torch.float32)
        np.testing.assert_allclose(py.float().numpy(), np.asarray(jy, np.float32), atol=1e-6)


@pytest.mark.parametrize("case", ["shapes", "dim"])
def test_concat_errors_match_jax(case):
    """The port raises, when it builds, the message of the JAX package's
    merge-point check (``check_concat_specs``)."""
    x = np.zeros((2, 3, 8, 8), np.float32)

    def make(nn, **kw):
        c = nn.Concat(2 if case == "shapes" else 5, **kw).set_name("cat")
        c.add(nn.SpatialConvolution(3, 4, 3, 3, **kw).set_name("a"))
        c.add(nn.SpatialConvolution(3, 5, 3, 3, 1, 1, 1, 1, **kw).set_name("b"))
        return c

    with pytest.raises(ValueError) as want:
        infer_module_shape(make(jnn), jax.ShapeDtypeStruct(x.shape, jnp.float32))
    with pytest.raises(ValueError) as got:
        make(pnn, device="cpu").init(sample_input=x)
    assert str(got.value) == str(want.value)
    assert ("cannot concatenate along dim 2" if case == "shapes" else "out of range") in \
        str(got.value)


# ------------------------------------------------------------------- LRN
@pytest.mark.parametrize("size,alpha,beta,k", [(5, 1e-4, 0.75, 1.0), (4, 1.0, 0.5, 2.0),
                                               (3, 2.0, 0.75, 1.0)],
                         ids=["inception", "even_size", "size3"])
def test_lrn_matches_jax(size, alpha, beta, k):
    rng = np.random.default_rng(size)
    x = (2 * rng.standard_normal((2, 7, 5, 6))).astype(np.float32)
    dy = rng.standard_normal(x.shape).astype(np.float32)
    jm = jnn.SpatialCrossMapLRN(size, alpha, beta, k)
    jy, vjp = jax.vjp(lambda v: jm.apply({}, {}, v)[0], jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    py, _ = pnn.SpatialCrossMapLRN(size, alpha, beta, k, device="cpu").apply({}, {}, xt)
    (pdx,) = torch.autograd.grad(py, xt, torch.from_numpy(dy))
    assert py.dtype == torch.float32
    np.testing.assert_allclose(py.detach().numpy(), np.asarray(jy), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(pdx.numpy(), np.asarray(vjp(jnp.asarray(dy))[0]), rtol=1e-5,
                               atol=1e-6)


def test_lrn_bf16_keeps_the_dtype():
    x = (2 * np.random.default_rng(9).standard_normal((2, 9, 4, 4))).astype(np.float32)
    jy = jnn.SpatialCrossMapLRN(5, 1.0, 0.75).apply({}, {}, jnp.asarray(x, jnp.bfloat16))[0]
    py, _ = pnn.SpatialCrossMapLRN(5, 1.0, 0.75, device="cpu").apply(
        {}, {}, torch.from_numpy(x).to(torch.bfloat16))
    assert jy.dtype == jnp.bfloat16 and py.dtype == torch.bfloat16
    want = np.asarray(jy, np.float32)
    np.testing.assert_allclose(py.float().numpy(), want, rtol=2 ** -5, atol=1e-6)


# ------------------------------------------------- one narrow inception module
CONFIG = ((4,), (4, 6), (2, 3), (3,))  # 4 + 6 + 3 + 3 = 16 channels out


def _narrow(nn, **kw):
    mod = j_inception_module if nn is jnn else _inception_module
    return nn.Sequential(
        mod(8, CONFIG, "inc", **kw),
        nn.SpatialAveragePooling(8, 8, 1, 1, **kw).set_name("gap"),
        nn.Reshape([16], **kw).set_name("flatten"),
        nn.Linear(16, 5, **kw).set_name("fc"),
        nn.LogSoftMax(**kw).set_name("logsoftmax"), **kw)


def test_inception_module_trains_like_jax():
    rng = np.random.default_rng(6)
    x = rng.standard_normal((8, 8, 8, 8)).astype(np.float32)
    y = rng.integers(0, 5, 8)
    run = sgd_steps(_narrow(jnn), _narrow(pnn, device="cpu"), x, y, batch=4)
    assert len(run["losses"]) == len(run["jax_losses"]) == 3
    np.testing.assert_allclose(run["losses"], run["jax_losses"], atol=1e-4)
    for k, v in run["jax_params"].items():
        np.testing.assert_allclose(run["params"][k], v, atol=1e-4, err_msg=k)
    assert update_distance(run) <= 1e-3
    assert "inc.inc_b4.inc_poolproj.weight" in run["params"]


# ------------------------------------------------------- the whole model
@pytest.mark.parametrize("has_dropout", [False, True])
def test_inception_paths_match_jax(jax_ref, has_dropout):
    ref_params = jax_ref["np_params"]
    want = {k: v.shape for k, v in flat(ref_params).items()}
    pm = Inception_v1(1000, has_dropout=has_dropout, device="cpu")
    pm.init(sample_input=_images()[:1])
    assert {k: tuple(v.shape) for k, v in pm.named_parameters()} == want
    load_jax_params(pm, ref_params)
    names = [m.name() for m in pm]
    assert [n for n in names if n != "pool5/drop_7x7_s1"] == \
        [m.name() for m in jax_ref["model"].modules]
    assert ("pool5/drop_7x7_s1" in names) == has_dropout
    assert sum(p.numel() for p in pm.parameters()) == 6998552


def test_inception_forward_matches_jax(jax_ref, monkeypatch):
    """f32 log-probabilities, and the 13 max pools' geometries: 4 ceil-mode
    3x3/s2 pools with the overhang on the high side only, 9 branch pools
    3x3/s1/p1."""
    pm = _port(jax_ref)
    seen = []
    real = pooling.maxpool2d
    monkeypatch.setattr(pooling, "maxpool2d",
                        lambda x, *g: seen.append((tuple(x.shape[2:]), *g)) or real(x, *g))
    for training in (True, False):
        seen.clear()
        y, _ = pm.apply(pm.get_parameters(), pm.get_state(), torch.from_numpy(_images()),
                        training=training)
        np.testing.assert_allclose(y.detach().numpy(), jax_ref["logprobs"], atol=1e-4)
    s2, s1 = ((3, 3), (2, 2), ((0, 1), (0, 1))), ((3, 3), (1, 1), ((1, 1), (1, 1)))
    assert seen == [((112, 112), *s2), ((56, 56), *s2), ((28, 28), *s1), ((28, 28), *s1),
                    ((28, 28), *s2)] + [((14, 14), *s1)] * 5 + [((14, 14), *s2)] + \
        [((7, 7), *s1)] * 2


def _to_torch(a):
    dt = torch.bfloat16 if a.dtype == jnp.bfloat16 else torch.float32
    return torch.from_numpy(np.array(a.astype(jnp.float32))).to(dt)


def test_inception_bf16_policy_matches_jax_node_by_node(jax_ref):
    pm = _port(jax_ref)
    jm, jp, js = jax_ref["model"], jax_ref["params"], jax_ref["state"]
    prev = (JEngine._state.compute_dtype, JEngine._state.activation_dtype)
    for engine in (JEngine, Engine):
        engine.set_compute_dtype("bfloat16")
        engine.set_activation_dtype("bfloat16")
    try:
        jx = jnp.asarray(_images())
        for m, q in zip(jm.modules, pm):
            assert m.name() == q.name()
            jy = m._apply(jp[m.name()], js[m.name()], jx, True, None)[0]
            py = q._apply_params(pm.get_parameters()[q.name()], pm.get_state()[q.name()],
                                 _to_torch(jx), True, None)[0]
            want, got = np.asarray(jy.astype(jnp.float32)), py.detach().float().numpy()
            assert (py.dtype == torch.bfloat16) == (jy.dtype == jnp.bfloat16), m.name()
            assert np.linalg.norm(got - want) <= 1e-2 * np.linalg.norm(want), m.name()
            assert np.abs(got - want).max() <= 5e-2 * np.abs(want).max(), m.name()
            jx = jy
        assert len(pm) == len(jm.modules) == 25
        y, _ = pm.apply(pm.get_parameters(), pm.get_state(), torch.from_numpy(_images()),
                        training=True)
        assert y.dtype == torch.float32 and bool(torch.isfinite(y).all())
    finally:
        JEngine._state.compute_dtype, JEngine._state.activation_dtype = prev
        Engine.set_activation_dtype(None)
