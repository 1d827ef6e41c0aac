"""The port's flagship ResNet-50 against the JAX package's, both stems, with
the JAX model's weights and BN state carried over (``load_jax_params``,
``load_jax_state``).

Size: batch 2 of (3, 64, 64) images from numpy with a seed, ``class_num=10``.
At 32x32 the last stage sees 1x1 maps, so train-mode BN there normalises two
values per channel and amplifies the 1e-7 differences of summation order into
O(1) differences of the output; at 64x64 it normalises eight, and the f32
train step agrees to 1e-4.

Tolerances, f32 (the same products summed in another order, through 50
layers): train-mode logits and loss 1e-3 absolute, new BN state 1e-3
absolute + 1e-3 relative, eval-mode logits 1e-4 of their largest value. The
parameter gradients are piecewise in the ReLU gates: a gate whose input lies
within the forward's ~1e-4 difference of zero opens in one package and not in
the other, and each such flip moves the whole gradient below it by about 1%.
So the head's gradients (no gate between them and the loss; they carry the
pooled features' forward difference) are held elementwise at 1e-3, and the
whole gradient tree at a relative L2 distance of 5e-2 (each tensor within
1e-1).

bf16 compute with the bf16 activation policy: bf16 steps (2^-8 relative)
taken at other places are amplified the same way through the depth, so the
two models are compared node by node, each node of the port fed the JAX
node's inputs: every node's output within 1e-2 relative L2 and 5e-2 of its
largest value (a node sums a few bf16-rounded products; the average pool
sums in bf16 in JAX and in fp32 in the port).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bigdl_tpu.nn as jnn
from bigdl_tpu.models import ResNet as JResNet
from bigdl_tpu.models import flagship_model as jax_flagship_model
from bigdl_tpu.utils.engine import Engine as JEngine
from bigdl_tpu.utils.table import T as JT
from bigdl_tpu_torch import Engine
from bigdl_tpu_torch.models import ResNet, flagship_model
from bigdl_tpu_torch.nn import ClassNLLCriterion
from bigdl_tpu_torch.utils.convert import load_jax_params, load_jax_state
from bigdl_tpu_torch.utils.table import T

from test_torch_conv_bn import flat, np_tree

SHAPE, CLASSES = (2, 3, 64, 64), 10
TARGETS = np.array([3, 7])


@pytest.fixture(autouse=True)
def _fp32_policy():
    Engine.set_compute_dtype("float32")
    Engine.set_activation_dtype(None)
    yield
    Engine.set_compute_dtype(None)
    Engine.set_activation_dtype(None)


def _images():
    return np.random.default_rng(0).standard_normal(SHAPE).astype(np.float32)


@pytest.fixture(scope="module")
def jax_ref():
    """One JAX ResNet-50 per stem, shared by the cases: parameters, state,
    the f32 train step (loss, logits, new state, gradients) and eval logits."""
    cache = {}

    def get(stem):
        if stem not in cache:
            x = _images()
            jm = JResNet(50, class_num=CLASSES, stem=stem)
            jp, js = jm.init(jax.random.PRNGKey(0), sample_input=x)
            crit = jnn.ClassNLLCriterion()

            def loss_fn(p):
                y, s = jm.apply(p, js, jnp.asarray(x), training=True, rng=None)
                return crit._apply(y, jnp.asarray(TARGETS)), (y, s)

            (loss, (y, ns)), grads = jax.value_and_grad(loss_fn, has_aux=True)(jp)
            cache[stem] = dict(
                model=jm, params=jp, state=js, np_params=np_tree(jp), np_state=np_tree(js),
                loss=float(loss), logits=np.asarray(y), new_state=flat(np_tree(ns)),
                grads=flat(np_tree(grads)),
                eval_logits=np.asarray(jm.apply(jp, js, jnp.asarray(x), training=False)[0]))
        return cache[stem]

    return get


def _port(ref, stem):
    pm = ResNet(50, class_num=CLASSES, stem=stem, device="cpu")
    pm.init(sample_input=_images())
    load_jax_params(pm, ref["np_params"])
    load_jax_state(pm, ref["np_state"])
    return pm


@pytest.mark.parametrize("stem", ["s2d", "conv7"])
def test_paths_match_jax(jax_ref, stem):
    ref = jax_ref(stem)
    pm = ResNet(50, class_num=CLASSES, stem=stem, device="cpu")
    pm.init(sample_input=_images())
    want = {k: v.shape for k, v in flat(ref["np_params"]).items()}
    got = {k: tuple(v.shape) for k, v in pm.named_parameters()}
    assert got == want
    assert {k: v.shape for k, v in flat(pm.get_state()).items()} == {
        k: v.shape for k, v in flat(ref["np_state"]).items()}
    assert [m.name() for m in pm] == [m.name() for m in ref["model"].modules]
    first = "stem_seq.stem_s2d_seq.stem.stem_conv.weight" if stem == "s2d" else \
        "stem_seq.stem.stem_conv.weight"
    assert first in got


@pytest.mark.parametrize("stem", ["s2d", "conv7"])
def test_train_step_matches_jax(jax_ref, stem):
    ref = jax_ref(stem)
    pm = _port(ref, stem)
    y, new_state = pm.apply(pm.get_parameters(), pm.get_state(), torch.from_numpy(_images()),
                            training=True)
    loss = ClassNLLCriterion()._apply(y, TARGETS)
    loss.backward()
    assert abs(loss.item() - ref["loss"]) < 1e-3
    np.testing.assert_allclose(y.detach().numpy(), ref["logits"], atol=1e-3)
    got_state = flat(new_state)
    assert set(got_state) == set(ref["new_state"])
    for k, v in ref["new_state"].items():
        np.testing.assert_allclose(got_state[k], v, atol=1e-3, rtol=1e-3, err_msg=k)
    grads = {k: p.grad.numpy() for k, p in pm.named_parameters()}
    want = ref["grads"]
    assert set(grads) == set(want)
    for k in ("fc.weight", "fc.bias"):
        np.testing.assert_allclose(grads[k], want[k], atol=1e-3, rtol=1e-3, err_msg=k)
    for k in want:
        assert np.linalg.norm(grads[k] - want[k]) <= 1e-1 * np.linalg.norm(want[k]), k
    dist = np.sqrt(sum(np.sum((grads[k] - want[k]) ** 2) for k in want))
    assert dist <= 5e-2 * np.sqrt(sum(np.sum(v ** 2) for v in want.values()))


@pytest.mark.parametrize("stem", ["s2d", "conv7"])
def test_eval_logits_match_jax(jax_ref, stem):
    ref = jax_ref(stem)
    pm = _port(ref, stem).eval()
    y = pm.forward(_images()).detach().numpy()
    np.testing.assert_allclose(y, ref["eval_logits"], atol=1e-4 * np.abs(ref["eval_logits"]).max())


def _to_torch(a):
    dt = torch.bfloat16 if a.dtype == jnp.bfloat16 else torch.float32
    return torch.from_numpy(np.array(a.astype(jnp.float32))).to(dt)


def test_bf16_policy_matches_jax_node_by_node(jax_ref):
    ref = jax_ref("s2d")
    pm = _port(ref, "s2d")
    jm, jp, js = ref["model"], ref["params"], ref["state"]
    prev = (JEngine._state.compute_dtype, JEngine._state.activation_dtype)
    JEngine.set_compute_dtype("bfloat16")
    JEngine.set_activation_dtype("bfloat16")
    Engine.set_compute_dtype("bfloat16")
    Engine.set_activation_dtype("bfloat16")
    try:
        values, checked = {}, 0
        for jn, pn in zip(jm._topo, pm._topo):
            if jn in jm.input_nodes:
                values[jn.id] = jnp.asarray(_images())
                continue
            m, q = jn.module, pn.module
            assert m.name() == q.name()
            ins = [values[p.id] for p in jn.parents]
            jx = ins[0] if len(ins) == 1 else JT(*ins)
            px = _to_torch(ins[0]) if len(ins) == 1 else T(*map(_to_torch, ins))
            jy = m._apply(jp[m.name()], js[m.name()], jx, True, None)[0]
            py = q._apply_params(pm.get_parameters()[q.name()], pm.get_state()[q.name()], px,
                                 True, None)[0]
            values[jn.id] = jy
            want, got = np.asarray(jy.astype(jnp.float32)), py.detach().float().numpy()
            assert (py.dtype == torch.bfloat16) == (jy.dtype == jnp.bfloat16), m.name()
            assert np.linalg.norm(got - want) <= 1e-2 * np.linalg.norm(want), m.name()
            assert np.abs(got - want).max() <= 5e-2 * np.abs(want).max(), m.name()
            checked += 1
        assert checked == len(pm)
        # the whole model under the policy: bf16 logits, finite; fp32 BN state
        y, new_state = pm.apply(pm.get_parameters(), pm.get_state(),
                                torch.from_numpy(_images()), training=True)
        assert y.dtype == torch.bfloat16 and bool(torch.isfinite(y).all())
        assert np.isfinite(ClassNLLCriterion()._apply(y, TARGETS).item())
        assert all(v.dtype == np.float32 and np.isfinite(v).all()
                   for v in flat(new_state).values())
    finally:
        JEngine._state.compute_dtype, JEngine._state.activation_dtype = prev


def test_resnet50_parameter_count_at_224(jax_ref):
    """The conv7 ResNet-50 at 224 with 1000 classes: JAX's count (its
    10-class model's, with the fc resized) and the reference 25,557,032 within
    the JAX test's margin."""
    pm = ResNet(50, class_num=1000, stem="conv7", device="cpu")
    pm.init(sample_input=np.zeros((1, 3, 224, 224), np.float32))
    jax_count = ref_count = jax_ref("conv7")["model"].n_parameters()
    jax_count += 2048 * (1000 - CLASSES) + (1000 - CLASSES)
    assert pm.n_parameters() == jax_count and ref_count < jax_count
    assert abs(pm.n_parameters() - 25_557_032) < 100_000


def test_flagship_model_matches_jax():
    pm, px, pl, pname = flagship_model(batch=2, seed=3, stem="s2d", device="cpu")
    jm, jx, jl, jname = jax_flagship_model(batch=2, seed=3, stem="s2d")
    np.testing.assert_array_equal(px, jx)
    np.testing.assert_array_equal(pl, jl)
    assert pname == jname and px.shape == (2, 3, 224, 224) and px.dtype == np.float32
    assert [m.name() for m in pm] == [m.name() for m in jm.modules]


@pytest.mark.parametrize("depth,dataset", [(18, "imagenet"), (34, "imagenet"),
                                           (101, "imagenet"), (152, "imagenet"),
                                           (20, "cifar10")])
def test_every_depth_has_jax_names(depth, dataset):
    """Every ImageNet depth and the CIFAR-10 variant: the same nodes, in the
    same order, as the JAX package's graph (built without weights)."""
    pm = ResNet(depth, class_num=10, dataset=dataset, with_log_softmax=True, device="cpu")
    jm = JResNet(depth, class_num=10, dataset=dataset, with_log_softmax=True)
    assert [m.name() for m in pm] == [m.name() for m in jm.modules]


def test_invalid_configurations_raise():
    with pytest.raises(ValueError):
        ResNet(37, device="cpu")
    with pytest.raises(ValueError):
        ResNet(21, dataset="cifar10", device="cpu")
    with pytest.raises(ValueError, match="stem"):
        ResNet(50, stem="conv3", device="cpu")
