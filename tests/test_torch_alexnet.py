"""The port's AlexNet against the JAX package's, at 227x227 (fc6 needs the
6x6 planes), batch 2 and 10 classes: parameter paths with and without
dropout, the f32 log-probabilities with dropout off and its three max-pool
geometries (3x3/s2 without padding on 55-, 27- and 13-wide planes), the
bf16 policy node by node, 3 ``LocalOptimizer`` SGD steps (lr 0.01,
momentum 0.9, ``ClassNLLCriterion``, the example's recipe) from the JAX
model's weights; dropout mode's mask rate and scaling; and
``examples/alexnet_train``'s ``main`` to its end at a tiny size.

Weights carried over with ``load_jax_params``; inputs from numpy with a
seed, f32 on the CPU. Tolerances, fixed before the first run:
- log-probabilities in f32: 1e-4 absolute (the same f32 products summed in
  another order through 8 layers, and two LRNs whose powers are libm's
  against XLA's);
- under the bf16 policy each node fed the JAX node's inputs: within 1e-2
  relative L2 and 5e-2 of its largest value (``test_torch_inception.py``'s
  limits; the JAX LRN rounds each of its six steps to bf16, 2^-5 relative
  together at most, the port's rounds once);
- after 3 steps: losses 1e-4, every parameter 1e-4 absolute and the whole
  update within 1e-3 relative L2 (the narrow Inception module's limits:
  ReLU gates near zero);
- dropout: each fc layer's kept share within 5 standard deviations of 0.5,
  every kept value scaled by exactly 2, eval mode the identity.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu.models import AlexNet as JAlexNet
from bigdl_tpu.utils.engine import Engine as JEngine
from bigdl_tpu_torch import Engine
from bigdl_tpu_torch import nn as pnn
from bigdl_tpu_torch.examples import alexnet_train
from bigdl_tpu_torch.models import AlexNet
from bigdl_tpu_torch.nn import pooling
from bigdl_tpu_torch.utils.convert import load_jax_params

from test_torch_conv_bn import flat, np_tree
from test_torch_inception import _to_torch
from test_torch_lenet import sgd_steps, update_distance
from test_torch_ncf import _engine_isolation, _fp32_policy  # noqa: F401 (fixtures)

SHAPE = (2, 3, 227, 227)
CLASSES = 10


def _images(n=2, seed=0):
    return np.random.default_rng(seed).standard_normal((n,) + SHAPE[1:]).astype(np.float32)


@pytest.fixture(scope="module")
def jax_ref():
    """The JAX AlexNet (dropout off), its weights and its f32 log-probabilities."""
    jm = JAlexNet(CLASSES, has_dropout=False)
    jp, js = jm.init(jax.random.PRNGKey(0), sample_input=_images())
    y = jm.apply(jp, js, jnp.asarray(_images()), training=True)[0]
    return dict(model=jm, params=jp, state=js, np_params=np_tree(jp), logprobs=np.asarray(y))


def _port(ref, has_dropout=False):
    pm = AlexNet(CLASSES, has_dropout=has_dropout, device="cpu")
    pm.init(sample_input=_images(1))
    load_jax_params(pm, ref["np_params"])  # no key left over on either side
    return pm


@pytest.mark.parametrize("has_dropout", [False, True])
def test_alexnet_paths_match_jax(jax_ref, has_dropout):
    want = {k: v.shape for k, v in flat(jax_ref["np_params"]).items()}
    pm = _port(jax_ref, has_dropout)
    assert {k: tuple(v.shape) for k, v in pm.named_parameters()} == want
    names = [m.name() for m in pm]
    assert [n for n in names if not n.startswith("drop")] == \
        [m.name() for m in jax_ref["model"].modules]
    assert [n for n in names if n.startswith("drop")] == (["drop6", "drop7"] if has_dropout
                                                          else [])
    assert [m.name() for m in JAlexNet(CLASSES, has_dropout=has_dropout).modules] == names


def test_alexnet_forward_matches_jax(jax_ref, monkeypatch):
    """f32 log-probabilities, and the three max pools' geometries."""
    pm = _port(jax_ref)
    seen = []
    real = pooling.maxpool2d
    monkeypatch.setattr(pooling, "maxpool2d",
                        lambda x, *g: seen.append((tuple(x.shape[1:]), *g)) or real(x, *g))
    for training in (True, False):
        seen.clear()
        y, _ = pm.apply(pm.get_parameters(), pm.get_state(), torch.from_numpy(_images()),
                        training=training)
        np.testing.assert_allclose(y.detach().numpy(), jax_ref["logprobs"], atol=1e-4)
    geometry = ((3, 3), (2, 2), ((0, 0), (0, 0)))
    assert seen == [((96, 55, 55), *geometry), ((256, 27, 27), *geometry),
                    ((256, 13, 13), *geometry)]


def test_alexnet_bf16_policy_matches_jax_node_by_node(jax_ref):
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
        assert len(pm) == len(jm.modules) == 22
    finally:
        JEngine._state.compute_dtype, JEngine._state.activation_dtype = prev
        Engine.set_activation_dtype(None)


def test_alexnet_trains_like_jax():
    x = _images(4, seed=1)
    y = np.random.default_rng(2).integers(0, CLASSES, 4)
    run = sgd_steps(JAlexNet(CLASSES, has_dropout=False),
                    AlexNet(CLASSES, has_dropout=False, device="cpu"), x, y, batch=2)
    assert len(run["losses"]) == len(run["jax_losses"]) == 3
    np.testing.assert_allclose(run["losses"], run["jax_losses"], atol=1e-4)
    for k, v in run["jax_params"].items():
        np.testing.assert_allclose(run["params"][k], v, atol=1e-4, err_msg=k)
    assert update_distance(run) <= 1e-3


def test_alexnet_dropout_mode():
    """drop6/drop7 in train mode: about half the units kept, each scaled by
    2 (inverted dropout); eval mode draws nothing."""
    pm = AlexNet(CLASSES, device="cpu")
    x = torch.from_numpy(_images(4, seed=3))
    pm.init(sample_input=x[:1])
    names = [m.name() for m in pm]
    with torch.no_grad():
        h = pm.apply(pm.get_parameters(), pm.get_state(), x)[0]
        assert tuple(h.shape) == (4, CLASSES)
        ones = torch.ones(64, 4096)
        for name in ("drop6", "drop7"):
            drop = pm[names.index(name)]
            y = drop.apply({}, {}, ones, training=True, rng=torch.Generator().manual_seed(5))[0]
            kept = (y != 0).float().mean().item()
            assert abs(kept - 0.5) <= 5 * (0.25 / ones.numel()) ** 0.5, (name, kept)
            assert torch.equal(y[y != 0], torch.full_like(y[y != 0], 2.0))
            assert torch.equal(drop.apply({}, {}, ones, training=False)[0], ones)
        pm.train()
        a, b = pm.forward(x), pm.forward(x)
        assert not torch.equal(a, b)  # fresh masks each training forward
        pm.evaluate()
        assert torch.equal(pm.forward(x), pm.forward(x))


def test_alexnet_example_runs_to_its_end(tmp_path):
    path = str(tmp_path / "alexnet.bin")
    run = alexnet_train.main(["--platform", "cpu", "--max-epoch", "1", "--synthetic-size", "16",
                              "--class-num", "10", "-b", "4", "--model-save", path])
    hist = run.optimizer.history
    assert len(hist) == 3 and all(np.isfinite(h["loss"]) for h in hist)
    assert run.val_dataset is not None and run.optimizer.optim_method.state[
        "n_validations"] == 1
    x, y = alexnet_train.synthetic_images(16, 10)
    assert x.shape == (16, 3, 227, 227) and x.dtype == np.float32 and y.max() < 10
    # --model-save: the trained model in nn.load_module's format
    # (the JAX package reads it in test_torch_examples_flags.py)
    loaded = pnn.load_module(path, device="cpu")
    for (k, a), (_, b) in zip(run.model.named_parameters(), loaded.named_parameters()):
        assert torch.equal(a, b), k
