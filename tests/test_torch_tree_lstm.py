"""``BinaryTreeLSTM`` and ``encode_tree`` (``nn/tree_lstm.py``),
``TreeNNAccuracy`` and ``examples/treelstm_train.py`` against the JAX
package's, on the CPU.

Inputs from numpy with a seed, the JAX layer's weights carried into the
port. Tolerances, fixed before the first run: hidden states and every
gradient 1e-5 of the largest |value| (f32 sums in another order, through
up to three levels of the tree); the encodings, the accuracies' counts and
the refusals equal. The example's trees are the JAX main's array for array.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu.nn.tree_lstm import BinaryTreeLSTM as JTree
from bigdl_tpu.nn.tree_lstm import encode_tree as jencode
from bigdl_tpu.optim.validation import TreeNNAccuracy as JTreeNNAccuracy
from bigdl_tpu.utils.random import RandomGenerator as JRandom
from bigdl_tpu.utils.table import T as JT
from bigdl_tpu_torch import Engine
from bigdl_tpu_torch import nn as pnn
from bigdl_tpu_torch.analysis import ShapeProp
from bigdl_tpu_torch.examples import treelstm_train
from bigdl_tpu_torch.optim import TreeNNAccuracy
from bigdl_tpu_torch.utils.convert import load_jax_params
from bigdl_tpu_torch.utils.table import T

REL = 1e-5
TREES = {
    "example": [(-1, -1)] * 4 + [(0, 1), (2, 3), (4, 5)],
    "chain": [(-1, -1), (-1, -1), (0, 1), (-1, -1), (2, 3)],
    "one_child": [(-1, -1), (0, -1), (-1, 1)],
}


@pytest.fixture(autouse=True)
def _fp32_policy():
    Engine.set_compute_dtype("float32")
    Engine.set_activation_dtype(None)
    yield
    Engine.set_compute_dtype(None)


def _close(got, want, what=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=REL * np.abs(want).max(),
                               err_msg=what)


def _batch(seed=0, n=4, slots=7, d=5):
    """Trees of three shapes padded to ``slots``, with their inputs."""
    x = np.random.default_rng(seed).standard_normal((n, slots, d)).astype(np.float32)
    shapes = list(TREES)
    ch = np.stack([jencode(TREES[shapes[i % 3]], slots) for i in range(n)])
    return x, ch


def _pair(x, ch, h=6):
    JRandom.set_seed(2)
    jm = JTree(x.shape[-1], h)
    jp, js = jm.init(sample_input=JT(jnp.asarray(x), jnp.asarray(ch)))
    pm = pnn.BinaryTreeLSTM(x.shape[-1], h, device="cpu")
    pm.init(sample_input=T(x, ch))
    load_jax_params(pm, jax.tree_util.tree_map(np.asarray, jp))
    return jm, jp, js, pm


@pytest.mark.parametrize("name", sorted(TREES))
def test_encode_tree_equals_jax(name):
    np.testing.assert_array_equal(pnn.encode_tree(TREES[name], 8), jencode(TREES[name], 8))


@pytest.mark.parametrize("seed", [0, 1])
def test_forward_and_gradients_match_jax(seed):
    x, ch = _batch(seed)
    jm, jp, js, pm = _pair(x, ch)
    w = np.random.default_rng(seed + 5).standard_normal((4, 7, 6)).astype(np.float32)

    def jloss(p, xx):
        y = jm.apply(p, js, JT(xx, jnp.asarray(ch)), training=True, rng=None)[0]
        return jnp.sum(y * w) + jnp.sum(y[:, -1] ** 2), y

    (jl, jy), (jg, jgx) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jp, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    y, _ = pm.apply(pm.get_parameters(), pm.get_state(), T(xt, torch.from_numpy(ch)),
                    training=True)
    ((y * torch.from_numpy(w)).sum() + (y[:, -1] ** 2).sum()).backward()
    _close(y.detach().numpy(), jy, "states")
    _close(xt.grad.numpy(), jgx, "dx")
    for key, p in pm.named_parameters():
        _close(p.grad.numpy(), jg[key], key)


def test_slot_zero_is_the_frozen_zero_state():
    """A slot whose children are 0 reads the zero state: leaves with a zero
    input give o·tanh(i·u) of the bias alone, identical in every tree, and
    padding slots past a tree's nodes stay at that value too."""
    x, ch = _batch(3)
    x[:] = 0.0
    _, _, _, pm = _pair(x, ch)
    with torch.no_grad():
        y, _ = pm.apply(pm.get_parameters(), pm.get_state(), T(torch.from_numpy(x),
                                                                torch.from_numpy(ch)))
    leaf = y[0, 0]
    pad = ch.sum(-1) == 0  # leaves and padding: no child
    assert pad.sum() > 4
    for n, s in zip(*np.nonzero(pad)):
        assert torch.equal(y[n, s], leaf)


def test_mismatched_encoding_raises_as_in_jax():
    x, ch = _batch(4)
    jm, jp, js, pm = _pair(x, ch)
    with pytest.raises(ValueError, match="does not match") as je:
        jm.apply(jp, js, JT(jnp.asarray(x), jnp.asarray(ch[:, :6])), training=False, rng=None)
    with pytest.raises(ValueError, match="does not match") as pe:
        pm.apply(pm.get_parameters(), pm.get_state(), T(torch.from_numpy(x),
                                                        torch.from_numpy(ch[:, :6])))
    assert str(pe.value) == str(je.value)
    with pytest.raises(ValueError, match="declared input size 4"):
        pnn.BinaryTreeLSTM(4, 6, device="cpu").init(sample_input=T(x, ch))


def test_shape_prop_runs_the_tree_on_meta_tensors():
    x, ch = _batch(5)
    _, _, _, pm = _pair(x, ch)
    out = ShapeProp(pm).infer(T(x, ch))
    assert out.device.type == "meta" and tuple(out.shape) == (4, 7, 6)
    assert pnn.BinaryTreeLSTM.accepts_table_input is True


def test_model_file_from_jax_loads_in_the_port(tmp_path):
    x, ch = _batch(6)
    jm, jp, js, _ = _pair(x, ch)
    path = str(tmp_path / "tree.npz")
    jm.save_module(path)
    pm = pnn.load_module(path, device="cpu")
    with torch.no_grad():
        y, _ = pm.apply(pm.get_parameters(), pm.get_state(), T(torch.from_numpy(x),
                                                                torch.from_numpy(ch)))
    _close(y.numpy(), jm.apply(jp, js, JT(jnp.asarray(x), jnp.asarray(ch)), training=False,
                               rng=None)[0])


@pytest.mark.parametrize("dims", [3, 2])
def test_tree_nn_accuracy_scores_node_zero_as_jax(dims):
    rng = np.random.default_rng(dims)
    out = rng.standard_normal((10, 5, 3) if dims == 3 else (10, 3)).astype(np.float32)
    target = rng.integers(0, 3, 10)
    a = TreeNNAccuracy().metric(torch.from_numpy(out), torch.from_numpy(target))
    b = JTreeNNAccuracy().metric(jnp.asarray(out), jnp.asarray(target))
    assert (float(a[0]), int(a[1])) == (float(b[0]), int(b[1]))
    root = out[:, 0] if dims == 3 else out
    assert float(a[0]) == float((root.argmax(-1) == target).sum())


def test_example_trains_the_jax_mains_trees():
    run = treelstm_train.main(["--platform", "cpu", "--max-epoch", "2",
                               "--synthetic-size", "96"])
    rng = np.random.default_rng(0)
    labels = rng.integers(0, 2, 96)
    np.testing.assert_array_equal(run.labels, labels)
    assert run.x.shape == (96, 7, 16) and (run.x[:, 4:] == 0).all()
    np.testing.assert_array_equal(run.children[0], jencode(TREES["example"], 7))
    assert len(run.losses) == 6 and np.isfinite(run.losses).all()
    assert run.losses[-1] < run.losses[0]
    assert 0.5 <= run.results["root_accuracy"] <= 1.0
