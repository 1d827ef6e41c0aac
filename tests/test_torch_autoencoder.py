"""The port's Autoencoder slice against the JAX package's: ``Sigmoid`` (f32
and bf16), ``MSECriterion`` (both reductions, its row-wise form, a float64
target), the Autoencoder's parameter paths and forward, 3 ``LocalOptimizer``
Adam steps (the example's recipe) from the JAX model's weights, a ragged
train tail of float (N, 784) targets padded and masked in both packages,
``load_mnist`` (the synthetic digits equal to JAX's; idx files the test
writes, plain and gzipped, read alike; its own ``TRAIN_MEAN``/``TRAIN_STD``)
and ``examples/autoencoder_train``'s ``main`` to its end at a tiny size.

Inputs from numpy with a seed, f32 on the CPU. Tolerances, fixed before
the first run: ``Sigmoid`` 1e-6 absolute in f32 and its gradient 1e-6
(XLA's logistic and torch's sigmoid may differ by a few units in the last
place); in bf16 two bf16 steps of the output (2^-6 relative: the first
run's one step, 2^-7, read 8.2e-3 at 0.0037, where JAX rounds exp(-x) and
1 + exp(-x) to bf16 before the divide and torch rounds once) and for the
gradient two steps plus |dy|·2^-7 (each rounds y(1 - y)·dy in its own
order); the MSE losses and gradients 1e-6 absolute + 1e-6 relative; the
model's output 1e-6 absolute; after 3 Adam steps (and on the ragged run,
5), losses 1e-5 and the whole update within 1e-3 relative L2, every
parameter within 1e-4 absolute, 1% of the rate (the first run's 1e-5 read
one weight of 12544 1.43e-5 apart: Adam steps each weight by about
lr·m/sqrt(v), and where a weight's gradients cancel across steps that ratio
magnifies f32 noise; the update's L2 distance is the check of the rule).
The loaders' arrays are equal exactly.
"""

import gzip
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bigdl_tpu.nn as jnn
from bigdl_tpu.dataset import mnist as jmnist
from bigdl_tpu.dataset.dataset import LocalArrayDataSet as JLocalArrayDataSet
from bigdl_tpu.dataset.dataset import SampleToMiniBatch
from bigdl_tpu.models import Autoencoder as JAutoencoder
from bigdl_tpu_torch import nn as pnn
from bigdl_tpu_torch.dataset import LocalArrayDataSet, MiniBatch, load_mnist
from bigdl_tpu_torch.dataset import mnist as pmnist
from bigdl_tpu_torch.examples import autoencoder_train
from bigdl_tpu_torch.models import Autoencoder
from bigdl_tpu_torch.utils.convert import load_jax_params

from test_torch_conv_bn import flat, np_tree
from test_torch_ncf import (_engine_isolation, _fp32_policy,  # noqa: F401 (fixtures)
                            assert_trained_alike, train_both)


ADAM_PARAMS_ATOL = 1e-4


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sigmoid_matches_jax(dtype):
    rng = np.random.default_rng(0)
    x = (4 * rng.standard_normal((5, 37))).astype(np.float32)
    dy = rng.standard_normal((5, 37)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jy, vjp = jax.vjp(lambda v: jnn.Sigmoid().apply({}, {}, v)[0], jnp.asarray(x, jdt))
    (jdx,) = vjp(jnp.asarray(dy, jdt))
    xt = torch.from_numpy(x).to(tdt).requires_grad_(True)
    py, _ = pnn.Sigmoid(device="cpu").apply({}, {}, xt)
    (pdx,) = torch.autograd.grad(py, xt, torch.from_numpy(dy).to(tdt))
    assert py.dtype == tdt and pdx.dtype == tdt
    want_y, want_dx = np.asarray(jy, np.float32), np.asarray(jdx, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(py.detach().numpy(), want_y, atol=1e-6)
        np.testing.assert_allclose(pdx.numpy(), want_dx, atol=1e-6)
    else:
        np.testing.assert_allclose(py.detach().float().numpy(), want_y, rtol=2 ** -6, atol=1e-6)
        allow = 1e-6 + 2.0 ** -6 * np.abs(want_dx) + 2.0 ** -7 * np.abs(dy)
        assert (np.abs(pdx.float().numpy() - want_dx) <= allow).all()


@pytest.mark.parametrize("size_average", [True, False])
@pytest.mark.parametrize("target_dtype", [np.float32, np.float64])
def test_mse_criterion_matches_jax(size_average, target_dtype):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((6, 11)).astype(np.float32)
    t = rng.standard_normal((6, 11)).astype(target_dtype)
    jc, pc = jnn.MSECriterion(size_average), pnn.MSECriterion(size_average)
    jl, jg = jax.value_and_grad(lambda v: jc._apply(v, t))(jnp.asarray(x))
    xt = torch.from_numpy(x)
    pl = pc.forward(xt, t)
    assert pl.dtype == torch.float32
    np.testing.assert_allclose(pl.item(), float(jl), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(pc.backward(xt, t).numpy(), np.asarray(jg), atol=1e-6,
                               rtol=1e-6)
    (jper, jw), (pper, pw) = jc.unreduced(jnp.asarray(x), t), pc.unreduced(xt, t)
    np.testing.assert_allclose(pper.numpy(), np.asarray(jper), atol=1e-6, rtol=1e-6)
    np.testing.assert_array_equal(pw.numpy(), np.asarray(jw))
    assert pc.supports_unreduced()


def _images(n, seed=0):
    x, _ = load_mnist(None, synthetic_size=n, normalize=False)
    return x, np.asarray(x, np.float32).reshape(n, 784)


def test_autoencoder_paths_and_forward_match_jax():
    x, _ = _images(4)
    jm = JAutoencoder(class_num=16)
    jp, js = jm.init(jax.random.PRNGKey(0), sample_input=x)
    pm = Autoencoder(class_num=16, device="cpu")
    pm.init(sample_input=x)
    assert {k: tuple(v.shape) for k, v in pm.named_parameters()} == {
        k: v.shape for k, v in flat(np_tree(jp)).items()}
    assert [m.name() for m in pm] == [m.name() for m in jm.modules]
    load_jax_params(pm, np_tree(jp))
    jy = jm.apply(jp, js, jnp.asarray(x))[0]
    py = pm.apply(pm.get_parameters(), pm.get_state(), torch.from_numpy(x))[0]
    assert tuple(py.shape) == (4, 784)
    np.testing.assert_allclose(py.detach().numpy(), np.asarray(jy), atol=1e-6)


def _mse_adam(steps):
    return dict(criterion=lambda nn: nn.MSECriterion(),
                method=lambda o: o.Adam(learningrate=0.01), steps=steps)


def test_autoencoder_trains_like_jax():
    x, t = _images(24)
    run = train_both(JAutoencoder(class_num=16), Autoencoder(class_num=16, device="cpu"), x, t,
                     8, **_mse_adam(3))
    assert_trained_alike(run, params_atol=ADAM_PARAMS_ATOL)


class _TailDataSet(LocalArrayDataSet):
    """Yields each epoch's ragged last batch in training too."""

    def data(self, train):
        for start in range(0, len(self._order), self.batch_size):
            idx = self._order[start:start + self.batch_size]
            yield MiniBatch(self.features[idx], self.labels[idx])


def test_autoencoder_ragged_tail_is_masked_like_jax():
    """20 images at batch 8: the 4-row tail of float targets is padded to 8
    and masked out of the MSE exactly, in both packages."""
    x, t = _images(20)
    run = train_both(JAutoencoder(class_num=16), Autoencoder(class_num=16, device="cpu"), x, t,
                     8, **_mse_adam(5),
                     jax_dataset=JLocalArrayDataSet(x, t, transformer=SampleToMiniBatch(8),
                                                    batch_size=8),
                     port_dataset=_TailDataSet(x, t, batch_size=8))
    assert run["records"] == [8, 8, 4, 8, 8]
    assert_trained_alike(run, steps=5, params_atol=ADAM_PARAMS_ATOL)


@pytest.mark.parametrize("kw", [dict(), dict(train=False), dict(synthetic_size=37),
                                dict(normalize=False, synthetic_size=50)])
def test_load_mnist_synthetic_matches_jax(kw):
    (gx, gy), (wx, wy) = load_mnist(None, **kw), jmnist.load_mnist(None, **kw)
    assert gx.dtype == wx.dtype and gy.dtype == wy.dtype and gx.shape == wx.shape
    np.testing.assert_array_equal(gx, wx)
    np.testing.assert_array_equal(gy, wy)
    assert (pmnist.TRAIN_MEAN, pmnist.TRAIN_STD) == (jmnist.TRAIN_MEAN, jmnist.TRAIN_STD)


def _write_idx(path, arr, gz):
    head = struct.pack(">I", 0x0800 | arr.ndim) + struct.pack(">" + "I" * arr.ndim, *arr.shape)
    with (gzip.open if gz else open)(path, "wb") as f:
        f.write(head + arr.astype(np.uint8).tobytes())


@pytest.mark.parametrize("gz", [False, True], ids=["plain", "gzip"])
def test_load_mnist_idx_files_match_jax(tmp_path, gz):
    rng = np.random.default_rng(2)
    suffix = ".gz" if gz else ""
    for stem, n in (("train", 9), ("t10k", 5)):
        _write_idx(tmp_path / f"{stem}-images-idx3-ubyte{suffix}",
                   rng.integers(0, 256, (n, 28, 28)), gz)
        _write_idx(tmp_path / f"{stem}-labels-idx1-ubyte{suffix}", rng.integers(0, 10, n), gz)
    for train in (True, False):
        for normalize in (True, False):
            (gx, gy), (wx, wy) = (f(str(tmp_path), train=train, normalize=normalize)
                                  for f in (load_mnist, jmnist.load_mnist))
            assert gx.shape == ((9 if train else 5), 1, 28, 28)
            np.testing.assert_array_equal(gx, wx)
            np.testing.assert_array_equal(gy, wy)


def test_autoencoder_example_runs_to_its_end(capsys, tmp_path):
    path = str(tmp_path / "autoencoder.bin")
    run = autoencoder_train.main(["--platform", "cpu", "--max-epoch", "2",
                                  "--synthetic-size", "300", "-b", "64", "--model-save", path])
    assert len(run.optimizer.history) == 2 * (300 // 64)
    assert all(np.isfinite(h["loss"]) for h in run.optimizer.history)
    assert 0 < run.results["mse"] < 1 and "reconstruction MSE" in capsys.readouterr().out
    # --model-save: the trained model in nn.load_module's format
    # (the JAX package reads it in test_torch_examples_flags.py)
    loaded = pnn.load_module(path, device="cpu")
    for (k, a), (_, b) in zip(run.model.named_parameters(), loaded.named_parameters()):
        assert torch.equal(a, b), k
