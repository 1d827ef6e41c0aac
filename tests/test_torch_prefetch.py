"""The optimizer's prefetch seam: ``LocalOptimizer`` pulls each epoch's
batches on a thread, seams and copies them, and hands them over through a
depth-2 ``StagingRing``.

A small MLP (108 -> 16 -> 3) on 8x8 images through an augmentation chain
(``RandomCrop``, a random ``HFlip``, ``ChannelNormalize``, ``MatToFloats``,
``ImageFrameToSample``) in a ``DataPipeline``, f32 on the CPU, the JAX
model's initial weights carried over and the same global seed in both
packages: the port trains within ``test_torch_training.py`` 's limits (1e-4
absolute and relative on the per-step losses and the final parameters) of
the JAX ``LocalOptimizer`` on the same stream, the ragged tail padded and
masked in both. Then the seam's own contract: a ragged tail padded on the
MLP and dropped with BN, an exception on the thread raised by
``optimize()``, no thread left by an early stop, an exception or a first
batch, and a resume mid-epoch training the batches of an unbroken run.
"""

import threading
import time

import numpy as np
import pytest
import torch

import bigdl_tpu.nn as jnn
import bigdl_tpu.optim as joptim
import bigdl_tpu.transform.vision.image as jv
from bigdl_tpu.dataset import dataset as jd
from bigdl_tpu.dataset import pipeline as jp
from bigdl_tpu.utils.random import RandomGenerator as JRandom
from bigdl_tpu_torch import Engine, RandomGenerator
from bigdl_tpu_torch import nn as pnn
from bigdl_tpu_torch import optim as poptim
import bigdl_tpu_torch.transform.vision.image as pv
from bigdl_tpu_torch.dataset import dataset as pd
from bigdl_tpu_torch.dataset import pipeline as pp

from test_torch_conv_bn import flat, np_tree
from test_torch_validation import _RecordingJax, carried_pair

ATOL = RTOL = 1e-4
SEED = 13
N, BATCH = 45, 8  # 5 full batches and a ragged tail of 5


@pytest.fixture(autouse=True, scope="module")
def _engine_isolation():
    from bigdl_tpu.utils.engine import Engine as JEngine

    JEngine.reset()
    yield
    JEngine.reset()


@pytest.fixture(autouse=True)
def _fp32_policy():
    Engine.set_compute_dtype("float32")
    yield
    Engine.set_compute_dtype(None)


def mlp(nn, d, bn=False):
    layers = [nn.Linear(108, 16, **d)]
    if bn:
        layers.append(nn.BatchNormalization(16, **d))
    layers += [nn.ReLU(**d), nn.Linear(16, 3, **d), nn.LogSoftMax(**d)]
    return nn.Sequential(*layers, **d)


def mlp_bn(nn, d):
    return mlp(nn, d, bn=True)


def _images(n=N, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (n, 8, 8, 3)).astype(np.float32), rng.integers(0, 3, n)


def _chain(v, d):
    ft = (v.RandomCrop(6, 6) >> v.RandomTransformer(v.HFlip(), 0.5)
          >> v.ChannelNormalize(104.0, 117.0, 123.0, 58.0, 57.0, 59.0) >> v.MatToFloats()
          >> v.ImageFrameToSample(input_keys=("floats",)))

    def fn(s):
        x, t = ft(v.ImageFeature(mat=s.feature, label=s.label)).sample()
        return d.Sample(x, np.int64(t))
    return d.Lambda(fn)


def _pipeline(pkg, workers, n=N, drop=False, chain=True):
    d, p, v = pkg
    x, y = _images(n)
    return p.DataPipeline(d.LocalArrayDataSet(x, y, batch_size=BATCH),
                          _chain(v, d) if chain else None, num_workers=workers,
                          drop_remainder=drop)


JAX, PORT = (jd, jp, jv), (pd, pp, pv)


def _threads():
    return [t.name for t in threading.enumerate()
            if t.is_alive() and t.name.startswith(("bigdl-pipe", "bigdl-prefetch"))]


def _no_threads_left():
    deadline = time.perf_counter() + 5
    while _threads() and time.perf_counter() < deadline:
        time.sleep(0.01)
    return not _threads()


def _port_optimizer(model, ds, epochs=2, lr=0.1, **kw):
    opt = poptim.LocalOptimizer(model, ds, pnn.ClassNLLCriterion(), **kw)
    opt.set_optim_method(poptim.SGD(learningrate=lr, momentum=0.9))
    return opt.set_end_when(poptim.Trigger.max_epoch(epochs))


@pytest.mark.parametrize("workers", [0, 3])
def test_pipeline_training_matches_jax(workers):
    x0 = np.zeros((BATCH, 108), np.float32)
    jm, pm = carried_pair(mlp, x0)
    JRandom.set_seed(SEED)
    jopt = _RecordingJax(jm, _pipeline(JAX, workers), jnn.ClassNLLCriterion())
    jopt.set_optim_method(joptim.SGD(learningrate=0.1, momentum=0.9))
    jopt.set_end_when(joptim.Trigger.max_epoch(2)).optimize()
    RandomGenerator.set_seed(SEED)
    popt = _port_optimizer(pm, _pipeline(PORT, workers))
    popt.optimize()
    assert [h["records"] for h in popt.history] == [8, 8, 8, 8, 8, 5] * 2  # the tail padded
    np.testing.assert_allclose([h["loss"] for h in popt.history], jopt.losses, atol=ATOL,
                               rtol=RTOL)
    got, want = flat(pm.get_parameters()), flat(np_tree(jm.get_parameters()))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=ATOL, rtol=RTOL, err_msg=k)
    assert all(h["input_wait_s"] >= 0 for h in popt.history)
    assert _no_threads_left(), _threads()


def test_a_ragged_tail_is_dropped_with_batch_norm(caplog):
    RandomGenerator.set_seed(SEED)
    model = mlp_bn(pnn, {"device": "cpu"})
    opt = _port_optimizer(model, _pipeline(PORT, 2), epochs=1)
    with caplog.at_level("WARNING"):
        opt.optimize()
    assert [h["records"] for h in opt.history] == [8] * 5
    assert any("dropping ragged 5-row batch" in r.message for r in caplog.records)


class _Faulty(pd.LocalArrayDataSet):
    """Raises on the prefetch thread after ``at`` batches of an epoch."""

    def __init__(self, *a, at=2, **k):
        super().__init__(*a, **k)
        self.at = at

    def data(self, train):
        for i, batch in enumerate(super().data(train)):
            if i == self.at:
                raise RuntimeError("disk gone")
            yield batch


def test_an_exception_on_the_thread_reaches_optimize():
    x, y = _images()
    ds = _Faulty(x.reshape(N, -1)[:, :108], y, batch_size=BATCH, at=2)
    opt = _port_optimizer(mlp(pnn, {"device": "cpu"}), ds)
    seen = _Seen(opt)
    with pytest.raises(RuntimeError, match="disk gone"):
        opt.optimize()
    assert len(seen.inputs) == 2  # the two batches before the fault were trained
    assert _no_threads_left(), _threads()


def test_an_exception_in_the_step_closes_the_pipeline():
    RandomGenerator.set_seed(SEED)
    opt = _port_optimizer(mlp(pnn, {"device": "cpu"}), _pipeline(PORT, 4, n=400))
    calls = {"n": 0}
    orig = opt._train_step

    def step(*a, **k):
        calls["n"] += 1
        if calls["n"] == 3:
            raise FloatingPointError("nan")
        return orig(*a, **k)

    opt._train_step = step
    with pytest.raises(FloatingPointError):
        opt.optimize()
    assert _no_threads_left(), _threads()


@pytest.mark.parametrize("workers", [0, 4])
def test_end_when_mid_epoch_leaves_no_thread(workers):
    RandomGenerator.set_seed(SEED)
    opt = _port_optimizer(mlp(pnn, {"device": "cpu"}), _pipeline(PORT, workers, n=800))
    opt.set_end_when(poptim.Trigger.max_iteration(3))
    opt.optimize()
    assert len(opt.history) == 3
    assert not opt._prefetch_thread.is_alive()
    assert _no_threads_left(), _threads()


def test_the_first_batch_closes_its_stream():
    RandomGenerator.set_seed(SEED)
    opt = _port_optimizer(mlp(pnn, {"device": "cpu"}), _pipeline(PORT, 4, n=800))
    assert opt._first_batch().size() == BATCH
    assert _no_threads_left(), _threads()


class _Seen:
    """Records each step's input on the instance's ``_train_step``."""

    def __init__(self, opt):
        self.inputs = []
        orig = opt._train_step

        def step(x, *a, **k):
            self.inputs.append(x.detach().clone())
            return orig(x, *a, **k)

        opt._train_step = step


@pytest.mark.parametrize("workers", [0, 3])
def test_a_resume_mid_epoch_trains_the_batches_of_an_unbroken_run(tmp_path, workers):
    def fresh():
        RandomGenerator.set_seed(SEED)
        torch.manual_seed(0)
        return mlp(pnn, {"device": "cpu"})

    model = fresh()
    opt = _port_optimizer(model, _pipeline(PORT, workers))
    whole = _Seen(opt)
    opt.optimize()

    first = fresh()
    opt1 = _port_optimizer(first, _pipeline(PORT, workers))
    opt1.set_checkpoint(str(tmp_path), poptim.Trigger.several_iteration(3))
    opt1.set_end_when(poptim.Trigger.max_iteration(9))
    part1 = _Seen(opt1)
    opt1.optimize()
    second = fresh()
    opt2 = _port_optimizer(second, _pipeline(PORT, workers))
    opt2.resume(str(tmp_path))
    part2 = _Seen(opt2)
    opt2.optimize()
    assert len(part1.inputs) == 9
    seen = part1.inputs[:9] + part2.inputs
    assert len(seen) == len(whole.inputs) == 12
    for a, b in zip(seen, whole.inputs):
        assert torch.equal(a, b)
    for k, v in flat(model.get_parameters()).items():
        np.testing.assert_array_equal(flat(second.get_parameters())[k], v, err_msg=k)
    assert _no_threads_left(), _threads()


def test_staged_bytes_and_device_tensors_walk_tables_and_sparse_tensors():
    """What the seam counts and marks on the card, walked on the CPU: a
    ``Table`` of a ``SparseTensor`` and a dense column, and a plain array."""
    from bigdl_tpu_torch.dataset.dataset import device_tensors, to_device
    from bigdl_tpu_torch.optim.local_optimizer import _host_bytes, staged_device_bytes
    from bigdl_tpu_torch.tensor.sparse import SparseTensor
    from bigdl_tpu_torch.utils.table import T

    sp = SparseTensor.from_coo(np.array([0, 1]), np.array([2, 0]),
                               np.array([1.5, 2.5], np.float32), (2, 4))
    dense = np.ones((2, 3), np.float32)
    tree = T(sp, dense)
    assert _host_bytes(tree) == sum(t.numel() * t.element_size() for t in
                                    (sp.row_indices, sp.col_indices, sp.values)) + dense.nbytes
    assert _host_bytes(np.zeros((4, 5), np.int64)) == 160
    moved = to_device(tree, torch.device("cpu"))
    assert len(list(device_tensors(moved))) == 4
    assert staged_device_bytes() == 0  # nothing staged off the card
