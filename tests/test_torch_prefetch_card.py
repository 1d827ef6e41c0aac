"""The prefetch seam on the card (every test is marked ``gpu`` and skips
without a card; run on the card with ``python -m pytest -m gpu
tests/test_torch_prefetch_card.py``). No JAX here: the CPU run of the same
seam is the oracle, itself held against the JAX package by
``test_torch_prefetch.py``.

On the card each batch is copied on the prefetch thread's own stream and
the step's stream waits on its event. Checked: every step's input, as the
step sees it on the card, equal to the CPU's reading of the same epoch to
the bit (a missed wait would hand the step a batch whose copy is still in
flight); the weights after 6 f32 steps (TF32 off) within 1e-5 relative L2
of the CPU run's; no staged bytes and no thread left after ``optimize()``,
an early stop included; a ``Table`` batch (Wide&Deep's sparse column) on
the same path."""

import threading

import numpy as np
import pytest
import torch

from bigdl_tpu_torch import Engine, RandomGenerator
from bigdl_tpu_torch import nn as pnn
from bigdl_tpu_torch import optim as poptim
from bigdl_tpu_torch.dataset import DataPipeline, DataSet, LocalArrayDataSet
from bigdl_tpu_torch.optim.local_optimizer import staged_device_bytes



def _weights(model):
    from bigdl_tpu_torch.utils.serialization import tree_items

    return {k: v.detach().cpu().numpy() for k, v in tree_items(model.get_parameters()).items()}


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run on the card with "
                    "`python -m pytest -m gpu tests/test_torch_prefetch_card.py`")
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    Engine.set_compute_dtype("float32")
    yield
    Engine.set_compute_dtype(None)
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def _mlp(device):
    d = {"device": device}
    return pnn.Sequential(pnn.Linear(4096, 64, **d), pnn.ReLU(**d), pnn.Linear(64, 5, **d),
                          pnn.LogSoftMax(**d), **d)


def _run(device, workers, iters=None):
    """6 steps over 3 epochs of 2 batches of 256 x 4096 f32 (4 MiB: the
    host library's gather), through a DataPipeline; returns (inputs the
    steps saw on the host, optimizer)."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((512, 4096)).astype(np.float32)
    y = rng.integers(0, 5, 512)
    RandomGenerator.set_seed(3)
    torch.manual_seed(0)
    model = _mlp(device)
    ds = DataPipeline(LocalArrayDataSet(x, y, batch_size=256), num_workers=workers)
    opt = poptim.LocalOptimizer(model, ds, pnn.ClassNLLCriterion())
    opt.set_optim_method(poptim.SGD(learningrate=0.05, momentum=0.9))
    opt.set_end_when(poptim.Trigger.max_iteration(iters) if iters
                     else poptim.Trigger.max_epoch(3))
    seen = []
    orig = opt._train_step

    def step(x, *a, **k):
        # integer sums of each row's bits, on the step's stream (no sync)
        seen.append(x.contiguous().view(torch.int32).sum(dim=1, dtype=torch.int64))
        return orig(x, *a, **k)

    opt._train_step = step
    opt.optimize()
    return [s.cpu().numpy() for s in seen], opt


def _threads():
    return [t.name for t in threading.enumerate()
            if t.is_alive() and t.name.startswith(("bigdl-pipe", "bigdl-prefetch"))]


@pytest.mark.gpu
@pytest.mark.parametrize("workers", [0, 4])
def test_card_steps_see_the_cpu_batches(cuda_card, workers):
    card, opt = _run("cuda", workers)
    cpu, cpu_opt = _run("cpu", workers)
    assert len(card) == len(cpu) == 6
    for a, b in zip(card, cpu):
        np.testing.assert_array_equal(a, b)
    got, want = _weights(opt.model), _weights(cpu_opt.model)
    for k in want:
        num = np.linalg.norm(got[k] - want[k])
        assert num <= 1e-5 * np.linalg.norm(want[k]), k
    assert staged_device_bytes() == 0 and not _threads()


@pytest.mark.gpu
def test_an_early_stop_on_the_card_leaves_nothing_staged(cuda_card):
    seen, opt = _run("cuda", 2, iters=3)
    assert len(seen) == 3
    assert staged_device_bytes() == 0 and not _threads()
    assert not opt._prefetch_thread.is_alive()


@pytest.mark.gpu
def test_a_table_batch_on_the_card(cuda_card):
    from bigdl_tpu_torch.dataset import load_criteo
    from bigdl_tpu_torch.models import WideAndDeep

    table, labels = load_criteo(None, n=1024, seed=0)
    RandomGenerator.set_seed(3)
    model = WideAndDeep(class_num=2, device="cuda")
    opt = poptim.LocalOptimizer(model, DataSet.array(table, labels, batch_size=256),
                                pnn.ClassNLLCriterion())
    opt.set_optim_method(poptim.Adam(learningrate=1e-3))
    opt.set_end_when(poptim.Trigger.max_epoch(2)).optimize()
    assert len(opt.history) == 8 and all(np.isfinite(h["loss"]) for h in opt.history)
    assert staged_device_bytes() == 0 and not _threads()
