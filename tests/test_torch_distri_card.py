"""``DistriOptimizer`` on the card (``-m gpu``; skipped without one), held
against its plain version, ``simulate_step`` (one process, the ranks' rows
one after the other, the gradients and the BN state averaged): two ranks
sharing the card over gloo (NCCL refuses two ranks on one device), 3 steps
of the conv/BN net under deterministic cuDNN; the same sums in the same
order, so the parameters are held within 1e-5 of the update's norm and the
BN state within 1e-6. And one rank joined over NCCL. No JAX here.

    python -m pytest -m gpu tests/test_torch_distri_card.py
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from torch_distri_worker import cnn, method_of, spawn_cases

pytestmark = pytest.mark.gpu

SEED, BATCH, STEPS = 7, 8, 3
SGD_WD = ("SGD", dict(learningrate=0.1, momentum=0.9, weightdecay=1e-3,
                      weightdecay_exclude=("bias",)))


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run on the card with "
                    "`python -m pytest -m gpu tests/test_torch_distri_card.py`")
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    yield
    torch.backends.cudnn.deterministic = False


def _numpy_tree(tree):
    return {k: _numpy_tree(v) if isinstance(v, dict) else v.detach().cpu().numpy().copy()
            for k, v in tree.items()}


def _data():
    rng = np.random.default_rng(0)
    return (rng.standard_normal((32, 3, 8, 8)).astype(np.float32),
            rng.integers(0, 5, 32).astype(np.int64))


@pytest.mark.parametrize("kw", [dict(parameter_sync="sharded"),
                                dict(parameter_sync="replicated", flat_update=True)],
                         ids=["sharded", "replicated_flat"])
def test_two_ranks_on_the_card_match_the_simulation(cuda_card, kw, tmp_path):
    from bigdl_tpu_torch import nn, optim
    from bigdl_tpu_torch.dataset import DataSet
    from bigdl_tpu_torch.parallel import simulate_step
    from bigdl_tpu_torch.utils.random import RandomGenerator

    x, y = _data()
    RandomGenerator.set_seed(SEED)
    model = cnn(nn, {"device": "cuda"})
    model.init(sample_input=torch.from_numpy(x[:BATCH // 2]))
    init, state = _numpy_tree(model.get_parameters()), _numpy_tree(model.get_state())
    case = dict(name="card", x=x, y=y, batch=BATCH, seed=SEED, init=init, state=state, kw=kw,
                method=SGD_WD, steps=STEPS, clip=None)
    ranks = spawn_cases(2, [case], str(tmp_path), device=None)["card"]
    for k in ranks[0]:
        if k.startswith(("p.", "s.")):
            assert np.array_equal(ranks[0][k], ranks[1][k]), k
    method = method_of(optim, SGD_WD)
    slots = method.init_slots(model.get_parameters())
    ds = DataSet.array(x, y, batch_size=BATCH)
    ds.shuffle(1)
    for step, batch in zip(range(1, STEPS + 1), ds.data(train=True)):
        simulate_step(model, nn.ClassNLLCriterion(), method, slots,
                      torch.as_tensor(batch.get_input()).cuda(),
                      torch.as_tensor(batch.get_target()).cuda(), 2, 0.1, step)
    from torch_distri_worker import _flat

    want_p, want_s = _flat(model.get_parameters()), _flat(model.get_state())
    got = ranks[0]
    num = sum(np.sum((got[f"p.{k}"] - v) ** 2) for k, v in want_p.items())
    den = sum(np.sum((v - _flat_np(init)[k]) ** 2) for k, v in want_p.items())
    assert np.sqrt(num / den) <= 1e-5
    for k, v in want_s.items():
        np.testing.assert_allclose(got[f"s.{k}"], v, atol=1e-6, err_msg=k)


def _flat_np(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        out.update(_flat_np(v, f"{prefix}{k}.") if isinstance(v, dict) else {prefix + k: v})
    return out


def test_one_rank_joins_over_nccl(cuda_card, tmp_path):
    from bigdl_tpu_torch.utils.engine import Engine

    Engine.init_distributed(f"file://{tmp_path}/group", 1, 0)
    try:
        assert Engine.backend() == "nccl" and Engine.rank_device().type == "cuda"
        assert Engine.device_count() == 1 and Engine.process_slice() == (0, 1)
    finally:
        Engine.shutdown_distributed()
