"""The keras example's CNN on the card against the CPU route (every test is
marked ``gpu`` and skips without a card; run on the card with ``python -m
pytest -m gpu tests/test_torch_keras_card.py``). No JAX here: the CPU route
is the oracle, itself held against the JAX package by
``test_torch_keras.py``.

Under the bf16 policy cuDNN returns the first convolution's output of a
one-channel input in channels-last memory; the max-pool kernel reads NCHW,
so its wrapper copies x to it in the backward. Limits, fixed before the
first run: one SGD step's loss within 1e-5 and the weights within 1e-5
relative L2 (f32, TF32 off: sums in another order), the max-pool launches
exactly 2 a step."""

import numpy as np
import pytest
import torch

from bigdl_tpu_torch import Engine, RandomGenerator
from bigdl_tpu_torch.examples import keras_train
from bigdl_tpu_torch.nn import keras as K
from bigdl_tpu_torch.ops import maxpool
from bigdl_tpu_torch.optim import SGD


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run on the card with "
                    "`python -m pytest -m gpu tests/test_torch_keras_card.py`")
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    yield
    Engine.set_compute_dtype(None)
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def _batch(n=64, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, 1, 28, 28)).astype(np.float32),
            rng.integers(0, 10, n))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_a_channels_last_conv_output_reaches_the_pool_kernel(cuda_card, dtype):
    Engine.set_compute_dtype(dtype)
    RandomGenerator.set_seed(1)
    model = keras_train.cnn(K, dropout=0.0)
    x, y = _batch()
    model.compile(optimizer=SGD(learningrate=0.01), loss="sparse_categorical_crossentropy")
    maxpool.launches = 0
    model.fit(x, y, batch_size=64, nb_epoch=1)
    assert maxpool.launches == 2
    assert np.isfinite(model.last_optimizer.history[0]["loss"])


@pytest.mark.gpu
def test_one_step_matches_the_cpu(cuda_card):
    Engine.set_compute_dtype("float32")
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    x, y = _batch(seed=1)
    runs = {}
    w0 = None
    for d in ("cpu", "cuda"):
        RandomGenerator.set_seed(2)
        model = keras_train.cnn(K, dropout=0.0, device=d)
        model.init(sample_input=x[:1])
        if w0 is None:
            w0 = [p.detach().clone() for p in model.parameters()]
        else:
            with torch.no_grad():
                for p, v in zip(model.parameters(), w0):
                    p.copy_(v)
        model.compile(optimizer=SGD(learningrate=0.05), loss="sparse_categorical_crossentropy")
        model.fit(x, y, batch_size=64, nb_epoch=1)
        runs[d] = (model.last_optimizer.history[0]["loss"],
                   [p.detach().cpu() for p in model.parameters()])
    (lc, pc), (lp, pp) = runs["cuda"], runs["cpu"]
    assert abs(lc - lp) <= 1e-5
    num = sum(float(((a - b) ** 2).sum()) for a, b in zip(pc, pp)) ** 0.5
    den = sum(float((b ** 2).sum()) for b in pp) ** 0.5
    assert num / den <= 1e-5
