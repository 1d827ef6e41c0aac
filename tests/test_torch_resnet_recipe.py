"""The port's ResNet ImageNet recipe (``bigdl_tpu_torch.examples.resnet_train``)
against ``examples/resnet/train.py``: the schedule it builds (linear warmup,
then MultiStep or Poly) gives the JAX recipe's rate at every iteration
(equal floats: the same host arithmetic), its synthetic data is the JAX
recipe's draw, and ``main()`` trains a narrow ResNet-18 on the CPU (32x32
images, 10 classes, batch 8, 32 records, 2 epochs) with the schedule's
closed-form rate at every iteration and Top-1/Top-5 validated every epoch.
The branches that need what the port lacks raise.
"""

import importlib.util
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from bigdl_tpu_torch import Engine
from bigdl_tpu_torch.examples import resnet_train

ROOT = Path(__file__).resolve().parents[1]


def _jax_recipe():
    spec = importlib.util.spec_from_file_location("jax_resnet_train",
                                                  ROOT / "examples" / "resnet" / "train.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Method:
    learningrate, learningrate_decay = 0.1, 0.0


@pytest.mark.parametrize("lr_schedule", ["multistep", "poly"])
@pytest.mark.parametrize("warmup,max_epoch,ipe", [(5, 90, 3), (0, 4, 7), (2, 3, 4)])
def test_schedule_matches_the_jax_recipe(lr_schedule, warmup, max_epoch, ipe):
    args = SimpleNamespace(warmup_epochs=warmup, lr_schedule=lr_schedule, max_epoch=max_epoch)
    js = _jax_recipe().build_imagenet_schedule(args, ipe)
    ps = resnet_train.build_imagenet_schedule(args, ipe)
    assert type(ps).__name__ == type(js).__name__
    for neval in range(1, max_epoch * ipe + 5):
        assert ps.update(_Method, {"neval": neval}) == js.update(_Method, {"neval": neval})


def _closed_form(lr, n, warmup_iters, schedule, total):
    """The recipe's rate at iteration ``n`` (0-based), written out."""
    if n < warmup_iters:
        return lr * (n + 1) / warmup_iters
    if schedule == "poly":
        return lr * (1 - n / total) ** 2.0 if n < total else 0.0
    return lr * 0.1 ** sum(n >= m for m in (30 * 4, 60 * 4, 80 * 4))


TINY = ["--dataset", "imagenet", "--depth", "18", "--platform", "cpu", "--image-size", "32",
        "--class-num", "10", "--synthetic-size", "32", "-b", "8", "--warmup-epochs", "1",
        "--max-epoch", "2"]


@pytest.fixture(autouse=True)
def _policy():
    yield
    Engine.set_activation_dtype(None)
    Engine.set_compute_dtype(None)


@pytest.mark.parametrize("lr_schedule", ["multistep", "poly"])
def test_main_trains_with_the_recipe_schedule_on_cpu(lr_schedule, capsys):
    recipe = resnet_train.main(TINY + ["--lr-schedule", lr_schedule])
    hist = recipe.optimizer.history
    assert recipe.iters_per_epoch == 4 and len(hist) == 8
    assert [h["lr"] for h in hist] == [_closed_form(0.01, n, 4, lr_schedule, 8)
                                       for n in range(8)]
    assert all(np.isfinite(h["loss"]) for h in hist)
    state = recipe.optimizer.optim_method.state
    assert state["n_validations"] == 2 and state["epoch"] == 3
    assert set(recipe.results) == {"Top1Accuracy", "Top5Accuracy"}
    assert Engine.activation_dtype() is None  # bf16 activations on the card only
    out = capsys.readouterr().out
    assert "Top1Accuracy:" in out and "Top5Accuracy:" in out
    method = recipe.optimizer.optim_method
    assert method.nesterov and method.weightdecay == 1e-4
    assert method.weightdecay_exclude == ("_bn", "bias")


def test_synthetic_data_is_the_jax_recipes_draw():
    args = resnet_train.parser().parse_args(TINY)
    train, val, ipe = resnet_train.load_imagenet(args)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((32, 3, 32, 32)).astype(np.float32)
    y = rng.integers(0, 10, 32)
    assert ipe == 4 and train.size() == 32 and val.size() == 8
    batch = next(iter(val.data(train=False)))
    np.testing.assert_array_equal(np.asarray(batch.get_input()), x[:8])
    np.testing.assert_array_equal(np.asarray(batch.get_target()), y[:8])


def test_model_save_writes_the_trained_model(tmp_path):
    """``--model-save``: the trained model in ``nn.load_module`` 's format
    (the JAX package reads it in ``test_torch_examples_flags.py``)."""
    from bigdl_tpu_torch import nn as pnn

    path = str(tmp_path / "resnet.bin")
    recipe = resnet_train.main(TINY[:-1] + ["1", "--model-save", path])
    loaded = pnn.load_module(path, device="cpu")
    for (k, a), (_, b) in zip(recipe.optimizer.model.named_parameters(),
                              loaded.named_parameters()):
        assert torch.equal(a, b), k


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run on the card with "
                    "`python -m pytest -m gpu tests/test_torch_resnet_recipe.py`")


@pytest.mark.gpu
def test_main_on_card_keeps_the_bf16_activation_rule(cuda_card):
    """On the card the recipe sets bf16 activations (the JAX recipe's TPU
    rule, kept for the card) and trains with the schedule's rates."""
    argv = [a for a in TINY if a not in ("--platform", "cpu")] + ["--lr-schedule", "poly"]
    recipe = resnet_train.main(argv)
    assert Engine.activation_dtype() == "bfloat16"
    assert recipe.model.device.type == "cuda"
    assert [h["lr"] for h in recipe.optimizer.history] == [
        _closed_form(0.01, n, 4, "poly", 8) for n in range(8)]
    assert all(np.isfinite(h["loss"]) for h in recipe.optimizer.history)
