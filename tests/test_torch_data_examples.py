"""The examples of the host data slice, each at a tiny size on the CPU
(``--platform cpu``): the ResNet ImageNet recipe from record shards
(``--data-dir``; its batch stream byte for byte the one
``examples/resnet/train.py`` reads from the same shards, its record
validation the same), and the single-card counterparts of
``examples/{lenet/train,lenet/test,textclassification/train,widedeep/train}.py``
(finite losses, the printed results, ``--model-save`` read back by
``lenet_test``, ``--summary-dir`` written by LeNet-5 alone). Inception-v1's is in ``test_torch_data_examples_inception.py``.
"""

import importlib.util
import math
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

from bigdl_tpu.utils.random import RandomGenerator as JRandom
from bigdl_tpu_torch import RandomGenerator
from bigdl_tpu_torch.dataset import write_record_shards
from bigdl_tpu_torch.examples import (lenet_test, lenet_train, resnet_train,
                                      textclassification_train, widedeep_train)

from test_torch_dataset_chains import assert_same_batches

ROOT = Path(__file__).resolve().parents[1]
SIZE = 32


def _jax_recipe():
    spec = importlib.util.spec_from_file_location("jax_resnet_train_shards",
                                                  ROOT / "examples" / "resnet" / "train.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _shards(directory, n=40, per_shard=12):
    rng = np.random.default_rng(0)
    imgs = rng.integers(0, 256, (n, SIZE, SIZE, 3), dtype=np.uint8)
    labels = rng.integers(0, 10, n)
    paths = write_record_shards(((imgs[i].tobytes(), int(labels[i])) for i in range(n)),
                                str(directory), records_per_shard=per_shard)
    (directory / "README.txt").write_text("metadata beside the shards")
    (directory / "sub").mkdir()
    return paths


def test_record_shards_stream_matches_the_jax_recipe(tmp_path):
    _shards(tmp_path)
    args = SimpleNamespace(data_dir=str(tmp_path), image_size=SIZE, batch_size=8,
                           class_num=10, synthetic_size=None)
    JRandom.set_seed(42)
    RandomGenerator.set_seed(42)
    jtrain, jval, jipe = _jax_recipe().load_imagenet(args, 1)
    ptrain, pval, pipe_ = resnet_train.load_imagenet(args)
    assert jval is None and pval is None and pipe_ == jipe == 5
    assert len(resnet_train.record_shards(str(tmp_path))) == 4  # README and sub passed over
    for epoch in (0, 1):
        jtrain.shuffle(epoch)
        ptrain.shuffle(epoch)
        assert assert_same_batches(jtrain.data(True), ptrain.data(True)) == 5
    # the pipeline under DataSet.distributed, as the JAX recipe wraps its reader
    assert ptrain.base.num_workers == resnet_train.PIPELINE_WORKERS


def test_main_trains_from_record_shards(tmp_path, capsys):
    _shards(tmp_path)
    argv = ["--dataset", "imagenet", "--depth", "18", "--platform", "cpu", "--image-size",
            str(SIZE), "--class-num", "10", "-b", "8", "--warmup-epochs", "0", "--max-epoch",
            "1", "--data-dir", str(tmp_path)]
    recipe = resnet_train.main(argv)
    assert recipe.val_dataset is None and recipe.results is None
    assert len(recipe.optimizer.history) == 5
    assert all(math.isfinite(h["loss"]) for h in recipe.optimizer.history)
    assert "Top1" not in capsys.readouterr().out
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(SystemExit, match="no record shards"):
        resnet_train.main(argv[:-1] + [str(empty)])


LENET = ["--platform", "cpu", "--max-epoch", "1", "--synthetic-size", "64", "-b", "16"]


def test_lenet_train_saves_what_lenet_test_reads(tmp_path, capsys):
    path = str(tmp_path / "lenet.bin")
    run = lenet_train.main(LENET + ["--model-save", path])
    assert len(run.optimizer.history) == 4
    assert all(math.isfinite(h["loss"]) for h in run.optimizer.history)
    top1 = run.results["Top1Accuracy"].result()[0]
    test = lenet_test.main(["--platform", "cpu", "--synthetic-size", "64", "-b", "16",
                            "--model", path])
    assert test.results["Top1Accuracy"].result() == (top1, 64)
    assert set(test.results) == {"Top1Accuracy", "Top5Accuracy"}
    out = capsys.readouterr().out
    assert "saved model to" in out and "Top5Accuracy" in out
    with pytest.raises(SystemExit, match="--model"):
        lenet_test.main(["--platform", "cpu"])


def test_textclassification_trains():
    run = textclassification_train.main(
        ["--platform", "cpu", "--max-epoch", "1", "--synthetic-size", "64", "-b", "16",
         "--vocab-size", "60", "--seq-len", "12", "--embedding-dim", "8", "--hidden-size", "8",
         "--class-num", "5"])
    assert len(run.optimizer.history) == 4
    assert all(math.isfinite(h["loss"]) for h in run.optimizer.history)
    assert 0.0 <= run.results["Top1Accuracy"].result()[0] <= 1.0


def test_widedeep_trains():
    run = widedeep_train.main(["--platform", "cpu", "--max-epoch", "1", "--synthetic-size",
                               "256", "-b", "64"])
    assert len(run.optimizer.history) == 4
    assert all(math.isfinite(h["loss"]) for h in run.optimizer.history)
    assert run.results["Top1Accuracy"].result()[1] == 128


TEXT = ["--platform", "cpu", "--max-epoch", "1", "--synthetic-size", "64", "-b", "16",
        "--vocab-size", "60", "--seq-len", "12", "--embedding-dim", "8", "--hidden-size", "8",
        "--class-num", "5"]
WIDEDEEP = ["--platform", "cpu", "--max-epoch", "1", "--synthetic-size", "256", "-b", "64"]


@pytest.mark.parametrize("main,argv", [(lenet_train.main, LENET),
                                       (textclassification_train.main, TEXT),
                                       (widedeep_train.main, WIDEDEEP)],
                         ids=["lenet", "textclassification", "widedeep"])
@pytest.mark.parametrize("flag", ["--summary-dir", "--n-devices"])
def test_summary_dir_and_n_devices_as_the_jax_mains(main, argv, flag, tmp_path):
    """``--summary-dir`` is taken: LeNet-5 writes its train and validation
    summaries there (read back in ``test_torch_examples_flags.py``), the
    others nothing, as their JAX mains; ``--n-devices`` above 1 is for the
    DistriOptimizer mains: these train on one card."""
    if flag == "--n-devices":
        with pytest.raises(ValueError, match="one card"):
            main(["--platform", "cpu", flag, "2"])
        return
    d = tmp_path / "summaries"
    main(argv + [flag, str(d)])
    written = sorted(p.parent.name for p in d.rglob("*tfevents*")) if d.exists() else []
    assert written == (["train", "validation"] if main is lenet_train.main else [])
