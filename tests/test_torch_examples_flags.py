"""The example mains' ``--model-save`` and ``--summary-dir``, as their JAX
mains take them, on the CPU at small sizes.

* Each of the ten mains whose JAX main calls ``finish`` (alexnet,
  autoencoder, keras, longctx, moe, ncf, pipeline, ptb, resnet,
  transformer; the others' files have tests of their own) trains with
  ``--model-save``: the JAX
  package's ``nn.load_module`` reads the file, and its parameter tree
  holds the port's model's parameters to the bit (the whole tree: the mesh
  mains save rank 0's gathered model, a ``PipelinedBlocks`` stack with
  every stage and an ``MoE`` with every expert). A second process of the
  main never writes: a mesh main's rank 0 writes and the parent prints
  "saved model to" nowhere else.
* ``lenet_train --summary-dir D``: the JAX ``TrainSummary`` reads one
  ``Loss`` scalar an iteration, its steps 1..n, their values the history's
  losses (float32), and ``ValidationSummary`` one ``Top1Accuracy`` an
  epoch; a main whose JAX main writes nothing under ``--summary-dir``
  (``ptb_train``, ``ncf_train``) writes nothing there.
"""

import math

import numpy as np
import pytest

import bigdl_tpu.nn as jnn
from bigdl_tpu.visualization import TrainSummary as JTrainSummary
from bigdl_tpu.visualization import ValidationSummary as JValidationSummary
from bigdl_tpu_torch import nn as pnn

from test_torch_conv_bn import flat, np_tree

SMALL = {
    "alexnet_train": ["--max-epoch", "1", "--synthetic-size", "16", "--class-num", "10",
                      "-b", "4"],
    "autoencoder_train": ["--max-epoch", "1", "--synthetic-size", "128", "-b", "64"],
    "keras_train": ["--max-epoch", "1", "--synthetic-size", "128", "-b", "64"],
    "longctx_train": ["--max-epoch", "1", "--synthetic-size", "3000", "--sp", "2",
                      "--seq-len", "16"],
    "moe_train": ["--max-epoch", "1", "--synthetic-size", "3000", "--n-experts", "2"],
    "ncf_train": ["--max-epoch", "1", "--synthetic-size", "400", "--embed-dim", "4",
                  "--mf-embed", "4", "-b", "32"],
    "pipeline_train": ["--max-epoch", "1", "--synthetic-size", "3000", "--n-stages", "2",
                       "--dp", "1"],
    "ptb_train": ["--max-epoch", "1", "--synthetic-size", "900", "--vocab-size", "40",
                  "--hidden-size", "8", "--seq-len", "10", "-b", "4"],
    "resnet_train": ["--dataset", "imagenet", "--depth", "18", "--image-size", "32",
                     "--class-num", "10", "--synthetic-size", "32", "-b", "8",
                     "--warmup-epochs", "0", "--max-epoch", "1"],
    "transformer_train": ["--max-epoch", "1", "--synthetic-size", "2000", "--seq-len", "16",
                          "--vocab-size", "50", "--hidden-size", "16", "--num-heads", "2",
                          "--num-layers", "1", "--decode-len", "4", "--beam-size", "2"],
}
MESH = ("longctx_train", "moe_train", "pipeline_train")  # trained on spawned ranks


def _main(name):
    import importlib

    return importlib.import_module(f"bigdl_tpu_torch.examples.{name}").main


@pytest.mark.parametrize("name", sorted(SMALL))
def test_model_save_is_read_by_the_jax_load_module(name, tmp_path, capsys):
    path = str(tmp_path / f"{name}.bin")
    run = _main(name)(["--platform", "cpu", "--model-save", path] + SMALL[name])
    out = capsys.readouterr().out
    jm = jnn.load_module(path)
    want = flat(np_tree(jm.get_parameters()))
    pm = pnn.load_module(path, device="cpu")
    got = flat(pm.get_parameters())
    assert set(got) == set(want) and want
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    if name in MESH:  # rank 0 of the spawned ranks wrote the file; the parent did not
        assert "saved model to" not in out and run.model is None
        if name == "pipeline_train":
            stacked = [v for k, v in want.items() if "stages" in k]
            assert stacked and all(v.shape[0] == 2 for v in stacked)
        if name == "moe_train":
            experts = [v for k, v in want.items() if k.endswith("w1")]
            assert experts and all(v.shape[0] == 2 for v in experts)
    else:
        assert out.count("saved model to") == 1
        trained = flat(run.model.get_parameters())
        for k, v in want.items():
            np.testing.assert_array_equal(trained[k], v, err_msg=k)


def test_lenet_summaries_are_read_by_the_jax_summaries(tmp_path):
    from bigdl_tpu_torch.examples import lenet_train

    d = str(tmp_path / "summaries")
    run = lenet_train.main(["--platform", "cpu", "--max-epoch", "2", "--synthetic-size", "64",
                            "-b", "16", "--summary-dir", d])
    losses = [h["loss"] for h in run.optimizer.history]
    assert len(losses) == 8 and all(math.isfinite(v) for v in losses)
    # the writers flush every 10 s and at exit, as the JAX package's do:
    # a reader in this process flushes them first
    run.optimizer.summary.flush()
    run.optimizer.val_summary.flush()
    got = JTrainSummary(d, "lenet").read_scalar("Loss")
    assert [int(s) for s, _ in got] == list(range(1, 9))
    np.testing.assert_allclose([v for _, v in got], np.float32(losses), rtol=1e-6)
    top1 = JValidationSummary(d, "lenet").read_scalar("Top1Accuracy")
    assert len(top1) == 2 and all(0.0 <= v <= 1.0 for _, v in top1)


@pytest.mark.parametrize("name", ["ptb_train", "ncf_train"])
def test_summary_dir_writes_nothing_where_the_jax_main_writes_nothing(name, tmp_path):
    d = tmp_path / "summaries"
    _main(name)(["--platform", "cpu", "--summary-dir", str(d)] + SMALL[name])
    assert not d.exists() or not any(p.is_file() for p in d.rglob("*"))
