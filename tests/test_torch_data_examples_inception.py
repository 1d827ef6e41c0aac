"""``bigdl_tpu_torch.examples.inception_train`` (the single-card counterpart
of ``examples/inception/train.py``) at its smallest size on the CPU: two
224x224 records at batch 2, 10 classes, one step, a finite loss, Top-1 over
the two records, and the model written by ``--model-save``."""

import math
import os

import pytest

from bigdl_tpu_torch.examples import inception_train


def test_inception_trains_one_step_and_saves(tmp_path, capsys):
    path = str(tmp_path / "inception.bin")
    run = inception_train.main(["--platform", "cpu", "--max-epoch", "1", "--synthetic-size",
                                "2", "-b", "2", "--class-num", "10", "--model-save", path])
    assert len(run.optimizer.history) == 1
    assert math.isfinite(run.optimizer.history[0]["loss"])
    assert run.results["Top1Accuracy"].result()[1] == 2
    assert os.path.getsize(path) > 0 and "saved model to" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="224"):
        inception_train.main(["--platform", "cpu", "--image-size", "112"])
