"""The elastic fleet on the card (``-m gpu``; skipped without one): the
chaos schedule of ``test_torch_elastic.py`` (``Linear(8, 4)`` +
``LogSoftMax``, N 48, batch 24, SGD 0.1, host 3 silent after step 4 and
back after step 9, 8 epochs) on 4 ranks sharing the card over gloo, the
survivors' groups carrying CUDA tensors, against a clean 4-rank run on the
card: the same shrink and rejoin records as the CPU run's, the emergency
fleet checkpoint bit-equal to the clean run's at the shrink step, every
rank ending with the same parameters. No JAX here.

    python -m pytest -m gpu tests/test_torch_elastic_card.py
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest
import torch

from torch_elastic_worker import spawn_cases

pytestmark = pytest.mark.gpu


def test_elastic_schedule_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run on the card with "
                    "`python -m pytest -m gpu tests/test_torch_elastic_card.py`")
    from bigdl_tpu_torch.utils import serialization as ser

    rng = np.random.default_rng(0)
    x, y = rng.standard_normal((48, 8)).astype(np.float32), rng.integers(0, 4, 48)
    base = dict(x=x, y=y, batch=24, init=None)
    cases = [dict(base, name="clean", ckpt_every=1, max_iteration=12),
             dict(base, name="elastic", elastic=True, kill=(3,), kill_at=4, revive_at=9,
                  end_epoch=8)]
    runs = spawn_cases(4, cases, str(tmp_path), deadline_s=300.0, device="cuda")
    ranks = runs["elastic"]
    assert [r["meta"]["outcome"] for r in ranks] == ["ok"] * 4
    warns = [w for w in ranks[0]["meta"]["records"] if w.get("type") == "warn"]
    s = [w for w in warns if w.get("reason") == "mesh_shrunk"]
    j = [w for w in warns if w.get("reason") == "mesh_rejoin"]
    assert len(s) == len(j) == 1
    # the CPU run's records (test_torch_elastic.py holds them against JAX)
    assert (s[0]["iteration"], s[0]["processes"], s[0]["generation"]) == (6, [0, 1, 2], 1)
    assert (j[0]["iteration"], j[0]["processes"], j[0]["generation"]) == (9, [0, 1, 2, 3], 2)
    step = s[0]["iteration"]
    like = {"Linear_0": {"weight": torch.zeros(4, 8), "bias": torch.zeros(4)}}
    pe, _, _, _ = ser.load_checkpoint(str(Path(tmp_path) / "elastic" / "ckpt"), step,
                                      params_like=like)
    pc, _, _, _ = ser.load_checkpoint(str(Path(tmp_path) / "clean" / "ckpt"), step)
    for k in pc:
        np.testing.assert_array_equal(pe[k], pc[k], err_msg=k)
    for rank in ranks[1:]:
        for k in ranks[0]:
            if k.startswith("p."):
                assert np.array_equal(rank[k], ranks[0][k]), k
