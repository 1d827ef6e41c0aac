"""The mesh parallelisms' card-only cases (``-m gpu``; they skip where
``torch.cuda.is_available()`` is false): two spawned ranks sharing the card
over gloo (``torch_mesh_worker.py``; NCCL refuses two ranks on one
device). No JAX here: each case is held against the same case on two CPU
ranks.

* ``ppermute`` of float32 and bfloat16 CUDA tensors around the ring (the
  route is one all-to-all with uneven splits; ``send``/``recv`` of CUDA
  tensors fails on gloo): bit-equal to what the peer drew;
* each phase's two-rank core: the ring (sp 2), ``moe_ffn`` (2 experts,
  top-1 and dp x ep's single-row form), ``pipeline_apply`` (2 stages) and
  the hybrid LM (model 2) against the CPU ranks: forwards and gradients
  within 1e-4 absolute (TF32 may round the card's products; the same
  values on the CPU within 1e-5 of the JAX package, held by
  ``test_torch_parallel_mesh.py``).

Run on the card: ``python -m pytest -m gpu tests/test_torch_parallel_card.py``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from torch_mesh_worker import spawn_mesh_cases

pytestmark = pytest.mark.gpu


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _rng(seed):
    r = np.random.default_rng(seed)
    return lambda *s: r.standard_normal(s).astype(np.float32)


def test_ppermute_is_bit_equal_on_a_shared_card(card, tmp_path):
    got = spawn_mesh_cases(2, [dict(name="hop", fn="hop", world=2, shape=(8, 8, 512, 64))],
                           str(tmp_path), device="cuda")["hop"]
    for r in range(2):
        g = torch.Generator().manual_seed(1000 + (r - 1) % 2)
        want = torch.randn((8, 8, 512, 64), generator=g)
        np.testing.assert_array_equal(got[r]["f32"], want.view(torch.int32).numpy())
        np.testing.assert_array_equal(got[r]["bf16"],
                                      want.to(torch.bfloat16).view(torch.int16).numpy())


def _cores():
    mk = _rng(3)
    lm_x = np.random.default_rng(4).integers(1, 32, (4, 8)).astype(np.int32)
    return [
        dict(name="ring", fn="ring", mesh={"sp": 2}, q=mk(2, 2, 16, 8), k=mk(2, 2, 16, 8),
             v=mk(2, 2, 16, 8), causal=True, ct=mk(2, 2, 16, 8)),
        dict(name="moe", fn="moe", mesh={"expert": 2}, router_w=mk(16, 2), w1=mk(2, 16, 32) * .2,
             w2=mk(2, 32, 16) * .2, x=mk(16, 16), k=1, cf=1.25, ct=mk(16, 16)),
        dict(name="pipe", fn="pipeline", mesh={"pipe": 2}, w=mk(2, 16, 16) * .3,
             b=mk(2, 16) * .1, x=mk(16, 16), n_micro=4, ct=mk(16, 16)),
        dict(name="hybrid", fn="hybrid", mesh={"data": 1, "model": 2}, x=lm_x,
             y=np.roll(lm_x, -1, axis=1), batch=4, init=None),
    ]


def test_each_phase_core_on_two_ranks_sharing_the_card(card, tmp_path):
    cases = _cores()
    (tmp_path / "cpu").mkdir()
    (tmp_path / "cuda").mkdir()
    cpu = spawn_mesh_cases(2, cases, str(tmp_path / "cpu"))
    gpu = spawn_mesh_cases(2, cases, str(tmp_path / "cuda"), device="cuda")
    for c in cases:
        for r in range(2):
            for key, v in cpu[c["name"]][r].items():
                np.testing.assert_allclose(gpu[c["name"]][r][key], v, atol=1e-4,
                                           err_msg=f"{c['name']} rank {r} {key}")
