"""Divisions by a host scalar, card against CPU (every test is marked
``gpu`` and skips without a card; run on the card with ``python -m pytest
-m gpu tests/test_torch_host_divisions_card.py -s``, which also prints how
many quotients the plain ``x / c`` gets wrong on the card).

ATen on the card divides by a host scalar as a product with its reciprocal,
a unit in the last place off the CPU's (and XLA's) true division where
``1 / c`` is inexact. Three sites divided so; each now divides through
``precision.true_div``, and each is held to the bit here on inputs whose
other operations are exact on both devices:

* beam search's length penalty ``(5 + length) / 6`` (at alpha 1, where
  ``pow`` is exact; and a whole beam search at alpha 0.6: equal sequences,
  scores within 1e-6 relative);
* the attention logits' ``/ sqrt(d)`` at head widths 48 and 80 (queries
  against one-hot keys: each logit is one query entry, exactly);
* ``SoftPlus(beta=3)``'s ``/ beta`` (beta·x from 30 up, where
  ``logaddexp(beta·x, 0)`` is beta·x exactly).
"""

import math

import numpy as np
import pytest
import torch

from bigdl_tpu_torch import Engine
from bigdl_tpu_torch import nn as pnn
from bigdl_tpu_torch.nn import attention as patt


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run on the card with "
                    "`python -m pytest -m gpu tests/test_torch_host_divisions_card.py`")
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    Engine.set_compute_dtype("float32")
    yield
    Engine.set_compute_dtype(None)
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def _report(site, raw_card, raw_cpu, routed_card, routed_cpu):
    raw = int((raw_card.cpu() != raw_cpu).sum())
    routed = int((routed_card.cpu() != routed_cpu).sum())
    print(f"{site}: plain x / c differs card vs CPU at {raw} of {raw_cpu.numel()}, "
          f"true_div at {routed}")
    return routed


@pytest.mark.gpu
def test_length_penalty_divides_as_the_cpu(cuda_card):
    length = torch.arange(1, 4097, dtype=torch.float32)
    raw = [(5.0 + length.to(d)) / 6.0 for d in ("cuda", "cpu")]
    got = [patt._length_penalty(length.to(d), 1.0) for d in ("cuda", "cpu")]
    assert _report("length penalty", raw[0], raw[1], got[0], got[1]) == 0


def _table_logits(vocab, seed):
    g = torch.Generator().manual_seed(seed)
    table = torch.randn(vocab, vocab, generator=g)
    table[:, 1] -= 1.5  # EOS now and then: finished beams and their near ties

    def fn(d):
        t = table.to(d)
        return lambda ids, i, cache: (t[ids[:, -1]], cache)

    return fn


@pytest.mark.gpu
def test_beam_search_at_alpha_06_matches_the_cpu(cuda_card):
    fn = _table_logits(37, 5)
    out = {}
    for d in ("cuda", "cpu"):
        ids = torch.tensor([2, 5, 9, 11], device=d)
        seqs, scores = patt.sequence_beam_search(fn(d), ids, {}, 37, beam_size=4, alpha=0.6,
                                                 max_decode_length=12, eos_id=1)
        out[d] = (seqs.cpu(), scores.cpu())
    assert torch.equal(out["cuda"][0], out["cpu"][0])
    torch.testing.assert_close(out["cuda"][1], out["cpu"][1], rtol=1e-6, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [48, 80])
def test_attention_logits_divide_as_the_cpu(cuda_card, d):
    g = torch.Generator().manual_seed(d)
    q = torch.randn(2, 3, 64, d, generator=g)
    k = torch.nn.functional.one_hot(torch.randint(0, d, (2, 3, 64), generator=g), d).float()
    raw = [torch.einsum("...qd,...kd->...qk", q.to(dv), k.to(dv)) / math.sqrt(d)
           for dv in ("cuda", "cpu")]
    got = [patt._scaled_logits(q.to(dv), k.to(dv)) for dv in ("cuda", "cpu")]
    assert _report(f"logits / sqrt({d})", raw[0], raw[1], got[0], got[1]) == 0
    v = torch.randn(2, 3, 64, d, generator=g)
    out = [patt.scaled_dot_product_attention(q.to(dv), k.to(dv), v.to(dv), impl="dense")
           for dv in ("cuda", "cpu")]
    torch.testing.assert_close(out[0].cpu(), out[1], rtol=1e-5, atol=1e-6)


@pytest.mark.gpu
def test_softplus_divides_by_beta_as_the_cpu(cuda_card):
    x = torch.linspace(10.0, 1000.0, 1 << 16)
    m = {d: pnn.SoftPlus(3.0, device=d) for d in ("cuda", "cpu")}
    raw = [torch.logaddexp(3.0 * x.to(d), torch.zeros_like(x, device=d)) / 3.0
           for d in ("cuda", "cpu")]
    got = [m[d].forward(x.to(d)) for d in ("cuda", "cpu")]
    assert _report("SoftPlus / beta", raw[0], raw[1], got[0], got[1]) == 0
