"""The port's flash-attention backward kernels (dQ, dK/dV) against their
plain version, on a CUDA card.

Marked ``gpu``: they skip where there is no card (the kernels have no CPU
mode). Run them on the card with
``python -m pytest -m gpu tests/test_torch_flash_backward_card.py``. Inputs
are those of ``test_torch_flash_backward.py`` with the head dim tiled to 64.
Tolerances: bf16 2e-2 absolute and relative (P, dS and the gradients rounded
to bf16), f32 1e-4 (fp32 sums in another order).
"""

import pytest
import torch

from bigdl_tpu_torch.ops import flash_attention as port

from test_torch_flash_backward import CASES, _inputs


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode); run on the card "
                    "with `python -m pytest -m gpu tests/test_torch_flash_backward_card.py`")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("tq,tk,causal,lengths,mask_q", CASES[1::3])
def test_kernels_match_plain_on_card(cuda_card, dtype, tq, tk, causal, lengths, mask_q):
    dt = getattr(torch, dtype)
    q, k, v, g = (torch.from_numpy(a).repeat(1, 1, 1, 4).to("cuda", dt)  # d = 64
                  for a in _inputs(tq, tk))
    tl = None if lengths is None else torch.tensor(lengths, dtype=torch.int32, device="cuda")
    out, lse = port.flash_attention_fwd(q, k, v, causal, lengths=tl, mask_q=mask_q)
    before = (port.launches_dq, port.launches_dkv)
    got = port.flash_attention_bwd(q, k, v, out, lse, g, causal, lengths=tl, mask_q=mask_q)
    torch.cuda.synchronize()
    assert (port.launches_dq, port.launches_dkv) == (before[0] + 1, before[1] + 1)
    want = port.flash_attention_bwd_reference(q, k, v, out, lse, g, causal, lengths=tl,
                                              mask_q=mask_q)
    tol = 2e-2 if dt == torch.bfloat16 else 1e-4  # bf16 rounding of P, dS, grads; f32 order
    for a, b in zip(got, want):
        torch.testing.assert_close(a.float(), b.float(), atol=tol, rtol=tol)


@pytest.mark.gpu
def test_autograd_through_kernels_on_card(cuda_card):
    q, k, v, g = (torch.from_numpy(a).repeat(1, 1, 1, 4).to("cuda", torch.bfloat16)
                  for a in _inputs(40, 40))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    before = (port.launches, port.launches_dq, port.launches_dkv)
    port.flash_attention(*leaves, True).sum().backward()
    torch.cuda.synchronize()
    assert (port.launches, port.launches_dq, port.launches_dkv) == tuple(b + 1 for b in before)
    out, lse = port.flash_attention_fwd(q, k, v, True)
    want = port.flash_attention_bwd_reference(q, k, v, out, lse, torch.ones_like(out), True)
    for t, b in zip(leaves, want):
        torch.testing.assert_close(t.grad.float(), b.float(), atol=2e-2, rtol=2e-2)
