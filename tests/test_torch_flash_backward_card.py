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


def _split_heads_card(shape, g):
    """An (N, H, T, d) bf16 view of an (N, T, H*d) tensor, as ``split_heads`` makes."""
    n, h, t, d = shape
    flat = torch.randn((n, t, h * d), generator=g, device="cuda").to(torch.bfloat16)
    return flat.view(n, t, h, d).permute(0, 2, 1, 3)


@pytest.mark.gpu
@pytest.mark.parametrize("n,h,t,d,causal,views", [
    (2, 8, 2048, 64, True, True),     # split_heads views at the LM's widths
    (1, 4, 1000, 128, True, True),    # views, d = 128, a ragged last item
    (2, 8, 2048, 128, True, False),   # d = 128 at T = 2048
    (4, 4, 129, 64, True, False),     # 128-row items with one row in the second
    (4, 4, 129, 128, False, False),
    (1, 8, 2047, 64, True, False),    # one row short of full items
], ids=["views-d64", "views-d128-T1000", "d128-T2048", "T129-d64", "T129-d128-noncausal",
        "T2047"])
def test_tma_layouts_and_ragged_items_on_card(cuda_card, n, h, t, d, causal, views):
    """The kernels read q, k, v and the cotangent through TMA tensor maps over
    the callers' strides, in items of 128 rows: strided views, both head dims
    and ragged items against the plain version (bf16 tolerance as above)."""
    g = torch.Generator(device="cuda").manual_seed(7)
    if views:
        q, k, v, d_out = (_split_heads_card((n, h, t, d), g) for _ in range(4))
        assert not q.is_contiguous()
    else:
        q, k, v, d_out = (torch.randn((n, h, t, d), generator=g, device="cuda")
                          .to(torch.bfloat16) for _ in range(4))
    out, lse = port.flash_attention_fwd(q, k, v, causal)
    got = port.flash_attention_bwd(q, k, v, out, lse, d_out, causal)
    again = port.flash_attention_bwd(q, k, v, out, lse, d_out, causal)
    torch.cuda.synchronize()
    want = port.flash_attention_bwd_reference(q, k, v, out, lse, d_out, causal)
    for a, b, c in zip(got, want, again):
        assert torch.isfinite(a).all()
        torch.testing.assert_close(a.float(), b.float(), atol=2e-2, rtol=2e-2)
        assert torch.equal(a, c)  # no atomics: a repeat gives the same bits
