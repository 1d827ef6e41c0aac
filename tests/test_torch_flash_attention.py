"""The port's flash-attention forward against the JAX package's Pallas kernel.

On the CPU the port's wrapper takes its plain version (CPU tensors), and the
JAX kernel runs in the Pallas interpreter with small blocks (16 query rows,
8 keys) so its multi-tile and padding paths run. Inputs are made with numpy
from a seed and handed to both. Tolerance: f32 throughout, 1e-5 absolute and
relative (the two sum the same products in another order).

The kernel itself runs only on a CUDA card: ``test_kernel_matches_plain_on_card``
is marked ``gpu`` and skips here.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from bigdl_tpu.ops.flash_attention import _flash_fwd_impl
from bigdl_tpu.ops.flash_attention import flash_attention as jax_flash_attention
from bigdl_tpu_torch.ops import flash_attention as port

ATOL = RTOL = 1e-5
BLOCK_Q, BLOCK_K = 16, 8

CASES = [
    # (Tq, Tk, causal, lengths, mask_q)
    (24, 24, False, None, None),
    (24, 24, True, None, None),
    (20, 37, False, None, None),
    (20, 37, True, None, None),
    (24, 24, False, [24, 13, 0], True),
    (24, 24, True, [24, 13, 0], True),
    (24, 24, False, [24, 13, 0], False),
    (24, 24, True, [24, 13, 0], False),
    (20, 37, False, [37, 21, 5], True),
    (20, 37, True, [37, 21, 5], True),
    (20, 37, False, [37, 21, 5], False),
    (20, 37, True, [37, 21, 5], False),
]


def _inputs(tq, tk, n=3, h=2, d=16, seed=0):
    rs = np.random.RandomState(seed)
    q = rs.randn(n, h, tq, d).astype(np.float32)
    k = rs.randn(n, h, tk, d).astype(np.float32)
    v = rs.randn(n, h, tk, d).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("tq,tk,causal,lengths,mask_q", CASES)
def test_forward_matches_jax_kernel(tq, tk, causal, lengths, mask_q):
    q, k, v = _inputs(tq, tk)
    n, h = q.shape[:2]
    jl = None if lengths is None else jnp.asarray(lengths, jnp.int32)
    mq = (tq == tk) if mask_q is None else mask_q
    j_out = np.asarray(jax_flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal,
        block_q=BLOCK_Q, block_k=BLOCK_K, interpret=True, lengths=jl, mask_q=mq))
    _, j_lse = _flash_fwd_impl(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jl,
                               causal, None, BLOCK_Q, BLOCK_K, True, mq)
    j_lse = np.asarray(j_lse)[:, 0, :tq].reshape(n, h, tq)

    tl = None if lengths is None else torch.tensor(lengths, dtype=torch.int32)
    before = port.launches
    out, lse = port.flash_attention_fwd(torch.from_numpy(q), torch.from_numpy(k),
                                        torch.from_numpy(v), causal, lengths=tl,
                                        mask_q=mask_q)
    assert port.launches == before  # CPU tensors never count as a kernel launch
    assert out.shape == q.shape and out.dtype == torch.float32
    assert lse.shape == (n, h, tq) and lse.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), j_out, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(lse.numpy(), j_lse, atol=ATOL, rtol=RTOL)


def test_rows_without_keys_give_zero_and_neg_big():
    q, k, v = _inputs(24, 24)
    lengths = torch.tensor([24, 13, 0], dtype=torch.int32)
    out, lse = port.flash_attention_fwd(torch.from_numpy(q), torch.from_numpy(k),
                                        torch.from_numpy(v), True, lengths=lengths)
    assert torch.all(out[2] == 0) and torch.all(lse[2] == port.NEG_BIG)
    assert torch.all(out[1, :, 13:] == 0) and torch.all(lse[1, :, 13:] == port.NEG_BIG)
    assert torch.isfinite(out).all()


def test_scale_argument_matches_jax():
    q, k, v = _inputs(24, 24, seed=3)
    _, j_lse = _flash_fwd_impl(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), None,
                               True, 0.3, BLOCK_Q, BLOCK_K, True, True)
    _, lse = port.flash_attention_fwd(torch.from_numpy(q), torch.from_numpy(k),
                                      torch.from_numpy(v), True, scale=0.3)
    np.testing.assert_allclose(lse.numpy(), np.asarray(j_lse)[:, 0, :24].reshape(3, 2, 24),
                               atol=ATOL, rtol=RTOL)


def test_unsupported_device_raises():
    q = torch.zeros((1, 1, 4, 64), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        port.flash_attention_fwd(q, q, q)


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode); run on the card "
                    "with `python -m pytest -m gpu tests/test_torch_flash_attention.py`")


def _split_heads(a):
    """(N, H, T, d) numpy -> the same values as an (N, H, T, d) view of an
    (N, T, H*d) tensor, the layout ``nn.attention.split_heads`` hands the
    kernel (T stride H*d)."""
    n, h, t, d = a.shape
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 2, 1, 3))).reshape(
        n, t, h * d).view(n, t, h, d).transpose(1, 2)


@pytest.mark.parametrize("tq,tk,causal,lengths,mask_q", CASES[1::3])
def test_split_heads_views_match_jax_kernel(tq, tk, causal, lengths, mask_q):
    """The wrapper on strided (split_heads) views computes what the JAX
    kernel computes on the contiguous arrays."""
    q, k, v = _inputs(tq, tk, seed=5)
    jl = None if lengths is None else jnp.asarray(lengths, jnp.int32)
    mq = (tq == tk) if mask_q is None else mask_q
    j_out, j_lse = _flash_fwd_impl(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jl,
                                   causal, None, BLOCK_Q, BLOCK_K, True, mq)
    qv, kv, vv = (_split_heads(a) for a in (q, k, v))
    assert not qv.is_contiguous() and qv.stride(2) == q.shape[1] * q.shape[3]
    tl = None if lengths is None else torch.tensor(lengths, dtype=torch.int32)
    out, lse = port.flash_attention_fwd(qv, kv, vv, causal, lengths=tl, mask_q=mask_q)
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out)[:, :, :tq], atol=ATOL,
                               rtol=RTOL)
    n, h = q.shape[:2]
    np.testing.assert_allclose(lse.numpy(), np.asarray(j_lse)[:, 0, :tq].reshape(n, h, tq),
                               atol=ATOL, rtol=RTOL)


@pytest.mark.gpu
@pytest.mark.parametrize("views", [False, True], ids=["contiguous", "split_heads"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("tq,tk,causal,lengths,mask_q", CASES[1::3])
def test_kernel_matches_plain_on_card(cuda_card, dtype, tq, tk, causal, lengths, mask_q,
                                      views):
    dt = getattr(torch, dtype)
    make = _split_heads if views else torch.from_numpy
    q, k, v = (make(np.ascontiguousarray(np.tile(a, (1, 1, 1, 4)))).to("cuda", dt)  # d = 64
               for a in _inputs(tq, tk))
    tl = None if lengths is None else torch.tensor(lengths, dtype=torch.int32,
                                                   device="cuda")
    before = port.launches
    out, lse = port.flash_attention_fwd(q, k, v, causal, lengths=tl, mask_q=mask_q)
    torch.cuda.synchronize()
    assert port.launches == before + 1
    ref_out, ref_lse = port.flash_attention_fwd_reference(q, k, v, causal, lengths=tl,
                                                          mask_q=mask_q)
    tol = 1e-2 if dt == torch.bfloat16 else 2e-5  # bf16 output rounding; fp32 sum order
    torch.testing.assert_close(out.float(), ref_out.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("n,h,t,d,lengths,mask_q", [
    (8, 8, 2048, 64, None, None),        # the LM's serving shape
    (2, 8, 1000, 64, None, None),        # ragged: TMA fills rows past T with zeros
    (1, 8, 2047, 64, None, None),
    (2, 4, 1000, 128, None, None),
    (4, 2, 1000, 64, [1000, 517, 1, 0], True),
], ids=["serving", "T1000", "T2047", "d128", "lengths-mask_q"])
def test_kernel_on_split_heads_views_at_lm_sizes(cuda_card, n, h, t, d, lengths, mask_q):
    """bf16 split_heads views at the LM's sizes (what [3] of chip_smoke.py holds
    too): within the bf16 tolerance of the plain version, and a repeat gives
    the same bits."""
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn((n, t, h * d), generator=g, device="cuda").bfloat16()
               .view(n, t, h, d).transpose(1, 2) for _ in range(3))
    tl = None if lengths is None else torch.tensor(lengths, dtype=torch.int32, device="cuda")
    out, lse = port.flash_attention_fwd(q, k, v, True, lengths=tl, mask_q=mask_q)
    again = port.flash_attention_fwd(q, k, v, True, lengths=tl, mask_q=mask_q)
    torch.cuda.synchronize()
    ref_out, ref_lse = port.flash_attention_fwd_reference(q, k, v, True, lengths=tl,
                                                          mask_q=mask_q)
    torch.testing.assert_close(out.float(), ref_out.float(), atol=1e-2, rtol=1e-2)
    torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=1e-5)
    assert torch.equal(again[0], out) and torch.equal(again[1], lse)
