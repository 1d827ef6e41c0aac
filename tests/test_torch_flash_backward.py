"""The port's flash-attention gradients against the JAX package's Pallas
backward kernels.

On the CPU, ``flash_attention`` goes through the port's autograd Function
over the plain forward and backward versions (CPU tensors); the JAX side is
``jax.grad`` of ``flash_attention(..., interpret=True)`` with small blocks
(16 query rows, 8 keys), so the Pallas dQ and dK/dV kernels run in the
interpreter over several tiles and padded edges. Inputs and the cotangent
come from numpy with a seed. Tolerance: f32 throughout, 1e-4 absolute and
relative (the same products summed in another order, through dP - delta).

The kernels themselves run only on a CUDA card: their tests are in
``test_torch_flash_backward_card.py``, marked ``gpu``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu.ops.flash_attention import _flash_bwd_impl, _flash_fwd_impl
from bigdl_tpu.ops.flash_attention import flash_attention as jax_flash_attention
from bigdl_tpu_torch.ops import flash_attention as port

ATOL = RTOL = 1e-4
BLOCK_Q, BLOCK_K = 16, 8

CASES = [
    # (Tq, Tk, causal, lengths, mask_q): the forward test's 12 cases ...
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
    # ... and Tq > Tk causal: the first rows see no key
    (37, 20, True, None, None),
]


def _inputs(tq, tk, n=3, h=2, d=16, seed=0):
    rs = np.random.RandomState(seed)
    q = rs.randn(n, h, tq, d).astype(np.float32)
    k = rs.randn(n, h, tk, d).astype(np.float32)
    v = rs.randn(n, h, tk, d).astype(np.float32)
    g = rs.randn(n, h, tq, d).astype(np.float32)
    return q, k, v, g


def _mask_q(tq, tk, mask_q):
    return (tq == tk) if mask_q is None else mask_q


@pytest.mark.parametrize("tq,tk,causal,lengths,mask_q", CASES)
def test_gradients_match_jax_kernels(tq, tk, causal, lengths, mask_q):
    q, k, v, g = _inputs(tq, tk)
    jl = None if lengths is None else jnp.asarray(lengths, jnp.int32)
    mq = _mask_q(tq, tk, mask_q)

    def loss(q, k, v):
        out = jax_flash_attention(q, k, v, causal, block_q=BLOCK_Q, block_k=BLOCK_K,
                                  interpret=True, lengths=jl, mask_q=mq)
        return jnp.sum(out * g)

    want = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))

    tl = None if lengths is None else torch.tensor(lengths, dtype=torch.int32)
    qt, kt, vt = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    before = (port.launches_dq, port.launches_dkv)
    out = port.flash_attention(qt, kt, vt, causal, lengths=tl, mask_q=mask_q)
    out.backward(torch.from_numpy(g))
    assert (port.launches_dq, port.launches_dkv) == before  # CPU: plain versions only
    for got, ref, name in zip((qt.grad, kt.grad, vt.grad), want, ("dq", "dk", "dv")):
        assert got.shape == ref.shape and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL,
                                   err_msg=name)


@pytest.mark.parametrize("tq,tk,causal,lengths,mask_q", CASES[1::2])
def test_bwd_reference_matches_jax_bwd_impl(tq, tk, causal, lengths, mask_q):
    """The plain backward given the same out/lse as the JAX kernels."""
    q, k, v, g = _inputs(tq, tk, seed=1)
    n, h = q.shape[:2]
    jl = None if lengths is None else jnp.asarray(lengths, jnp.int32)
    mq = _mask_q(tq, tk, mask_q)
    args = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    out, lse = _flash_fwd_impl(*args, jl, causal, None, BLOCK_Q, BLOCK_K, True, mq)
    want = _flash_bwd_impl(*args, jl, out, lse, jnp.asarray(g), causal, None,
                           BLOCK_Q, BLOCK_K, True, mq)

    lse_port = torch.from_numpy(np.asarray(lse)[:, 0, :tq].reshape(n, h, tq).copy())
    tl = None if lengths is None else torch.tensor(lengths, dtype=torch.int32)
    got = port.flash_attention_bwd_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(np.array(out)), lse_port, torch.from_numpy(g), causal,
        lengths=tl, mask_q=mask_q)
    for a, b, name in zip(got, want, ("dq", "dk", "dv")):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL, rtol=RTOL,
                                   err_msg=name)


def test_rows_without_keys_get_no_gradient():
    q, k, v, g = _inputs(24, 24, seed=2)
    lengths = torch.tensor([24, 13, 0], dtype=torch.int32)
    qt, kt, vt = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    port.flash_attention(qt, kt, vt, True, lengths=lengths).backward(torch.from_numpy(g))
    for grad in (qt.grad, kt.grad, vt.grad):
        assert torch.isfinite(grad).all()
        assert torch.all(grad[2] == 0) and torch.all(grad[1, :, 13:] == 0)


def test_scale_and_sum_cotangent():
    """A scale argument, and the stride-0 cotangent of ``sum()``."""
    q, k, v, _ = _inputs(24, 24, seed=3)

    def loss(q, k, v):
        return jnp.sum(jax_flash_attention(q, k, v, True, 0.3, block_q=BLOCK_Q,
                                           block_k=BLOCK_K, interpret=True))

    want = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    qt, kt, vt = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    port.flash_attention(qt, kt, vt, True, scale=0.3).sum().backward()
    for got, ref in zip((qt.grad, kt.grad, vt.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)


def test_inference_mode_forward_only():
    q, k, v, _ = _inputs(24, 24)
    with torch.inference_mode():
        out = port.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), True)
    ref, _ = port.flash_attention_fwd_reference(torch.from_numpy(q), torch.from_numpy(k),
                                                torch.from_numpy(v), True)
    torch.testing.assert_close(out, ref)
    assert not out.requires_grad


def test_unsupported_device_raises():
    q = torch.zeros((1, 1, 4, 64), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        port.flash_attention_bwd(q, q, q, q, torch.zeros((1, 1, 4), device="meta"), q)
