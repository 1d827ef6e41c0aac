#!/usr/bin/env python3
"""Time one checkout's flash-attention backward at the LM's shape on one CUDA card.

    python3 tools/torch_flash_bwd_ab.py ROOT LABEL

Imports ``bigdl_tpu_torch`` from the checkout at ROOT (building its kernel
library there) and prints, after LABEL, at (8, 8, 2048, 64) bf16 causal:
the dQ and dK/dV kernels' ms a call, each launched alone through its C entry
point; the pair through ``flash_attention_bwd`` (delta included) on
contiguous tensors and on ``split_heads`` views of (8, 2048, 512) tensors;
``scaled_dot_product_attention``'s backward (dq, dk and dv) under each
backend that takes the shape; and the host's µs a ``flash_attention_bwd``
call at (1, 1, 128, 64), where the card never holds the host back: the
least and the median of 5 blocks of 100 calls enqueued back to back (the
host's clock is shared with other work; the least is the call's own cost).
Run it for two checkouts in turns (a, b, b, a), one after another on one
card, to compare them.
"""

import sys
import time

root, label = sys.argv[1], sys.argv[2]
sys.path.insert(0, root)
sys.modules["jax"] = None
sys.modules["bigdl_tpu"] = None

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402
from torch.nn.attention import SDPBackend, sdpa_kernel  # noqa: E402
from bigdl_tpu_torch.ops import _build  # noqa: E402
from bigdl_tpu_torch.ops import flash_attention as fa  # noqa: E402


def ms(fn, iters=100):
    for _ in range(10):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def check(rc):
    if rc != 0:
        raise RuntimeError(f"backward kernel launch failed with CUDA error {rc}")


lib = _build.load()
g = torch.Generator(device="cuda").manual_seed(0)
q, k, v, d_out = (torch.randn(8, 8, 2048, 64, generator=g, device="cuda").bfloat16()
                  for _ in range(4))
qv, kv, vv, dov = (torch.randn(8, 2048, 512, generator=g, device="cuda").bfloat16()
                   .view(8, 2048, 8, 64).transpose(1, 2) for _ in range(4))
out, lse = fa.flash_attention_fwd(q, k, v, True)
outv, lsev = fa.flash_attention_fwd(qv, kv, vv, True)
head, tail, keep = fa._bwd_kernel_args(q, k, v, out, lse, d_out, True, None, None, True)
dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
r = dict(
    dq=ms(lambda: check(lib.bigdl_flash_attention_bwd_dq(*head, dq.data_ptr(), *tail))),
    dkv=ms(lambda: check(lib.bigdl_flash_attention_bwd_dkv(*head, dk.data_ptr(), dv.data_ptr(),
                                                           *tail))),
    pair=ms(lambda: fa.flash_attention_bwd(q, k, v, out, lse, d_out, True)),
    views=ms(lambda: fa.flash_attention_bwd(qv, kv, vv, outv, lsev, dov, True)))
leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
for name in ("CUDNN_ATTENTION", "FLASH_ATTENTION", "EFFICIENT_ATTENTION"):
    try:
        with sdpa_kernel([getattr(SDPBackend, name)]):
            o = F.scaled_dot_product_attention(*leaves, is_causal=True)
        r["sdpa_" + name.split("_")[0].lower()] = ms(
            lambda: torch.autograd.grad(o, leaves, d_out, retain_graph=True), iters=50)
        del o
    except (RuntimeError, AttributeError):  # the backend refuses the shape or is absent
        r["sdpa_" + name.split("_")[0].lower()] = float("nan")
small = [torch.randn(1, 1, 128, 64, generator=g, device="cuda").bfloat16() for _ in range(4)]
so, sl = fa.flash_attention_fwd(*small[:3], True)
blocks = []
for _ in range(6):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(100):
        fa.flash_attention_bwd(*small[:3], so, sl, small[3], True)
    blocks.append((time.perf_counter() - t0) / 100 * 1e6)
r["host_us_per_call"] = min(blocks[1:])  # the first block warms up
r["host_us_median"] = sorted(blocks[1:])[2]
torch.cuda.synchronize()
print(f"BWD_AB {label}: " + ", ".join(f"{k2} {v2:.4f}" for k2, v2 in r.items()), flush=True)
