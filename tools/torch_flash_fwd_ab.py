#!/usr/bin/env python3
"""Time one checkout's flash-attention forward at the LM's shape on one CUDA card.

    python3 tools/torch_flash_fwd_ab.py ROOT LABEL

Imports ``bigdl_tpu_torch`` from the checkout at ROOT (building its kernel
library there) and prints, after LABEL, the forward's ms a call at (8, 8,
2048, 64) bf16 causal on contiguous tensors and on ``split_heads`` views of
(8, 2048, 512) tensors, ``scaled_dot_product_attention``'s ms on the same
inputs, and the host's µs a call (200 calls enqueued back to back). Run it
for two checkouts in turns (a, b, b, a) in one session on one card to
compare them.
"""

import sys
import time

root, label = sys.argv[1], sys.argv[2]
sys.path.insert(0, root)
sys.modules["jax"] = None
sys.modules["bigdl_tpu"] = None

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402
from bigdl_tpu_torch.ops import _build  # noqa: E402
from bigdl_tpu_torch.ops.flash_attention import flash_attention_fwd  # noqa: E402


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


_build.load()
g = torch.Generator(device="cuda").manual_seed(0)
q, k, v = (torch.randn(8, 8, 2048, 64, generator=g, device="cuda").bfloat16() for _ in range(3))
qv, kv, vv = (torch.randn(8, 2048, 512, generator=g, device="cuda").bfloat16()
              .view(8, 2048, 8, 64).transpose(1, 2) for _ in range(3))
r = dict(contiguous=ms(lambda: flash_attention_fwd(q, k, v, True)),
         views=ms(lambda: flash_attention_fwd(qv, kv, vv, True)),
         sdpa=ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True)))
torch.cuda.synchronize()
t0 = time.perf_counter()
for _ in range(200):
    flash_attention_fwd(qv, kv, vv, True)
r["host_us_per_call"] = (time.perf_counter() - t0) / 200 * 1e6
torch.cuda.synchronize()
print(f"AB {label}: " + ", ".join(f"{k2} {v2:.4f}" for k2, v2 in r.items()), flush=True)
