#!/usr/bin/env python3
"""Where the time goes in one served batch of the port's Transformer-LM.

    python3 tools/torch_serving_profile.py      # needs one CUDA card

Builds the full-width LM of ``chip_smoke.py`` (vocab 8192, hidden 512, 8
heads, filter 2048, 6 layers, T=2048, bf16 compute, random weights from a
seed), runs ``Predictor.forward_batch`` on a batch of 8 records under
``torch.profiler``, and prints the device time by kernel family (the flash
kernel, matmuls, the rest), the device's busy share of the forward's wall
time, and the time to copy one request's (T, vocab) f32 logits to the host.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

sys.modules["jax"] = None
sys.modules["bigdl_tpu"] = None
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def family(name: str) -> str:
    n = name.lower()
    if "flash_fwd" in n:
        return "flash_attention_fwd (this repo's kernel)"
    if "gemm" in n or "sm90_xmma" in n or "cutlass" in n or "nvjet" in n:
        return "matmul (cuBLAS)"
    if "softmax" in n or "reduce" in n or "norm" in n:
        return "reductions"
    return "elementwise / copies / other"


def main() -> int:
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from bigdl_tpu_torch import Engine, RandomGenerator
    from bigdl_tpu_torch.nn import Transformer
    from bigdl_tpu_torch.optim import Predictor

    if not torch.cuda.is_available():
        print("torch_serving_profile.py: needs a CUDA card", file=sys.stderr)
        return 2
    Engine.set_compute_dtype("bfloat16")
    RandomGenerator.set_seed(0)
    model = Transformer(8192, 512, 8, 2048, 6, 0.0, 0.0, 0.0, device="cuda").eval()
    pred = Predictor(model, batch_size=8)
    x = np.random.default_rng(0).integers(1, 8192, size=(8, 2048), dtype=np.int64)
    for _ in range(3):
        pred.forward_batch(x)
    torch.cuda.synchronize()

    reps = 5
    t0 = time.perf_counter()
    for _ in range(reps):
        y = pred.forward_batch(x)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / reps * 1e3

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            y = pred.forward_batch(x)
        torch.cuda.synchronize()
    by_family: dict = {}
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = ev.self_cuda_time_total
        if dev_us > 0 and ev.device_type == torch.autograd.DeviceType.CUDA:
            f = family(ev.key)
            by_family[f] = by_family.get(f, 0.0) + dev_us / 1e3 / reps
    busy = sum(by_family.values())

    row = y[0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        row.cpu()
    copy_ms = (time.perf_counter() - t0) / reps * 1e3

    print(f"card: {torch.cuda.get_device_name(0)}")
    print(f"forward_batch (8 x 2048 tokens): wall {wall_ms:.3f} ms, device busy "
          f"{busy:.3f} ms ({100 * busy / wall_ms:.1f}% of wall)")
    for f, ms in sorted(by_family.items(), key=lambda kv: -kv[1]):
        print(f"  {f:45s} {ms:8.3f} ms  {100 * ms / busy:5.1f}%")
    print(f"one request's logits to host ({tuple(row.shape)} f32, "
          f"{row.numel() * 4 / 1e6:.1f} MB): {copy_ms:.3f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
