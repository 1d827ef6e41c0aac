#!/usr/bin/env python3
"""Where the time goes in one training step of the port's Transformer-LM.

    python3 tools/torch_training_profile.py      # needs one CUDA card

Builds the full-width LM of ``chip_smoke.py`` (vocab 8192, hidden 512, 8
heads, filter 2048, 6 layers, T=2048, dropout 0, bf16 compute, random
weights from a seed), trains it through ``LocalOptimizer`` (SGD, lr 0.1,
``CrossEntropyCriterion``, batch 8): 3 warm-up iterations, 5 timed ones
(the step time is the median gap between the optimizer's one-step-late
loss pulls, the first of a run left out), then 5 under ``torch.profiler``.
Prints the step time and tokens/s, the device time per step by kernel family
(the three flash kernels, matmuls, reductions, the rest) and the device's
busy share of the step.
"""

from __future__ import annotations

import statistics
import sys
from pathlib import Path

sys.modules["jax"] = None
sys.modules["bigdl_tpu"] = None
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def family(name: str) -> str:
    n = name.lower()
    for kernel in ("flash_bwd_dq", "flash_bwd_dkv", "flash_fwd"):
        if kernel in n:
            return f"{kernel} (this repo's kernel)"
    if "gemm" in n or "sm90_xmma" in n or "cutlass" in n or "nvjet" in n:
        return "matmul (cuBLAS)"
    if "softmax" in n or "reduce" in n or "norm" in n:
        return "reductions (softmax, norms, sums)"
    return "elementwise / copies / other"


def main() -> int:
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from bigdl_tpu_torch import Engine, RandomGenerator
    from bigdl_tpu_torch.dataset import DataSet
    from bigdl_tpu_torch.nn import CrossEntropyCriterion, Transformer
    from bigdl_tpu_torch.optim import SGD, LocalOptimizer, Trigger

    if not torch.cuda.is_available():
        print("torch_training_profile.py: needs a CUDA card", file=sys.stderr)
        return 2
    vocab, batch, seq, warmup, reps = 8192, 8, 2048, 3, 5
    Engine.set_compute_dtype("bfloat16")
    RandomGenerator.set_seed(0)
    gen = np.random.default_rng(0)
    ids = gen.integers(0, vocab, (40, seq))
    targets = gen.integers(0, vocab, (40, seq))
    model = Transformer(vocab, 512, 8, 2048, 6, 0.0, 0.0, 0.0, device="cuda")
    opt = LocalOptimizer(model, DataSet.array(ids, targets, batch_size=batch),
                         CrossEntropyCriterion()).set_optim_method(SGD(learningrate=0.1))
    opt.set_end_when(Trigger.max_iteration(warmup)).optimize()
    torch.cuda.synchronize()

    opt.set_end_when(Trigger.max_iteration(warmup + reps)).optimize()
    # the first pull of a run also waits for its first dispatch: steady steps only
    step_ms = statistics.median(h["wall_s"] for h in opt.history[warmup + 1:]) * 1e3
    opt.set_end_when(Trigger.max_iteration(warmup + 2 * reps))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        opt.optimize()
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

    print(f"card: {torch.cuda.get_device_name(0)}")
    print(f"training step (8 x 2048 tokens): {step_ms:.3f} ms, "
          f"{batch * seq / step_ms * 1e3:.0f} tokens/s; device busy {busy:.3f} ms per step "
          f"({100 * busy / step_ms:.1f}% of the step)")
    for f, ms in sorted(by_family.items(), key=lambda kv: -kv[1]):
        print(f"  {f:45s} {ms:8.3f} ms  {100 * ms / busy:5.1f}%")
    return 0


if __name__ == "__main__":
    sys.exit(main())
