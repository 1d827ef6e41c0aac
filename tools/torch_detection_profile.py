#!/usr/bin/env python3
"""Where the time goes in a MaskRCNN forward of the port.

    python3 tools/torch_detection_profile.py [--batch 2] [--hw 800 1344]   # one CUDA card

The detector of ``chip_smoke.py`` [18a]: ``MaskRCNN(81)`` at its defaults,
random weights from a seed, eval mode, the port's default policy, batch 2 of
800x1344 seeded images. One warm forward, then the forward split into its
stages, each run 5 times between ``torch.cuda.synchronize`` calls on the
previous stage's outputs:

* ``backbone + FPN`` (``MaskRCNN.features``),
* ``RPN head`` (the 3x3 and the two 1x1 convolutions),
* ``RPN proposals`` (the stable sort of every anchor's objectness, the
  decode and clip of the top 256, NMS down to 64: 64 Python steps),
* ``box + mask heads`` (``MaskRCNN.detect``: multi-level RoiAlign, the box
  head, per-class decoding, NMS down to 16 (16 steps), RoiAlign and the
  mask head on the kept boxes),

with each stage's host ms (median, the stage's launches and the wait for
the card), its device events (kernels, copies, fills) and their device ms
under ``torch.profiler`` (one run), so a stage whose host ms exceeds its
device ms is set by its launches. Then one whole forward under the profiler:
its device ms by kernel family and the card's busy share of its wall.
"""

from __future__ import annotations

import argparse
import statistics
import sys
import time
from pathlib import Path

sys.modules["jax"] = None
sys.modules["bigdl_tpu"] = None
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def family(name: str) -> str:
    n = name.lower()
    if "memcpy" in n or "memset" in n:
        return "copies / fills"
    if "conv" in n or "implicit" in n or "xmma" in n or "cudnn" in n or "winograd" in n:
        return "convolution (cuDNN)"
    if "gemm" in n or "cutlass" in n or "nvjet" in n:
        return "matmul (cuBLAS)"
    if "sort" in n or "radix" in n or "cub" in n:
        return "sort"
    if "gather" in n or "index" in n or "scatter" in n:
        return "gathers"
    if "reduce" in n or "argmax" in n or "max" in n or "softmax" in n:
        return "reductions"
    return "elementwise / casts / other"


def device_events(prof):
    import torch

    return [ev for ev in prof.profiler.kineto_results.events()
            if ev.device_type() == torch.autograd.DeviceType.CUDA]


def main(argv=None) -> int:
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from bigdl_tpu_torch import RandomGenerator
    from bigdl_tpu_torch.models import MaskRCNN

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batch", type=int, default=2)
    p.add_argument("--hw", type=int, nargs=2, default=(800, 1344))
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_detection_profile.py needs a CUDA card", file=sys.stderr)
        return 2
    RandomGenerator.set_seed(50)
    model = MaskRCNN(81).evaluate()
    x = torch.from_numpy(np.random.default_rng(51).standard_normal(
        (args.batch, 3) + tuple(args.hw)).astype(np.float32)).cuda()
    rpn = model[model.n_backbone + 1]
    with torch.no_grad():
        model.forward(x)  # builds the model
        torch.cuda.synchronize()
        p_, s_ = model.get_parameters(), model.get_state()
        levels = model.features(p_, s_, x)[0]
        logits, deltas, _ = rpn.head(p_[rpn.name()], s_[rpn.name()], levels[0])
        props = rpn.proposals(logits, deltas)
        stages = [
            ("backbone + FPN", lambda: model.features(p_, s_, x)),
            ("RPN head", lambda: rpn.head(p_[rpn.name()], s_[rpn.name()], levels[0])),
            ("RPN proposals", lambda: rpn.proposals(logits, deltas)),
            ("box + mask heads", lambda: model.detect(p_, s_, levels, props,
                                                       tuple(args.hw))),
        ]
        total_host = 0.0
        for name, fn in stages:
            host = []
            for _ in range(5):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                host.append((time.perf_counter() - t0) * 1e3)
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
            evs = device_events(prof)
            dev = sum(ev.duration_ns() for ev in evs) / 1e6
            med = statistics.median(host)
            total_host += med
            print(f"{name:18s} host {med:8.3f} ms (median of 5; {min(host):.3f}-{max(host):.3f})"
                  f"  {len(evs):5d} device events  {dev:8.3f} ms of device time")
        print(f"{'stages together':18s} host {total_host:8.3f} ms")
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            model.forward(x)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
    evs = device_events(prof)
    fam = {}
    for ev in evs:
        k = family(ev.name())
        n, ms = fam.get(k, (0, 0.0))
        fam[k] = (n + 1, ms + ev.duration_ns() / 1e6)
    dev = sum(ms for _, ms in fam.values())
    print(f"whole forward under the profiler: wall {wall:.3f} ms, {len(evs)} device events, "
          f"{dev:.3f} ms of device time ({100 * dev / wall:.1f}% busy)")
    for k, (n, ms) in sorted(fam.items(), key=lambda kv: -kv[1][1]):
        print(f"  {k:30s} {n:5d} events {ms:8.3f} ms ({100 * ms / dev:.1f}%)")
    import subprocess

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
