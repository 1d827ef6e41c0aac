#!/usr/bin/env python3
"""Device work of one step of the ResNet recipe through each update layout,
by kernel name, on one CUDA card.

    python3 tools/torch_distri_profile.py [--steps 2] [--top 12]   # one CUDA card

The ImageNet recipe of ``bigdl_tpu_torch/examples/resnet_train.py`` (ResNet-50
conv7, 1000 classes, batch 128 of 224x224 synthetic images, bf16 activations,
nesterov SGD with ``("_bn", "bias")`` excluded from weight decay) is built
three times from the seed and trained through ``LocalOptimizer`` on the tree
(``tree``), ``LocalOptimizer(flat_update=True)`` (``flat``) and
``DistriOptimizer`` without a process group (``distri``: the ZeRO-1 step at
world size 1), in turns ``tree, flat, distri, tree``. Each run takes 3 steps,
then ``--steps`` more under ``torch.profiler``: the device time a step
summed over the CUDA kernels, each kernel name's ms a step, and the names
whose time differs most between ``tree`` and ``flat``. The card's name and
power limit are printed beside the numbers.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time
from collections import defaultdict

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGV = ["--dataset", "imagenet", "--depth", "50", "-b", "128", "--warmup-epochs", "0",
        "--max-epoch", "1", "--synthetic-size", "640"]


def _card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True, capture_output=True,
                          text=True, timeout=60).stdout.strip().splitlines()[0]


def _profile(kind: str, steps: int):
    """(device ms a step, {kernel name: ms a step}, host ms a step) of one
    layout's profiled steps."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from bigdl_tpu_torch.examples import resnet_train
    from bigdl_tpu_torch.optim import LocalOptimizer, Trigger
    from bigdl_tpu_torch.parallel import DistriOptimizer
    from bigdl_tpu_torch.utils.engine import Engine

    Engine.set_activation_dtype(None)
    recipe = resnet_train.build(resnet_train.parser().parse_args(ARGV))
    base = recipe.optimizer
    if kind == "distri":
        opt = DistriOptimizer(recipe.model, base.dataset, base.criterion)
    else:
        opt = LocalOptimizer(recipe.model, base.dataset, base.criterion,
                             flat_update=kind == "flat")
    opt.set_optim_method(base.optim_method).set_end_when(Trigger.max_iteration(3))
    opt.optimize()
    opt.set_end_when(Trigger.max_iteration(3 + steps))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        opt.optimize()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name = defaultdict(float)
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() == torch.autograd.DeviceType.CUDA:
            by_name[ev.name()] += ev.duration_ns() / 1e6 / steps
    del opt, recipe
    torch.cuda.empty_cache()
    return sum(by_name.values()), dict(by_name), wall * 1e3 / steps


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--steps", type=int, default=2)
    p.add_argument("--top", type=int, default=12)
    a = p.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_distri_profile.py: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    card = _card()
    runs = []
    for kind in ("tree", "flat", "distri", "tree"):
        dev, by_name, wall = _profile(kind, a.steps)
        runs.append((kind, dev, by_name))
        print(f"{kind}: device work {dev:.2f} ms a step, profiled wall {wall:.2f} ms a step; "
              f"card {card}", flush=True)
        for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:a.top]:
            print(f"    {ms:8.3f} ms  {name[:120]}")
    tree, flat = runs[0][2], runs[1][2]
    names = set(tree) | set(flat)
    delta = sorted(((flat.get(n, 0.0) - tree.get(n, 0.0), n) for n in names),
                   key=lambda d: -abs(d[0]))
    print(f"flat - tree, by kernel name (ms a step; card {card}):")
    for d, n in delta[:a.top]:
        print(f"    {d:+8.3f} ms  tree {tree.get(n, 0.0):7.3f}  flat {flat.get(n, 0.0):7.3f}  "
              f"{n[:100]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
