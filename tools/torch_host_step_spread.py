#!/usr/bin/env python3
"""The BiLSTM classifier's training step under the conditions it meets in
the scripts that time it, and the host's cost of one launch, in one
process.

    python3 tools/torch_host_step_spread.py   # one CUDA card

The step is ``chip_smoke.py`` [11]'s (``models.parity_config("bilstm")``:
batch 128, T 200, hidden 128; bf16 compute and activations, ClassNLL, SGD
lr 0.01 momentum 0.9; 10 iterations through ``LocalOptimizer``, the median
of iterations 3-10), run by [11]'s own function. The host sets it (the
device is busy about 6% of it), so it reads what the host thread does.

First the host's costs, each as wall per call and the main thread's CPU
time over that wall: a pure-Python loop (the thread clock's own check),
``add_`` on a one-element CPU tensor (torch's dispatch), the same on a CUDA
tensor with no synchronization until the end (dispatch and launch), and the
kernels one BiLSTM step launches (from a ``torch.profiler`` session of 3
iterations). Then the step under each condition, the conditions taken in
turn ``RUNS`` (4) times over (so a drift over the process falls on each
alike):

- ``nothing right before``: no other work just before the run (the
  first of these is the process's first run);
- ``after the Inception-v1 route check``: right after [11]'s CPU-vs-card
  route check of Inception-v1 (3 f32 SGD steps on each route, the CPU's
  with every intra-op thread), which [11] runs just before this step;
- ``after the route check and 10 s idle``: the same, then 10 s asleep;
- ``after the route check on 1 intra-op thread``: its CPU route on one
  thread (``torch.set_num_threads(1)`` during the check only);
- ``after the route check, gc off``: Python's collector disabled during
  the run;
- ``1 intra-op thread``: ``torch.set_num_threads(1)`` during the run;

and last, ``RUNS`` runs ``after the profiler``: after the profiler session
above, as ``tools/torch_training_profile.py`` profiles LeNet-5 and
Inception-v1 before it times the BiLSTM.

Prints each run's step and the CPU time of the main thread and of the
process over the run's wall (autograd runs the backward on its own device
thread, so the main thread's share leaves it out), [11]'s lines (every
iteration's wall), the host's CPUs, torch's thread count, the load average
and the cores' clock, and the card's name and power limit.
"""

from __future__ import annotations

import contextlib
import gc
import os
import statistics
import sys
import time
from pathlib import Path

sys.modules["jax"] = None
sys.modules["bigdl_tpu"] = None
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

RUNS = 4  # of the step under each condition


def _host() -> str:
    import torch

    mhz, model = [], "?"
    with open("/proc/cpuinfo") as f:
        for line in f:
            if line.startswith("cpu MHz"):
                mhz.append(float(line.split(":")[1]))
            elif line.startswith("model name"):
                model = line.split(":")[1].strip()
    with open("/proc/loadavg") as f:
        load = " ".join(f.read().split()[:3])
    clock = f"{min(mhz):.0f}-{max(mhz):.0f} MHz" if mhz else "clock not readable"
    return (f"CPU model {model}; {os.cpu_count()} CPUs, {len(os.sched_getaffinity(0))} usable; "
            f"torch {torch.get_num_threads()} intra-op threads; load {load}; cores at {clock}")


def _per_call(label, fn, n, sync=None):
    """Wall µs per call of fn over n calls and the main thread's CPU share."""
    t0, c0 = time.perf_counter(), time.thread_time()
    for _ in range(n):
        fn()
    if sync:
        sync()
    wall, cpu = time.perf_counter() - t0, time.thread_time() - c0
    print(f"  {label}: {wall / n * 1e6:.2f} us a call over {n}, the main thread on the CPU "
          f"{100 * cpu / wall:.1f}% of the wall", flush=True)


def host_costs() -> None:
    import torch

    print("host costs:", flush=True)
    box = [0]

    def py():
        box[0] = sum(range(200))

    _per_call("pure-Python loop (sum of 200 ints)", py, 200_000)
    cpu_t = torch.zeros(1)
    _per_call("add_ on a one-element CPU tensor", lambda: cpu_t.add_(1), 50_000)
    gpu_t = torch.zeros(1, device="cuda")
    for _ in range(1000):
        gpu_t.add_(1)
    torch.cuda.synchronize()
    _per_call("add_ on a one-element CUDA tensor, one sync at the end",
              lambda: gpu_t.add_(1), 50_000, torch.cuda.synchronize)


@contextlib.contextmanager
def _threads(n: int):
    import torch

    prev = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(prev)


@contextlib.contextmanager
def _gc_off():
    gc.disable()
    try:
        yield
    finally:
        gc.enable()


def _profiled_iterations(n: int) -> None:
    """n BiLSTM iterations under torch.profiler, as the profile tool runs
    them; prints the CUDA kernels launched an iteration."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from bigdl_tpu_torch.dataset import DataSet
    from bigdl_tpu_torch.models import parity_config
    from bigdl_tpu_torch.nn import ClassNLLCriterion
    from bigdl_tpu_torch.optim import SGD, LocalOptimizer, Trigger

    model, x, y, batch = parity_config("bilstm", device="cuda")
    opt = LocalOptimizer(model, DataSet.array(x, y, batch_size=batch), ClassNLLCriterion())
    opt.set_optim_method(SGD(learningrate=0.01, momentum=0.9))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        opt.set_end_when(Trigger.max_iteration(n)).optimize()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = sum(ev.count for ev in prof.key_averages()
                  if ev.device_type == torch.autograd.DeviceType.CUDA
                  and ev.self_device_time_total > 0)
    print(f"  the BiLSTM step launches {kernels / n:.0f} CUDA kernels an iteration (profiled, "
          f"{wall * 1e3 / n:.1f} ms an iteration under the profiler)", flush=True)
    del opt, model
    torch.cuda.empty_cache()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_host_step_spread.py: needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as smoke
    from bigdl_tpu_torch.ops import _build

    card = smoke.nvidia_smi()
    _build.load()  # as chip_smoke.py [2]: the library's first load launches its probe
    print(f"card: {card}; host: {_host()}", flush=True)
    host_costs()
    steps: dict = {}

    def run(label, before=None, during=contextlib.nullcontext):
        if before:
            before()
        with during():
            _, ms, cpu = smoke._train_parity_config("bilstm", card)
        steps.setdefault(label, []).append((ms, *cpu))

    def route_check():
        smoke._parity_config_routes("inception")

    def route_check_idle():
        route_check()
        time.sleep(10)

    def route_check_one_thread():
        with _threads(1):
            route_check()

    conditions = [("nothing right before", None, contextlib.nullcontext),
                  ("after the Inception-v1 route check", route_check, contextlib.nullcontext),
                  ("after the route check and 10 s idle", route_check_idle,
                   contextlib.nullcontext),
                  ("after the route check on 1 intra-op thread", route_check_one_thread,
                   contextlib.nullcontext),
                  ("after the route check, gc off", route_check, _gc_off),
                  ("1 intra-op thread", None, lambda: _threads(1))]
    for _ in range(RUNS):
        for label, before, during in conditions:
            run(label, before, during)
    _profiled_iterations(3)
    for _ in range(RUNS):
        run("after the profiler")
    print(f"host: {_host()}; card {card}")
    for label, got in steps.items():
        print(f"=> {label}: steps " + ", ".join(f"{g[0]:.2f}" for g in got) + " ms (median "
              f"{statistics.median(g[0] for g in got):.2f}); CPU time over the wall: the main "
              "thread " + ", ".join(f"{100 * g[1]:.1f}" for g in got) + "%, the process "
              + ", ".join(f"{100 * g[2]:.1f}" for g in got) + "%")
    return 0


if __name__ == "__main__":
    sys.exit(main())
