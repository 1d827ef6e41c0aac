"""Sum of the device time of one profiled training iteration, two ways.

    python3 tools/torch_profiler_sum_check.py     # on the card, from the repo root

Profiles one forward and backward of ``chip_smoke.py``'s [16a] GRU
classifier (T 200, batch 128, bf16) and of its [16b] ConvLSTM predictor
(16 x 10 x 64x64) under ``torch.profiler`` and prints the device time
summed over the profiler's raw events (what ``chip_smoke._busy_share``
reads) beside ``key_averages()``'s ``self_device_time_total`` sum, with
the host seconds each takes.
"""

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import chip_smoke as cs  # noqa: E402
from bigdl_tpu_torch import Engine  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_profiler_sum_check.py: no CUDA device", file=sys.stderr)
        return 2
    Engine.set_compute_dtype("bfloat16")
    Engine.set_activation_dtype("bfloat16")
    cases = [("GRU classifier", lambda: cs.cell_classifier("GRU", None),
              torch.from_numpy(np.random.default_rng(0).integers(1, 20000, (128, 200))).cuda()),
             ("ConvLSTM", lambda: cs.convlstm_predictor(None),
              torch.rand(16, 10, 1, 64, 64, device="cuda"))]
    print(cs.nvidia_smi())
    for name, build, x in cases:
        m = build()
        m.init(sample_input=x)

        def iteration():
            y, _ = m.apply(m.get_parameters(), m.get_state(), x, training=True)
            y.float().sum().backward()

        iteration()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            iteration()
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        raw = sum(e.duration_ns() for e in prof.profiler.kineto_results.events()
                  if e.device_type() == torch.autograd.DeviceType.CUDA) / 1e6
        t1 = time.perf_counter()
        ka = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
        t2 = time.perf_counter()
        print(f"{name}: raw {raw:.3f} ms ({t1 - t0:.2f} s), key_averages {ka:.3f} ms "
              f"({t2 - t1:.2f} s)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
