#!/usr/bin/env python3
"""Where the time goes in the port's served requests.

    python3 tools/torch_serving_profile.py [lm] [flagship]   # needs one CUDA card

``lm`` (the default): the full-width Transformer-LM of ``chip_smoke.py`` [5]
(vocab 8192, hidden 512, 8 heads, filter 2048, 6 layers, T=2048, bf16
compute, random weights from a seed): ``Predictor.forward_batch`` on a batch
of 8 records under ``torch.profiler``, the device time by kernel family (the
flash kernel, matmuls, the rest), the device's busy share of the forward's
wall time, and the time to copy one request's (T, vocab) f32 logits to the
host.

``flagship``: the flagship ResNet-50 of ``chip_smoke.py`` [12] (conv7 stem,
bf16 compute, batch 128, ``bench.py``'s serving configuration): the padded
forward of a mix-A flush (8 records padded to 128) and of a full batch (128
records) under ``torch.profiler``, each with its device time by family
(convolutions, BN and ReLU's elementwise work, pooling, the fc matmul,
copies), the card's busy share of the forward's wall and the host's
share (the records' stack and their copy to the card); then a short served
run at mix A (8 synchronous clients, 256 requests, ``max_delay_ms=5``) and
its requests' mean ``spans()``: queue wait, assembly, dispatch and the row's
copy to the host (which waits for the forward).
"""

from __future__ import annotations

import sys
import threading
import time
from pathlib import Path

sys.modules["jax"] = None
sys.modules["bigdl_tpu"] = None
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def lm_family(name: str) -> str:
    n = name.lower()
    if "flash_fwd" in n:
        return "flash_attention_fwd (this repo's kernel)"
    if "gemm" in n or "sm90_xmma" in n or "cutlass" in n or "nvjet" in n:
        return "matmul (cuBLAS)"
    if "softmax" in n or "reduce" in n or "norm" in n:
        return "reductions"
    return "elementwise / copies / other"


def image_family(name: str) -> str:
    n = name.lower()
    if "memcpy" in n or "memset" in n or "copy" in n or "cat" in n:
        return "copies / casts / pad"
    if "pool" in n:
        return "pooling"
    if "conv" in n or "implicit" in n or "dgrad" in n or "xmma" in n or "cudnn" in n:
        return "convolution (cuDNN)"
    if "gemm" in n or "cutlass" in n or "nvjet" in n:
        return "matmul (cuBLAS)"
    if "nchw" in n or "nhwc" in n or "transpose" in n:
        return "layout transforms"
    if "reduce" in n:
        return "reductions"
    return "elementwise (BN apply, ReLU, residual add)"


def device_by_family(prof, reps: int, family) -> dict:
    import torch

    out: dict = {}
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = ev.self_cuda_time_total
        if dev_us > 0 and ev.device_type == torch.autograd.DeviceType.CUDA:
            f = family(ev.key)
            out[f] = out.get(f, 0.0) + dev_us / 1e3 / reps
    return out


def profile_lm(card: str) -> None:
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from bigdl_tpu_torch import Engine, RandomGenerator
    from bigdl_tpu_torch.nn import Transformer
    from bigdl_tpu_torch.optim import Predictor

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
    by_family = device_by_family(prof, reps, lm_family)
    busy = sum(by_family.values())

    row = y[0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        row.cpu()
    copy_ms = (time.perf_counter() - t0) / reps * 1e3

    print(f"== lm; card: {card}")
    print(f"forward_batch (8 x 2048 tokens): wall {wall_ms:.3f} ms, device busy "
          f"{busy:.3f} ms ({100 * busy / wall_ms:.1f}% of wall)")
    for f, ms in sorted(by_family.items(), key=lambda kv: -kv[1]):
        print(f"  {f:45s} {ms:8.3f} ms  {100 * ms / busy:5.1f}%")
    print(f"one request's logits to host ({tuple(row.shape)} f32, "
          f"{row.numel() * 4 / 1e6:.1f} MB): {copy_ms:.3f} ms")


def profile_flagship(card: str) -> None:
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from bigdl_tpu_torch import Engine, RandomGenerator
    from bigdl_tpu_torch.models import flagship_model
    from bigdl_tpu_torch.optim import Predictor
    from bigdl_tpu_torch.serving import ModelServer

    Engine.set_compute_dtype("bfloat16")
    Engine.set_activation_dtype(None)
    RandomGenerator.set_seed(1)
    model, x, _, _ = flagship_model(batch=128, seed=0, stem="conv7", device="cuda")
    model.init(sample_input=x)
    model.eval()
    pred = Predictor(model, batch_size=128)
    print(f"== flagship (ResNet-50 conv7, bf16 compute, batch 128); card: {card}")
    reps = 10
    for n in (8, 128):
        recs = [x[i] for i in range(n)]
        for _ in range(3):
            pred.forward_batch(np.stack(recs))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            y = pred.forward_batch(np.stack(recs))  # the flush's host stack included
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) / reps * 1e3
        t0 = time.perf_counter()
        for _ in range(reps):
            np.stack(recs)
        stack_ms = (time.perf_counter() - t0) / reps * 1e3
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                y = pred.forward_batch(np.stack(recs))
            torch.cuda.synchronize()
        by_family = device_by_family(prof, reps, image_family)
        busy = sum(by_family.values())
        print(f"forward_batch of {n} records padded to 128: wall {wall_ms:.3f} ms (host stack "
              f"of the records {stack_ms:.3f} ms), device busy {busy:.3f} ms "
              f"({100 * busy / wall_ms:.1f}% of wall)")
        for f, ms in sorted(by_family.items(), key=lambda kv: -kv[1]):
            print(f"  {f:45s} {ms:8.3f} ms  {100 * ms / busy:5.1f}%")
    row = y[0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        row.cpu()
    print(f"one request's row to host ({tuple(row.shape)} {row.dtype}, idle card): "
          f"{(time.perf_counter() - t0) / reps * 1e3:.3f} ms")

    clients, per = 8, 32
    futs, lock = [], threading.Lock()
    with ModelServer() as server:
        server.register("flagship", model, sample_input=x[0], batch_size=128, max_delay_ms=5)

        def client(k):
            gen = np.random.default_rng(k)
            for _ in range(per):
                f = server.infer("flagship", x[int(gen.integers(len(x)))])
                f.result(timeout=300)
                with lock:
                    futs.append(f)

        threads = [threading.Thread(target=client, args=(k,)) for k in range(clients)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        wall = time.perf_counter() - t0
        flushes = server.models()["flagship"]["flushes"]
    spans = [f.spans() for f in futs]
    mean = {k: 1e3 * float(np.mean([s[k] for s in spans])) for k in spans[0]}
    print(f"served, mix A ({clients} synchronous clients x {per}): {len(futs) / wall:.2f} "
          f"requests/s, {flushes} flushes ({len(futs) / flushes:.2f} records a flush); mean "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in mean.items()))


def main() -> int:
    import subprocess

    import torch

    if not torch.cuda.is_available():
        print("torch_serving_profile.py: needs a CUDA card", file=sys.stderr)
        return 2
    modes = sys.argv[1:] or ["lm"]
    unknown = set(modes) - {"lm", "flagship"}
    if unknown:
        print(f"torch_serving_profile.py: unknown mode(s) {sorted(unknown)}", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()
    for mode in modes:
        (profile_lm if mode == "lm" else profile_flagship)(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
