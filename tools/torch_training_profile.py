#!/usr/bin/env python3
"""Where the time goes in one training step of the port, on one CUDA card.

    python3 tools/torch_training_profile.py [lm] [flagship] [vgg16] [normlm] [lenet] [vgg]
        [inception] [bilstm] [widedeep]   # one CUDA card

Training steps through ``LocalOptimizer`` (every mode when none is
named): ``lm``, the full-width Transformer-LM of ``chip_smoke.py`` (vocab
8192, hidden 512, 8 heads, filter 2048, 6 layers, T=2048, dropout 0, bf16
compute, random weights from a seed; SGD lr 0.1, ``CrossEntropyCriterion``,
batch 8); ``flagship``, ResNet-50 (``stem="s2d"``, 1000 classes, batch 128
of 224x224 images drawn as ``flagship_model`` draws them, bf16 compute and
bf16 activations, ``ClassNLLCriterion`` on the raw logits, SGD lr 0.1
momentum 0.9); ``vgg16``, the VGG-16 of ``chip_smoke.py`` [8] (conv/fc ReLUs
declared as epilogues, the fused-kernel switch on, dropout on, batch 64,
bf16 compute and activations, ``ClassNLLCriterion`` on the ``LogSoftMax``
output, SGD lr 0.01 momentum 0.9); ``normlm``, the norm-LM of
``chip_smoke.py`` [9] in both variants (LayerNormalization, then RMSNorm;
V 8192, H 512, 6 stages, batch 8 of 2048 planted-bigram tokens, the
fused-kernel switch on, bf16 compute and activations, ``Adam(3e-3)``,
``TimeDistributedCriterion(CrossEntropyCriterion(), size_average=True)``);
``lenet``, ``vgg``, ``inception``, ``bilstm``, ``widedeep``, BASELINE's
parity configs of ``chip_smoke.py`` [11] (``models.parity_config`` at the
bench's batch: 512; 128 of 32x32 (VGG-for-CIFAR-10) and 128 of 224x224,
dropout on; 128 of T 200; 2048 records of the synthetic click log; bf16
compute and activations, ``ClassNLLCriterion``, SGD lr 0.01 momentum 0.9,
the one batch every iteration).

Each: 3 warm-up iterations, 5 timed ones, then 5 under ``torch.profiler``.
Prints two step times and the rate of the first: the median gap between
the optimizer's one-step-late loss pulls (the first of a run left out; an
epoch's set-up lands in one gap, which the median leaves out) and the
timed run's wall over its iterations (set-up included). Then the device
time per step by kernel family (and the optimizer update's, from a
``record_function`` range around it) and the device's busy share of the
profiled run's wall, with the card's name and power limit.
"""

from __future__ import annotations

import statistics
import subprocess
import sys
import time
from pathlib import Path

sys.modules["jax"] = None
sys.modules["bigdl_tpu"] = None
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def lm_family(name: str) -> str:
    n = name.lower()
    for kernel in ("flash_bwd_dq", "flash_bwd_dkv", "flash_fwd"):
        if kernel in n:
            return f"{kernel} (this repo's kernel)"
    if "gemm" in n or "sm90_xmma" in n or "cutlass" in n or "nvjet" in n:
        return "matmul (cuBLAS)"
    if "softmax" in n or "reduce" in n or "norm" in n:
        return "reductions (softmax, norms, sums)"
    return "elementwise / copies / other"


def flagship_family(name: str) -> str:
    n = name.lower()
    if "maxpool2d_bwd" in n:
        return "maxpool2d_bwd (this repo's kernel)"
    if "nchwtonhwc" in n or "nhwctonchw" in n:
        return "layout transforms (cuDNN, NCHW <-> NHWC)"
    if "dgrad" in n or "wgrad" in n or ("conv" in n and "backward" in n):
        return "convolution backward (cuDNN)"
    if any(k in n for k in ("fprop", "conv", "xmma", "implicit", "gemm", "nvjet", "cutlass")):
        return "convolution forward, fc matmuls (cuDNN, cuBLAS)"
    if "max_pool" in n or "maxpool" in n or "avg_pool" in n or "avgpool" in n:
        return "pooling forward and average-pool backward (ATen)"
    if "reduce" in n or "welford" in n or "var_mean" in n or "norm" in n:
        return "reductions (BN statistics and their backward)"
    if "copy" in n or "memcpy" in n or "cat" in n:
        return "copies and casts"
    return "elementwise (BN apply, ReLU, add, SGD update, ...)"


def vgg_family(name: str) -> str:
    if "bias_act" in name.lower():
        return "bias_act fwd/bwd (this repo's kernels)"
    f = flagship_family(name)
    if f.startswith("elementwise"):
        return "elementwise (dropout, SGD update, weight casts, ...)"
    if f.startswith("reductions"):
        return "reductions (log-softmax, loss, bias sums)"
    return f


def normlm_family(name: str) -> str:
    n = name.lower()
    if "layer_norm_" in n or "rms_norm_" in n or "column_fold" in n:
        return "norm fwd/bwd + dw/db fold (this repo's kernels)"
    if "gemm" in n or "sm90_xmma" in n or "cutlass" in n or "nvjet" in n:
        return "matmul (cuBLAS)"
    if "softmax" in n or "reduce" in n or "nll" in n:
        return "reductions (log-softmax, loss, bias sums)"
    if "embedding" in n or "index" in n or "scatter" in n or "gather" in n:
        return "embedding gather and its backward"
    if "copy" in n or "memcpy" in n or "cat" in n:
        return "copies and casts"
    return "elementwise (Adam update, ReLU, adds, ...)"


def image_family(name: str) -> str:
    """LeNet-5's and Inception-v1's kernels (no BN: their reductions are the
    head's; the LRN's window sums are ``avg_pool3d``)."""
    f = flagship_family(name)
    if f.startswith("pooling"):
        return "pooling forward, LRN window sums (avg_pool3d) and their backward (ATen)"
    if f.startswith("reductions"):
        return "reductions (log-softmax, loss, bias sums)"
    if f.startswith("elementwise"):
        return "elementwise (ReLU/tanh, LRN arithmetic, dropout, SGD update, ...)"
    return f


def rnn_family(name: str) -> str:
    n = name.lower()
    if "gemm" in n or "sm90_xmma" in n or "cutlass" in n or "nvjet" in n:
        return "matmul (cuBLAS)"
    if "embedding" in n or "index" in n or "scatter" in n or "gather" in n:
        return "embedding gather and its backward"
    if "softmax" in n or "reduce" in n or "nll" in n:
        return "reductions (log-softmax, loss, bias sums)"
    if "copy" in n or "memcpy" in n or "cat" in n or "flip" in n or "stack" in n:
        return "copies, casts, flips, stacks"
    return "elementwise (gates: sigmoid, tanh, products, sums; SGD update)"


def wide_family(name: str) -> str:
    """Wide&Deep's kernels: the sparse product's and the embeddings' gathers
    and scatter-adds, a small MLP."""
    n = name.lower()
    if "index" in n or "scatter" in n or "gather" in n or "embedding" in n:
        return "gathers and scatter-adds (index_select, index_add_, embeddings)"
    if "gemm" in n or "sm90_xmma" in n or "cutlass" in n or "nvjet" in n:
        return "matmul (cuBLAS)"
    if "softmax" in n or "reduce" in n or "nll" in n:
        return "reductions (log-softmax, loss, bias sums)"
    if "copy" in n or "memcpy" in n or "cat" in n:
        return "copies, casts, concatenation (the batch's copy to the card included)"
    return "elementwise (ReLU, products, SGD update, ...)"


PARITY_FAMILY = {"bilstm": rnn_family, "vgg": flagship_family, "widedeep": wide_family}


def _profile(opt, reps: int, family):
    """Device ms per step by family over ``reps`` iterations, and the
    optimizer update's own device ms per step (a ``record_function`` range)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    method = opt.optim_method
    update = method.update

    def traced_update(*a, **k):
        with record_function("optimizer_update"):
            return update(*a, **k)

    method.update = traced_update
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            opt.optimize()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        del method.update
    # the profiler slows the host: the busy share is taken against the
    # profiled run's own wall per iteration
    prof_step_ms = wall * 1e3 / reps
    by_family: dict = {}
    update_ms = 0.0
    for ev in prof.key_averages():
        if ev.key == "optimizer_update":
            # the range appears twice: as a host op (its device_time_total sums
            # the kernels it launched) and as a device-side annotation spanning
            # them, which is no kernel and must not be counted in a family
            if ev.device_type == torch.autograd.DeviceType.CPU:
                update_ms = ev.device_time_total / 1e3 / reps
            continue
        dev_us = ev.self_device_time_total
        if dev_us > 0 and ev.device_type == torch.autograd.DeviceType.CUDA:
            f = family(ev.key)
            by_family[f] = by_family.get(f, 0.0) + dev_us / 1e3 / reps
    return by_family, update_ms, prof_step_ms


def _report(label, steps, rate, profiled, card):
    by_family, update_ms, prof_step_ms = profiled
    busy = sum(by_family.values())
    print(f"card: {card}")
    print(f"{label}: step {steps[0]:.3f} ms (median gap), {rate}; {steps[1]:.3f} ms per "
          f"iteration over the timed run; under the profiler {prof_step_ms:.3f} ms per "
          f"iteration, the device busy {busy:.3f} ms of it ({100 * busy / prof_step_ms:.1f}%)")
    for f, ms in sorted(by_family.items(), key=lambda kv: -kv[1]):
        print(f"  {f:55s} {ms:8.3f} ms  {100 * ms / busy:5.1f}%")
    print(f"  of which the optimizer update (device time under its range) {update_ms:8.3f} ms")


def _timed(opt, warmup: int, reps: int):
    """(median gap between loss pulls, wall per iteration of the run) in ms."""
    import torch

    from bigdl_tpu_torch.optim import Trigger

    opt.set_end_when(Trigger.max_iteration(warmup)).optimize()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    opt.set_end_when(Trigger.max_iteration(warmup + reps)).optimize()
    torch.cuda.synchronize()
    per_iter = (time.perf_counter() - t0) * 1e3 / reps
    # the first pull of a run also waits for its first dispatch: steady steps only
    step_ms = statistics.median(h["wall_s"] for h in opt.history[warmup + 1:]) * 1e3
    opt.set_end_when(Trigger.max_iteration(warmup + 2 * reps))
    return step_ms, per_iter


def profile_lm(card: str, warmup: int = 3, reps: int = 5) -> None:
    import numpy as np

    from bigdl_tpu_torch import Engine, RandomGenerator
    from bigdl_tpu_torch.dataset import DataSet
    from bigdl_tpu_torch.nn import CrossEntropyCriterion, Transformer
    from bigdl_tpu_torch.optim import SGD, LocalOptimizer

    vocab, batch, seq = 8192, 8, 2048
    Engine.set_compute_dtype("bfloat16")
    Engine.set_activation_dtype(None)
    RandomGenerator.set_seed(0)
    gen = np.random.default_rng(0)
    ids = gen.integers(0, vocab, (40, seq))
    targets = gen.integers(0, vocab, (40, seq))
    model = Transformer(vocab, 512, 8, 2048, 6, 0.0, 0.0, 0.0, device="cuda")
    opt = LocalOptimizer(model, DataSet.array(ids, targets, batch_size=batch),
                         CrossEntropyCriterion()).set_optim_method(SGD(learningrate=0.1))
    steps = _timed(opt, warmup, reps)
    _report("LM training step (8 x 2048 tokens)", steps,
            f"{batch * seq / steps[0] * 1e3:.0f} tokens/s", _profile(opt, reps, lm_family), card)


def profile_flagship(card: str, warmup: int = 3, reps: int = 5) -> None:
    from bigdl_tpu_torch import Engine, RandomGenerator
    from bigdl_tpu_torch.dataset import DataSet
    from bigdl_tpu_torch.models import flagship_model
    from bigdl_tpu_torch.nn import ClassNLLCriterion
    from bigdl_tpu_torch.optim import SGD, LocalOptimizer

    batch = 128
    Engine.set_compute_dtype("bfloat16")
    Engine.set_activation_dtype("bfloat16")
    RandomGenerator.set_seed(1)
    model, images, labels, _ = flagship_model(batch=3 * batch, seed=0, stem="s2d",
                                              device="cuda")
    opt = LocalOptimizer(model, DataSet.array(images, labels, batch_size=batch),
                         ClassNLLCriterion()).set_optim_method(
        SGD(learningrate=0.1, momentum=0.9))
    steps = _timed(opt, warmup, reps)
    _report(f"flagship ResNet-50 training step (batch {batch}, bf16)", steps,
            f"{batch / steps[0] * 1e3:.1f} images/s", _profile(opt, reps, flagship_family), card)


def profile_vgg(card: str, warmup: int = 3, reps: int = 5) -> None:
    import numpy as np

    from bigdl_tpu_torch import Engine, RandomGenerator
    from bigdl_tpu_torch.dataset import DataSet
    from bigdl_tpu_torch.nn import ClassNLLCriterion
    from bigdl_tpu_torch.optim import SGD, LocalOptimizer
    from chip_smoke import vgg16_declared

    batch = 64
    Engine.set_compute_dtype("bfloat16")
    Engine.set_activation_dtype("bfloat16")
    Engine.set_fused_kernels(True)
    RandomGenerator.set_seed(0)
    images = np.random.default_rng(0).standard_normal((3 * batch, 3, 224, 224)).astype(
        np.float32)
    labels = np.random.default_rng(1).integers(0, 1000, 3 * batch)
    model = vgg16_declared(has_dropout=True, device="cuda")
    opt = LocalOptimizer(model, DataSet.array(images, labels, batch_size=batch),
                         ClassNLLCriterion()).set_optim_method(
        SGD(learningrate=0.01, momentum=0.9))
    steps = _timed(opt, warmup, reps)
    _report(f"VGG-16 training step (batch {batch}, bf16, fused epilogues)", steps,
            f"{batch / steps[0] * 1e3:.1f} images/s", _profile(opt, reps, vgg_family), card)


def profile_normlm(card: str, warmup: int = 3, reps: int = 5) -> None:
    from bigdl_tpu_torch import Engine, RandomGenerator
    from bigdl_tpu_torch.dataset import DataSet
    from bigdl_tpu_torch.nn import CrossEntropyCriterion, TimeDistributedCriterion
    from bigdl_tpu_torch.optim import Adam, LocalOptimizer
    from chip_smoke import NORM_LM, norm_lm, planted_bigram_ids

    c = NORM_LM
    seq, batch = c["seq"], c["batch"]
    Engine.set_compute_dtype("bfloat16")
    Engine.set_activation_dtype("bfloat16")
    Engine.set_fused_kernels(True)
    ids = planted_bigram_ids(c["n_seq"] * seq + 1, c["vocab"])
    x, y = ids[:-1].reshape(c["n_seq"], seq), ids[1:].reshape(c["n_seq"], seq)
    for variant in ("ln", "rms"):
        RandomGenerator.set_seed(0)
        model = norm_lm(variant, c["vocab"], c["hidden"], c["stages"], device="cuda")
        opt = LocalOptimizer(model, DataSet.array(x, y, batch_size=batch),
                             TimeDistributedCriterion(CrossEntropyCriterion(),
                                                      size_average=True)).set_optim_method(
            Adam(learningrate=3e-3))
        steps = _timed(opt, warmup, reps)
        _report(f"norm-LM/{variant.upper()} training step ({batch} x {seq} tokens, bf16, "
                f"fused norms)", steps, f"{batch * seq / steps[0] * 1e3:.0f} tokens/s",
                _profile(opt, reps, normlm_family), card)
        del opt, model


def profile_parity(name: str, card: str, warmup: int = 3, reps: int = 5) -> None:
    from bigdl_tpu_torch import Engine, RandomGenerator
    from bigdl_tpu_torch.dataset import DataSet
    from bigdl_tpu_torch.models import parity_config
    from bigdl_tpu_torch.nn import ClassNLLCriterion
    from bigdl_tpu_torch.optim import SGD, LocalOptimizer

    Engine.set_compute_dtype("bfloat16")
    Engine.set_activation_dtype("bfloat16")
    Engine.set_fused_kernels(False)
    RandomGenerator.set_seed(1)
    model, x, y, batch = parity_config(name, device="cuda")
    opt = LocalOptimizer(model, DataSet.array(x, y, batch_size=batch),
                         ClassNLLCriterion()).set_optim_method(
        SGD(learningrate=0.01, momentum=0.9))
    steps = _timed(opt, warmup, reps)
    _report(f"{name} training step (batch {batch}, bf16)", steps,
            f"{batch / steps[0] * 1e3:.1f} records/s",
            _profile(opt, reps, PARITY_FAMILY.get(name, image_family)), card)
    del opt, model


MODES = {"lm": profile_lm, "flagship": profile_flagship, "vgg16": profile_vgg,
         "normlm": profile_normlm,
         **{name: (lambda card, name=name: profile_parity(name, card))
            for name in ("lenet", "vgg", "inception", "bilstm", "widedeep")}}


def main() -> int:
    import torch

    modes = sys.argv[1:] or list(MODES)
    if any(m not in MODES for m in modes):
        print(f"torch_training_profile.py: modes are {sorted(MODES)}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("torch_training_profile.py: needs a CUDA card", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True, capture_output=True,
                          text=True, timeout=60).stdout.strip().splitlines()[0]
    for mode in modes:
        MODES[mode](card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
