#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``bigdl_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py          # from the root of a checkout; needs one CUDA card

Phases, in order; any failure raises and the script exits non-zero:

1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
2. build the port's CUDA kernels from ``bigdl_tpu_torch/csrc`` (timed) and
   launch each once;
3. each kernel against its plain PyTorch version on the card, over the
   serving/training shape and the masking/shape edge cases, with stated
   tolerances: the forward [3] and the backward kernels dQ and dK/dV [3b]
   (whose repeated run must give the same bits);
4. kernel, plain-version and library times beside the card's bound;
5. serving: the full-width Transformer-LM (vocab 8192, hidden 512, 8
   heads, filter 2048, 6 layers, T=2048, random weights from a seed) served
   through ``ModelServer`` — 16 single-record requests from 4 threads, each
   answer checked against a direct forward on the card and one against an
   fp32 CPU forward, and the flash kernel's launches counted;
6. training: the same LM trained through ``LocalOptimizer`` (SGD, lr 0.1,
   ``CrossEntropyCriterion``, batch 8 of 40 records, 10 iterations across
   an epoch boundary) with finite losses and 6 launches per iteration of
   each flash kernel, then 3 steps on the flash route held against 3 steps
   on the dense route from the same weights.

Each of the two main paths (serving, training) runs with the kernels'
launch counts set to 0 just before it and read just after.

The last lines are the ``{"kernels": [...]}`` record, the card's name and
power limit, and ``{"ok": true, "device": {...}}``. Neither JAX nor the JAX
package is imported (both are blocked below).
"""

from __future__ import annotations

import json
import subprocess
import sys
import threading
import time
from pathlib import Path

sys.modules["jax"] = None  # the port must run without JAX: any import fails
sys.modules["bigdl_tpu"] = None

ROOT = Path(__file__).resolve().parent
SEED = 0

# Card peaks for bound_ms (NVIDIA data sheets, dense): (bf16 FLOP/s, fp32
# non-tensor-core FLOP/s, memory bytes/s). SXM is the default part.
PEAKS = {
    "sxm": (989e12, 67e12, 3.35e12),
    "pcie": (756e12, 51e12, 2.0e12),
}

# Tolerances of the kernel against its plain version (|err| <= atol + rtol*|ref|):
# bf16 out: the output is rounded to bf16 (2^-8 relative steps) and P is
#   rounded to bf16 before P·V (as in the TPU kernel), so one bf16 step of
#   the largest values is allowed;
# f32 out: fp32 sums over <= 2048 keys taken in another order;
# lse: fp32 in both, summation order and exp2/log2 rounding only.
TOL = {
    "bf16_out": (1e-2, 1e-2),
    "f32_out": (2e-5, 2e-5),
    "lse": (1e-3, 1e-5),
}

# Tolerances of the backward kernels against their plain version (dq, dk, dv):
# bf16: both round P and dS to bf16 before the second products (as the TPU
#   kernels do) but from fp32 values summed in another order, so a rare entry
#   rounds one bf16 step apart, and each gradient is rounded to bf16 once
#   (2^-8 relative steps): two bf16 steps of the largest values are allowed;
# f32: fp32 sums over <= 2048 keys or rows taken in another order, through
#   the cancellation dP - delta.
TOL_BWD = {
    "bf16": (2e-2, 2e-2),
    "f32": (1e-4, 1e-4),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]


def peaks(name: str):
    return PEAKS["pcie" if "PCIe" in name else "sxm"]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(flops: float, tensors, card: str):
    """Least time for one call: max(bytes / memory rate, FLOPs / peak rate for
    the operands' type), each of ``tensors`` (the inputs and outputs) moved
    once."""
    import torch

    bf16_peak, f32_peak, mem = peaks(card)
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    peak = bf16_peak if tensors[0].dtype == torch.bfloat16 else f32_peak
    t_ops, t_bytes = flops / peak, nbytes / mem
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def attention_bound_ms(q, k, v, out, lse, vis_pairs: int, card: str):
    """Forward: QK^T and P·V (2 FLOP per MAC) over the (query, key) pairs
    these inputs make visible."""
    return bound_ms(4 * q.shape[-1] * vis_pairs, (q, k, v, out, lse), card)


# ------------------------------------------------------------------ phases
def phase_card():
    import torch

    card = nvidia_smi()
    cap = torch.cuda.get_device_capability(0)
    log(f"[1] card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"capability sm_{cap[0]}{cap[1]}, kernels built for sm_90a")
    if cap != (9, 0):
        raise RuntimeError(f"the kernels are built for sm_90a; this card is sm_{cap[0]}{cap[1]}")
    return card


def phase_build():
    import torch
    from bigdl_tpu_torch.ops import _build
    from bigdl_tpu_torch.ops.flash_attention import flash_attention_bwd, flash_attention_fwd

    t0 = time.perf_counter()
    lib = _build.build(force=True)
    _build.load()
    log(f"[2] built {lib.relative_to(ROOT)} in {time.perf_counter() - t0:.1f} s")
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log("    ptxas: " + line.strip())
    g = torch.Generator(device="cuda").manual_seed(SEED)
    for dt in (torch.bfloat16, torch.float32):
        q = torch.randn((1, 1, 64, 64), generator=g, device="cuda").to(dt)
        out, lse = flash_attention_fwd(q, q, q, causal=True)
        flash_attention_bwd(q, q, q, out, lse, q, causal=True)
    torch.cuda.synchronize()
    log("    flash_attention_fwd and flash_attention_bwd (dQ, dK/dV) launched once "
        "in bf16 and f32")


def _rand(shape, dtype, g):
    import torch

    return torch.randn(shape, generator=g, device="cuda").to(dtype)


def _visible_pairs(n, h, tq, tk, causal, lengths, mask_q):
    from bigdl_tpu_torch.ops.flash_attention import visible_mask

    return int(visible_mask(n, tq, tk, causal, lengths, mask_q, "cuda").sum()) * (
        h if lengths is not None else n * h)


def phase_parity():
    """Kernel vs plain version on the card; returns the serving-shape record."""
    import torch
    from bigdl_tpu_torch.ops.flash_attention import (
        flash_attention_fwd, flash_attention_fwd_reference)

    torch.backends.cuda.matmul.allow_tf32 = False  # fp32 reference stays fp32
    torch.backends.cudnn.allow_tf32 = False
    bf, f32 = torch.bfloat16, torch.float32
    # (label, N, H, Tq, Tk, d, dtype, causal, lengths, mask_q)
    cases = [
        ("serving shape", 8, 8, 2048, 2048, 64, bf, True, None, None),
        ("serving shape f32", 8, 8, 2048, 2048, 64, f32, True, None, None),
        ("ragged lengths + mask_q", 4, 2, 1000, 1000, 64, bf, True, [1000, 517, 1, 0], True),
        ("ragged lengths, no causal", 4, 2, 777, 777, 128, f32, False, [700, 33, 0, 777], True),
        ("rectangular Tq<Tk causal", 2, 4, 300, 1100, 64, bf, True, None, None),
        ("rectangular Tq<Tk, key lengths", 2, 4, 300, 1100, 64, f32, False, [1100, 90], False),
        ("Tq>Tk causal (rows with no key)", 2, 2, 200, 130, 64, bf, True, None, None),
        ("odd T=1000 causal", 2, 4, 1000, 1000, 64, bf, True, None, None),
        ("odd T=2047 causal", 1, 8, 2047, 2047, 64, bf, True, None, None),
        ("odd T=2047 non-causal", 1, 4, 2047, 2047, 64, bf, False, None, None),
        ("d=128 causal", 2, 4, 1024, 1024, 128, bf, True, None, None),
        ("d=128 f32 causal", 2, 4, 1024, 1024, 128, f32, True, [1024, 300], True),
    ]
    g = torch.Generator(device="cuda").manual_seed(SEED)
    log("[3] kernel vs plain version on the card "
        f"(|err| <= atol + rtol*|ref|; {TOL})")
    record = None
    for label, n, h, tq, tk, d, dt, causal, lens, mask_q in cases:
        q, k, v = _rand((n, h, tq, d), dt, g), _rand((n, h, tk, d), dt, g), _rand((n, h, tk, d), dt, g)
        lengths = None if lens is None else torch.tensor(lens, dtype=torch.int32, device="cuda")
        out, lse = flash_attention_fwd(q, k, v, causal, lengths=lengths, mask_q=mask_q)
        torch.cuda.synchronize()
        ref_out, ref_lse = flash_attention_fwd_reference(q, k, v, causal, lengths=lengths,
                                                         mask_q=mask_q)
        atol, rtol = TOL["bf16_out" if dt == bf else "f32_out"]
        err_out = (out.float() - ref_out.float()).abs()
        ok_out = bool((err_out <= atol + rtol * ref_out.float().abs()).all())
        la, lr = TOL["lse"]
        err_lse = (lse - ref_lse).abs()
        ok_lse = bool((err_lse <= la + lr * ref_lse.abs()).all())
        finite = bool(torch.isfinite(out).all())
        log(f"    {label:34s} {str(dt)[6:]:8s} out max err {err_out.max().item():.3e}  "
            f"lse max err {err_lse.max().item():.3e}  "
            f"{'ok' if ok_out and ok_lse and finite else 'FAIL'}")
        if not (ok_out and ok_lse and finite):
            raise AssertionError(f"flash_attention_fwd disagrees with its plain version: {label}")
        if record is None:
            record = dict(q=q, k=k, v=v, out=out, lse=lse,
                          max_abs_err=err_out.max().item(),
                          pairs=_visible_pairs(n, h, tq, tk, causal, lengths, mask_q))
        del q, k, v, out, lse, ref_out, ref_lse, err_out, err_lse
    torch.cuda.empty_cache()
    return record


def phase_bwd_parity():
    """Backward kernels vs their plain version on the card; returns the
    training-shape record."""
    import torch
    from bigdl_tpu_torch.ops.flash_attention import (
        flash_attention_bwd, flash_attention_bwd_reference, flash_attention_fwd)

    bf, f32 = torch.bfloat16, torch.float32
    # (label, N, H, Tq, Tk, d, dtype, causal, lengths, mask_q)
    cases = [
        ("training shape", 8, 8, 2048, 2048, 64, bf, True, None, None),
        ("training shape f32", 8, 8, 2048, 2048, 64, f32, True, None, None),
        ("ragged lengths + mask_q", 4, 2, 1000, 1000, 64, bf, True, [1000, 517, 1, 0], True),
        ("ragged lengths, no causal", 4, 2, 777, 777, 128, f32, False, [700, 33, 0, 777], True),
        ("rectangular Tq<Tk causal", 2, 4, 300, 1100, 64, bf, True, None, None),
        ("rectangular Tq<Tk, key lengths", 2, 4, 300, 1100, 64, f32, False, [1100, 90], False),
        ("Tq>Tk causal (rows with no key)", 2, 2, 200, 130, 64, bf, True, None, None),
        ("Tq>Tk causal f32", 2, 2, 200, 130, 128, f32, True, None, None),
        ("odd T=1000 causal", 2, 4, 1000, 1000, 64, bf, True, None, None),
        ("odd T=2047 causal", 1, 8, 2047, 2047, 64, bf, True, None, None),
        ("odd T=2047 non-causal", 1, 4, 2047, 2047, 64, bf, False, None, None),
        ("d=128 causal", 2, 4, 1024, 1024, 128, bf, True, None, None),
        ("d=128 ragged + mask_q", 2, 4, 1024, 1024, 128, bf, True, [1024, 300], True),
        ("d=128 f32 causal", 2, 4, 1024, 1024, 128, f32, True, [1024, 300], True),
    ]
    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    log("[3b] backward kernels (dQ, dK/dV) vs plain version on the card "
        f"(|err| <= atol + rtol*|ref|; {TOL_BWD})")
    record = None
    for label, n, h, tq, tk, d, dt, causal, lens, mask_q in cases:
        q, k, v = _rand((n, h, tq, d), dt, g), _rand((n, h, tk, d), dt, g), _rand((n, h, tk, d), dt, g)
        d_out = _rand((n, h, tq, d), dt, g)
        lengths = None if lens is None else torch.tensor(lens, dtype=torch.int32, device="cuda")
        out, lse = flash_attention_fwd(q, k, v, causal, lengths=lengths, mask_q=mask_q)
        grads = flash_attention_bwd(q, k, v, out, lse, d_out, causal, lengths=lengths,
                                    mask_q=mask_q)
        torch.cuda.synchronize()
        refs = flash_attention_bwd_reference(q, k, v, out, lse, d_out, causal,
                                             lengths=lengths, mask_q=mask_q)
        atol, rtol = TOL_BWD["bf16" if dt == bf else "f32"]
        errs, ok = [], True
        for got, ref in zip(grads, refs):
            err = (got.float() - ref.float()).abs()
            ok &= bool((err <= atol + rtol * ref.float().abs()).all())
            ok &= bool(torch.isfinite(got).all())
            errs.append(err.max().item())
        log(f"    {label:34s} {str(dt)[6:]:8s} max err dq {errs[0]:.3e}  dk {errs[1]:.3e}  "
            f"dv {errs[2]:.3e}  {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"flash_attention_bwd disagrees with its plain version: {label}")
        if record is None:
            again = flash_attention_bwd(q, k, v, out, lse, d_out, causal)
            same = all(torch.equal(a, b) for a, b in zip(grads, again))
            log(f"    repeated training-shape backward bit-identical: {same}")
            if not same:
                raise AssertionError("two runs of the backward kernels gave different bits")
            record = dict(q=q, k=k, v=v, out=out, lse=lse, d_out=d_out,
                          err_dq=errs[0], err_dkv=max(errs[1:]),
                          pairs=_visible_pairs(n, h, tq, tk, causal, lengths, mask_q))
            del again
        del q, k, v, d_out, out, lse, grads, refs
    torch.cuda.empty_cache()
    return record


def phase_times(rec, card):
    import torch
    import torch.nn.functional as F
    from bigdl_tpu_torch.ops.flash_attention import (
        flash_attention_fwd, flash_attention_fwd_reference)

    q, k, v = rec["q"], rec["k"], rec["v"]
    ms = cuda_ms(lambda: flash_attention_fwd(q, k, v, True))
    plain_ms = cuda_ms(lambda: flash_attention_fwd_reference(q, k, v, True), iters=5)
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True))
    bound_ms, bound_by = attention_bound_ms(q, k, v, rec["out"], rec["lse"], rec["pairs"], card)
    kernel = {
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": "bigdl_tpu_torch/csrc/flash_attention.cu",
        "replaces": "bigdl_tpu/ops/flash_attention.py:50",
        "launches": None,  # filled from the main path's run
        "max_abs_err": rec["max_abs_err"],
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": library_ms,
    }
    log(f"[4] kernels: flash_attention_fwd (8,8,2048,64) bf16 causal: verdict ok, "
        f"kernel_ms {ms:.4f}, plain_ms {plain_ms:.4f}, bound_ms {bound_ms:.4f} "
        f"({bound_by}), library_ms {library_ms:.4f} "
        f"(torch scaled_dot_product_attention, yardstick only); card {card}")
    return kernel


def phase_bwd_times(rec, card):
    """Times of the dQ and dK/dV kernels at the training shape (each launched
    through its C entry point alone, so the wrapper's counts stay those of
    the main paths), the plain backward, and the library's backward."""
    import torch
    import torch.nn.functional as F
    from bigdl_tpu_torch.ops import _build
    from bigdl_tpu_torch.ops import flash_attention as fa

    q, k, v, out, lse, d_out = (rec[n] for n in ("q", "k", "v", "out", "lse", "d_out"))
    lib = _build.load()
    head, tail, keep = fa._bwd_kernel_args(q, k, v, out, lse, d_out, True, None, None, True)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)

    def run(rc):
        if rc != 0:
            raise RuntimeError(f"backward kernel launch failed with CUDA error {rc}")

    ms_dq = cuda_ms(lambda: run(lib.bigdl_flash_attention_bwd_dq(*head, dq.data_ptr(), *tail)))
    ms_dkv = cuda_ms(lambda: run(lib.bigdl_flash_attention_bwd_dkv(
        *head, dk.data_ptr(), dv.data_ptr(), *tail)))
    ms_wrapper = cuda_ms(lambda: fa.flash_attention_bwd(q, k, v, out, lse, d_out, True))
    plain_ms = cuda_ms(lambda: fa.flash_attention_bwd_reference(q, k, v, out, lse, d_out, True),
                       iters=3)
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    lib_out = F.scaled_dot_product_attention(*leaves, is_causal=True)
    library_ms = cuda_ms(lambda: torch.autograd.grad(lib_out, leaves, d_out, retain_graph=True))
    del keep, lib_out, leaves

    d, pairs = q.shape[-1], rec["pairs"]
    io = (q, k, v, d_out, lse, lse)  # lse and delta: (N, H, T) f32 each
    b_dq = bound_ms(6 * d * pairs, io + (dq,), card)  # S, dP, dS·K
    b_dkv = bound_ms(8 * d * pairs, io + (dk, dv), card)  # S^T, dP^T, P^T·dO, dS^T·Q
    b_least = bound_ms(10 * d * pairs, io + (dq, dk, dv), card)  # five products
    kernels = []
    for name, ms, (b, by), err, line in (
            ("flash_attention_bwd_dq", ms_dq, b_dq, rec["err_dq"], 263),
            ("flash_attention_bwd_dkv", ms_dkv, b_dkv, rec["err_dkv"], 315)):
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "bigdl_tpu_torch/csrc/flash_attention_bwd.cu",
            "replaces": f"bigdl_tpu/ops/flash_attention.py:{line}",
            "launches": None,  # filled from the main path's run
            "max_abs_err": err,
            "ms": ms,
            "plain_ms": plain_ms,  # the plain backward computes dq, dk and dv together
            "bound_ms": b,
            "bound_by": by,
            "library_ms": library_ms,  # backward of scaled_dot_product_attention: the pair
        })
        log(f"[4] kernels: {name} (8,8,2048,64) bf16 causal: verdict ok, kernel_ms {ms:.4f}, "
            f"plain_ms {plain_ms:.4f} (dq+dk+dv), bound_ms {b:.4f} ({by}), library_ms "
            f"{library_ms:.4f} (torch scaled_dot_product_attention backward, dq+dk+dv, "
            f"yardstick only); card {card}")
    log(f"    backward pair: kernels {ms_dq + ms_dkv:.4f} ms, wrapper with delta "
        f"{ms_wrapper:.4f} ms, least work (five products) bound {b_least[0]:.4f} ms "
        f"({b_least[1]}); card {card}")
    return kernels


def phase_slice(card):
    """Serve the full-width LM through ModelServer; returns flash launches."""
    import numpy as np
    import torch
    from bigdl_tpu_torch import Engine, RandomGenerator
    from bigdl_tpu_torch.nn import Transformer
    from bigdl_tpu_torch.ops import flash_attention as fa
    from bigdl_tpu_torch.serving import ModelServer
    from bigdl_tpu_torch.utils.convert import load_jax_params

    vocab, hidden, heads, filt, layers, T = 8192, 512, 8, 2048, 6, 2048
    n_req, n_threads = 16, 4
    Engine.set_compute_dtype("bfloat16")
    RandomGenerator.set_seed(SEED)
    records = np.random.RandomState(SEED).randint(1, vocab, size=(n_req, T)).astype(np.int64)
    model = Transformer(vocab, hidden, heads, filt, layers, 0.0, 0.0, 0.0,
                        mode="lm", device="cuda").eval()

    fa.launches = fa.launches_dq = fa.launches_dkv = 0  # the main path starts here
    results, lat = [None] * n_req, [None] * n_req
    with ModelServer() as server:
        t0 = time.perf_counter()
        server.register("lm", model, sample_input=records[0], batch_size=8, max_delay_ms=5)
        log(f"[5] registered + warmed the LM in {time.perf_counter() - t0:.2f} s "
            f"({sum(p.numel() for p in model.parameters()) / 1e6:.1f} M params)")

        def client(idx):
            futs = [(i, server.infer("lm", records[i])) for i in idx]
            for i, f in futs:
                results[i] = f.result(timeout=300)
                lat[i] = f.t_materialize - f.t_enqueue

        threads = [threading.Thread(target=client, args=(range(c, n_req, n_threads),))
                   for c in range(n_threads)]
        t_start = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        wall = time.perf_counter() - t_start
        if any(t.is_alive() for t in threads) or any(r is None for r in results):
            raise RuntimeError("not every request was served")
        flushes = server.models()["lm"]["flushes"]
    launches = fa.launches  # the main path ends here
    if fa.launches_dq or fa.launches_dkv:
        raise AssertionError("serving launched a backward kernel")
    expect = layers * (1 + flushes)  # one warmup forward + one forward per flush
    log(f"    served {n_req} requests in {wall:.3f} s over {flushes} flushes: "
        f"{n_req / wall:.2f} requests/s, p50 {np.percentile(lat, 50) * 1e3:.1f} ms, "
        f"p99 {np.percentile(lat, 99) * 1e3:.1f} ms; card {card}")
    log(f"    flash_attention_fwd launches: {launches} (expected {layers} per forward "
        f"x (1 warmup + {flushes} flushes) = {expect})")
    if launches != expect:
        raise AssertionError(f"flash kernel launched {launches} times, expected {expect}")

    # Each answer against a direct forward of that record on the card. Rows
    # served in a batch of 8 and forwards of one record run the same bf16
    # arithmetic through GEMMs of other shapes, so the sums' order differs:
    # logits (std ~1) may differ by a few bf16 steps (2^-7 at 1..2).
    atol = 0.1
    worst, flips = 0.0, 0
    with torch.inference_mode():
        for i in range(n_req):
            ref = model.forward(records[i][None])[0].float().cpu()
            got = results[i]
            if got.shape != (T, vocab) or not bool(torch.isfinite(got).all()):
                raise AssertionError(f"request {i}: shape {tuple(got.shape)} or non-finite")
            worst = max(worst, (got - ref).abs().max().item())
            top2 = ref.topk(2, dim=-1).values
            clear = (top2[:, 0] - top2[:, 1]) > 2 * atol  # argmax decided beyond tolerance
            flips += int((got.argmax(-1) != ref.argmax(-1))[clear].sum())
    log(f"    served vs direct forward (card, bf16): max |logit diff| {worst:.4f} "
        f"(tol {atol}), argmax flips where the margin > {2 * atol}: {flips}")
    if worst > atol or flips:
        raise AssertionError("served logits disagree with the direct forward")

    # One record against an fp32 forward on the CPU through the dense plain
    # attention path: bf16 operands in every matmul of 6 layers plus the
    # LM head give logits a few hundredths off (std ~1); 0.25 is ~30 bf16
    # steps at 1.0.
    cpu_tol = 0.25
    Engine.set_compute_dtype("float32")
    try:
        cpu_model = Transformer(vocab, hidden, heads, filt, layers, 0.0, 0.0, 0.0,
                                mode="lm", device="cpu").eval()
        cpu_model.init(sample_input=records[:1])
        load_jax_params(cpu_model, {k: v.detach().cpu().numpy()
                                    for k, v in model.named_parameters()})
        with torch.inference_mode():
            ref = cpu_model.forward(records[:1])[0]
    finally:
        Engine.set_compute_dtype("bfloat16")
    err = (results[0] - ref).abs()
    agree = (results[0].argmax(-1) == ref.argmax(-1)).float().mean().item()
    log(f"    served vs fp32 CPU forward (record 0): max |logit diff| {err.max().item():.4f}, "
        f"mean {err.mean().item():.5f} (tol {cpu_tol}), argmax agreement {agree:.4f}")
    if err.max().item() > cpu_tol:
        raise AssertionError("served logits disagree with the fp32 CPU forward")
    return launches


# Flash route vs dense route over 3 SGD steps from the same weights (bf16
# operands in both, fixed before the first run): the two routes round
# attention's products at other places (the dense route keeps bf16 scores
# and weights; the kernels keep fp32 P and round it once), which moves the
# loss (~9.0) by ~1e-3; the weights after 3 steps differ from each other by
# far less than the steps themselves moved them.
TRAIN_TOL = {
    "loss": 2e-2,    # |loss_flash - loss_dense| per step
    "params": 1e-3,  # ||p_flash - p_dense|| / ||p_dense||
    "update": 1e-1,  # ||(p_flash - p0) - (p_dense - p0)|| / ||p_dense - p0||
}


def phase_training(card):
    """Train the full-width LM through LocalOptimizer; returns the flash
    kernels' launches (forward, dQ, dK/dV) of that run."""
    import os
    import statistics

    import numpy as np
    import torch
    from bigdl_tpu_torch import Engine, RandomGenerator
    from bigdl_tpu_torch.dataset import DataSet
    from bigdl_tpu_torch.nn import CrossEntropyCriterion, Transformer
    from bigdl_tpu_torch.ops import flash_attention as fa
    from bigdl_tpu_torch.optim import SGD, LocalOptimizer, Trigger
    from bigdl_tpu_torch.utils.convert import load_jax_params

    vocab, hidden, heads, filt, layers, T = 8192, 512, 8, 2048, 6, 2048
    batch, n_records, iters = 8, 40, 10
    Engine.set_compute_dtype("bfloat16")
    RandomGenerator.set_seed(SEED)
    gen = np.random.default_rng(SEED)
    ids = gen.integers(0, vocab, (n_records, T))
    targets = gen.integers(0, vocab, (n_records, T))

    def lm():
        return Transformer(vocab, hidden, heads, filt, layers, 0.0, 0.0, 0.0,
                           mode="lm", device="cuda")

    def trainer(model, n, steps):
        opt = LocalOptimizer(model, DataSet.array(ids[:n], targets[:n], batch_size=batch),
                             CrossEntropyCriterion())
        return opt.set_optim_method(SGD(learningrate=0.1)).set_end_when(
            Trigger.max_iteration(steps))

    model = lm()
    opt = trainer(model, n_records, iters)
    fa.launches = fa.launches_dq = fa.launches_dkv = 0  # the main path starts here
    t0 = time.perf_counter()
    opt.optimize()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = (fa.launches, fa.launches_dq, fa.launches_dkv)  # the main path ends here
    hist = opt.history
    losses = [h["loss"] for h in hist]
    step_ms = statistics.median(h["wall_s"] for h in hist[2:]) * 1e3  # iterations 3-10
    log(f"[6] trained the LM ({sum(p.numel() for p in model.parameters()) / 1e6:.1f} M "
        f"params) through LocalOptimizer: {len(hist)} iterations over epochs "
        f"{sorted({h['epoch'] for h in hist})} in {wall:.2f} s; step {step_ms:.2f} ms "
        f"(median of iterations 3-{iters}), {batch * T / step_ms * 1e3:.0f} tokens/s; "
        f"card {card}")
    log("    losses: " + ", ".join(f"{x:.4f}" for x in losses))
    log(f"    launches: flash_attention_fwd {counts[0]}, dq {counts[1]}, dkv {counts[2]} "
        f"(expected {layers} per iteration each = {layers * iters})")
    if len(hist) != iters or not all(np.isfinite(losses)) or len({h["epoch"] for h in hist}) < 2:
        raise AssertionError(f"training: {len(hist)} iterations, losses {losses}")
    if counts != (layers * iters,) * 3:
        raise AssertionError(f"flash kernels launched {counts}, expected {layers * iters} each")
    del opt, model
    torch.cuda.empty_cache()

    # Flash route vs dense route: 3 SGD steps on one batch from the same weights.
    init = lm()
    init.init(sample_input=ids[:batch])
    w0 = {k: v.detach().cpu().numpy() for k, v in init.named_parameters()}
    del init
    runs = {}
    prev = os.environ.get("BIGDL_ATTN_IMPL")
    try:
        for impl in ("flash", "dense"):
            os.environ["BIGDL_ATTN_IMPL"] = impl
            m = lm()
            m.init(sample_input=ids[:batch])
            load_jax_params(m, w0)
            o = trainer(m, batch, 3)
            o.optimize()
            runs[impl] = ([h["loss"] for h in o.history],
                          torch.cat([p.detach().float().flatten() for p in m.parameters()]))
            del m, o
            torch.cuda.empty_cache()
    finally:
        if prev is None:
            os.environ.pop("BIGDL_ATTN_IMPL", None)
        else:
            os.environ["BIGDL_ATTN_IMPL"] = prev
    p0 = torch.cat([torch.from_numpy(w0[k]).flatten() for k in w0]).to("cuda")
    (lf, pf), (ld, pd) = runs["flash"], runs["dense"]
    d_loss = max(abs(a - b) for a, b in zip(lf, ld))
    d_params = ((pf - pd).norm() / pd.norm()).item()
    d_update = ((pf - pd).norm() / (pd - p0).norm()).item()
    log(f"    flash vs dense route, 3 SGD steps from the same weights (card, bf16): losses "
        f"{[round(x, 4) for x in lf]} vs {[round(x, 4) for x in ld]}, max diff {d_loss:.2e} "
        f"(tol {TRAIN_TOL['loss']}); params rel diff {d_params:.2e} (tol "
        f"{TRAIN_TOL['params']}); update rel diff {d_update:.2e} (tol {TRAIN_TOL['update']})")
    if (len(lf) != 3 or d_loss > TRAIN_TOL["loss"] or d_params > TRAIN_TOL["params"]
            or d_update > TRAIN_TOL["update"]):
        raise AssertionError("the flash route's training disagrees with the dense route")
    return counts


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device; this script runs on the card only",
              file=sys.stderr)
        return 2
    if not (ROOT / "bigdl_tpu_torch").is_dir():
        print("chip_smoke.py: bigdl_tpu_torch/ not found next to this script; run it "
              "from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    t0 = time.perf_counter()
    card = phase_card()
    phase_build()
    rec = phase_parity()
    bwd_rec = phase_bwd_parity()
    fwd = phase_times(rec, card)
    dq, dkv = phase_bwd_times(bwd_rec, card)
    del rec, bwd_rec
    torch.cuda.empty_cache()
    served = phase_slice(card)
    trained = phase_training(card)
    fwd["launches"] = served + trained[0]
    fwd["launches_by_path"] = {"serving": served, "training": trained[0]}
    dq["launches"], dkv["launches"] = trained[1], trained[2]
    for k in (dq, dkv):
        k["launches_by_path"] = {"serving": 0, "training": k["launches"]}
    log(f"done in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": [fwd, dq, dkv]}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
