#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``bigdl_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py          # from the root of a checkout; needs one CUDA card

Phases, in order; any failure raises and the script exits non-zero:

1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
2. build the port's CUDA kernels from ``bigdl_tpu_torch/csrc`` (timed) and
   launch each once;
3. each kernel against its plain PyTorch version on the card, over the
   serving shape and the masking/shape edge cases, with stated tolerances;
4. kernel, plain-version and library times beside the card's bound;
5. the slice: the full-width Transformer-LM (vocab 8192, hidden 512, 8
   heads, filter 2048, 6 layers, T=2048, random weights from a seed) served
   through ``ModelServer`` — 16 single-record requests from 4 threads, each
   answer checked against a direct forward on the card and one against an
   fp32 CPU forward, and the flash kernel's launches counted.

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


def attention_bound_ms(q, k, v, out, lse, vis_pairs: int, card: str):
    """Least time for one attention call: max(bytes / memory rate, FLOPs /
    peak rate), each input read once and each output written once, counting
    only the (query, key) pairs these inputs make visible."""
    import torch

    bf16_peak, f32_peak, mem = peaks(card)
    flops = 4 * q.shape[-1] * vis_pairs  # QK^T and P·V, 2 FLOP per MAC
    nbytes = sum(t.numel() * t.element_size() for t in (q, k, v, out, lse))
    peak = bf16_peak if q.dtype == torch.bfloat16 else f32_peak
    t_ops, t_bytes = flops / peak, nbytes / mem
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


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
    from bigdl_tpu_torch.ops.flash_attention import flash_attention_fwd

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
        flash_attention_fwd(q, q, q, causal=True)
    torch.cuda.synchronize()
    log("    flash_attention_fwd launched once in bf16 and f32")


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

    fa.launches = 0  # the main path starts here
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
    kernel = phase_times(rec, card)
    del rec
    torch.cuda.empty_cache()
    kernel["launches"] = phase_slice(card)
    log(f"done in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": [kernel]}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
