#!/usr/bin/env python3
"""Ablation profile of the bf16 flash-attention backward kernels on one CUDA card.

    python3 tools/torch_flash_bwd_ablation.py [variant ...]   # default: all

Each variant is ``bigdl_tpu_torch/csrc/flash_attention_bwd.cu`` (with the
headers it includes) with one part of the kernels' work taken out, or one
tile setting changed. A part taken out makes the results wrong; only the
time means anything. Every variant's library is built side by side with nvcc
under ``build/ablation_bwd/`` (the other sources are compiled once and
shared), then the dQ and dK/dV kernels are timed, each through its C entry
point, at the LM's shape (8, 8, 2048, 64) bf16 causal and at (2, 8, 2048,
128) causal, the variants in turns, two rounds. Where ncu and nsys do not
run, the time a part takes away is what can be said about where the kernels'
time goes.

Variants: ``base`` (the kernels as they are); ``noexp`` (P's exp2 replaced
by its argument); ``nocompute`` (no P or dS: the raw accumulators go on to
the second products); ``noload`` (no streamed TMA loads: each ring stage is
marked full without data); ``nosecond`` (no second products: dS K, P^T dO
and dS^T Q); ``nomma`` (no products at all: P and dS from whatever the
accumulators hold); ``nopingpong`` (the two warpgroups issue without taking turns);
``dq_sub64`` (dQ takes 64 keys a round at d = 64, not 128); ``wait0``
(each round waits for all its products before computing P and dS, so
nothing overlaps that within a warpgroup); ``dkv_sub32`` (dK/dV takes 32
query rows a round at d = 64, not 64).
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

sys.modules["jax"] = None
sys.modules["bigdl_tpu"] = None
ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

BWD, TMA = "flash_attention_bwd.cu", "flash_tma.cuh"
# (file, old, new); every occurrence of old is replaced
NOLOAD = [
    (TMA, "hopper::mbar_expect_tx(full, 2 * kTile);", "hopper::mbar_expect_tx(full, 0);"),
    (TMA, "hopper::mbar_arrive_expect_tx(full, 2 * kTile);",
     "hopper::mbar_arrive_expect_tx(full, 0);"),
    (TMA, """          hopper::tma_load_4d(st + hf * kHalf, str0, full, hf * 64, s * kRows, ld.hh, ld.n);
          hopper::tma_load_4d(st + kTile + hf * kHalf, str1, full, hf * 64, s * kRows, ld.hh,
                              ld.n);""", ""),
]
VARIANTS = {
    "base": [],
    "noexp": [(BWD, "fast_exp2(fminf(fmaf(", "(fminf(fmaf(")],
    "nocompute": [(BWD, "      compute(j0);\n", ""), (BWD, "        compute(j);\n", "")],
    "noload": NOLOAD,
    "nosecond": [
        (BWD, "      hopper::wgmma_rs<D>(dq, pb[kk], hopper::desc_mnmajor(kt + kk * 2048, kHalf));",
         "      ;"),
        (BWD, "      hopper::wgmma_rs<D>(dv, pa[kk], hopper::desc_mnmajor(ot + kk * 2048, kHalf));",
         ""),
        (BWD, "      hopper::wgmma_rs<D>(dk, da[kk], hopper::desc_mnmajor(qt + kk * 2048, kHalf));",
         "")],
    "nopingpong": [(BWD, "    hopper::named_sync(my_bar, 256);\n", ""),
                   (BWD, "hopper::named_arrive(other_bar, 256);", ""),
                   (BWD, "if (cw == 1) hopper::named_arrive(1, 256);", ""),
                   (BWD, "if (cw == 0) hopper::named_sync(1, 256);", "")],
    "dq_sub64": [(BWD, "static constexpr int kSub = D == 64 ? 128 : 64, kStages = D == 64 ? 4 : 2;",
                  "static constexpr int kSub = 64, kStages = D == 64 ? 4 : 2;")],
    "nomma": [
        (BWD, """      hopper::wgmma_ss<kSub>(s, hopper::desc_kmajor(q_w + off), hopper::desc_kmajor(kt + off),
                             kk > 0);
      hopper::wgmma_ss<kSub>(dp, hopper::desc_kmajor(o_w + off), hopper::desc_kmajor(vt + off),
                             kk > 0);""", ""),
        (BWD, """      hopper::wgmma_ss<kSub>(st, hopper::desc_kmajor(k_w + off), hopper::desc_kmajor(qt + off),
                             kk > 0);
      hopper::wgmma_ss<kSub>(dpt, hopper::desc_kmajor(v_w + off), hopper::desc_kmajor(ot + off),
                             kk > 0);""", ""),
        (BWD, "      hopper::wgmma_rs<D>(dq, pb[kk], hopper::desc_mnmajor(kt + kk * 2048, kHalf));",
         "      ;"),
        (BWD, "      hopper::wgmma_rs<D>(dv, pa[kk], hopper::desc_mnmajor(ot + kk * 2048, kHalf));",
         ""),
        (BWD, "      hopper::wgmma_rs<D>(dk, da[kk], hopper::desc_mnmajor(qt + kk * 2048, kHalf));",
         "")],
    "wait0": [(BWD, "hopper::wgmma_wait<1>();", "hopper::wgmma_wait<0>();")],
    "dkv_sub32": [(BWD, "static constexpr int kSub = D == 64 ? 64 : 32, kStages = D == 64 ? 4 : 2;",
                   "static constexpr int kSub = 32, kStages = D == 64 ? 4 : 2;")],
}
SHAPES = [(8, 8, 2048, 64), (2, 8, 2048, 128)]


def _compile(src: Path, obj: Path) -> str:
    from bigdl_tpu_torch.ops import _build

    r = subprocess.run([_build._nvcc(), *_build.ARCH, *_build.FLAGS, "-c", str(src), "-o",
                        str(obj)], capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{r.stdout}{r.stderr}")
    return r.stdout + r.stderr


def build(name: str, shared: list) -> Path:
    """The library of one variant: its backward object and the shared others."""
    from bigdl_tpu_torch.ops import _build

    d = ROOT / "build" / "ablation_bwd" / name
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(_build.CSRC, d / "csrc")
    for fname, old, new in VARIANTS[name]:
        f = d / "csrc" / fname
        src = f.read_text()
        if old not in src:
            raise RuntimeError(f"variant {name}: {fname} no longer has {old.strip()[:60]!r}")
        f.write_text(src.replace(old, new))
    obj = d / "bwd.o"
    log = _compile(d / "csrc" / BWD, obj)
    if "C7514" in log:
        print(f"  {name}: ptxas serialized its wgmma (C7514)", flush=True)
    for line in log.splitlines():
        if "spill" in line and not line.strip().startswith("0 bytes"):
            print(f"  {name}: {line.strip()}", flush=True)
    lib = d / "lib.so"
    subprocess.run([_build._nvcc(), *_build.ARCH, "-shared", "-o", str(lib), str(obj),
                    *map(str, shared)], check=True)
    return lib


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_flash_bwd_ablation.py: no CUDA device", file=sys.stderr)
        return 2
    from bigdl_tpu_torch.ops import _build
    from bigdl_tpu_torch.ops import flash_attention as fa

    names = sys.argv[1:] or list(VARIANTS)
    t0 = time.perf_counter()
    common = ROOT / "build" / "ablation_bwd" / "common"
    common.mkdir(parents=True, exist_ok=True)
    others = [s for s in _build.sources() if s.name != BWD]
    shared = [common / (s.stem + ".o") for s in others]
    with ThreadPoolExecutor(8) as pool:
        list(pool.map(_compile, others, shared))
        libs = dict(zip(names, pool.map(lambda n: build(n, shared), names)))
    print(f"built {len(names)} variants in {time.perf_counter() - t0:.1f} s", flush=True)
    bound = {name: _build._bind(ctypes.CDLL(str(lib))) for name, lib in libs.items()}
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    _build.load()  # the shapes' forward runs on the checkout's own library
    g = torch.Generator(device="cuda").manual_seed(0)
    args = {}
    for sh in SHAPES:
        q, k, v, d_out = (torch.randn(sh, generator=g, device="cuda").bfloat16() for _ in range(4))
        out, lse = fa.flash_attention_fwd(q, k, v, True)
        head, tail, keep = fa._bwd_kernel_args(q, k, v, out, lse, d_out, True, None, None, True)
        args[sh] = (head, tail, keep, torch.empty_like(q), torch.empty_like(k),
                    torch.empty_like(v))

    def ms(fn, iters=50):
        for _ in range(5):
            fn()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    def check(rc):
        if rc != 0:
            raise RuntimeError(f"backward kernel launch failed with CUDA error {rc}")

    print(f"card: {card}; ms a call (dQ, dK/dV) at " + ", ".join(map(str, SHAPES)))
    for _ in range(2):
        for name in names:
            lib, row = bound[name], []
            for sh in SHAPES:
                head, tail, _, dq, dk, dv = args[sh]
                row.append(ms(lambda: check(lib.bigdl_flash_attention_bwd_dq(
                    *head, dq.data_ptr(), *tail))))
                row.append(ms(lambda: check(lib.bigdl_flash_attention_bwd_dkv(
                    *head, dk.data_ptr(), dv.data_ptr(), *tail))))
            print(f"  {name:12s} " + "  ".join(f"{t:.4f}" for t in row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
