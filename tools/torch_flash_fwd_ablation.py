#!/usr/bin/env python3
"""Ablation profile of the bf16 flash-attention forward kernel on one CUDA card.

    python3 tools/torch_flash_fwd_ablation.py [variant ...]   # default: all

Each variant is ``bigdl_tpu_torch/csrc/flash_attention.cu`` with one part
of the kernel's work taken out (its results are wrong; only its time means
anything). Every variant's library is built side by side with nvcc under
``build/ablation/``, then the forward is timed at the LM's shape (8, 8,
2048, 64) bf16 causal, at (1, 1, 8192, 64) non-causal (every key tile full,
64 work items) and at (8, 8, 2048, 128) causal, the variants in turns, two
rounds, beside ``scaled_dot_product_attention``. Where ncu and nsys do not
run, the time a part takes away is what can be said about where the
kernel's time goes.

Variants: ``base`` (the kernel as it is); ``noexp`` (the softmax's exp2
replaced by its argument); ``nosoftmax`` (no softmax); ``noload`` (no k/v
TMA loads: each ring stage is marked full without data); ``noload_nosoftmax``
(both); ``nopingpong`` (the two warpgroups issue without taking turns).
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

NOLOAD = [
    ("        hopper::mbar_arrive_expect_tx(bar_full + 8 * s, 2 * L::kTile);",
     "        hopper::mbar_arrive(bar_full + 8 * s);"),
    ("""          hopper::tma_load_4d(kt + hf * kHalfBytes, &tm_k, bar_full + 8 * s, hf * 64, j * kBK,
                              t.hh, t.n);
          hopper::tma_load_4d(vt + hf * kHalfBytes, &tm_v, bar_full + 8 * s, hf * 64, j * kBK,
                              t.hh, t.n);""", ""),
]
NOSOFTMAX = [("      softmax(0);\n", ""), ("        softmax(j);\n", "")]
VARIANTS = {
    "base": [],
    "noexp": [("const float pe = fast_exp2(fmaf(s[i], sl2, neg_m[(i >> 1) & 1]));",
               "const float pe = fmaf(s[i], sl2, neg_m[(i >> 1) & 1]);")],
    "nosoftmax": NOSOFTMAX,
    "noload": NOLOAD,
    "noload_nosoftmax": NOLOAD + NOSOFTMAX,
    "nopingpong": [("    hopper::named_sync(my_bar, 256);\n", ""),
                   ("hopper::named_arrive(other_bar, 256);", ""),
                   ("if (cw == 1) hopper::named_arrive(1, 256);", ""),
                   ("if (cw == 0) hopper::named_sync(1, 256);", "")],
}
SHAPES = [(8, 8, 2048, 64, True), (1, 1, 8192, 64, False), (8, 8, 2048, 128, True)]


def build(name: str) -> Path:
    """The library of one variant (every source compiled as _build does)."""
    from bigdl_tpu_torch.ops import _build

    d = ROOT / "build" / "ablation" / name
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(_build.CSRC, d / "csrc")
    f = d / "csrc" / "flash_attention.cu"
    src = f.read_text()
    for old, new in VARIANTS[name]:
        if old not in src:
            raise RuntimeError(f"variant {name}: the source no longer has {old.strip()[:60]!r}")
        src = src.replace(old, new)
    f.write_text(src)
    nvcc, objs = _build._nvcc(), []
    for s in sorted((d / "csrc").glob("*.cu")):
        objs.append(str(d / (s.stem + ".o")))
        subprocess.run([nvcc, *_build.ARCH, *_build.FLAGS, "-c", str(s), "-o", objs[-1]],
                       check=True, capture_output=True)
    lib = d / "lib.so"
    subprocess.run([nvcc, *_build.ARCH, "-shared", "-o", str(lib), *objs], check=True)
    return lib


def main() -> int:
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("torch_flash_fwd_ablation.py: no CUDA device", file=sys.stderr)
        return 2
    from bigdl_tpu_torch.ops import _build
    from bigdl_tpu_torch.ops import flash_attention as fa

    names = sys.argv[1:] or list(VARIANTS)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as pool:
        libs = dict(zip(names, pool.map(build, names)))
    print(f"built {len(names)} variants in {time.perf_counter() - t0:.1f} s", flush=True)
    bound = {name: _build._bind(ctypes.CDLL(str(lib))) for name, lib in libs.items()}
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    g = torch.Generator(device="cuda").manual_seed(0)
    data = {sh: [torch.randn(sh[:4], generator=g, device="cuda").bfloat16() for _ in range(3)]
            for sh in SHAPES}

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

    print(f"card: {card}; ms a call at " + ", ".join(map(str, SHAPES)))
    for _ in range(2):
        for name in names:
            _build._lib = bound[name]  # the wrapper launches this variant
            row = [ms(lambda: fa.flash_attention_fwd(*data[sh][:3], sh[4])) for sh in SHAPES]
            print(f"  {name:18s} " + "  ".join(f"{t:.4f}" for t in row), flush=True)
        row = [ms(lambda: F.scaled_dot_product_attention(*data[sh][:3], is_causal=sh[4]))
               for sh in SHAPES]
        print(f"  {'sdpa':18s} " + "  ".join(f"{t:.4f}" for t in row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
