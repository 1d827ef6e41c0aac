#!/usr/bin/env python3
"""Ablation profile of the max-pool backward kernel on one CUDA card.

    python3 tools/torch_maxpool_bwd_ablation.py [variant ...]   # default: all

Each variant is ``bigdl_tpu_torch/csrc/maxpool_bwd.cu`` (with the headers it
includes) with one part of the kernel's work taken out or one setting
changed. A part taken out makes the results wrong; only the time means
anything. Each variant is compiled alone with nvcc into a library of its
own under ``build/ablation_pool/`` (all of them side by side), and its C
entry point ``bigdl_maxpool2d_bwd`` is timed at the shapes and inputs of
``tools/torch_maxpool_bwd_ab.py`` (the flagship's stem pool, VGG-16's five
pools, Inception-v1's ten pool shapes), the variants in turns, two rounds.
Beside them, ``copy16`` moves the same bytes with 16-byte accesses and no
other work (read x and dy once, write dx once): the rate this card reaches
on this traffic. Where ncu and nsys do not run, the time a part takes away
is what can be said about where the kernel's time goes.

The variants depend on the kernel's design, recognised from its source:

- the first gather kernel (one block per plane tile, runtime geometry),
  when this file is run from a checkout that has it:
  ``noargmax`` (no window's argmax is searched: every window takes its
  first offset), ``nodyread`` (the gather adds 1 where it would read dy),
  ``noxread`` (the staging writes 0 where it would read x);
- the band kernel (compile-time geometry, one work item a block):
  ``noargmax`` (as above), ``nodyread`` (the gather adds 1 where it would
  read dy from shared memory), ``noload`` (no cp.async copy is issued: the
  staging buffers hold whatever they held), ``items4k``, ``items8k`` and
  ``items32k`` (items of at most about 4096, 8192 or 32768 dx elements
  instead of 16384), ``ring2`` and ``ring3`` (a persistent grid whose
  blocks walk the items through a ring of 2 or 3 staging buffers, the next
  items' copies in flight while one is computed, instead of one item a
  block), ``general`` (every shape through the runtime-geometry instance);
  and for its 3x3/s1 instance: ``s1noargmax`` (no window's argmax is
  searched and no x is read: every window takes its centre),
  ``s1nogather`` (phase 2 reads nothing and writes zeros), ``s1nocopy``
  (no dx chunk goes out to device memory), ``s1runs1`` and ``s1runsx2``
  (one run a column of windows, or twice as many as fit a block's threads
  at once), ``s1smem24k`` and ``s1smem96k`` (plane groups sized to 24 or 96
  KB of shared memory instead of 56), ``s1no1`` and ``s1no2`` (no phase 1, no phase 2),
  ``s1nodyw`` (phase 1 reads no dy and writes none to the frame),
  ``s1ring2`` (a persistent grid whose blocks walk the items with two
  staging buffers, the next item's copies in flight while one is
  computed), ``s1blocks1``, ``s1blocks2`` and ``s1blocks3`` (registers capped for
  one, two or three blocks an SM instead of four).
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
sys.path.insert(0, str(ROOT / "tools"))

POOL = "maxpool_bwd.cu"
# design -> (marker in the source, {variant: [(old, new), ...]}); every
# occurrence of old is replaced
# The band kernel with a persistent grid (as many blocks as fit on the SMs)
# whose blocks walk the items in order through a ring of S staging buffers:
# the next items' cp.async copies stay in flight while this one is computed.
RING_BODY = """  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int S = STAGES;
  T* bufs = reinterpret_cast<T*>(smem);
  const int st = p.x_stage + p.dy_stage;
  uint16_t* am = reinterpret_cast<uint16_t*>(smem + sizeof(T) * S * st);
  const long long step = gridDim.x;
  for (int s = 0; s < S - 1; ++s) {
    if (blockIdx.x + s * step < p.items)
      issue<T, SH>(x, dy, bufs + s * st, p, blockIdx.x + s * step);
    asm volatile("cp.async.commit_group;\\n" ::: "memory");
  }
  int k = 0;
  for (long long it = blockIdx.x; it < p.items; it += step, ++k) {
    const long long next = it + (S - 1) * step;
    if (next < p.items) issue<T, SH>(x, dy, bufs + (k + S - 1) % S * st, p, next);
    asm volatile("cp.async.commit_group;\\n" ::: "memory");
    asm volatile("cp.async.wait_group %0;\\n" ::"n"(S - 1) : "memory");
    __syncthreads();
    compute<T, KH, KW, SH, SW>(dx, bufs + k % S * st, am, x, dy, p, it);
    __syncthreads();
  }
}
"""
ONE_ITEM_BODY = """  extern __shared__ __align__(16) unsigned char smem[];
  T* buf = reinterpret_cast<T*>(smem);
  uint16_t* am = reinterpret_cast<uint16_t*>(smem + sizeof(T) * (p.x_stage + p.dy_stage));
  issue<T, SH>(x, dy, buf, p, blockIdx.x);
  cp_async_wait_all();
  __syncthreads();
  compute<T, KH, KW, SH, SW>(dx, buf, am, x, dy, p, blockIdx.x);
}
"""

# The 3x3/s1 kernel with a persistent grid whose blocks walk the items with
# two staging buffers: the next item's x and dy copies in flight while one
# is computed (the second buffer after the window frame).
S1_ONE_ITEM_BODY = """  extern __shared__ __align__(16) unsigned char smem[];
  T* buf = reinterpret_cast<T*>(smem + p.mask_bytes);  // x, then dy
  issue<T, 1>(x, dy, buf, p, blockIdx.x);
  for (int k = threadIdx.x; k < p.mask_bytes / 16; k += kThreads)  // no window: mask 0
    reinterpret_cast<uint4*>(smem)[k] = make_uint4(0, 0, 0, 0);
  cp_async_wait_all();
  __syncthreads();
  compute_s1<T>(dx, buf, smem, x, dy, p, blockIdx.x);
}
"""
S1_RING_BODY = """  extern __shared__ __align__(16) unsigned char smem[];
  const int st = p.x_stage + p.dy_stage;
  T* bufs[2] = {reinterpret_cast<T*>(smem + p.mask_bytes),
                reinterpret_cast<T*>(smem + p.mask_bytes + sizeof(T) * st +
                                     sizeof(float) * (p.mask_bytes / 2))};
  const long long step = gridDim.x;
  issue<T, 1>(x, dy, bufs[0], p, blockIdx.x);
  asm volatile("cp.async.commit_group;\\n" ::: "memory");
  int k = 0;
  for (long long it = blockIdx.x; it < p.items; it += step, ++k) {
    if (it + step < p.items) issue<T, 1>(x, dy, bufs[(k + 1) % 2], p, it + step);
    asm volatile("cp.async.commit_group;\\n" ::: "memory");
    for (int c = threadIdx.x; c < p.mask_bytes / 16; c += kThreads)
      reinterpret_cast<uint4*>(smem)[c] = make_uint4(0, 0, 0, 0);
    asm volatile("cp.async.wait_group 1;\\n" ::: "memory");
    __syncthreads();
    compute_s1<T>(dx, bufs[k % 2], smem, x, dy, p, it);
    __syncthreads();
  }
}
"""
S1_RING = [(S1_ONE_ITEM_BODY, S1_RING_BODY),
           ("           static_cast<size_t>(elem) * (p.x_stage + p.dy_stage);",
            "           static_cast<size_t>(elem) * 2 * (p.x_stage + p.dy_stage) + 64;"),
           ("  maxpool2d_bwd_s1<T><<<static_cast<unsigned>(p.items), kThreads, smem, stream>>>(",
            "  int per_sm = 1, dev = 0, sms = 132;\n"
            "  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, maxpool2d_bwd_s1<T>, kThreads,"
            " smem);\n"
            "  cudaGetDevice(&dev);\n"
            "  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);\n"
            "  maxpool2d_bwd_s1<T><<<static_cast<unsigned>(std::min(p.items, 1LL * std::max(1, "
            "per_sm) * sms)), kThreads, smem, stream>>>(")]


def ring(stages: int):
    return [(ONE_ITEM_BODY, RING_BODY.replace("STAGES", str(stages))),
            ("    return static_cast<size_t>(p.x_stage + p.dy_stage) * elem +",
             f"    return static_cast<size_t>({stages}) * (p.x_stage + p.dy_stage) * elem +"),
            ("  kernel<<<static_cast<unsigned>(p.items), kThreads, smem, stream>>>(",
             "  int per_sm = 1, dev = 0, sms = 132;\n"
             "  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);\n"
             "  cudaGetDevice(&dev);\n"
             "  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);\n"
             "  kernel<<<static_cast<unsigned>(std::min(p.items, 1LL * std::max(1, per_sm) * sms)),"
             " kThreads, smem, stream>>>(")]


DESIGNS = {
    "gather": ("kTilePositions", {
        "base": [],
        "noargmax": [("for (int a = 0; a < g.kh; ++a)\n      for (int b = 0; b < g.kw; ++b) {",
                      "for (int a = 0; a < 0; ++a)\n      for (int b = 0; b < g.kw; ++b) {")],
        "nodyread": [("acc += to_float(dyp[static_cast<long long>(oh) * g.wo + ow]);",
                      "acc += 1.f;")],
        "noxread": [("? to_float(xp[static_cast<long long>(r) * g.w + c])", "? 0.f")],
    }),
    "band": ("struct FastDivmod", {
        "base": [],
        "noargmax": [("    am[i] = static_cast<uint16_t>(best_k);", "    am[i] = 0;")],
        "nodyread": [("to_float(ys[row + ow])", "1.f")],
        "noload": [("      cp_async16(dst + k * VEC, src + g0);", "")],
        "items4k": [("constexpr int kItemElemsMax = 16384;", "constexpr int kItemElemsMax = 4096;")],
        "items8k": [("constexpr int kItemElemsMax = 16384;", "constexpr int kItemElemsMax = 8192;")],
        "items32k": [("constexpr int kItemElemsMax = 16384;",
                      "constexpr int kItemElemsMax = 32768;"),
                     ("constexpr int kSmemTarget = 48 * 1024;",
                      "constexpr int kSmemTarget = 160 * 1024;")],
        "ring2": ring(2),
        "ring3": ring(3),
        "general": [("p.kh == 3 && p.kw == 3 && p.sh == 2 && p.sw == 2", "false"),
                    ("p.kh == 2 && p.kw == 2 && p.sh == 2 && p.sw == 2", "false"),
                    ("p.kh == 3 && p.kw == 3 && p.sh == 1 && p.sw == 1", "false")],
        "s1noargmax": [("static_cast<uint32_t>(dm[j] == mx ? dc[j] : 6 + tt[j])", "4u")],
        "s1nogather": [("if (e >= 0 && e < 8 && (mask[q / 2] >> (16 * (q % 2) + 3 * a + b) & 1u)) "
                        "acc[e] += val[q];", "")],
        "s1nocopy": [("      store<T, VEC>(dx + g0, load<T, VEC>(buf + k * VEC));", "")],
        "s1runs1": [("kThreads / std::max(1, std::max(1, p.group) * groups)", "1")],
        "s1runsx2": [("kThreads / std::max(1, std::max(1, p.group) * groups)",
                      "2 * kThreads / std::max(1, std::max(1, p.group) * groups)")],
        "s1smem24k": [("constexpr int kS1SmemTarget = 56 * 1024;",
                       "constexpr int kS1SmemTarget = 24 * 1024;")],
        "s1smem96k": [("constexpr int kS1SmemTarget = 56 * 1024;",
                       "constexpr int kS1SmemTarget = 96 * 1024;")],
        "s1no1": [("    s1_windows<T>(p, t, xs, ys, masks, dyw, pl, run, p.g_lo + group);", "")],
        "s1no2": [("    s1_gather<T>(p, masks, dyw, buf + head + pl * p.hw + r * p.w + group * 8, pl, r, "
                   "group * 8);", "")],
        "s1nodyw": [("    dw[sr * step] = make_float4(val[0], val[1], val[2], val[3]);", "")],
        "s1ring2": S1_RING,
        "s1blocks1": [("__launch_bounds__(kThreads, 4)\n    maxpool2d_bwd_s1(",
                       "__launch_bounds__(kThreads, 1)\n    maxpool2d_bwd_s1(")],
        "s1blocks2": [("__launch_bounds__(kThreads, 4)\n    maxpool2d_bwd_s1(",
                       "__launch_bounds__(kThreads, 2)\n    maxpool2d_bwd_s1(")],
        "s1blocks3": [("__launch_bounds__(kThreads, 4)\n    maxpool2d_bwd_s1(",
                       "__launch_bounds__(kThreads, 3)\n    maxpool2d_bwd_s1(")],
    }),
}

COPY_SRC = r"""
#include <cuda_runtime.h>
#include <stdint.h>
__global__ void __launch_bounds__(256)
    copy16(const uint4* __restrict__ x, const uint4* __restrict__ dy, uint4* __restrict__ dx,
           long long nx, long long ny) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < nx;
       i += stride) {
    uint4 v = x[i];
    if (i < ny) {
      const uint4 d = dy[i];
      v.x ^= d.x; v.y ^= d.y; v.z ^= d.z; v.w ^= d.w;
    }
    dx[i] = v;
  }
}
extern "C" int bigdl_copy16(const void* x, const void* dy, void* dx, long long nx, long long ny,
                            int blocks, void* stream) {
  copy16<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(x), static_cast<const uint4*>(dy), static_cast<uint4*>(dx), nx,
      ny);
  return static_cast<int>(cudaGetLastError());
}
"""


def _nvcc(args) -> str:
    from bigdl_tpu_torch.ops import _build

    r = subprocess.run([_build._nvcc(), *_build.ARCH, *_build.FLAGS, *args], capture_output=True,
                       text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed: {args}\n{r.stdout}{r.stderr}")
    return r.stdout + r.stderr


def build(name: str, edits) -> Path:
    """The library of one variant: its max-pool source alone, with the edits."""
    from bigdl_tpu_torch.ops import _build

    d = ROOT / "build" / "ablation_pool" / name
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(_build.CSRC, d / "csrc")
    f = d / "csrc" / POOL
    src = f.read_text()
    for old, new in edits:
        if old not in src:
            raise RuntimeError(f"variant {name}: {POOL} no longer has {old.strip()[:60]!r}")
        src = src.replace(old, new)
    f.write_text(src)
    lib = d / "lib.so"
    log = _nvcc(["-shared", str(f), "-o", str(lib)])
    for line in log.splitlines():
        if name == "base" and ("registers" in line or "spill" in line):
            print(f"  ptxas {name}: {line.strip()}", flush=True)
        elif "spill" in line and not line.strip().startswith("0 bytes"):
            print(f"  ptxas {name}: {line.strip()}", flush=True)
    return lib


def build_copy() -> Path:
    d = ROOT / "build" / "ablation_pool" / "copy16"
    d.mkdir(parents=True, exist_ok=True)
    (d / "copy16.cu").write_text(COPY_SRC)
    _nvcc(["-shared", str(d / "copy16.cu"), "-o", str(d / "lib.so")])
    return d / "lib.so"


def main() -> int:
    import torch
    from torch_maxpool_bwd_ab import SHAPES, bound_ms, kernel_ms, ms, pool_inputs

    if not torch.cuda.is_available():
        print("torch_maxpool_bwd_ablation.py: no CUDA device", file=sys.stderr)
        return 2
    from bigdl_tpu_torch.ops import _build

    src = (_build.CSRC / POOL).read_text()
    design = next(k for k, (marker, _) in DESIGNS.items() if marker in src)
    variants = DESIGNS[design][1]
    names = sys.argv[1:] or list(variants)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(8) as pool:
        copy_lib = pool.submit(build_copy)
        libs = dict(zip(names, pool.map(lambda n: build(n, variants[n]), names)))
        copy_lib = copy_lib.result()
    print(f"design {design}: built {len(names)} variants and copy16 in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    bound = {}
    for name, path in libs.items():
        lib = ctypes.CDLL(str(path))
        lib.bigdl_maxpool2d_bwd.argtypes = [vp] * 3 + [i, ll] + [i] * 10 + [vp]
        lib.bigdl_maxpool2d_bwd.restype = i
        bound[name] = lib
    copy = ctypes.CDLL(str(copy_lib))
    copy.bigdl_copy16.argtypes = [vp] * 3 + [ll, ll, i, vp]
    copy.bigdl_copy16.restype = i
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    g = torch.Generator(device="cuda").manual_seed(0)
    args = []
    for _, shape, geometry, kind in SHAPES:
        x, dy = pool_inputs(shape, geometry, kind, g)
        args.append((x, dy, torch.empty_like(x), geometry))

    def copy_ms(x, dy, dx):
        nx, ny = x.numel() * 2 // 16, dy.numel() * 2 // 16
        stream = torch.cuda.current_stream().cuda_stream

        def launch():
            rc = copy.bigdl_copy16(x.data_ptr(), dy.data_ptr(), dx.data_ptr(), nx, ny,
                                   min(-(-nx // 256), 8 * sms), stream)
            if rc != 0:
                raise RuntimeError(f"copy16 launch failed with CUDA error {rc}")

        return ms(launch)

    print(f"card: {card}; ms a call at " + ", ".join(s[0] for s in SHAPES), flush=True)
    print("  bound        " + "  ".join(f"{bound_ms(a[0], a[1]):.4f}" for a in args), flush=True)
    for _ in range(2):
        print("  copy16       " + "  ".join(f"{copy_ms(*a[:3]):.4f}" for a in args), flush=True)
        for name in names:
            row = [kernel_ms(bound[name], *a) for a in args]
            print(f"  {name:12s} " + "  ".join(f"{t:.4f}" for t in row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
