#!/usr/bin/env python3
"""Rehearse the max-pool backward kernel's logic on the CPU, with no card and no nvcc.

    python3 tools/torch_maxpool_bwd_rehearse.py [--asan]

Builds ``bigdl_tpu_torch/csrc/maxpool_bwd.cu`` with g++ under stand-ins for
the CUDA pieces it uses, into ``build/rehearse_pool/`` (which ``.gitignore``
lists): one thread a block (every block-stride loop then visits all its
work), a launch as a loop over the grid's blocks, ``cp.async`` as a 16-byte
memcpy, and for each block a fresh shared-memory allocation of exactly the
size the launch asks for, filled with 0xff bytes (NaN in bf16 and f32), so
that a read of a slot nothing wrote shows up in dx. The 3x3/s1 instance
splits its window rows as it does on the card (256 threads a block). With
``--asan`` the library is built under AddressSanitizer and the script runs
again with the sanitizer's runtime preloaded: a read or write past a
block's shared memory stops the run.

Then it calls the C entry point ``bigdl_maxpool2d_bwd`` through ctypes on
CPU tensors and holds dx against ``maxpool_grad_reference`` (the plain
version) with the card's tolerance (``chip_smoke.py`` ``TOL_MAXPOOL``): 3x3/s1
at every padding the entry point takes on planes of 1x1 to 150x40 (row
bands included), NaN, -inf, tied and integer inputs, storage offsets of one
element, the other instances' geometries, VGG-for-CIFAR-10's five
2x2/s2 pools (planes down to 2x2, pooled rows one element wide) and
AlexNet's three 3x3/s2 pools on odd planes without padding (55, 27 and 13
wide), in f32 and bf16. It prints one
line a case and the count; exit 1 if any case disagrees. What it cannot
show: anything about speed, warps, bank conflicts or the card's compiler.
"""

from __future__ import annotations

import ctypes
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

sys.modules["jax"] = None
sys.modules["bigdl_tpu"] = None
ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
OUT = ROOT / "build" / "rehearse_pool"

SHIM = r"""
#pragma once
#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __align__(n) alignas(n)
struct dim3i { unsigned x, y, z; };
inline long long g_block = 0, g_grid = 0, g_smem_size = 0;
inline unsigned char* g_smem = nullptr;
#define threadIdx (dim3i{0, 0, 0})
#define blockIdx (dim3i{(unsigned)g_block, 0, 0})
#define gridDim (dim3i{(unsigned)g_grid, 0, 0})
#define blockDim (dim3i{1, 0, 0})
typedef void* cudaStream_t;
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaDevAttrMultiProcessorCount = 16,
       cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
inline int cudaGetDevice(int* d) { *d = 0; return 0; }
inline int cudaDeviceGetAttribute(int* v, int, int) { *v = 132; return 0; }
template <class K> inline int cudaFuncSetAttribute(K, int, int) { return 0; }
inline int cudaGetLastError() { return 0; }
struct float2 { float x, y; };
struct float4 { float x, y, z, w; };
struct uint2 { unsigned x, y; };
struct uint4 { unsigned x, y, z, w; };
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
inline uint2 make_uint2(unsigned a, unsigned b) { return {a, b}; }
inline uint4 make_uint4(unsigned a, unsigned b, unsigned c, unsigned d) { return {a, b, c, d}; }
struct __nv_bfloat16 { uint16_t x; };
inline float __bfloat162float(__nv_bfloat16 v) {
  uint32_t u = uint32_t(v.x) << 16;
  float f;
  memcpy(&f, &u, 4);
  return f;
}
inline __nv_bfloat16 __float2bfloat16(float f) {  // round to nearest even
  uint32_t u;
  memcpy(&u, &f, 4);
  if ((u & 0x7fffffff) > 0x7f800000) return {uint16_t((u >> 16) | 0x40)};
  u += 0x7fff + ((u >> 16) & 1);
  return {uint16_t(u >> 16)};
}
inline unsigned __umulhi(unsigned a, unsigned b) { return unsigned((uint64_t(a) * b) >> 32); }
inline float __fadd_rn(float a, float b) { return a + b; }
inline long long min(long long a, long long b) { return a < b ? a : b; }
inline long long max(long long a, long long b) { return a > b ? a : b; }
inline void __syncthreads() {}
inline void alloc_smem() {
  const size_t n = (g_smem_size + 15) / 16 * 16;
  g_smem = static_cast<unsigned char*>(aligned_alloc(16, n ? n : 16));
  memset(g_smem, 0xff, n);
}
inline void free_smem() {
  free(g_smem);
  g_smem = nullptr;
}
"""


def transform(src: str) -> str:
    """The CUDA source with its CUDA-only pieces replaced by the stand-ins."""
    edits = [
        ("#include <cuda_bf16.h>", '#include "shim.h"'),
        ("#include <cuda_runtime.h>", ""),
        ("constexpr int kThreads = 256;", "constexpr int kThreads = 1;"),
        ("extern __shared__ __align__(16) unsigned char smem[];", "unsigned char* smem = g_smem;"),
        ('asm volatile("cp.async.wait_all;\\n" ::: "memory");', ""),
        # the 3x3/s1 instance's phase-1 runs as on the card
        ("kThreads / std::max(1, std::max(1, p.group) * groups)",
         "256 / std::max(1, std::max(1, p.group) * groups)"),
    ]
    for old, new in edits:
        src = src.replace(old, new)
    src = re.sub(r'asm volatile\("cp\.async\.cg.*?: "memory"\);', "memcpy(dst, src, 16);", src,
                 flags=re.S)
    # K<<<grid, threads, smem, stream>>>(args); -> a loop over the blocks
    return re.sub(r"(\S+)<<<(.*?), (\w+), (\w+), (\w+)>>>\(",
                  r"for (g_grid = (\2), g_block = 0, g_smem_size = (\4); "
                  r"g_block < g_grid && (alloc_smem(), 1); ++g_block, free_smem()) \1(", src,
                  flags=re.S)


def build(asan: bool) -> Path:
    from bigdl_tpu_torch.ops import _build

    shutil.rmtree(OUT, ignore_errors=True)
    OUT.mkdir(parents=True)
    (OUT / "shim.h").write_text(SHIM)
    for name in ("maxpool_bwd.cu", "vec_common.cuh"):
        (OUT / name).write_text(transform((_build.CSRC / name).read_text()))
    lib = OUT / "libpool.so"
    flags = ["-fsanitize=address", "-fno-omit-frame-pointer"] if asan else []
    r = subprocess.run(["g++", "-std=c++17", "-O1", "-g", *flags, "-shared", "-fPIC", "-x", "c++",
                        str(OUT / "maxpool_bwd.cu"), "-o", str(lib)], capture_output=True,
                       text=True)
    if r.returncode != 0:
        raise RuntimeError(f"g++ failed:\n{r.stdout}{r.stderr}")
    return lib


def cases():
    """(shape, kernel, stride, padding, dtype, input kind, storage offset)."""
    import torch

    s1 = ((3, 3), (1, 1))
    out = []
    for dt in (torch.float32, torch.bfloat16):
        for shape in [(2, 6, 28, 28), (3, 7, 14, 14), (3, 7, 7, 7), (2, 9, 7, 7), (1, 3, 13, 11),
                      (2, 3, 5, 3), (1, 2, 1, 1), (1, 2, 2, 9), (1, 1, 64, 64), (1, 2, 70, 90),
                      (1, 1, 113, 113), (1, 3, 8, 16), (2, 2, 16, 8), (1, 1, 9, 300),
                      (1, 1, 150, 40)]:
            for pad in [((1, 1), (1, 1)), ((0, 0), (0, 0)), ((2, 2), (2, 2)), ((0, 1), (0, 1)),
                        ((1, 0), (0, 1)), ((4, 3), (3, 5))]:
                if shape[2] + pad[0][0] + pad[0][1] >= 3 and shape[3] + pad[1][0] + pad[1][1] >= 3:
                    out.append((shape, *s1, pad, dt, "normal", 0))
        for shape in [(3, 7, 7, 7), (2, 3, 28, 28), (2, 5, 14, 14), (1, 1, 64, 64)]:
            out += [(shape, *s1, ((1, 1), (1, 1)), dt, kind, 0)
                    for kind in ("nan", "neginf", "zeros", "ints", "relu")]
            out += [(shape, *s1, ((1, 1), (1, 1)), dt, kind, 1) for kind in ("normal", "nan")]
        out += [((2, 3, 64, 64), (3, 3), (2, 2), ((1, 1), (1, 1)), dt, "normal", 1),
                ((2, 8, 28, 28), (2, 2), (2, 2), ((0, 0), (0, 0)), dt, "relu", 0),
                ((2, 5, 30, 17), (5, 4), (1, 3), ((2, 1), (0, 2)), dt, "normal", 0),
                ((2, 4, 28, 28), (3, 3), (2, 2), ((0, 1), (0, 1)), dt, "nan", 0)]
        # VGG-for-CIFAR-10's five 2x2/s2 pools (32x32 down to 2x2 planes: pooled
        # rows of 16, 8, 4, 2 and 1 elements) at batch 2, the last two also at
        # a storage offset of one element
        vgg = ((2, 2), (2, 2), ((0, 0), (0, 0)))
        out += [((2, c, hw, hw), *vgg, dt, "relu", 0)
                for c, hw in ((64, 32), (128, 16), (256, 8), (512, 4), (512, 2))]
        out += [((2, 512, hw, hw), *vgg, dt, kind, 1) for hw in (4, 2) for kind in ("relu", "nan")]
        # AlexNet's three 3x3/s2 pools without padding on odd planes (55, 27
        # and 13 wide: pooled rows of 27, 13 and 6), at batch 1-2, post-ReLU,
        # with NaN and -inf, and at a storage offset of one element
        alex = ((3, 3), (2, 2), ((0, 0), (0, 0)))
        for c, hw in ((96, 55), (256, 27), (256, 13)):
            out += [((2, c, hw, hw), *alex, dt, "relu", 0), ((1, c, hw, hw), *alex, dt, "nan", 0),
                    ((1, c, hw, hw), *alex, dt, "normal", 1)]
    return out


def run_case(lib, shape, kernel, stride, padding, dt, kind, offset) -> bool:
    import torch
    from bigdl_tpu_torch.ops.maxpool import maxpool_grad_reference, pooled_size

    g = torch.Generator().manual_seed(0)
    n, c, h, w = shape
    x = torch.randn(shape, generator=g)
    u = torch.rand(shape, generator=g)
    if kind == "relu":
        x = x.relu()
    elif kind == "zeros":
        x.zero_()
    elif kind == "ints":
        x = torch.randint(0, 3, shape, generator=g).float()
    elif kind == "nan":  # NaN, -inf and +inf cells
        x[u < 0.05] = float("nan")
        x[(u >= 0.05) & (u < 0.12)] = float("-inf")
        x[(u >= 0.12) & (u < 0.15)] = float("inf")
    elif kind == "neginf":  # whole windows of -inf
        x[u < 0.6] = float("-inf")
    ho, wo = pooled_size((h, w), kernel, stride, padding)
    dy = torch.randn((n, c, ho, wo), generator=g)
    x, dy = (torch.cat([t.new_zeros(offset), t.ravel().to(dt)])[offset:].view(t.shape)
             for t in (x.to(dt), dy.to(dt)))
    dx = torch.full_like(x, float("nan"))
    rc = lib.bigdl_maxpool2d_bwd(x.data_ptr(), dy.data_ptr(), dx.data_ptr(),
                                 1 if dt == torch.bfloat16 else 0, n * c, h, w, ho, wo, *kernel,
                                 *stride, padding[0][0], padding[1][0], None)
    ref = maxpool_grad_reference(x, dy, kernel, stride, padding)
    err = (dx.float() - ref.float()).abs()
    n_terms = -(-kernel[0] // stride[0]) * -(-kernel[1] // stride[1])
    allow = 1e-6 * n_terms * dy.float().abs().max().item()
    bound = allow + (2.0 ** -7 * ref.float().abs() if dt == torch.bfloat16 else 0.0)
    ok = rc == 0 and bool((err <= bound).all())
    print(f"{'ok  ' if ok else 'FAIL'} x {shape} {kernel}/{stride} padding {padding} "
          f"{str(dt)[6:]} {kind} offset {offset}: rc {rc}, max err {err.max().item():.2e}",
          flush=True)
    return ok


def main() -> int:
    asan = "--asan" in sys.argv[1:]
    runtime = subprocess.run(["g++", "-print-file-name=libasan.so"], capture_output=True,
                             text=True).stdout.strip() if asan else ""
    if asan and runtime not in os.environ.get("LD_PRELOAD", ""):
        lib = build(asan=True)
        env = dict(os.environ, LD_PRELOAD=runtime, ASAN_OPTIONS="detect_leaks=0")
        return subprocess.run([sys.executable, __file__, "--asan", "--built"], env=env).returncode
    lib = OUT / "libpool.so" if "--built" in sys.argv[1:] else build(asan=False)
    vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    cdll = ctypes.CDLL(str(lib))
    cdll.bigdl_maxpool2d_bwd.argtypes = [vp] * 3 + [i, ll] + [i] * 10 + [vp]
    cdll.bigdl_maxpool2d_bwd.restype = i
    todo = cases()
    bad = sum(not run_case(cdll, *case) for case in todo)
    print(f"{len(todo) - bad} / {len(todo)} cases agree with maxpool_grad_reference"
          f"{' under AddressSanitizer' if asan else ''}")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
