// Helpers of the flash-attention kernels: the constants and bf16 packing
// (forward, flash_attention.cu, and backward, flash_attention_bwd.cu), and
// the backward's mma.sync m16n8k16 bf16 product and strided row-tile loader.
//
// Fragment layouts of mma.sync.m16n8k16 (lane = 4 * quad + c2 / 2):
//   A (16x16, row-major): a0 = (quad, c2..c2+1), a1 = (quad+8, c2..c2+1),
//                         a2 = (quad, c2+8..c2+9), a3 = (quad+8, c2+8..c2+9)
//   B (16x8, k x n):      b0 = (k = c2..c2+1, n = quad), b1 = (k = c2+8..c2+9, n = quad)
//   C (16x8, fp32):       c0, c1 = (quad, c2..c2+1), c2', c3 = (quad+8, c2..c2+1)
// so the accumulators of n-tiles 2kk and 2kk+1 of one product are exactly the
// A fragment of k-step kk of the next product.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {

constexpr float kNegBig = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

using bf16 = __nv_bfloat16;

__device__ inline uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ inline uint32_t pack_bf16_raw(bf16 lo, bf16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// d[0..3] += A(16x16, row) * B(16x8, col); bf16 operands, fp32 accumulator.
__device__ inline void mma_bf16(float* d, const uint32_t* a, uint32_t b0,
                                uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Copy rows [r0, r0 + ROWS) of a (rows, D) strided bf16 matrix into shared
// memory (row pitch LD), zero-filling rows past `rows`. 16-byte accesses.
template <int ROWS, int D, int LD, int NT>
__device__ inline void load_rows_bf16(bf16* s, const bf16* g, int r0, int rows,
                                      long long st) {
  constexpr int kVec = 8, kPerRow = D / kVec;
  for (int i = threadIdx.x; i < ROWS * kPerRow; i += NT) {
    const int r = i / kPerRow, c = (i % kPerRow) * kVec;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r0 + r < rows)
      val = *reinterpret_cast<const uint4*>(g + (long long)(r0 + r) * st + c);
    *reinterpret_cast<uint4*>(s + r * LD + c) = val;
  }
}

// The A fragment (16 rows from r, 16 columns from c) of a bf16 tile in
// shared memory with row pitch LD; r and c already include quad and c2.
template <int LD>
__device__ inline void a_frag(uint32_t* a, const bf16* s, int r, int c) {
  a[0] = *reinterpret_cast<const uint32_t*>(&s[r * LD + c]);
  a[1] = *reinterpret_cast<const uint32_t*>(&s[(r + 8) * LD + c]);
  a[2] = *reinterpret_cast<const uint32_t*>(&s[r * LD + c + 8]);
  a[3] = *reinterpret_cast<const uint32_t*>(&s[(r + 8) * LD + c + 8]);
}

}  // namespace flash
