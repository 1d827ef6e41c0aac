// The parts the TMA/wgmma flash kernels share (the forward in
// flash_attention.cu, dQ and dK/dV in flash_attention_bwd.cu): the persistent
// grid's order of work items, the producer warp that keeps TMA loads in
// flight, the fast exp2, and the epilogue that writes an accumulator's rows
// as bf16 16-byte chunks.
//
// Every kernel here has the same shape: a block of one producer warpgroup and
// two consumer warpgroups; each work item has "resident" tiles (loaded once
// an item: the forward's q tile; dQ's Q and dO; dK/dV's K and V) and
// "streamed" tile pairs that pass through a ring of shared-memory stages (the
// forward's and dQ's K and V; dK/dV's Q and dO). Every TMA box is 128 rows
// of 64 bf16 columns (kRows x 64, 128-byte swizzle); a head dim of 128 is two
// such boxes side by side ("halves", kHalf bytes apart).

#pragma once

#include "flash_common.cuh"
#include "hopper_common.cuh"

namespace flash_tma {

constexpr int kRows = 128;               // rows of a TMA box, an item and a stage
constexpr int kHalf = kRows * 128;       // bytes of one 128-row x 64-column tile
constexpr int kThreads = 384;            // producer warpgroup + two consumer warpgroups
constexpr int kConsumerWarps = 8;

// Bytes of a 128-row tile of head dim D.
template <int D>
__host__ __device__ constexpr int tile_bytes() {
  return (D / 64) * kHalf;
}

// 2^x on the special-function unit, results below 2^-126 flushed to 0 (values
// that small vanish in the bf16 rounding of P anyway).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The item this block takes in its round r: rows of gridDim.x items in
// order, dealt left to right on even rounds and right to left on odd ones,
// which evens out the blocks' sums of work when items run longest first.
__device__ inline int item_of(int r) {
  const int b = (r & 1) ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  return r * gridDim.x + b;
}

// What the producer needs of a work item: the head (n, hh), the first row
// of its resident tiles, and its stages [s0, s1) of the streamed maps (stage
// s holds rows [128 s, 128 s + 128)). s1 <= s0: nothing to load.
struct Load {
  int n, hh, r0, s0, s1;
};

// The producer warp. For each of this block's work items (items(i) -> Load)
// it loads the NR (1 or 2) resident tiles once the consumers have released
// the previous item's (bar_res_empty), then the item's stages of the two
// streamed maps into the ring of kStages stages of stage_bytes each: the
// first map's tile at the stage's start, the second's a tile later.
// Barriers: full and empty a stage (8 bytes apart), resident full and empty.
// With kExtra, every lane of the warp calls extra(slot, s, load) for each
// stage after the slot is free and then arrives on its full barrier, which
// counts 32 arrivals (lane 0 adds the bytes of the TMA loads); without it
// only lane 0 runs (the full barrier counts 1 arrival) and the others return.
template <int D, int NR, int kStages, bool kExtra, class Items, class Extra>
__device__ inline void produce(const CUtensorMap* res0, const CUtensorMap* res1,
                               const CUtensorMap* str0, const CUtensorMap* str1,
                               uint32_t res_smem, uint32_t ring_smem, uint32_t stage_bytes,
                               uint32_t bar_full, uint32_t bar_empty, uint32_t bar_res_full,
                               uint32_t bar_res_empty, int n_items, Items items, Extra extra) {
  constexpr int kTile = tile_bytes<D>();
  const int lane = threadIdx.x % 32;
  if (!kExtra && lane != 0) return;
  int kv = 0, nres = 0;  // stages and resident loads issued so far
  for (int r = 0; r * gridDim.x < n_items; ++r) {
    const int item = item_of(r);
    if (item >= n_items) continue;
    const Load ld = items(item);
    if (ld.s1 <= ld.s0) continue;
    if (lane == 0) {
      // the resident buffers are free once both warpgroups' last product
      // reading them has completed
      if (nres > 0) hopper::mbar_wait(bar_res_empty, (nres - 1) & 1);
      hopper::mbar_arrive_expect_tx(bar_res_full, NR * kTile);
#pragma unroll
      for (int hf = 0; hf < D / 64; ++hf) {
        hopper::tma_load_4d(res_smem + hf * kHalf, res0, bar_res_full, hf * 64, ld.r0, ld.hh,
                            ld.n);
        if constexpr (NR == 2)
          hopper::tma_load_4d(res_smem + kTile + hf * kHalf, res1, bar_res_full, hf * 64, ld.r0,
                              ld.hh, ld.n);
      }
    }
    ++nres;
    for (int s = ld.s0; s < ld.s1; ++s, ++kv) {
      const int slot = kv % kStages;
      if (kv >= kStages) hopper::mbar_wait(bar_empty + 8 * slot, ((kv / kStages) - 1) & 1);
      const uint32_t full = bar_full + 8 * slot, st = ring_smem + slot * stage_bytes;
      if (lane == 0) {
        if constexpr (kExtra)
          hopper::mbar_expect_tx(full, 2 * kTile);
        else
          hopper::mbar_arrive_expect_tx(full, 2 * kTile);
#pragma unroll
        for (int hf = 0; hf < D / 64; ++hf) {
          hopper::tma_load_4d(st + hf * kHalf, str0, full, hf * 64, s * kRows, ld.hh, ld.n);
          hopper::tma_load_4d(st + kTile + hf * kHalf, str1, full, hf * 64, s * kRows, ld.hh,
                              ld.n);
        }
      }
      if constexpr (kExtra) {
        extra(slot, s, ld);
        hopper::mbar_arrive(full);
      }
    }
  }
}

// Of four values, the one at (runtime) index i, without local memory.
__device__ inline uint32_t pick4(uint32_t a, uint32_t b, uint32_t c, uint32_t d, int i) {
  const uint32_t lo = (i & 1) ? b : a, hi = (i & 1) ? d : c;
  return (i & 2) ? hi : lo;
}

// Row r (0: the thread's first row, 1: its second, 8 rows on) of an
// m64nD fp32 accumulator, times mul, rounded to bf16 and stored at dst (the
// row's first element; stored only where ok). The 4 threads of a quad hold
// the 8 columns of each 8-column block of a row, 2 each, and swap pieces by
// shuffles so that each stores whole 16-byte chunks: thread c of the quad
// stores blocks 4u + c. Every lane of the warp must call it.
template <int D>
__device__ inline void store_row_bf16(const float* acc, int r, float mul, flash::bf16* dst,
                                      bool ok) {
  const int lane = threadIdx.x % 32, c = lane & 3;
  uint32_t w[D / 8];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
    w[i] = flash::pack_bf16(acc[i * 4 + 2 * r] * mul, acc[i * 4 + 2 * r + 1] * mul);
#pragma unroll
  for (int u = 0; u < D / 32; ++u) {
    uint32_t got[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      // round k: read from quad lane (c + k) & 3, which sends its piece of
      // block 4u + ((its c - k) & 3), i.e. of this thread's block
      const uint32_t send = pick4(w[4 * u], w[4 * u + 1], w[4 * u + 2], w[4 * u + 3], (c - k) & 3);
      got[k] = __shfl_sync(0xffffffffu, send, (lane & ~3) | ((c + k) & 3));
    }
    // got[k] is the piece of quad lane (c + k) & 3; piece q is got[(q - c) & 3]
    uint4 chunk;
    chunk.x = pick4(got[0], got[1], got[2], got[3], (0 - c) & 3);
    chunk.y = pick4(got[0], got[1], got[2], got[3], (1 - c) & 3);
    chunk.z = pick4(got[0], got[1], got[2], got[3], (2 - c) & 3);
    chunk.w = pick4(got[0], got[1], got[2], got[3], (3 - c) & 3);
    if (ok) *reinterpret_cast<uint4*>(dst + (4 * u + c) * 8) = chunk;
  }
}

// The 4-D tensor map of a bf16 (N, H, T, D) operand with element strides
// (sn, sh, st) and a contiguous head dim, boxes of 64 columns x 128 rows.
template <int D>
inline int encode_rows(CUtensorMap* map, const void* base, int n, int h, int t, long long sn,
                       long long sh, long long st) {
  const long long dims[4] = {D, t, h, n}, strides[3] = {st, sh, sn};
  return hopper_host::encode_bf16_4d(map, base, dims, strides, 64, kRows);
}

// One block an SM, or one a work item where there are fewer.
inline int persistent_grid(int items) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return items < sms ? items : sms;
}

}  // namespace flash_tma
