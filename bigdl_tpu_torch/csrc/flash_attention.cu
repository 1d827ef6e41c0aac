// Flash-attention forward for Hopper (sm_90a), bound to Python through a
// plain C entry point (ctypes; see bigdl_tpu_torch/ops/_build.py).
//
// Replaces: bigdl_tpu/ops/flash_attention.py::_fwd_kernel (the Pallas TPU
// kernel launched by _flash_fwd_impl). Same function: exact softmax attention
// with an online softmax, fp32 accumulation and fp32 softmax bookkeeping, plus
// the per-row logsumexp. Masks: causal aligned at the end (query row i sees
// keys j <= i + Tk - Tq), per-sequence `lengths` giving the horizon
// kl = min(lengths[n], Tk), `mask_q` (query rows with i + Tk - Tq >= kl give 0
// output), and a row with no visible key gives out = 0, lse = NEG_BIG. P is
// rounded to bf16 before P·V, as the TPU kernel does; nothing is summed with
// atomics, so a repeat gives the same bits.
//
// Bound on this card: at the LM's shape (8, 8, 2048, 64) bf16 causal the two
// products are ~3.4e10 FLOP over the visible pairs (~0.035 ms at 989 TFLOP/s)
// against ~67 MB of traffic (~0.020 ms at 3.35 TB/s), and the softmax takes
// one exp2 a visible pair, ~1.3e8 on the special-function units (16 a clock
// on each of 132 SMs at ~1.8 GHz: ~0.035 ms too). Tensor cores and
// special-function units bound it about equally; one after the other they
// cannot get under ~0.07 ms, so the design overlaps them.
//
// The bf16 design (d = 64 or 128):
// - A persistent grid, one block an SM, walks work items of (n*h, 128-row q
//   tile) longest first (causal), dealt to the blocks in a snake order so
//   that their sums of work even out. A block is a producer warp and two
//   consumer warpgroups of 64 query rows each; the producer's warpgroup
//   gives its registers back (setmaxnreg 40), the consumers take 232.
// - TMA: 4-D tensor maps over (d, T, H, N) built from the caller's strides,
//   so the LM's split_heads views go in without a copy; 128-byte swizzle.
//   The producer loads an item's q tile (as soon as the previous item's last
//   S product has read its own) and its k/v tiles of 128 keys into a ring of
//   3 stages with full/empty mbarriers that runs on across items; rows past
//   T come back as zeros; key tiles no row of the item can see are never
//   loaded.
// - wgmma: S = Q K^T as m64n128k16 with both operands in shared memory
//   (K-major); O += P V with P from registers (the S accumulators rounded to
//   bf16) and V read in place as an MN-major operand. 128 keys a tile at both
//   head dims: at d = 128 a consumer thread holds O (64 floats), S (64) and
//   the previous tile's P (32 registers) within its 232, and 3 stages of
//   64 KB plus the 32 KB q tile fill 224 of the 227 KB a block may use.
// - Overlap: each round a warpgroup issues S of tile j and P V of tile j-1
//   together, then runs tile j's softmax while P V runs; the two warpgroups
//   take turns to issue (named barriers 1 and 2), so one's softmax can run
//   under the other's products. The rounds are peeled so that no branch
//   sits between a product and its wait (ptxas would serialize the wgmmas).
// - The softmax stays in registers: base 2 with ex2.approx, fp32 running max
//   and sum per row, reductions by shuffles within a row's 4 threads, the
//   masks applied in a separate loop taken only on tiles that are not fully
//   visible, as one compare an element against each row's last visible key
//   (per-element mask tests in that loop had cost ~10% of the kernel).
// - Epilogue: O scaled by 1/l and rounded to bf16; the 4 threads of a quad
//   swap their pieces by shuffles and each writes whole 16-byte chunks of a
//   row; the lse as (m + log2 l) ln 2.
//
// float32 inputs take a separate CUDA-core (FMA) kernel: 4 threads per query
// row, each owning a quarter of the head dim, 32-key tiles, one block per
// (64-row q tile, n*h).

#include <math.h>

#include "flash_common.cuh"
#include "hopper_common.cuh"

namespace {

using namespace flash;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;             // (N, H, Tq, D) contiguous, q's dtype
  float* lse;          // (N, H, Tq) contiguous
  const int* lengths;  // (N,) or nullptr
  int h, tq, tk;
  long long q_sn, q_sh, q_st;  // element strides; the head dim is contiguous
  long long k_sn, k_sh, k_st;
  long long v_sn, v_sh, v_st;
  float scale;
  int causal, has_lengths, mask_q;
};

// Geometry shared by both kernels for one (n*h = bh, q tile qt of bq rows).
struct Tile {
  int n, hh, bh, q0, co, kl, k_end;
  bool qmask;
};

__device__ inline Tile make_tile(const Params& p, int bq, int bh, int qt) {
  Tile t;
  t.bh = bh;
  t.n = t.bh / p.h;
  t.hh = t.bh % p.h;
  t.q0 = qt * bq;
  t.co = p.tk - p.tq;
  t.kl = p.has_lengths ? min(p.lengths[t.n], p.tk) : p.tk;
  t.qmask = p.has_lengths && p.mask_q;
  // keys [0, k_end) are visible to at least one row of the tile
  const int q_last = min(t.q0 + bq, p.tq) - 1;
  int k_end = t.kl;
  if (p.causal) k_end = min(k_end, q_last + t.co + 1);
  if (t.qmask && t.q0 + t.co >= t.kl) k_end = 0;
  t.k_end = k_end;
  return t;
}

__device__ inline bool allowed(const Params& p, const Tile& t, int row, int col) {
  return col < t.kl && (!t.qmask || row + t.co < t.kl) &&
         (!p.causal || row + t.co >= col);
}

// Every entry of the (bq x bk) tile of rows from q0 and keys from k0 is visible.
__device__ inline bool tile_full(const Params& p, const Tile& t, int q0, int k0, int bq,
                                 int bk) {
  return k0 + bk <= t.kl && (!p.causal || q0 + t.co >= k0 + bk - 1) &&
         (!t.qmask || q0 + bq - 1 + t.co < t.kl);
}

// ------------------------------------------------------------------ bf16 path
// 2^x on the special-function unit, results below 2^-126 flushed to 0 (P
// values that small vanish in the bf16 rounding of P anyway).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

constexpr int kBQ = 128;         // query rows a work item (two warpgroups of 64)
constexpr int kBK = 128;         // keys a tile
constexpr int kStages = 3;       // k/v ring depth
constexpr int kThreads = 384;    // producer warpgroup + two consumer warpgroups
constexpr int kHalfBytes = 128 * 128;  // 128 rows x 64 bf16 columns, swizzled
constexpr int kConsumerWarps = 8;

// Shared memory of one block, in bytes from a 1024-aligned base: the q
// tile, then stage s's K at kv(s) and V at kv(s) + tile, then the mbarriers
// (full and empty a stage, the q tile's full and empty).
template <int D>
struct FwdSmem {
  static constexpr int kTile = (D / 64) * kHalfBytes;
  static constexpr int kQ = 0;
  static constexpr int kBar = kTile * (1 + 2 * kStages);
  static constexpr int kBytes = kBar + 8 * (2 * kStages + 2) + 1024;  // + alignment slack
  static constexpr __host__ __device__ int kv(int s) { return kTile * (1 + 2 * s); }
};

template <int D>
__device__ inline void s_product(float* s, uint32_t q_tile, uint32_t k_tile) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk / 4) * kHalfBytes + (kk % 4) * 32;
    hopper::wgmma_ss_n128(s, hopper::desc_kmajor(q_tile + off),
                          hopper::desc_kmajor(k_tile + off), kk > 0);
  }
}

template <int D>
__device__ inline void pv_product(float* o, const uint32_t (*pb)[4], uint32_t v_tile) {
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk) {
    const uint64_t db = hopper::desc_mnmajor(v_tile + kk * 2048, kHalfBytes);
    if constexpr (D == 64)
      hopper::wgmma_rs_n64(o, pb[kk], db);
    else
      hopper::wgmma_rs_n128(o, pb[kk], db);
  }
}

// Work item i of the persistent grid: q tile (q_tiles - 1 - i / nh) of head
// bh = i % nh, so items run longest first (causal).
__device__ inline Tile item_tile(const Params& p, int item, int nh, int q_tiles) {
  return make_tile(p, kBQ, item % nh, q_tiles - 1 - item / nh);
}

// The item this block takes in its round r: rows of gridDim.x items in
// order, dealt left to right on even rounds and right to left on odd ones,
// which evens out the blocks' sums of decreasing causal work.
__device__ inline int item_of(int r) {
  const int b = (r & 1) ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  return r * gridDim.x + b;
}

// Of four values, the one at (runtime) index i, without local memory.
__device__ inline uint32_t pick4(uint32_t a, uint32_t b, uint32_t c, uint32_t d, int i) {
  const uint32_t lo = (i & 1) ? b : a, hi = (i & 1) ? d : c;
  return (i & 2) ? hi : lo;
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_bf16(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v, Params p, int nh, int q_tiles) {
  using L = FwdSmem<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (hopper::smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t bar_full = base + L::kBar;          // + 8 s
  const uint32_t bar_empty = bar_full + 8 * kStages;  // + 8 s
  const uint32_t bar_q_full = bar_empty + 8 * kStages;
  const uint32_t bar_q_empty = bar_q_full + 8;
  const int n_items = nh * q_tiles;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(bar_full + 8 * s, 1);
      hopper::mbar_init(bar_empty + 8 * s, kConsumerWarps);
    }
    hopper::mbar_init(bar_q_full, 1);
    hopper::mbar_init(bar_q_empty, kConsumerWarps);
    hopper::mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---------------------------------------------------------- producer
    hopper::setmaxnreg_dec<40>();
    if (threadIdx.x != 0) return;
    int kv = 0, nq = 0;  // k/v tiles and q tiles loaded so far
    for (int r = 0; r * gridDim.x < n_items; ++r) {
      const int item = item_of(r);
      if (item >= n_items) continue;
      const Tile t = item_tile(p, item, nh, q_tiles);
      const int n_tiles = (t.k_end + kBK - 1) / kBK;
      if (n_tiles == 0) continue;
      // the q buffer is free once both warpgroups' last S of the previous
      // item has completed
      if (nq > 0) hopper::mbar_wait(bar_q_empty, (nq - 1) & 1);
      hopper::mbar_arrive_expect_tx(bar_q_full, L::kTile);
#pragma unroll
      for (int hf = 0; hf < D / 64; ++hf)
        hopper::tma_load_4d(base + L::kQ + hf * kHalfBytes, &tm_q, bar_q_full, hf * 64, t.q0,
                            t.hh, t.n);
      ++nq;
      for (int j = 0; j < n_tiles; ++j, ++kv) {
        const int s = kv % kStages;
        if (kv >= kStages) hopper::mbar_wait(bar_empty + 8 * s, ((kv / kStages) - 1) & 1);
        hopper::mbar_arrive_expect_tx(bar_full + 8 * s, 2 * L::kTile);
        const uint32_t kt = base + L::kv(s), vt = kt + L::kTile;
#pragma unroll
        for (int hf = 0; hf < D / 64; ++hf) {
          hopper::tma_load_4d(kt + hf * kHalfBytes, &tm_k, bar_full + 8 * s, hf * 64, j * kBK,
                              t.hh, t.n);
          hopper::tma_load_4d(vt + hf * kHalfBytes, &tm_v, bar_full + 8 * s, hf * 64, j * kBK,
                              t.hh, t.n);
        }
      }
    }
    return;
  }

  // -------------------------------------------------------------- consumers
  hopper::setmaxnreg_inc<232>();
  const int cw = wg - 1;  // this warpgroup's 64 rows of a q tile start at 64 cw
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int quad = lane / 4, c2 = (lane % 4) * 2;
  const uint32_t q_tile = base + L::kQ + cw * 64 * 128;
  const float sl2 = p.scale * kLog2e;  // scores kept in base-2 units
  const int my_bar = 1 + cw, other_bar = 2 - cw;  // named barriers 1 and 2: turns to issue

  float o[D / 2];
  float s[kBK / 2];
  uint32_t pb[kBK / 16][4];  // P of the previous tile: A fragments of P·V
  float m[2], l[2], corr[2], rs[2];
  int kv = 0, nq = 0;  // k/v tiles and q tiles consumed so far
  Tile t;
  int q0w = 0, row0 = 0;

  // Each round a warpgroup issues S_j = Q K_j^T (j < n) and O += P_{j-1}
  // V_{j-1} (j > 0) in its turn; the rounds are peeled so that the steady
  // loop has no branch between a product and its wait.
  auto wait_kv = [&](int j) {
    hopper::mbar_wait(bar_full + 8 * ((kv + j) % kStages), ((kv + j) / kStages) & 1);
  };
  auto turn_begin = [&]() {
    hopper::named_sync(my_bar, 256);
    hopper::fence_regs<kBK / 2>(s);
    hopper::fence_regs<D / 2>(o);
    hopper::fence_regs<kBK / 4>(&pb[0][0]);
    hopper::wgmma_fence();
  };
  auto issue_s = [&](int j) {
    s_product<D>(s, q_tile, base + L::kv((kv + j) % kStages));
    hopper::wgmma_commit();
  };
  auto issue_pv = [&](int j) {
    pv_product<D>(o, pb, base + L::kv((kv + j - 1) % kStages) + L::kTile);
    hopper::wgmma_commit();
  };
  // Tile j's online softmax on S (in registers): P in s, the row sums in rs,
  // the factor for O and l in corr. The max is taken on the raw scores
  // (sl2 > 0 keeps the order), then p = 2^(s sl2 - m) in one FMA. Only tiles
  // that are not fully visible run the masked loop (a uniform branch).
  auto softmax = [&](int j) {
    hopper::fence_regs<kBK / 2>(s);
    const int k0 = j * kBK;
    float mx[2] = {-INFINITY, -INFINITY};
    if (tile_full(p, t, q0w, k0, 64, kBK)) {
#pragma unroll
      for (int i = 0; i < kBK / 2; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
    } else {
      // a row sees the keys up to its last visible one (allowed() per row):
      // offsets from this thread's first column c2 of the tile
      int last[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + 8 * r;
        int lim = t.kl - 1;
        if (p.causal) lim = min(lim, row + t.co);
        if (t.qmask && row + t.co >= t.kl) lim = -1;
        last[r] = lim - k0 - c2;
      }
#pragma unroll
      for (int i = 0; i < kBK / 2; ++i) {
        if ((i >> 2) * 8 + (i & 1) > last[(i >> 1) & 1]) s[i] = -INFINITY;
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
      }
    }
    float neg_m[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r] * sl2);
      corr[r] = fast_exp2(m[r] - m_new);
      m[r] = m_new;
      neg_m[r] = -m_new;
      rs[r] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < kBK / 2; ++i) {
      // masked entries are -inf and m is finite, so they become exactly 0
      const float pe = fast_exp2(fmaf(s[i], sl2, neg_m[(i >> 1) & 1]));
      s[i] = pe;
      rs[(i >> 1) & 1] += pe;
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
    }
  };
  // After P_{j-1} V_{j-1} completed: free its stage.
  auto release = [&](int j) {
    hopper::fence_regs<D / 2>(o);
    hopper::fence_regs<kBK / 4>(&pb[0][0]);  // P_{j-1} is read until here
    if (lane == 0) hopper::mbar_arrive(bar_empty + 8 * ((kv + j - 1) % kStages));
  };
  // The q tile is free once this warpgroup's last S has completed.
  auto release_q = [&]() {
    if (lane == 0) hopper::mbar_arrive(bar_q_empty);
  };
  // Rescale O and l to tile j's max and round P_j to bf16 A fragments: the S
  // accumulators of 8-key blocks 2kk, 2kk+1 are the A fragment of k-step kk
  // (P rounded to bf16, as the TPU kernel does).
  auto fold = [&]() {
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + rs[r];
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      o[i * 4 + 0] *= corr[0];
      o[i * 4 + 1] *= corr[0];
      o[i * 4 + 2] *= corr[1];
      o[i * 4 + 3] *= corr[1];
    }
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      pb[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
      pb[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      pb[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      pb[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }
  };

  if (cw == 1) hopper::named_arrive(1, 256);  // the first warpgroup issues first
  for (int r = 0; r * gridDim.x < n_items; ++r) {
    const int item = item_of(r);
    if (item >= n_items) continue;
    t = item_tile(p, item, nh, q_tiles);
    const int n_tiles = (t.k_end + kBK - 1) / kBK;
    q0w = t.q0 + 64 * cw;
    row0 = q0w + warp * 16 + quad;  // this thread's rows: row0 and row0 + 8
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    m[0] = m[1] = kNegBig;
    l[0] = l[1] = 0.f;

    if (n_tiles > 0) {
      hopper::mbar_wait(bar_q_full, nq & 1);
      // round 0: S_0 only
      wait_kv(0);
      turn_begin();
      issue_s(0);
      hopper::named_arrive(other_bar, 256);
      hopper::wgmma_wait<0>();
      if (n_tiles == 1) release_q();
      softmax(0);
      fold();
      // rounds 1 .. n-1: S_j with P_{j-1} V_{j-1}; tile j's softmax runs under P V
      for (int j = 1; j < n_tiles; ++j) {
        wait_kv(j);
        turn_begin();
        issue_s(j);
        issue_pv(j);
        hopper::named_arrive(other_bar, 256);
        hopper::wgmma_wait<1>();
        if (j == n_tiles - 1) release_q();
        softmax(j);
        hopper::wgmma_wait<0>();
        release(j);
        fold();
      }
      // round n: the last P V
      turn_begin();
      issue_pv(n_tiles);
      hopper::named_arrive(other_bar, 256);
      hopper::wgmma_wait<0>();
      release(n_tiles);
      kv += n_tiles;
      ++nq;
    }

    // Epilogue: O / l rounded to bf16; the 4 threads of a quad hold the 8
    // columns of each 8-column block of a row, 2 each, and swap pieces by
    // shuffles so that each stores whole 16-byte chunks: thread c of the
    // quad stores blocks 4u + c.
    const int c = lane & 3;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      const float inv = 1.f / fmaxf(l[r], 1e-30f);
      uint32_t w[D / 8];
#pragma unroll
      for (int i = 0; i < D / 8; ++i)
        w[i] = pack_bf16(o[i * 4 + 2 * r] * inv, o[i * 4 + 2 * r + 1] * inv);
      bf16* O = static_cast<bf16*>(p.o) + ((long long)t.bh * p.tq + row) * D;
#pragma unroll
      for (int u = 0; u < D / 32; ++u) {
        uint32_t got[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          // round k: read from quad lane (c + k) & 3, which sends its
          // piece of block 4u + ((its c - k) & 3), i.e. of this thread's block
          const uint32_t send = pick4(w[4 * u], w[4 * u + 1], w[4 * u + 2], w[4 * u + 3],
                                      (c - k) & 3);
          got[k] = __shfl_sync(0xffffffffu, send, (lane & ~3) | ((c + k) & 3));
        }
        // got[k] is the piece of quad lane (c + k) & 3; piece q is got[(q - c) & 3]
        uint4 chunk;
        chunk.x = pick4(got[0], got[1], got[2], got[3], (0 - c) & 3);
        chunk.y = pick4(got[0], got[1], got[2], got[3], (1 - c) & 3);
        chunk.z = pick4(got[0], got[1], got[2], got[3], (2 - c) & 3);
        chunk.w = pick4(got[0], got[1], got[2], got[3], (3 - c) & 3);
        if (row < p.tq) *reinterpret_cast<uint4*>(O + (4 * u + c) * 8) = chunk;
      }
      if (c == 0 && row < p.tq)
        p.lse[(long long)t.bh * p.tq + row] = l[r] > 0.f ? (m[r] + log2f(l[r])) * kLn2 : kNegBig;
    }
  }
  if (cw == 0) hopper::named_sync(1, 256);  // the second warpgroup's last turn
}

template <int D>
int launch_bf16(const Params& p, int n, int h, int tq, int tk, cudaStream_t stream) {
  using hopper_host::encode_bf16_4d;
  CUtensorMap mq, mk, mv;
  const long long dq[4] = {D, tq, h, n}, dk[4] = {D, tk, h, n};
  const long long sq[3] = {p.q_st, p.q_sh, p.q_sn}, sk[3] = {p.k_st, p.k_sh, p.k_sn},
                  sv[3] = {p.v_st, p.v_sh, p.v_sn};
  int rc = encode_bf16_4d(&mq, p.q, dq, sq, 64, kBQ);
  if (rc == 0) rc = encode_bf16_4d(&mk, p.k, dk, sk, 64, kBK);
  if (rc == 0) rc = encode_bf16_4d(&mv, p.v, dk, sv, 64, kBK);
  if (rc != 0) return rc;
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_bf16<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, FwdSmem<D>::kBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int q_tiles = (tq + kBQ - 1) / kBQ, items = n * h * q_tiles;
  const int grid = items < sms ? items : sms;  // persistent: one block an SM
  flash_fwd_bf16<D><<<grid, kThreads, FwdSmem<D>::kBytes, stream>>>(mq, mk, mv, p, n * h,
                                                                    q_tiles);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------------------- f32 path
template <int D>
__global__ void __launch_bounds__(256) flash_fwd_f32(Params p) {
  constexpr int BQ = 64, BK = 32, G = 4, C = D / (4 * G), NT = 256;
  __shared__ __align__(16) float sK[BK * D];
  __shared__ __align__(16) float sV[BK * D];

  const Tile t = make_tile(p, BQ, blockIdx.y, gridDim.x - 1 - blockIdx.x);
  const int sub = threadIdx.x % G;  // this thread owns float4 chunks sub + G*c
  const int row = t.q0 + threadIdx.x / G;
  const float* Q = static_cast<const float*>(p.q) + t.n * p.q_sn + t.hh * p.q_sh;
  const float* K = static_cast<const float*>(p.k) + t.n * p.k_sn + t.hh * p.k_sh;
  const float* V = static_cast<const float*>(p.v) + t.n * p.v_sn + t.hh * p.v_sh;

  float4 qv[C], acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    qv[c] = row < p.tq ? *reinterpret_cast<const float4*>(
                             Q + (long long)row * p.q_st + (sub + G * c) * 4)
                       : make_float4(0.f, 0.f, 0.f, 0.f);
    acc[c] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const float sl2 = p.scale * kLog2e;
  float m = kNegBig, l = 0.f;

  for (int k0 = 0; k0 < t.k_end; k0 += BK) {
    for (int i = threadIdx.x; i < BK * D / 4; i += NT) {
      const int r = i / (D / 4), c = (i % (D / 4)) * 4;
      float4 kv = make_float4(0.f, 0.f, 0.f, 0.f), vv = kv;
      if (k0 + r < p.tk) {
        kv = *reinterpret_cast<const float4*>(K + (long long)(k0 + r) * p.k_st + c);
        vv = *reinterpret_cast<const float4*>(V + (long long)(k0 + r) * p.v_st + c);
      }
      *reinterpret_cast<float4*>(&sK[r * D + c]) = kv;
      *reinterpret_cast<float4*>(&sV[r * D + c]) = vv;
    }
    __syncthreads();
    for (int jj = 0; jj < BK; jj += 8) {
      float sc[8];
      float mx = m;
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const float* kr = &sK[(jj + u) * D];
        float dot = 0.f;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const float4 kk = *reinterpret_cast<const float4*>(kr + (sub + G * c) * 4);
          dot = fmaf(qv[c].x, kk.x, dot);
          dot = fmaf(qv[c].y, kk.y, dot);
          dot = fmaf(qv[c].z, kk.z, dot);
          dot = fmaf(qv[c].w, kk.w, dot);
        }
        dot += __shfl_xor_sync(0xffffffffu, dot, 1);
        dot += __shfl_xor_sync(0xffffffffu, dot, 2);
        const float x = allowed(p, t, row, k0 + jj + u) ? dot * sl2 : -INFINITY;
        sc[u] = x;
        mx = fmaxf(mx, x);
      }
      const float corr = exp2f(m - mx);
      m = mx;
      l *= corr;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        acc[c].x *= corr;
        acc[c].y *= corr;
        acc[c].z *= corr;
        acc[c].w *= corr;
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const float pu = exp2f(sc[u] - m);
        l += pu;
        const float* vr = &sV[(jj + u) * D];
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const float4 vv = *reinterpret_cast<const float4*>(vr + (sub + G * c) * 4);
          acc[c].x = fmaf(pu, vv.x, acc[c].x);
          acc[c].y = fmaf(pu, vv.y, acc[c].y);
          acc[c].z = fmaf(pu, vv.z, acc[c].z);
          acc[c].w = fmaf(pu, vv.w, acc[c].w);
        }
      }
    }
    __syncthreads();
  }

  if (row >= p.tq) return;
  const float inv = 1.f / fmaxf(l, 1e-30f);
  float* O = static_cast<float*>(p.o) + ((long long)t.bh * p.tq + row) * D;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    *reinterpret_cast<float4*>(O + (sub + G * c) * 4) =
        make_float4(acc[c].x * inv, acc[c].y * inv, acc[c].z * inv, acc[c].w * inv);
  }
  if (sub == 0)
    p.lse[(long long)t.bh * p.tq + row] =
        l > 0.f ? (m + log2f(l)) * kLn2 : kNegBig;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after launch
// (cudaErrorInvalidValue for a head dim other than 64 or 128, or strides a
// bf16 tensor map does not take).
extern "C" int bigdl_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* out, void* lse,
    const void* lengths, int dtype, int n, int h, int tq, int tk, int d,
    long long q_sn, long long q_sh, long long q_st, long long k_sn,
    long long k_sh, long long k_st, long long v_sn, long long v_sh,
    long long v_st, float scale, int causal, int mask_q, void* stream) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = out;
  p.lse = static_cast<float*>(lse);
  p.lengths = static_cast<const int*>(lengths);
  p.h = h;
  p.tq = tq;
  p.tk = tk;
  p.q_sn = q_sn; p.q_sh = q_sh; p.q_st = q_st;
  p.k_sn = k_sn; p.k_sh = k_sh; p.k_st = k_st;
  p.v_sn = v_sn; p.v_sh = v_sh; p.v_st = v_st;
  p.scale = scale;
  p.causal = causal;
  p.has_lengths = lengths != nullptr;
  p.mask_q = mask_q;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && d == 64) return launch_bf16<64>(p, n, h, tq, tk, s);
  if (dtype == 1 && d == 128) return launch_bf16<128>(p, n, h, tq, tk, s);
  const dim3 grid((tq + 63) / 64, n * h);
  if (dtype == 0 && d == 64)
    flash_fwd_f32<64><<<grid, 256, 0, s>>>(p);
  else if (dtype == 0 && d == 128)
    flash_fwd_f32<128><<<grid, 256, 0, s>>>(p);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
