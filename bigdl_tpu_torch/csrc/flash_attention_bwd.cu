// Flash-attention backward for Hopper (sm_90a): dQ and dK/dV, bound to
// Python through plain C entry points (ctypes; see
// bigdl_tpu_torch/ops/_build.py).
//
// Replaces: bigdl_tpu/ops/flash_attention.py::_dq_kernel and ::_dkv_kernel
// (the Pallas TPU kernels launched by _flash_bwd_impl). Same function: with
// the forward's per-row logsumexp `lse` (natural-log units) and
// delta = rowsum(dO * O) (computed by the wrapper, fp32),
//   P  = exp(S * scale - lse),  S = Q K^T            (masked entries: P = 0)
//   dS = P * (dO V^T - delta) * scale
//   dQ = dS K,  dK = dS^T Q,  dV = P^T dO
// with the forward's masks: causal aligned at the end (query row i sees keys
// j <= i + Tk - Tq), the per-sequence horizon kl = min(lengths[n], Tk),
// `mask_q` (rows with i + Tk - Tq >= kl get no gradient), and rows with no
// visible key get none. The exponent is clamped to <= 0 (the TPU kernel's
// clip in _bwd_masked_p). As on the TPU, P is rounded to dO's dtype before
// P^T dO, and dS to the operands' dtype before dS K and dS^T Q; everything
// else (accumulators, softmax bookkeeping) is fp32. No atomics: two runs give
// the same bits. The split into two kernels recomputes S and dP (7 products
// where the least work is 5); adding dQ from the dK/dV kernel would need
// atomics, whose order changes from run to run.
//
// Bound on this card, at the training shape (8, 8, 2048, 64) bf16 causal,
// ~1.34e8 visible (query, key) pairs: dQ runs 3 products (S, dP, dS K), ~5.2e10
// FLOP against ~85 MB of traffic; dK/dV 4 products (S^T, dP^T, P^T dO,
// dS^T Q), ~6.9e10 FLOP against ~102 MB. Both sit far above the H100's ~295
// FLOP/byte ridge, so both are bound by the tensor cores (~0.052 ms and
// ~0.070 ms at 989 TFLOP/s); beside them one exp2 a visible pair on the
// special-function units (~0.035 ms a kernel).
//
// The bf16 design (d = 64 or 128), the forward's (flash_attention.cu) turned
// around, its producer reused (flash_tma.cuh):
// - A persistent grid, one block an SM, walks work items longest first in a
//   snake order: dQ's items are (n*h, 128-row q tile), the late q tiles
//   first; dK/dV's are (n*h, 128-key tile), the early key tiles first. A
//   block is a producer warp and two consumer warpgroups of 64 rows (dQ:
//   query rows; dK/dV: keys); setmaxnreg 40 for the producer, 232 for them.
// - TMA: 4-D tensor maps over (d, T, H, N) from the caller's strides (the
//   LM's split_heads views go in without a copy), boxes of 128 rows, 128-byte
//   swizzle, zeros past T; one set of four maps (Q, K, V, dO) serves both
//   kernels of a call. The item's resident tiles (dQ: Q and dO; dK/dV: K and
//   V) are loaded once, as soon as the previous item's last product that
//   reads them has completed; the other pair is streamed in stages of 128
//   rows through a ring with full/empty mbarriers, from the first stage that
//   can see the item to its horizon (nothing else is loaded). dK/dV's
//   producer warp copies each stage's lse * log2(e) and delta beside it.
// - wgmma: the consumers take a stage in sub-tiles of 64 rows (dK/dV at
//   d = 128: 32, for registers). S and dP (dK/dV: S^T = K Q^T and dP^T =
//   V dO^T, rows = keys) with both operands in shared memory, K-major; the
//   second products with the A operand from registers (the accumulators
//   rounded to bf16, see hopper_common.cuh) and the B operand read in place,
//   MN-major: dQ += dS K reads the K tile that S read K-major, dV += P^T dO
//   and dK += dS^T Q read the dO and Q tiles that dP^T and S^T read.
// - Overlap: each round a warpgroup issues S, dP of sub-tile j and the
//   second products of sub-tile j-1 together, then computes sub-tile j's P
//   and dS while those run; the two warpgroups take turns to issue (named
//   barriers 1 and 2). The rounds are peeled so that no branch and no read
//   of an accumulator sits between a wgmma and its wait.
// - P and dS in registers: exp2 on the special-function unit; masks only on
//   sub-tiles that are not fully visible (a uniform branch), as compares
//   against each row's last visible key (dQ) or each key's first visible
//   row and the rows' end (dK/dV).
// - Epilogue: dQ, dK, dV rounded to bf16 and written from registers as
//   16-byte chunks after shuffles within each quad.
//
// float32 inputs (exact paths, not the training path) take CUDA-core (FMA)
// kernels: 4 threads per row, each owning a quarter of the head dim, one
// block per (64-row tile, n*h).

#include <math.h>

#include "flash_common.cuh"
#include "flash_tma.cuh"
#include "hopper_common.cuh"

namespace {

using namespace flash;

struct BwdParams {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;    // (N, H, Tq) contiguous, natural-log units
  const float* delta;  // (N, H, Tq) contiguous
  void* dq;            // (N, H, Tq, D) contiguous, q's dtype
  void* dk;            // (N, H, Tk, D) contiguous
  void* dv;            // (N, H, Tk, D) contiguous
  const int* lengths;  // (N,) or nullptr
  int h, tq, tk;
  long long q_sn, q_sh, q_st;  // element strides; the head dim is contiguous
  long long k_sn, k_sh, k_st;
  long long v_sn, v_sh, v_st;
  long long o_sn, o_sh, o_st;  // dO
  float scale;
  int causal, has_lengths, mask_q;
};

// Per-(n, h) geometry of a block.
struct Head {
  int n, hh, bh, co, kl;
  bool qmask;
};

__device__ inline Head make_head(const BwdParams& p) {
  Head g;
  g.bh = blockIdx.y;
  g.n = g.bh / p.h;
  g.hh = g.bh % p.h;
  g.co = p.tk - p.tq;
  g.kl = p.has_lengths ? min(p.lengths[g.n], p.tk) : p.tk;
  g.qmask = p.has_lengths && p.mask_q;
  return g;
}

__device__ inline bool allowed(const BwdParams& p, const Head& g, int row, int col) {
  return row < p.tq && col < g.kl && (!g.qmask || row + g.co < g.kl) &&
         (!p.causal || row + g.co >= col);
}

// Keys [0, k_end) are visible to at least one row of the q tile at q0.
__device__ inline int dq_k_end(const BwdParams& p, const Head& g, int q0, int bq) {
  int k_end = g.kl;
  if (p.causal) k_end = min(k_end, min(q0 + bq, p.tq) - 1 + g.co + 1);
  if (g.qmask && q0 + g.co >= g.kl) k_end = 0;
  return max(k_end, 0);
}

// Query rows [*begin, *end) may see a key of the k tile at k0; *begin is
// rounded down to a multiple of bq.
__device__ inline void dkv_q_range(const BwdParams& p, const Head& g, int k0, int bq,
                                   int* begin, int* end) {
  int b = 0, e = p.tq;
  if (p.causal) b = max(0, k0 - g.co);
  if (g.qmask) e = min(e, g.kl - g.co);
  if (k0 >= g.kl) e = 0;  // keys past the horizon get zero gradient
  *begin = (b / bq) * bq;
  *end = e;
}

// ------------------------------------------------------------------ bf16 path
using flash_tma::fast_exp2;
using flash_tma::kConsumerWarps;
using flash_tma::kHalf;
using flash_tma::kRows;
using flash_tma::kThreads;

// Tile sizes: a work item is 128 rows of the resident operand (64 a consumer
// warpgroup); the streamed operand comes in stages of 128 rows, taken by the
// consumers in sub-tiles of kSub rows. Registers of a consumer thread (fp32
// accumulators, the bf16 A operands of the previous sub-tile):
//   dQ:    S, dP kSub/2 each + dQ D/2 + dS kSub/4    (d 64, kSub 128: 192;
//          d 128, kSub 64: 144)
//   dK/dV: S^T, dP^T kSub/2 each + dK, dV D/2 each + P^T, dS^T kSub/4 each
//          (d 64, kSub 64: 160; d 128, kSub 32: 176)
// and the ring fills what shared memory is left (d 64: 4 stages of 32 KB;
// d 128: 2 of 64 KB, beside the 64 KB resident tiles).
template <int D>
struct DqCfg {
  static constexpr int kSub = D == 64 ? 128 : 64, kStages = D == 64 ? 4 : 2;
};

template <int D>
struct DkvCfg {
  static constexpr int kSub = D == 64 ? 64 : 32, kStages = D == 64 ? 4 : 2;
};

// Shared memory of one block, in bytes from a 1024-aligned base: the two
// resident tiles, kStages stages of two tiles each, kAux bytes a stage (dK/dV:
// lse * log2(e) and delta of the stage's 128 rows), then the mbarriers (full
// and empty a stage, the resident tiles' full and empty).
template <int D, int kStages, int kAux>
struct BwdSmem {
  static constexpr int kTile = flash_tma::tile_bytes<D>();
  static constexpr int kRes = 0;
  static constexpr int kStage = 2 * kTile;
  static constexpr int kRing = 2 * kTile;
  static constexpr int kAuxAt = kRing + kStages * kStage;
  static constexpr int kBar = kAuxAt + kStages * kAux;
  static constexpr int kBytes = kBar + 8 * (2 * kStages + 2) + 1024;  // + alignment slack
  static_assert(kBytes <= 232448, "more shared memory than a block may use");
};

// A work item's geometry: its head, the first row of its resident tiles
// (r0), its sub-tiles [j0, j1) of kSub streamed rows, the key horizon kl, the
// causal offset co = Tk - Tq, and (dK/dV) the end of the query rows that may
// see a key, q_end.
struct BwdItem {
  int n, hh, bh, r0, j0, j1, co, kl, q_end;
  bool qmask;
};

__device__ inline BwdItem item_head(const BwdParams& p, int bh) {
  BwdItem it{};
  it.bh = bh;
  it.n = bh / p.h;
  it.hh = bh % p.h;
  it.co = p.tk - p.tq;
  it.kl = p.has_lengths ? min(p.lengths[it.n], p.tk) : p.tk;
  it.qmask = p.has_lengths && p.mask_q;
  return it;
}

// dQ item i: q tile (q_tiles - 1 - i / nh) of head i % nh, so items run
// longest first under causal; its keys [0, k_end) are those at least one of
// its rows sees.
template <int kSub>
__device__ inline BwdItem dq_item(const BwdParams& p, int item, int nh, int q_tiles) {
  BwdItem it = item_head(p, item % nh);
  it.r0 = (q_tiles - 1 - item / nh) * kRows;
  int k_end = it.kl;
  if (p.causal) k_end = min(k_end, min(it.r0 + kRows, p.tq) - 1 + it.co + 1);
  if (it.qmask && it.r0 + it.co >= it.kl) k_end = 0;
  it.j0 = 0;
  it.j1 = (max(k_end, 0) + kSub - 1) / kSub;
  it.q_end = p.tq;
  return it;
}

// dK/dV item i: key tile i / nh of head i % nh (under causal the early key
// tiles see the most rows); its query rows [q_beg, q_end) are those that may
// see one of its keys. Keys at or past the horizon get zero gradient.
template <int kSub>
__device__ inline BwdItem dkv_item(const BwdParams& p, int item, int nh) {
  BwdItem it = item_head(p, item % nh);
  it.r0 = (item / nh) * kRows;
  int q_end = it.qmask ? min(p.tq, it.kl - it.co) : p.tq;
  if (it.r0 >= it.kl) q_end = 0;
  const int q_beg = p.causal ? max(0, it.r0 - it.co) : 0;
  it.q_end = q_end;
  it.j0 = q_beg / kSub;
  it.j1 = q_end > q_beg ? (q_end + kSub - 1) / kSub : it.j0;
  return it;
}

// The producer's view of an item: the stages that hold its sub-tiles.
template <int kSub>
__device__ inline flash_tma::Load load_of(const BwdItem& it) {
  const int s0 = it.j0 * kSub / kRows;
  return flash_tma::Load{it.n, it.hh, it.r0, s0, it.j1 > it.j0 ? (it.j1 - 1) * kSub / kRows + 1 : s0};
}

// dQ for one (n*h, 128-row q tile) work item per round of a persistent grid:
//   S = Q K^T, dP = dO V^T (wgmma, both operands in shared memory, K-major),
//   dS = P (dP - delta) scale in registers, dQ += dS K (wgmma, dS from
//   registers, K read in place as an MN-major operand).
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq_bf16(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      const __grid_constant__ CUtensorMap tm_o, BwdParams p, int nh,
                      int q_tiles) {
  constexpr int kSub = DqCfg<D>::kSub, kStages = DqCfg<D>::kStages, kSps = kRows / kSub;
  using L = BwdSmem<D, kStages, 0>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (hopper::smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t bar_full = base + L::kBar;
  const uint32_t bar_empty = bar_full + 8 * kStages;
  const uint32_t bar_res_full = bar_empty + 8 * kStages;
  const uint32_t bar_res_empty = bar_res_full + 8;
  const int n_items = nh * q_tiles;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(bar_full + 8 * s, 1);
      hopper::mbar_init(bar_empty + 8 * s, kConsumerWarps);
    }
    hopper::mbar_init(bar_res_full, 1);
    hopper::mbar_init(bar_res_empty, kConsumerWarps);
    hopper::mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---------------------------------------------------------- producer
    hopper::setmaxnreg_dec<40>();
    if (threadIdx.x >= 32) return;
    // Q and dO are resident; k/v stages of 128 keys are streamed up to k_end
    flash_tma::produce<D, 2, kStages, false>(
        &tm_q, &tm_o, &tm_k, &tm_v, base + L::kRes, base + L::kRing, L::kStage, bar_full,
        bar_empty, bar_res_full, bar_res_empty, n_items,
        [&](int item) { return load_of<kSub>(dq_item<kSub>(p, item, nh, q_tiles)); },
        [](int, int, const flash_tma::Load&) {});
    return;
  }

  // -------------------------------------------------------------- consumers
  hopper::setmaxnreg_inc<232>();
  const int cw = wg - 1;  // this warpgroup's 64 rows of an item start at 64 cw
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int quad = lane / 4, c2 = (lane % 4) * 2;
  const uint32_t q_w = base + L::kRes + cw * 64 * 128, o_w = q_w + L::kTile;
  const float sl2 = p.scale * kLog2e;  // exponents kept in base-2 units
  const int my_bar = 1 + cw, other_bar = 2 - cw;  // named barriers 1 and 2: turns to issue

  float s[kSub / 2], dp[kSub / 2], dq[D / 2];
  uint32_t pb[kSub / 16][4];  // dS of the previous sub-tile: A fragments of dS K
  float lse2[2], dl[2];  // this thread's rows' lse * log2(e) and delta * scale
  int kv = 0, nres = 0;  // stages and resident tiles consumed so far
  BwdItem it{};
  int s0 = 0, q0w = 0, row0 = 0;

  // ring position, stage address and row offset of sub-tile j
  auto pos = [&](int j) { return kv + j * kSub / kRows - s0; };
  auto tile_at = [&](int j) {
    return base + L::kRing + (pos(j) % kStages) * L::kStage + (j % kSps) * kSub * 128;
  };
  auto wait_full = [&](int j) {
    hopper::mbar_wait(bar_full + 8 * (pos(j) % kStages), (pos(j) / kStages) & 1);
  };
  auto turn_begin = [&]() {
    hopper::named_sync(my_bar, 256);
    hopper::fence_regs<kSub / 2>(s);
    hopper::fence_regs<kSub / 2>(dp);
    hopper::fence_regs<D / 2>(dq);
    hopper::fence_regs<kSub / 4>(&pb[0][0]);
    hopper::wgmma_fence();
  };
  auto issue_sdp = [&](int j) {
    const uint32_t kt = tile_at(j), vt = kt + L::kTile;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk / 4) * kHalf + (kk % 4) * 32;
      hopper::wgmma_ss<kSub>(s, hopper::desc_kmajor(q_w + off), hopper::desc_kmajor(kt + off),
                             kk > 0);
      hopper::wgmma_ss<kSub>(dp, hopper::desc_kmajor(o_w + off), hopper::desc_kmajor(vt + off),
                             kk > 0);
    }
    hopper::wgmma_commit();
  };
  auto issue_dq = [&](int j) {
    const uint32_t kt = tile_at(j);
#pragma unroll
    for (int kk = 0; kk < kSub / 16; ++kk)
      hopper::wgmma_rs<D>(dq, pb[kk], hopper::desc_mnmajor(kt + kk * 2048, kHalf));
    hopper::wgmma_commit();
  };
  // dS of sub-tile j into s (P rebuilt from lse, the exponent clamped to <= 0);
  // only sub-tiles that are not fully visible run the masked loop (a uniform
  // branch), with one compare an element against each row's last visible key.
  auto compute = [&](int j) {
    hopper::fence_regs<kSub / 2>(s);
    hopper::fence_regs<kSub / 2>(dp);
    const int k0 = j * kSub;
    if (k0 + kSub <= it.kl && (!p.causal || q0w + it.co >= k0 + kSub - 1) &&
        (!it.qmask || q0w + 63 + it.co < it.kl)) {
#pragma unroll
      for (int i = 0; i < kSub / 2; ++i) {
        const int r = (i >> 1) & 1;
        const float pe = fast_exp2(fminf(fmaf(s[i], sl2, -lse2[r]), 0.f));
        s[i] = pe * fmaf(dp[i], p.scale, -dl[r]);
      }
    } else {
      int last[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + 8 * r;
        int lim = it.kl - 1;
        if (p.causal) lim = min(lim, row + it.co);
        if (it.qmask && row + it.co >= it.kl) lim = -1;
        last[r] = lim - k0 - c2;
      }
#pragma unroll
      for (int i = 0; i < kSub / 2; ++i) {
        const int r = (i >> 1) & 1;
        float pe = fast_exp2(fminf(fmaf(s[i], sl2, -lse2[r]), 0.f));
        if ((i >> 2) * 8 + (i & 1) > last[r]) pe = 0.f;
        s[i] = pe * fmaf(dp[i], p.scale, -dl[r]);
      }
    }
  };
  // dS rounded to bf16: the accumulators of 8-key blocks 2kk, 2kk+1 are the A
  // fragment of k-step kk of dS K.
  auto pack = [&]() {
#pragma unroll
    for (int kk = 0; kk < kSub / 16; ++kk) {
      pb[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
      pb[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      pb[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      pb[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }
  };
  // After dS_j K_j completed: free the stage if j is its last sub-tile.
  auto release = [&](int j) {
    hopper::fence_regs<D / 2>(dq);
    hopper::fence_regs<kSub / 4>(&pb[0][0]);
    if (lane == 0 && (j == it.j1 - 1 || (j + 1) % kSps == 0))
      hopper::mbar_arrive(bar_empty + 8 * (pos(j) % kStages));
  };
  auto release_res = [&]() {
    if (lane == 0) hopper::mbar_arrive(bar_res_empty);
  };

  if (cw == 1) hopper::named_arrive(1, 256);  // the first warpgroup issues first
  for (int r = 0; r * gridDim.x < n_items; ++r) {
    const int item = flash_tma::item_of(r);
    if (item >= n_items) continue;
    it = dq_item<kSub>(p, item, nh, q_tiles);
    s0 = load_of<kSub>(it).s0;
    q0w = it.r0 + 64 * cw;
    row0 = q0w + warp * 16 + quad;  // this thread's rows: row0 and row0 + 8
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int row = row0 + 8 * rr;
      const long long at = (long long)it.bh * p.tq + row;
      lse2[rr] = row < p.tq ? p.lse[at] * kLog2e : 0.f;
      dl[rr] = row < p.tq ? p.delta[at] * p.scale : 0.f;
    }
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;

    const int j0 = it.j0, j1 = it.j1;
    if (j1 > j0) {
      hopper::mbar_wait(bar_res_full, nres & 1);
      // round 0: S_0 and dP_0 only
      wait_full(j0);
      turn_begin();
      issue_sdp(j0);
      hopper::named_arrive(other_bar, 256);
      hopper::wgmma_wait<0>();
      if (j1 - j0 == 1) release_res();
      compute(j0);
      pack();
      // rounds j0+1 .. j1-1: S_j, dP_j with dQ += dS_{j-1} K_{j-1}; sub-tile
      // j's dS runs under dS_{j-1} K_{j-1}
      for (int j = j0 + 1; j < j1; ++j) {
        wait_full(j);
        turn_begin();
        issue_sdp(j);
        issue_dq(j - 1);
        hopper::named_arrive(other_bar, 256);
        hopper::wgmma_wait<1>();
        if (j == j1 - 1) release_res();
        compute(j);
        hopper::wgmma_wait<0>();
        release(j - 1);
        pack();
      }
      // last round: the last dS K
      turn_begin();
      issue_dq(j1 - 1);
      hopper::named_arrive(other_bar, 256);
      hopper::wgmma_wait<0>();
      release(j1 - 1);
      kv += load_of<kSub>(it).s1 - s0;
      ++nres;
    }

    bf16* dQ = static_cast<bf16*>(p.dq);
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int row = row0 + 8 * rr;
      flash_tma::store_row_bf16<D>(dq, rr, 1.f, dQ + ((long long)it.bh * p.tq + row) * D,
                                   row < p.tq);
    }
  }
  if (cw == 0) hopper::named_sync(1, 256);  // the second warpgroup's last turn
}

// dK/dV for one (n*h, 128-key tile) work item per round of a persistent grid:
//   S^T = K Q^T, dP^T = V dO^T (wgmma SS, K-major; rows = keys),
//   P^T = exp2(min(S^T scale log2e - lse log2e, 0)), dS^T = P^T (dP^T - delta)
//   scale in registers, dV += P^T dO and dK += dS^T Q (wgmma RS: the A
//   operands from registers, dO and Q read in place as MN-major operands, the
//   same swizzled bits that S^T and dP^T read K-major).
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkv_bf16(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       const __grid_constant__ CUtensorMap tm_o, BwdParams p, int nh,
                       int k_tiles) {
  constexpr int kSub = DkvCfg<D>::kSub, kStages = DkvCfg<D>::kStages, kSps = kRows / kSub;
  constexpr int kAux = 2 * kRows * 4;  // lse * log2(e), then delta * scale, of a stage's rows
  using L = BwdSmem<D, kStages, kAux>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (hopper::smem_u32(smem_raw) + 1023) & ~1023u;
  float* const aux = reinterpret_cast<float*>(smem_raw + (base - hopper::smem_u32(smem_raw)) +
                                              L::kAuxAt);
  const uint32_t bar_full = base + L::kBar;
  const uint32_t bar_empty = bar_full + 8 * kStages;
  const uint32_t bar_res_full = bar_empty + 8 * kStages;
  const uint32_t bar_res_empty = bar_res_full + 8;
  const int n_items = nh * k_tiles;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(bar_full + 8 * s, 32);  // the producer warp's lanes
      hopper::mbar_init(bar_empty + 8 * s, kConsumerWarps);
    }
    hopper::mbar_init(bar_res_full, 1);
    hopper::mbar_init(bar_res_empty, kConsumerWarps);
    hopper::mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---------------------------------------------------------- producer
    hopper::setmaxnreg_dec<40>();
    if (threadIdx.x >= 32) return;
    // K and V are resident; q/dO stages of 128 rows are streamed, each with
    // its rows' lse * log2(e) and delta * scale (zero past Tq), copied by the
    // warp
    flash_tma::produce<D, 2, kStages, true>(
        &tm_k, &tm_v, &tm_q, &tm_o, base + L::kRes, base + L::kRing, L::kStage, bar_full,
        bar_empty, bar_res_full, bar_res_empty, n_items,
        [&](int item) { return load_of<kSub>(dkv_item<kSub>(p, item, nh)); },
        [&](int slot, int s, const flash_tma::Load& ld) {
          float* a = aux + slot * (kAux / 4);
          const long long at = ((long long)ld.n * p.h + ld.hh) * p.tq;
          for (int i = threadIdx.x % 32; i < kRows; i += 32) {
            const int row = s * kRows + i;
            a[i] = row < p.tq ? p.lse[at + row] * kLog2e : 0.f;
            a[kRows + i] = row < p.tq ? p.delta[at + row] * p.scale : 0.f;
          }
        });
    return;
  }

  // -------------------------------------------------------------- consumers
  hopper::setmaxnreg_inc<232>();
  const int cw = wg - 1;  // this warpgroup's 64 keys of an item start at 64 cw
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int quad = lane / 4, c2 = (lane % 4) * 2;
  const uint32_t k_w = base + L::kRes + cw * 64 * 128, v_w = k_w + L::kTile;
  const float sl2 = p.scale * kLog2e;
  const int my_bar = 1 + cw, other_bar = 2 - cw;

  float st[kSub / 2], dpt[kSub / 2], dk[D / 2], dv[D / 2];
  uint32_t pa[kSub / 16][4], da[kSub / 16][4];  // P^T and dS^T of the previous sub-tile
  int kv = 0, nres = 0;
  BwdItem it{};
  int s0 = 0, kw0 = 0, key0 = 0;

  auto pos = [&](int j) { return kv + j * kSub / kRows - s0; };
  auto tile_at = [&](int j) {
    return base + L::kRing + (pos(j) % kStages) * L::kStage + (j % kSps) * kSub * 128;
  };
  auto wait_full = [&](int j) {
    hopper::mbar_wait(bar_full + 8 * (pos(j) % kStages), (pos(j) / kStages) & 1);
  };
  auto turn_begin = [&]() {
    hopper::named_sync(my_bar, 256);
    hopper::fence_regs<kSub / 2>(st);
    hopper::fence_regs<kSub / 2>(dpt);
    hopper::fence_regs<D / 2>(dk);
    hopper::fence_regs<D / 2>(dv);
    hopper::fence_regs<kSub / 4>(&pa[0][0]);
    hopper::fence_regs<kSub / 4>(&da[0][0]);
    hopper::wgmma_fence();
  };
  auto issue_sdp = [&](int j) {
    const uint32_t qt = tile_at(j), ot = qt + L::kTile;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk / 4) * kHalf + (kk % 4) * 32;
      hopper::wgmma_ss<kSub>(st, hopper::desc_kmajor(k_w + off), hopper::desc_kmajor(qt + off),
                             kk > 0);
      hopper::wgmma_ss<kSub>(dpt, hopper::desc_kmajor(v_w + off), hopper::desc_kmajor(ot + off),
                             kk > 0);
    }
    hopper::wgmma_commit();
  };
  auto issue_dkv = [&](int j) {
    const uint32_t qt = tile_at(j), ot = qt + L::kTile;
#pragma unroll
    for (int kk = 0; kk < kSub / 16; ++kk) {
      hopper::wgmma_rs<D>(dv, pa[kk], hopper::desc_mnmajor(ot + kk * 2048, kHalf));
      hopper::wgmma_rs<D>(dk, da[kk], hopper::desc_mnmajor(qt + kk * 2048, kHalf));
    }
    hopper::wgmma_commit();
  };
  // P^T into st and dS^T into dpt for sub-tile j; lse and delta index the
  // columns (query rows). Only sub-tiles that are not fully visible run the
  // masked loop, where a key sees the rows from its first visible one
  // (causal) up to q_end.
  auto compute = [&](int j) {
    hopper::fence_regs<kSub / 2>(st);
    hopper::fence_regs<kSub / 2>(dpt);
    const int qs = j * kSub;
    const float* la = aux + (pos(j) % kStages) * (kAux / 4) + (j % kSps) * kSub + c2;
    if (kw0 + 64 <= it.kl && qs + kSub <= it.q_end && (!p.causal || qs + it.co >= kw0 + 63)) {
#pragma unroll
      for (int jj = 0; jj < kSub / 8; ++jj) {
        const float2 l = *reinterpret_cast<const float2*>(la + 8 * jj);
        const float2 d = *reinterpret_cast<const float2*>(la + kRows + 8 * jj);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * jj + e;
          const float pe = fast_exp2(fminf(fmaf(st[i], sl2, -((e & 1) ? l.y : l.x)), 0.f));
          st[i] = pe;
          dpt[i] = pe * fmaf(dpt[i], p.scale, -((e & 1) ? d.y : d.x));
        }
      }
    } else {
      // this thread's columns are qs + c2 + 8 jj + (e & 1): offsets o = 8 jj +
      // (e & 1) in [lo[r], hi] are visible to key key0 + 8 r
      int lo[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int key = key0 + 8 * r;
        const int first = key >= it.kl ? (1 << 30) : (p.causal ? key - it.co : -(1 << 30));
        lo[r] = max(first, -(1 << 29)) - qs - c2;
      }
      const int hi = it.q_end - 1 - qs - c2;
#pragma unroll
      for (int jj = 0; jj < kSub / 8; ++jj) {
        const float2 l = *reinterpret_cast<const float2*>(la + 8 * jj);
        const float2 d = *reinterpret_cast<const float2*>(la + kRows + 8 * jj);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * jj + e, o = 8 * jj + (e & 1);
          float pe = fast_exp2(fminf(fmaf(st[i], sl2, -((e & 1) ? l.y : l.x)), 0.f));
          if (o < lo[e >> 1] || o > hi) pe = 0.f;
          st[i] = pe;
          dpt[i] = pe * fmaf(dpt[i], p.scale, -((e & 1) ? d.y : d.x));
        }
      }
    }
  };
  // P^T and dS^T rounded to bf16 A fragments (P to dO's dtype, dS to Q's).
  auto pack = [&]() {
#pragma unroll
    for (int kk = 0; kk < kSub / 16; ++kk) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        pa[kk][e] = pack_bf16(st[8 * kk + 2 * e], st[8 * kk + 2 * e + 1]);
        da[kk][e] = pack_bf16(dpt[8 * kk + 2 * e], dpt[8 * kk + 2 * e + 1]);
      }
    }
  };
  auto release = [&](int j) {
    hopper::fence_regs<D / 2>(dk);
    hopper::fence_regs<D / 2>(dv);
    hopper::fence_regs<kSub / 4>(&pa[0][0]);
    hopper::fence_regs<kSub / 4>(&da[0][0]);
    if (lane == 0 && (j == it.j1 - 1 || (j + 1) % kSps == 0))
      hopper::mbar_arrive(bar_empty + 8 * (pos(j) % kStages));
  };
  auto release_res = [&]() {
    if (lane == 0) hopper::mbar_arrive(bar_res_empty);
  };

  if (cw == 1) hopper::named_arrive(1, 256);
  for (int r = 0; r * gridDim.x < n_items; ++r) {
    const int item = flash_tma::item_of(r);
    if (item >= n_items) continue;
    it = dkv_item<kSub>(p, item, nh);
    s0 = load_of<kSub>(it).s0;
    kw0 = it.r0 + 64 * cw;
    key0 = kw0 + warp * 16 + quad;  // this thread's keys: key0 and key0 + 8
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;

    const int j0 = it.j0, j1 = it.j1;
    if (j1 > j0) {
      hopper::mbar_wait(bar_res_full, nres & 1);
      wait_full(j0);
      turn_begin();
      issue_sdp(j0);
      hopper::named_arrive(other_bar, 256);
      hopper::wgmma_wait<0>();
      if (j1 - j0 == 1) release_res();
      compute(j0);
      pack();
      for (int j = j0 + 1; j < j1; ++j) {
        wait_full(j);
        turn_begin();
        issue_sdp(j);
        issue_dkv(j - 1);
        hopper::named_arrive(other_bar, 256);
        hopper::wgmma_wait<1>();
        if (j == j1 - 1) release_res();
        compute(j);
        hopper::wgmma_wait<0>();
        release(j - 1);
        pack();
      }
      turn_begin();
      issue_dkv(j1 - 1);
      hopper::named_arrive(other_bar, 256);
      hopper::wgmma_wait<0>();
      release(j1 - 1);
      kv += load_of<kSub>(it).s1 - s0;
      ++nres;
    }

    bf16* dK = static_cast<bf16*>(p.dk);
    bf16* dV = static_cast<bf16*>(p.dv);
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int key = key0 + 8 * rr;
      const long long at = ((long long)it.bh * p.tk + key) * D;
      flash_tma::store_row_bf16<D>(dk, rr, 1.f, dK + at, key < p.tk);
      flash_tma::store_row_bf16<D>(dv, rr, 1.f, dV + at, key < p.tk);
    }
  }
  if (cw == 0) hopper::named_sync(1, 256);
}

// Encodes the four tensor maps (Q, K, V, dO: one set for both kernels) and
// launches dQ and/or dK/dV on the persistent grid.
template <int D>
int launch_bwd_bf16(const BwdParams& p, int n, bool dq, bool dkv, cudaStream_t stream) {
  using flash_tma::encode_rows;
  CUtensorMap mq, mk, mv, mo;
  int rc = encode_rows<D>(&mq, p.q, n, p.h, p.tq, p.q_sn, p.q_sh, p.q_st);
  if (rc == 0) rc = encode_rows<D>(&mk, p.k, n, p.h, p.tk, p.k_sn, p.k_sh, p.k_st);
  if (rc == 0) rc = encode_rows<D>(&mv, p.v, n, p.h, p.tk, p.v_sn, p.v_sh, p.v_st);
  if (rc == 0) rc = encode_rows<D>(&mo, p.dout, n, p.h, p.tq, p.o_sn, p.o_sh, p.o_st);
  if (rc != 0) return rc;
  const int nh = n * p.h;
  if (dq) {
    using L = BwdSmem<D, DqCfg<D>::kStages, 0>;
    static const cudaError_t attr = cudaFuncSetAttribute(
        flash_bwd_dq_bf16<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
    if (attr != cudaSuccess) return static_cast<int>(attr);
    const int q_tiles = (p.tq + kRows - 1) / kRows;
    flash_bwd_dq_bf16<D><<<flash_tma::persistent_grid(nh * q_tiles), kThreads, L::kBytes,
                           stream>>>(mq, mk, mv, mo, p, nh, q_tiles);
    rc = static_cast<int>(cudaGetLastError());
    if (rc != 0) return rc;
  }
  if (dkv) {
    using L = BwdSmem<D, DkvCfg<D>::kStages, 2 * kRows * 4>;
    static const cudaError_t attr = cudaFuncSetAttribute(
        flash_bwd_dkv_bf16<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
    if (attr != cudaSuccess) return static_cast<int>(attr);
    const int k_tiles = (p.tk + kRows - 1) / kRows;
    flash_bwd_dkv_bf16<D><<<flash_tma::persistent_grid(nh * k_tiles), kThreads, L::kBytes,
                            stream>>>(mq, mk, mv, mo, p, nh, k_tiles);
    rc = static_cast<int>(cudaGetLastError());
  }
  return rc;
}

// ------------------------------------------------------------------- f32 path
__device__ inline float dot4(const float4& a, const float4& b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ inline void axpy4(float4& y, float a, const float4& x) {
  y.x = fmaf(a, x.x, y.x);
  y.y = fmaf(a, x.y, y.y);
  y.z = fmaf(a, x.z, y.z);
  y.w = fmaf(a, x.w, y.w);
}

// Sum over the G = 4 threads that share a row.
__device__ inline float sum4(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Copy rows [r0, r0 + ROWS) of a (rows, D) strided f32 matrix into shared
// memory (dense, pitch D), zero-filling rows past `rows`.
template <int ROWS, int D, int NT>
__device__ inline void load_rows_f32(float* s, const float* g, int r0, int rows,
                                     long long st) {
  for (int i = threadIdx.x; i < ROWS * D / 4; i += NT) {
    const int r = i / (D / 4), c = (i % (D / 4)) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < rows)
      val = *reinterpret_cast<const float4*>(g + (long long)(r0 + r) * st + c);
    *reinterpret_cast<float4*>(&s[r * D + c]) = val;
  }
}

// dQ: 4 threads per query row, 64 rows per block, 32-key tiles.
template <int D>
__global__ void __launch_bounds__(256) flash_bwd_dq_f32(BwdParams p) {
  constexpr int BQ = 64, BK = 32, G = 4, C = D / (4 * G), NT = 256;
  __shared__ __align__(16) float sK[BK * D];
  __shared__ __align__(16) float sV[BK * D];

  const Head g = make_head(p);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int k_end = dq_k_end(p, g, q0, BQ);
  const int sub = threadIdx.x % G;  // this thread owns float4 chunks sub + G*c
  const int row = q0 + threadIdx.x / G;
  const float* Q = static_cast<const float*>(p.q) + g.n * p.q_sn + g.hh * p.q_sh;
  const float* K = static_cast<const float*>(p.k) + g.n * p.k_sn + g.hh * p.k_sh;
  const float* V = static_cast<const float*>(p.v) + g.n * p.v_sn + g.hh * p.v_sh;
  const float* O = static_cast<const float*>(p.dout) + g.n * p.o_sn + g.hh * p.o_sh;

  float4 qv[C], ov[C], acc[C];
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int col = (sub + G * c) * 4;
    qv[c] = row < p.tq ? *reinterpret_cast<const float4*>(Q + (long long)row * p.q_st + col) : zero;
    ov[c] = row < p.tq ? *reinterpret_cast<const float4*>(O + (long long)row * p.o_st + col) : zero;
    acc[c] = zero;
  }
  const long long ri = (long long)g.bh * p.tq + row;
  const float lse = row < p.tq ? p.lse[ri] : 0.f;
  const float dlt = row < p.tq ? p.delta[ri] : 0.f;

  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();
    load_rows_f32<BK, D, NT>(sK, K, k0, p.tk, p.k_st);
    load_rows_f32<BK, D, NT>(sV, V, k0, p.tk, p.v_st);
    __syncthreads();
    for (int u = 0; u < BK; ++u) {
      const float4* kr = reinterpret_cast<const float4*>(&sK[u * D]);
      const float4* vr = reinterpret_cast<const float4*>(&sV[u * D]);
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        s = dot4(qv[c], kr[sub + G * c], s);
        dp = dot4(ov[c], vr[sub + G * c], dp);
      }
      s = sum4(s);
      dp = sum4(dp);
      const float pe = allowed(p, g, row, k0 + u) ? expf(fminf(s * p.scale - lse, 0.f)) : 0.f;
      const float ds = pe * (dp - dlt) * p.scale;
#pragma unroll
      for (int c = 0; c < C; ++c) axpy4(acc[c], ds, kr[sub + G * c]);
    }
  }

  if (row >= p.tq) return;
  float* dQ = static_cast<float*>(p.dq) + ((long long)g.bh * p.tq + row) * D;
#pragma unroll
  for (int c = 0; c < C; ++c) *reinterpret_cast<float4*>(dQ + (sub + G * c) * 4) = acc[c];
}

// dK/dV: 4 threads per key, 64 keys per block, 32-row q tiles.
template <int D>
__global__ void __launch_bounds__(256) flash_bwd_dkv_f32(BwdParams p) {
  constexpr int BK = 64, BQ = 32, G = 4, C = D / (4 * G), NT = 256;
  __shared__ __align__(16) float sQ[BQ * D];
  __shared__ __align__(16) float sO[BQ * D];
  __shared__ float sL[BQ], sD[BQ];

  const Head g = make_head(p);
  const int k0 = blockIdx.x * BK;
  int q_begin, q_end;
  dkv_q_range(p, g, k0, BQ, &q_begin, &q_end);
  const int sub = threadIdx.x % G;
  const int key = k0 + threadIdx.x / G;
  const float* Q = static_cast<const float*>(p.q) + g.n * p.q_sn + g.hh * p.q_sh;
  const float* K = static_cast<const float*>(p.k) + g.n * p.k_sn + g.hh * p.k_sh;
  const float* V = static_cast<const float*>(p.v) + g.n * p.v_sn + g.hh * p.v_sh;
  const float* O = static_cast<const float*>(p.dout) + g.n * p.o_sn + g.hh * p.o_sh;
  const float* LSE = p.lse + (long long)g.bh * p.tq;
  const float* DLT = p.delta + (long long)g.bh * p.tq;

  float4 kv[C], vv[C], dk[C], dv[C];
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int col = (sub + G * c) * 4;
    kv[c] = key < p.tk ? *reinterpret_cast<const float4*>(K + (long long)key * p.k_st + col) : zero;
    vv[c] = key < p.tk ? *reinterpret_cast<const float4*>(V + (long long)key * p.v_st + col) : zero;
    dk[c] = dv[c] = zero;
  }

  for (int q0 = q_begin; q0 < q_end; q0 += BQ) {
    __syncthreads();
    load_rows_f32<BQ, D, NT>(sQ, Q, q0, p.tq, p.q_st);
    load_rows_f32<BQ, D, NT>(sO, O, q0, p.tq, p.o_st);
    for (int i = threadIdx.x; i < BQ; i += NT) {
      const bool in = q0 + i < p.tq;
      sL[i] = in ? LSE[q0 + i] : 0.f;
      sD[i] = in ? DLT[q0 + i] : 0.f;
    }
    __syncthreads();
    for (int u = 0; u < BQ; ++u) {
      const float4* qr = reinterpret_cast<const float4*>(&sQ[u * D]);
      const float4* orow = reinterpret_cast<const float4*>(&sO[u * D]);
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        s = dot4(kv[c], qr[sub + G * c], s);
        dp = dot4(vv[c], orow[sub + G * c], dp);
      }
      s = sum4(s);
      dp = sum4(dp);
      const float pe =
          allowed(p, g, q0 + u, key) ? expf(fminf(s * p.scale - sL[u], 0.f)) : 0.f;
      const float ds = pe * (dp - sD[u]) * p.scale;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        axpy4(dv[c], pe, orow[sub + G * c]);
        axpy4(dk[c], ds, qr[sub + G * c]);
      }
    }
  }

  if (key >= p.tk) return;
  const long long at = ((long long)g.bh * p.tk + key) * D;
  float* dK = static_cast<float*>(p.dk) + at;
  float* dV = static_cast<float*>(p.dv) + at;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    *reinterpret_cast<float4*>(dK + (sub + G * c) * 4) = dk[c];
    *reinterpret_cast<float4*>(dV + (sub + G * c) * 4) = dv[c];
  }
}

// Launch a kernel that takes `smem` bytes of dynamic shared memory (above
// 48 KB only after raising the kernel's limit).
template <typename Kernel>
int launch(Kernel kernel, dim3 grid, int threads, int smem, cudaStream_t s,
           const BwdParams& p) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<grid, threads, smem, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

BwdParams make_params(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* delta, const void* lengths,
                      int h, int tq, int tk, long long q_sn, long long q_sh,
                      long long q_st, long long k_sn, long long k_sh,
                      long long k_st, long long v_sn, long long v_sh,
                      long long v_st, long long o_sn, long long o_sh,
                      long long o_st, float scale, int causal, int mask_q) {
  BwdParams p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.dq = p.dk = p.dv = nullptr;
  p.lengths = static_cast<const int*>(lengths);
  p.h = h;
  p.tq = tq;
  p.tk = tk;
  p.q_sn = q_sn; p.q_sh = q_sh; p.q_st = q_st;
  p.k_sn = k_sn; p.k_sh = k_sh; p.k_st = k_st;
  p.v_sn = v_sn; p.v_sh = v_sh; p.v_st = v_st;
  p.o_sn = o_sn; p.o_sh = o_sh; p.o_st = o_st;
  p.scale = scale;
  p.causal = causal;
  p.has_lengths = lengths != nullptr;
  p.mask_q = mask_q;
  return p;
}

}  // namespace

#define BWD_ARGS                                                               \
  const void *q, const void *k, const void *v, const void *dout,              \
      const void *lse, const void *delta

#define BWD_TAIL                                                               \
  const void *lengths, int dtype, int n, int h, int tq, int tk, int d,        \
      long long q_sn, long long q_sh, long long q_st, long long k_sn,         \
      long long k_sh, long long k_st, long long v_sn, long long v_sh,         \
      long long v_st, long long o_sn, long long o_sh, long long o_st,         \
      float scale, int causal, int mask_q, void *stream

#define BWD_PARAMS                                                             \
  make_params(q, k, v, dout, lse, delta, lengths, h, tq, tk, q_sn, q_sh, q_st, \
              k_sn, k_sh, k_st, v_sn, v_sh, v_st, o_sn, o_sh, o_st, scale,     \
              causal, mask_q)

// dtype: 0 = float32, 1 = bfloat16. Each returns cudaGetLastError() after its
// launches (cudaErrorInvalidValue for a head dim other than 64 or 128, or
// strides a bf16 tensor map does not take). bigdl_flash_attention_bwd
// launches both kernels (dQ first) with one set of tensor maps;
// bigdl_flash_attention_bwd_dq and _dkv launch one each.
namespace {

int launch_bwd(BwdParams p, int dtype, int n, int d, bool dq, bool dkv, cudaStream_t s) {
  if (dtype == 1 && d == 64) return launch_bwd_bf16<64>(p, n, dq, dkv, s);
  if (dtype == 1 && d == 128) return launch_bwd_bf16<128>(p, n, dq, dkv, s);
  if (dtype != 0 || (d != 64 && d != 128)) return static_cast<int>(cudaErrorInvalidValue);
  int rc = 0;
  if (dq) {
    const dim3 grid((p.tq + 63) / 64, n * p.h);
    rc = d == 64 ? launch(flash_bwd_dq_f32<64>, grid, 256, 0, s, p)
                 : launch(flash_bwd_dq_f32<128>, grid, 256, 0, s, p);
    if (rc != 0) return rc;
  }
  if (dkv) {
    const dim3 grid((p.tk + 63) / 64, n * p.h);
    rc = d == 64 ? launch(flash_bwd_dkv_f32<64>, grid, 256, 0, s, p)
                 : launch(flash_bwd_dkv_f32<128>, grid, 256, 0, s, p);
  }
  return rc;
}

}  // namespace

extern "C" int bigdl_flash_attention_bwd(BWD_ARGS, void* dq, void* dk, void* dv, BWD_TAIL) {
  BwdParams p = BWD_PARAMS;
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  return launch_bwd(p, dtype, n, d, true, true, static_cast<cudaStream_t>(stream));
}

extern "C" int bigdl_flash_attention_bwd_dq(BWD_ARGS, void* dq, BWD_TAIL) {
  BwdParams p = BWD_PARAMS;
  p.dq = dq;
  return launch_bwd(p, dtype, n, d, true, false, static_cast<cudaStream_t>(stream));
}

extern "C" int bigdl_flash_attention_bwd_dkv(BWD_ARGS, void* dk, void* dv, BWD_TAIL) {
  BwdParams p = BWD_PARAMS;
  p.dk = dk;
  p.dv = dv;
  return launch_bwd(p, dtype, n, d, false, true, static_cast<cudaStream_t>(stream));
}
