// Flash-attention backward for Hopper (sm_90a): dQ and dK/dV, bound to
// Python through two plain C entry points (ctypes; see
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
// else (accumulators, softmax bookkeeping) is fp32.
//
// Bound on this card, at the training shape (8, 8, 2048, 64) bf16 causal,
// ~1.34e8 visible (query, key) pairs: dQ runs 3 products (S, dP, dS K), ~5.2e10
// FLOP against ~85 MB of traffic; dK/dV 4 products (S^T, dP^T, P^T dO,
// dS^T Q), ~6.9e10 FLOP against ~102 MB. Both sit far above the H100's ~295
// FLOP/byte ridge, so both are bound by the tensor cores (~0.052 ms and
// ~0.070 ms at 989 TFLOP/s; the split recomputes S and dP, the backward's
// least work of five products is ~0.087 ms for the pair). What the design
// does about it: every product runs on the tensor cores (mma.sync m16n8k16,
// bf16 in, fp32 accumulate); P and dS never leave registers (dK/dV computes
// S^T = K Q^T, rows = keys, so P^T and dS^T come out in the accumulator
// layout that is the A operand of the next product); tiles past the causal
// or `lengths` horizon are never loaded. Not done yet (later work): wgmma,
// TMA/cp.async pipelining, ldmatrix, register-resident A operands.
//
// The TPU kernels' sequential-grid accumulators in VMEM are not carried
// over: here one thread block owns one (n*h, 64-row q tile) for dQ, or one
// (n*h, 64-key k tile) for dK/dV, and loops over the other axis itself with
// its accumulators in registers. No atomics: two runs give the same bits.
//
// float32 inputs (exact paths, not the training path) take CUDA-core (FMA)
// kernels: 4 threads per row, each owning a quarter of the head dim.

#include <math.h>

#include "flash_common.cuh"

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

// Every (row, col) of the (bq x bk) tile at (q0, k0) is visible.
__device__ inline bool tile_full(const BwdParams& p, const Head& g, int q0, int bq,
                                 int k0, int bk) {
  return q0 + bq <= p.tq && k0 + bk <= g.kl &&
         (!p.causal || q0 + g.co >= k0 + bk - 1) &&
         (!g.qmask || q0 + bq - 1 + g.co < g.kl);
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
// dQ: one block (4 warps, 16 query rows each) per (n*h, 64-row q tile).
template <int D>
__global__ void __launch_bounds__(128) flash_bwd_dq_bf16(BwdParams p) {
  constexpr int BQ = 64, BK = 64, LD = D + 8, NT = 128;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sO = sQ + BQ * LD;  // dO
  bf16* sK = sO + BQ * LD;
  bf16* sV = sK + BK * LD;

  const Head g = make_head(p);
  // causal tiles late in the sequence carry the most work: start them first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int k_end = dq_k_end(p, g, q0, BQ);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int quad = lane / 4, c2 = (lane % 4) * 2;
  const bf16* Q = static_cast<const bf16*>(p.q) + g.n * p.q_sn + g.hh * p.q_sh;
  const bf16* K = static_cast<const bf16*>(p.k) + g.n * p.k_sn + g.hh * p.k_sh;
  const bf16* V = static_cast<const bf16*>(p.v) + g.n * p.v_sn + g.hh * p.v_sh;
  const bf16* O = static_cast<const bf16*>(p.dout) + g.n * p.o_sn + g.hh * p.o_sh;
  load_rows_bf16<BQ, D, LD, NT>(sQ, Q, q0, p.tq, p.q_st);
  load_rows_bf16<BQ, D, LD, NT>(sO, O, q0, p.tq, p.o_st);

  // this thread's two query rows: row0 and row0 + 8
  const int row0 = q0 + warp * 16 + quad;
  float lse2[2], dlt[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    const long long i = (long long)g.bh * p.tq + row;
    lse2[r] = row < p.tq ? p.lse[i] * kLog2e : 0.f;
    dlt[r] = row < p.tq ? p.delta[i] : 0.f;
  }
  const float sl2 = p.scale * kLog2e;  // exponents kept in base-2 units
  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();  // the previous tile is no longer read
    load_rows_bf16<BK, D, LD, NT>(sK, K, k0, p.tk, p.k_st);
    load_rows_bf16<BK, D, LD, NT>(sV, V, k0, p.tk, p.v_st);
    __syncthreads();

    // S = Q K^T and dP = dO V^T for this warp's 16 rows x 64 keys
    float s[BK / 8][4], dp[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = dp[j][0] = dp[j][1] = dp[j][2] =
          dp[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t qa[4], oa[4];
      a_frag<LD>(qa, sQ, warp * 16 + quad, kk * 16 + c2);
      a_frag<LD>(oa, sO, warp * 16 + quad, kk * 16 + c2);
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        const bf16* kr = &sK[(j * 8 + quad) * LD + kk * 16 + c2];
        mma_bf16(s[j], qa, *reinterpret_cast<const uint32_t*>(kr),
                 *reinterpret_cast<const uint32_t*>(kr + 8));
        const bf16* vr = &sV[(j * 8 + quad) * LD + kk * 16 + c2];
        mma_bf16(dp[j], oa, *reinterpret_cast<const uint32_t*>(vr),
                 *reinterpret_cast<const uint32_t*>(vr + 8));
      }
    }

    // dS = P (dP - delta) scale, into s
    const bool full = tile_full(p, g, q0, BQ, k0, BK);
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        float pe = 0.f;
        if (full || allowed(p, g, row0 + 8 * r, k0 + j * 8 + c2 + (e & 1)))
          pe = exp2f(fminf(s[j][e] * sl2 - lse2[r], 0.f));
        s[j][e] = pe * (dp[j][e] - dlt[r]) * p.scale;
      }
    }

    // dQ += dS K: the dS accumulators are the A fragments (rounded to bf16)
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const bf16* k0p = &sK[(kk * 16 + c2) * LD + quad];
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        const bf16* kp = k0p + i * 8;
        mma_bf16(acc[i], a, pack_bf16_raw(kp[0], kp[LD]),
                 pack_bf16_raw(kp[8 * LD], kp[9 * LD]));
      }
    }
  }

  bf16* dQ = static_cast<bf16*>(p.dq) + (long long)g.bh * p.tq * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= p.tq) continue;
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
      *reinterpret_cast<uint32_t*>(&dQ[(long long)row * D + i * 8 + c2]) =
          pack_bf16(acc[i][2 * r], acc[i][2 * r + 1]);
  }
}

// dK/dV: one block (4 warps, 16 keys each) per (n*h, 64-key k tile), looping
// over BQ-row q tiles. S^T = K Q^T keeps keys on the accumulator rows.
template <int D, int BQ>
__global__ void __launch_bounds__(128) flash_bwd_dkv_bf16(BwdParams p) {
  constexpr int BK = 64, LD = D + 8, NT = 128;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = sK + BK * LD;
  bf16* sQ = sV + BK * LD;
  bf16* sO = sQ + BQ * LD;  // dO
  float* sL = reinterpret_cast<float*>(sO + BQ * LD);  // lse * log2(e)
  float* sD = sL + BQ;                                 // delta

  const Head g = make_head(p);
  const int k0 = blockIdx.x * BK;  // causal: early k tiles carry the most work
  int q_begin, q_end;
  dkv_q_range(p, g, k0, BQ, &q_begin, &q_end);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int quad = lane / 4, c2 = (lane % 4) * 2;
  const bf16* Q = static_cast<const bf16*>(p.q) + g.n * p.q_sn + g.hh * p.q_sh;
  const bf16* K = static_cast<const bf16*>(p.k) + g.n * p.k_sn + g.hh * p.k_sh;
  const bf16* V = static_cast<const bf16*>(p.v) + g.n * p.v_sn + g.hh * p.v_sh;
  const bf16* O = static_cast<const bf16*>(p.dout) + g.n * p.o_sn + g.hh * p.o_sh;
  const float* LSE = p.lse + (long long)g.bh * p.tq;
  const float* DLT = p.delta + (long long)g.bh * p.tq;
  load_rows_bf16<BK, D, LD, NT>(sK, K, k0, p.tk, p.k_st);
  load_rows_bf16<BK, D, LD, NT>(sV, V, k0, p.tk, p.v_st);

  // this thread's two keys: key0 and key0 + 8
  const int key0 = k0 + warp * 16 + quad;
  const float sl2 = p.scale * kLog2e;
  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
    dk[i][0] = dk[i][1] = dk[i][2] = dk[i][3] = dv[i][0] = dv[i][1] = dv[i][2] =
        dv[i][3] = 0.f;

  for (int q0 = q_begin; q0 < q_end; q0 += BQ) {
    __syncthreads();  // the previous tile is no longer read
    load_rows_bf16<BQ, D, LD, NT>(sQ, Q, q0, p.tq, p.q_st);
    load_rows_bf16<BQ, D, LD, NT>(sO, O, q0, p.tq, p.o_st);
    for (int i = threadIdx.x; i < BQ; i += NT) {
      const bool in = q0 + i < p.tq;
      sL[i] = in ? LSE[q0 + i] * kLog2e : 0.f;
      sD[i] = in ? DLT[q0 + i] : 0.f;
    }
    __syncthreads();

    // S^T = K Q^T and dP^T = V dO^T for this warp's 16 keys x BQ rows
    float st[BQ / 8][4], dpt[BQ / 8][4];
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j)
      st[j][0] = st[j][1] = st[j][2] = st[j][3] = dpt[j][0] = dpt[j][1] =
          dpt[j][2] = dpt[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t ka[4], va[4];
      a_frag<LD>(ka, sK, warp * 16 + quad, kk * 16 + c2);
      a_frag<LD>(va, sV, warp * 16 + quad, kk * 16 + c2);
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j) {
        const bf16* qr = &sQ[(j * 8 + quad) * LD + kk * 16 + c2];
        mma_bf16(st[j], ka, *reinterpret_cast<const uint32_t*>(qr),
                 *reinterpret_cast<const uint32_t*>(qr + 8));
        const bf16* orow = &sO[(j * 8 + quad) * LD + kk * 16 + c2];
        mma_bf16(dpt[j], va, *reinterpret_cast<const uint32_t*>(orow),
                 *reinterpret_cast<const uint32_t*>(orow + 8));
      }
    }

    // P^T into st, dS^T into dpt; lse and delta index the columns (rows of Q)
    const bool full = tile_full(p, g, q0, BQ, k0, BK);
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * 8 + c2 + (e & 1);
        float pe = 0.f;
        if (full || allowed(p, g, q0 + col, key0 + (e >= 2 ? 8 : 0)))
          pe = exp2f(fminf(st[j][e] * sl2 - sL[col], 0.f));
        st[j][e] = pe;
        dpt[j][e] = pe * (dpt[j][e] - sD[col]) * p.scale;
      }
    }

    // dV += P^T dO and dK += dS^T Q (A operands rounded to bf16)
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(st[2 * kk][0], st[2 * kk][1]),
                              pack_bf16(st[2 * kk][2], st[2 * kk][3]),
                              pack_bf16(st[2 * kk + 1][0], st[2 * kk + 1][1]),
                              pack_bf16(st[2 * kk + 1][2], st[2 * kk + 1][3])};
      const uint32_t da[4] = {pack_bf16(dpt[2 * kk][0], dpt[2 * kk][1]),
                              pack_bf16(dpt[2 * kk][2], dpt[2 * kk][3]),
                              pack_bf16(dpt[2 * kk + 1][0], dpt[2 * kk + 1][1]),
                              pack_bf16(dpt[2 * kk + 1][2], dpt[2 * kk + 1][3])};
      const bf16* o0 = &sO[(kk * 16 + c2) * LD + quad];
      const bf16* q0p = &sQ[(kk * 16 + c2) * LD + quad];
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        const bf16* op = o0 + i * 8;
        mma_bf16(dv[i], pa, pack_bf16_raw(op[0], op[LD]),
                 pack_bf16_raw(op[8 * LD], op[9 * LD]));
        const bf16* qp = q0p + i * 8;
        mma_bf16(dk[i], da, pack_bf16_raw(qp[0], qp[LD]),
                 pack_bf16_raw(qp[8 * LD], qp[9 * LD]));
      }
    }
  }

  bf16* dK = static_cast<bf16*>(p.dk) + (long long)g.bh * p.tk * D;
  bf16* dV = static_cast<bf16*>(p.dv) + (long long)g.bh * p.tk * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + 8 * r;
    if (key >= p.tk) continue;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      const long long at = (long long)key * D + i * 8 + c2;
      *reinterpret_cast<uint32_t*>(&dK[at]) = pack_bf16(dk[i][2 * r], dk[i][2 * r + 1]);
      *reinterpret_cast<uint32_t*>(&dV[at]) = pack_bf16(dv[i][2 * r], dv[i][2 * r + 1]);
    }
  }
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

constexpr int bf16_smem(int d, int rows) { return rows * (d + 8) * 2; }

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

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after launch
// (cudaErrorInvalidValue for a head dim other than 64 or 128).
extern "C" int bigdl_flash_attention_bwd_dq(BWD_ARGS, void* dq, BWD_TAIL) {
  BwdParams p = BWD_PARAMS;
  p.dq = dq;
  const dim3 grid((tq + 63) / 64, n * h);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // dQ (bf16) stages Q and dO (64 rows) and one K and V tile (64 keys)
  if (dtype == 1 && d == 64)
    return launch(flash_bwd_dq_bf16<64>, grid, 128, 4 * bf16_smem(64, 64), s, p);
  if (dtype == 1 && d == 128)
    return launch(flash_bwd_dq_bf16<128>, grid, 128, 4 * bf16_smem(128, 64), s, p);
  if (dtype == 0 && d == 64) return launch(flash_bwd_dq_f32<64>, grid, 256, 0, s, p);
  if (dtype == 0 && d == 128) return launch(flash_bwd_dq_f32<128>, grid, 256, 0, s, p);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int bigdl_flash_attention_bwd_dkv(BWD_ARGS, void* dk, void* dv, BWD_TAIL) {
  BwdParams p = BWD_PARAMS;
  p.dk = dk;
  p.dv = dv;
  const dim3 grid((tk + 63) / 64, n * h);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // dK/dV (bf16) stages one K and V tile (64 keys), a Q and dO tile (BQ rows:
  // 64 at d=64, 32 at d=128 to keep the two fp32 accumulators in registers)
  // and BQ lse/delta values
  if (dtype == 1 && d == 64)
    return launch(flash_bwd_dkv_bf16<64, 64>, grid, 128,
                  2 * bf16_smem(64, 64) + 2 * bf16_smem(64, 64) + 2 * 64 * 4, s, p);
  if (dtype == 1 && d == 128)
    return launch(flash_bwd_dkv_bf16<128, 32>, grid, 128,
                  2 * bf16_smem(128, 64) + 2 * bf16_smem(128, 32) + 2 * 32 * 4, s, p);
  if (dtype == 0 && d == 64) return launch(flash_bwd_dkv_f32<64>, grid, 256, 0, s, p);
  if (dtype == 0 && d == 128) return launch(flash_bwd_dkv_f32<128>, grid, 256, 0, s, p);
  return static_cast<int>(cudaErrorInvalidValue);
}
