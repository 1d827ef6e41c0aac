// Flash-attention forward for Hopper (sm_90a), bound to Python through a
// plain C entry point (ctypes; see bigdl_tpu_torch/ops/_build.py).
//
// Replaces: bigdl_tpu/ops/flash_attention.py::_fwd_kernel (the Pallas TPU
// kernel launched by _flash_fwd_impl). Same function: exact softmax attention
// with an online softmax, fp32 accumulation and fp32 softmax bookkeeping, plus
// the per-row logsumexp. Masks: causal aligned at the end (query row i sees
// keys j <= i + Tk - Tq), per-sequence `lengths` giving the horizon
// kl = min(lengths[n], Tk), `mask_q` (query rows with i + Tk - Tq >= kl give 0
// output), and a row with no visible key gives out = 0, lse = NEG_BIG.
//
// Bound on this card: at the serving shape (8, 8, 2048, 64) bf16 causal the
// work is ~3.4e10 FLOP against ~67 MB of traffic (≈510 FLOP/byte), above the
// H100's ~295 FLOP/byte ridge, so the bound is the tensor cores
// (~35 us at 989 TFLOP/s). What the design does about it: both products run
// on the tensor cores (mma.sync m16n8k16, bf16 in, fp32 accumulate), the
// score tile never leaves registers (its accumulator layout is reused as the
// A operand of the P·V product), causal tiles past a q tile's horizon are
// never loaded, and q tiles are scheduled heaviest first. Not done yet (later
// work): wgmma, TMA/cp.async pipelining of the k/v tiles, ldmatrix.
//
// The TPU kernel's sequential-grid scratch carry and its 1024/512 blocks are
// not carried over: here one thread block owns one (n*h, 64-row q tile) and
// loops over 64-key k/v tiles staged in shared memory; the online-softmax
// state lives in registers.
//
// float32 inputs take a separate CUDA-core (FMA) kernel: 4 threads per query
// row, each owning a quarter of the head dim, 32-key tiles.

#include <math.h>

#include "flash_common.cuh"

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

// Geometry shared by both kernels for one (n, h, q tile).
struct Tile {
  int n, hh, bh, q0, co, kl, k_end;
  bool qmask;
};

__device__ inline Tile make_tile(const Params& p, int bq) {
  Tile t;
  t.bh = blockIdx.y;
  t.n = t.bh / p.h;
  t.hh = t.bh % p.h;
  // causal tiles late in the sequence carry the most work: start them first
  t.q0 = (gridDim.x - 1 - blockIdx.x) * bq;
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

// Every entry of the (bq x bk) tile at (q0, k0) is visible.
__device__ inline bool tile_full(const Params& p, const Tile& t, int k0, int bq,
                                 int bk) {
  return k0 + bk <= t.kl && (!p.causal || t.q0 + t.co >= k0 + bk - 1) &&
         (!t.qmask || t.q0 + bq - 1 + t.co < t.kl);
}

// ------------------------------------------------------------------ bf16 path
template <int D>
__global__ void __launch_bounds__(128) flash_fwd_bf16(Params p) {
  constexpr int BQ = 64, BK = 64, LD = D + 8, NT = 128;
  __shared__ __align__(16) bf16 sK[BK * LD];
  __shared__ __align__(16) bf16 sV[BK * LD];

  const Tile t = make_tile(p, BQ);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int quad = lane / 4, c2 = (lane % 4) * 2;
  const bf16* Q = static_cast<const bf16*>(p.q) + t.n * p.q_sn + t.hh * p.q_sh;
  const bf16* K = static_cast<const bf16*>(p.k) + t.n * p.k_sn + t.hh * p.k_sh;
  const bf16* V = static_cast<const bf16*>(p.v) + t.n * p.v_sn + t.hh * p.v_sh;

  // Q fragments (A operand, 16 rows per warp) stay in registers for the
  // whole loop; the tile is staged through sK first.
  uint32_t qf[D / 16][4];
  load_rows_bf16<64, D, LD, NT>(sK, Q, t.q0, p.tq, p.q_st);
  __syncthreads();
  {
    const int r = warp * 16 + quad;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int c = kk * 16 + c2;
      qf[kk][0] = *reinterpret_cast<const uint32_t*>(&sK[r * LD + c]);
      qf[kk][1] = *reinterpret_cast<const uint32_t*>(&sK[(r + 8) * LD + c]);
      qf[kk][2] = *reinterpret_cast<const uint32_t*>(&sK[r * LD + c + 8]);
      qf[kk][3] = *reinterpret_cast<const uint32_t*>(&sK[(r + 8) * LD + c + 8]);
    }
  }
  __syncthreads();

  // this thread's two query rows: row0 and row0 + 8
  const int row0 = t.q0 + warp * 16 + quad;
  const float sl2 = p.scale * kLog2e;  // scores kept in base-2 units
  float o[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m[2] = {kNegBig, kNegBig}, l[2] = {0.f, 0.f};

  for (int k0 = 0; k0 < t.k_end; k0 += BK) {
    load_rows_bf16<64, D, LD, NT>(sK, K, k0, p.tk, p.k_st);
    load_rows_bf16<64, D, LD, NT>(sV, V, k0, p.tk, p.v_st);
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys (8 n-tiles of 8 keys)
    float s[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        const bf16* kr = &sK[(j * 8 + quad) * LD + kk * 16 + c2];
        mma_bf16(s[j], qf[kk], *reinterpret_cast<const uint32_t*>(kr),
                 *reinterpret_cast<const uint32_t*>(kr + 8));
      }
    }

    const bool full = tile_full(p, t, k0, BQ, BK);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * sl2;
        if (!full) {
          const int row = row0 + (e >= 2 ? 8 : 0);
          const int col = k0 + j * 8 + c2 + (e & 1);
          if (!allowed(p, t, row, col)) x = -INFINITY;
        }
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float corr[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      corr[r] = exp2f(m[r] - mx[r]);
      m[r] = mx[r];
    }
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // masked entries are -inf and m is finite, so they become exactly 0
        const float pe = exp2f(s[j][e] - m[e >> 1]);
        s[j][e] = pe;
        rs[e >> 1] += pe;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
      l[r] = l[r] * corr[r] + rs[r];
    }
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      o[i][0] *= corr[0];
      o[i][1] *= corr[0];
      o[i][2] *= corr[1];
      o[i][3] *= corr[1];
    }

    // O += P V: the score accumulators of n-tiles 2kk, 2kk+1 are exactly the
    // A fragment of k-step kk (rounded to bf16, as the TPU kernel does)
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const bf16* v0 = &sV[(kk * 16 + c2) * LD + quad];
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        const bf16* vp = v0 + i * 8;
        const uint32_t b0 = pack_bf16_raw(vp[0], vp[LD]);
        const uint32_t b1 = pack_bf16_raw(vp[8 * LD], vp[9 * LD]);
        mma_bf16(o[i], a, b0, b1);
      }
    }
    __syncthreads();  // the next tile overwrites sK / sV
  }

  bf16* O = static_cast<bf16*>(p.o) + (long long)t.bh * p.tq * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= p.tq) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      *reinterpret_cast<uint32_t*>(&O[(long long)row * D + i * 8 + c2]) =
          pack_bf16(o[i][2 * r] * inv, o[i][2 * r + 1] * inv);
    }
    if ((lane & 3) == 0)
      p.lse[(long long)t.bh * p.tq + row] =
          l[r] > 0.f ? (m[r] + log2f(l[r])) * kLn2 : kNegBig;
  }
}

// ------------------------------------------------------------------- f32 path
template <int D>
__global__ void __launch_bounds__(256) flash_fwd_f32(Params p) {
  constexpr int BQ = 64, BK = 32, G = 4, C = D / (4 * G), NT = 256;
  __shared__ __align__(16) float sK[BK * D];
  __shared__ __align__(16) float sV[BK * D];

  const Tile t = make_tile(p, BQ);
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
// (cudaErrorInvalidValue for a head dim other than 64 or 128).
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
  const dim3 grid((tq + 63) / 64, n * h);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && d == 64)
    flash_fwd_bf16<64><<<grid, 128, 0, s>>>(p);
  else if (dtype == 1 && d == 128)
    flash_fwd_bf16<128><<<grid, 128, 0, s>>>(p);
  else if (dtype == 0 && d == 64)
    flash_fwd_f32<64><<<grid, 256, 0, s>>>(p);
  else if (dtype == 0 && d == 128)
    flash_fwd_f32<128><<<grid, 256, 0, s>>>(p);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
