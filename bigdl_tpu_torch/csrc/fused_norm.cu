// LayerNorm and RMSNorm over the last dim for Hopper (sm_90a): a forward
// and a backward kernel each, bound to Python through plain C entry points
// (ctypes; see bigdl_tpu_torch/ops/_build.py and ops/fused_norm.py).
//
// Replaces the Pallas TPU kernels of bigdl_tpu/ops/fused_norm.py:
//   layer_norm_fwd  <- _ln_fwd_kernel   (launched by _ln_fwd_call)
//   layer_norm_bwd  <- _ln_bwd_kernel   (launched by _ln_vjp_bwd)
//   rms_norm_fwd    <- _rms_fwd_kernel  (launched by _rms_fwd_call)
//   rms_norm_bwd    <- _rms_bwd_kernel  (launched by _rms_vjp_bwd)
// Same functions, on a contiguous (rows, h) view of x:
//   LayerNorm: mu = mean(x), then var = mean((x - mu)^2) (the two-pass
//     statistic, never E[x^2] - mu^2), r = rsqrt(var + eps), y = (x - mu) * r
//     * w + b in fp32, written in fp32 whatever x's dtype;
//     backward: xh = (x - mu) * r and g = dy * w recomputed from x,
//     dx = r * (g - mean(g) - xh * mean(g * xh)) in x's dtype, dw = sum over
//     rows of dy * xh and db = sum of dy in fp32 (dy is fp32, as y is);
//   RMSNorm: r = rsqrt(mean(x^2) + eps), y = x * r * w in fp32 rounded once
//     to x's dtype; backward: g = dy * w, dx = r * g - x * r^3 * sum(g * x) / h
//     in x's dtype, dw = sum over rows of dy * x * r in fp32.
// Every statistic is fp32; w and b are the fp32 master parameters.
//
// Bound on this card: a few flops per element against 8 to 12 bytes per
// element moved, so bytes bound all four. At the main path's (16384, 512)
// f32 that is 67.1 MB forward (x read, y written) and 100.7 MB backward (x,
// dy read, dx written): 0.020 ms and 0.030 ms at 3.35 TB/s.
//
// Design. Each operand is read once: TPR threads own a row (a warp when
// h <= 1024, the whole 256-thread block up to h = 8192), each holding PER
// (16 or 32) of its values in registers as vectors of VEC elements (16 bytes
// of x, or 1 element when h or a pointer does not allow that), so the row
// stays in registers from its statistics to its write. Row sums run in a
// fixed order: each thread adds its values in order, a butterfly of shuffles
// combines the warp (every lane ends with the same bits), and in block mode
// the 8 warp sums are added in warp order from shared memory.
// The TPU backward accumulates dw and db over its sequential row-block grid.
// Here each backward block owns a tile of row_tile rows (chosen by the
// caller from the shape alone), accumulates its columns' dw and db in
// registers in row order, adds its 8 warps' rows in warp order through
// shared memory (warp mode), writes one fp32 partial row per tile, and
// column_fold (vec_common.cuh) sums the tiles' partials per column in tile
// order. No atomics: two runs give the same bits. Later work: more rows in
// flight per block, cp.async or TMA staging.

#include "vec_common.cuh"

namespace {

constexpr int kWarp = 32;
constexpr int kPerMax = 32;  // values of a row one thread holds at most

// Sum of v over the TPR threads that own a row; every one of them gets the
// same bits. Block mode uses red (kThreads / 32 floats) and syncs the block.
template <int TPR>
__device__ __forceinline__ float row_sum(float v, float* red) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off /= 2)
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, off));
  if constexpr (TPR == kWarp) {
    return v;
  } else {
    __syncthreads();  // the previous sum's readers are done with red
    if (threadIdx.x % kWarp == 0) red[threadIdx.x / kWarp] = v;
    __syncthreads();
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kThreads / kWarp; ++w) s = __fadd_rn(s, red[w]);
    return s;
  }
}

// A row's vectors k * TPR + lane (k < NV) into registers as fp32; vectors
// past the row read as 0.
template <typename T, int VEC, int NV, int TPR>
__device__ __forceinline__ void load_row(const T* row, int n_vec, int lane, float (&v)[NV][VEC]) {
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int i = k * TPR + lane;
    if (i < n_vec) {
      const Pack<T, VEC> p = load<T, VEC>(row + static_cast<long long>(i) * VEC);
#pragma unroll
      for (int j = 0; j < VEC; ++j) v[k][j] = to_float(p.v[j]);
    } else {
#pragma unroll
      for (int j = 0; j < VEC; ++j) v[k][j] = 0.f;
    }
  }
}

// The row's (x - mu) into v (the values past the row stay 0) and rsqrt(var + eps).
template <int VEC, int NV, int TPR>
__device__ __forceinline__ float center_and_rstd(float (&v)[NV][VEC], int n_vec, int lane, int h,
                                                 float eps, float* red) {
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < NV; ++k)
#pragma unroll
    for (int j = 0; j < VEC; ++j) s = __fadd_rn(s, v[k][j]);
  const float mu = __fdiv_rn(row_sum<TPR>(s, red), static_cast<float>(h));
  float q = 0.f;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    if (k * TPR + lane < n_vec) {
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        v[k][j] = __fsub_rn(v[k][j], mu);
        q = __fadd_rn(q, __fmul_rn(v[k][j], v[k][j]));
      }
    }
  }
  const float var = __fdiv_rn(row_sum<TPR>(q, red), static_cast<float>(h));
  return rsqrtf(__fadd_rn(var, eps));
}

// rsqrt(mean(x^2) + eps) of the row in v.
template <int VEC, int NV, int TPR>
__device__ __forceinline__ float rms_rstd(const float (&v)[NV][VEC], int h, float eps,
                                          float* red) {
  float q = 0.f;
#pragma unroll
  for (int k = 0; k < NV; ++k)
#pragma unroll
    for (int j = 0; j < VEC; ++j) q = __fadd_rn(q, __fmul_rn(v[k][j], v[k][j]));
  return rsqrtf(__fadd_rn(__fdiv_rn(row_sum<TPR>(q, red), static_cast<float>(h)), eps));
}

template <typename T, int VEC, int TPR, int PER>
__global__ void __launch_bounds__(kThreads)
    layer_norm_fwd(const T* __restrict__ x, const float* __restrict__ w,
                   const float* __restrict__ b, float* __restrict__ y, long long rows, int h,
                   float eps) {
  constexpr int NV = PER / VEC;
  __shared__ float red[kThreads / kWarp];
  const int lane = threadIdx.x % TPR;
  const long long row = static_cast<long long>(blockIdx.x) * (kThreads / TPR) + threadIdx.x / TPR;
  if (row >= rows) return;  // uniform over the row's threads (the block, in block mode)
  const int n_vec = h / VEC;
  float v[NV][VEC];
  load_row<T, VEC, NV, TPR>(x + row * h, n_vec, lane, v);
  const float r = center_and_rstd<VEC, NV, TPR>(v, n_vec, lane, h, eps, red);
  float* yr = y + row * h;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int i = k * TPR + lane;
    if (i < n_vec) {
      const Pack<float, VEC> wv = load<float, VEC>(w + i * VEC);
      const Pack<float, VEC> bv = load<float, VEC>(b + i * VEC);
      Pack<float, VEC> out;
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        out.v[j] = __fadd_rn(__fmul_rn(__fmul_rn(v[k][j], r), wv.v[j]), bv.v[j]);
      store<float, VEC>(yr + i * VEC, out);
    }
  }
}

template <typename T, int VEC, int TPR, int PER>
__global__ void __launch_bounds__(kThreads)
    rms_norm_fwd(const T* __restrict__ x, const float* __restrict__ w, T* __restrict__ y,
                 long long rows, int h, float eps) {
  constexpr int NV = PER / VEC;
  __shared__ float red[kThreads / kWarp];
  const int lane = threadIdx.x % TPR;
  const long long row = static_cast<long long>(blockIdx.x) * (kThreads / TPR) + threadIdx.x / TPR;
  if (row >= rows) return;
  const int n_vec = h / VEC;
  float v[NV][VEC];
  load_row<T, VEC, NV, TPR>(x + row * h, n_vec, lane, v);
  const float r = rms_rstd<VEC, NV, TPR>(v, h, eps, red);
  T* yr = y + row * h;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int i = k * TPR + lane;
    if (i < n_vec) {
      const Pack<float, VEC> wv = load<float, VEC>(w + i * VEC);
      Pack<T, VEC> out;
#pragma unroll
      for (int j = 0; j < VEC; ++j) out.v[j] = from_float<T>(__fmul_rn(__fmul_rn(v[k][j], r), wv.v[j]));
      store<T, VEC>(yr + i * VEC, out);
    }
  }
}

// The block's per-thread column sums acc (NV vectors of the columns this
// thread owns) written as one fp32 row at out: directly in block mode (one
// thread per column), through shared memory summed in warp order in warp
// mode (the block's 8 warps own the same columns).
template <int VEC, int NV, int TPR>
__device__ __forceinline__ void write_partial(const float (&acc)[NV][VEC], float* out, int n_vec,
                                              int h, float (*stage)[kPerMax * kWarp]) {
  const int lane = threadIdx.x % TPR;
  if constexpr (TPR == kThreads) {
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int i = k * TPR + lane;
      if (i < n_vec) {
        Pack<float, VEC> p;
#pragma unroll
        for (int j = 0; j < VEC; ++j) p.v[j] = acc[k][j];
        store<float, VEC>(out + i * VEC, p);
      }
    }
  } else {
    constexpr int kRowsInFlight = kThreads / TPR;
    const int q = threadIdx.x / TPR;
    __syncthreads();  // an earlier pass's readers are done with stage
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int i = k * TPR + lane;
      if (i < n_vec) {
#pragma unroll
        for (int j = 0; j < VEC; ++j) stage[q][i * VEC + j] = acc[k][j];
      }
    }
    __syncthreads();
    for (int c = threadIdx.x; c < h; c += kThreads) {
      float s = 0.f;
#pragma unroll
      for (int r = 0; r < kRowsInFlight; ++r) s = __fadd_rn(s, stage[r][c]);
      out[c] = s;
    }
  }
}

template <typename T, int VEC, int TPR, int PER>
__global__ void __launch_bounds__(kThreads)
    layer_norm_bwd(const T* __restrict__ x, const float* __restrict__ w,
                   const float* __restrict__ dy, T* __restrict__ dx, float* __restrict__ partial,
                   long long rows, int h, int row_tile, float eps) {
  constexpr int NV = PER / VEC;
  constexpr int kRowsInFlight = kThreads / TPR;
  __shared__ float red[kThreads / kWarp];
  __shared__ float stage[TPR == kWarp ? kRowsInFlight : 1][kPerMax * kWarp];
  const int lane = threadIdx.x % TPR;
  const int n_vec = h / VEC;
  const long long r0 = static_cast<long long>(blockIdx.x) * row_tile;
  const long long r1 = min(r0 + row_tile, rows);
  float dw[NV][VEC], db[NV][VEC];
#pragma unroll
  for (int k = 0; k < NV; ++k)
#pragma unroll
    for (int j = 0; j < VEC; ++j) dw[k][j] = db[k][j] = 0.f;
  for (long long row = r0 + threadIdx.x / TPR; row < r1; row += kRowsInFlight) {
    float v[NV][VEC], g[NV][VEC];
    load_row<T, VEC, NV, TPR>(x + row * h, n_vec, lane, v);
    load_row<float, VEC, NV, TPR>(dy + row * h, n_vec, lane, g);
    const float r = center_and_rstd<VEC, NV, TPR>(v, n_vec, lane, h, eps, red);
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int i = k * TPR + lane;
      if (i < n_vec) {
        const Pack<float, VEC> wv = load<float, VEC>(w + i * VEC);
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const float xh = __fmul_rn(v[k][j], r);
          v[k][j] = xh;
          dw[k][j] = __fadd_rn(dw[k][j], __fmul_rn(g[k][j], xh));
          db[k][j] = __fadd_rn(db[k][j], g[k][j]);
          g[k][j] = __fmul_rn(g[k][j], wv.v[j]);
          s1 = __fadd_rn(s1, g[k][j]);
          s2 = __fadd_rn(s2, __fmul_rn(g[k][j], xh));
        }
      }
    }
    const float m1 = __fdiv_rn(row_sum<TPR>(s1, red), static_cast<float>(h));
    const float m2 = __fdiv_rn(row_sum<TPR>(s2, red), static_cast<float>(h));
    T* dxr = dx + row * h;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int i = k * TPR + lane;
      if (i < n_vec) {
        Pack<T, VEC> out;
#pragma unroll
        for (int j = 0; j < VEC; ++j)
          out.v[j] = from_float<T>(
              __fmul_rn(r, __fsub_rn(__fsub_rn(g[k][j], m1), __fmul_rn(v[k][j], m2))));
        store<T, VEC>(dxr + i * VEC, out);
      }
    }
  }
  float* out = partial + static_cast<long long>(blockIdx.x) * 2 * h;
  write_partial<VEC, NV, TPR>(dw, out, n_vec, h, stage);
  write_partial<VEC, NV, TPR>(db, out + h, n_vec, h, stage);
}

template <typename T, int VEC, int TPR, int PER>
__global__ void __launch_bounds__(kThreads)
    rms_norm_bwd(const T* __restrict__ x, const float* __restrict__ w, const T* __restrict__ dy,
                 T* __restrict__ dx, float* __restrict__ partial, long long rows, int h,
                 int row_tile, float eps) {
  constexpr int NV = PER / VEC;
  constexpr int kRowsInFlight = kThreads / TPR;
  __shared__ float red[kThreads / kWarp];
  __shared__ float stage[TPR == kWarp ? kRowsInFlight : 1][kPerMax * kWarp];
  const int lane = threadIdx.x % TPR;
  const int n_vec = h / VEC;
  const long long r0 = static_cast<long long>(blockIdx.x) * row_tile;
  const long long r1 = min(r0 + row_tile, rows);
  float dw[NV][VEC];
#pragma unroll
  for (int k = 0; k < NV; ++k)
#pragma unroll
    for (int j = 0; j < VEC; ++j) dw[k][j] = 0.f;
  for (long long row = r0 + threadIdx.x / TPR; row < r1; row += kRowsInFlight) {
    float v[NV][VEC], g[NV][VEC];
    load_row<T, VEC, NV, TPR>(x + row * h, n_vec, lane, v);
    load_row<T, VEC, NV, TPR>(dy + row * h, n_vec, lane, g);
    const float r = rms_rstd<VEC, NV, TPR>(v, h, eps, red);
    float dot = 0.f;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int i = k * TPR + lane;
      if (i < n_vec) {
        const Pack<float, VEC> wv = load<float, VEC>(w + i * VEC);
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          dw[k][j] = __fadd_rn(dw[k][j], __fmul_rn(__fmul_rn(g[k][j], v[k][j]), r));
          g[k][j] = __fmul_rn(g[k][j], wv.v[j]);
          dot = __fadd_rn(dot, __fmul_rn(g[k][j], v[k][j]));
        }
      }
    }
    const float r3 = __fmul_rn(__fmul_rn(r, r), r);
    const float dh = __fdiv_rn(row_sum<TPR>(dot, red), static_cast<float>(h));
    T* dxr = dx + row * h;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int i = k * TPR + lane;
      if (i < n_vec) {
        Pack<T, VEC> out;
#pragma unroll
        for (int j = 0; j < VEC; ++j)
          out.v[j] = from_float<T>(
              __fsub_rn(__fmul_rn(r, g[k][j]), __fmul_rn(__fmul_rn(v[k][j], r3), dh)));
        store<T, VEC>(dxr + i * VEC, out);
      }
    }
  }
  write_partial<VEC, NV, TPR>(dw, partial + static_cast<long long>(blockIdx.x) * h, n_vec, h,
                              stage);
}

// Calls f(VEC, TPR, PER) (integral constants) for a row of h elements: a
// warp owns rows up to 1024 elements, the block up to 8192; each thread
// holds up to 16 or 32 of them. VEC is 16 bytes of T when vec allows it,
// else 1.
template <typename T, typename F>
int with_row_geometry(int vec, int h, F&& f) {
  constexpr int kWide = 16 / static_cast<int>(sizeof(T));
  auto go = [&](auto tpr, auto per) -> int {
    if (vec == kWide) return f(std::integral_constant<int, kWide>{}, tpr, per);
    return f(std::integral_constant<int, 1>{}, tpr, per);
  };
  using W = std::integral_constant<int, kWarp>;
  using B = std::integral_constant<int, kThreads>;
  using P16 = std::integral_constant<int, 16>;
  using P32 = std::integral_constant<int, kPerMax>;
  if (h <= 16 * kWarp) return go(W{}, P16{});
  if (h <= kPerMax * kWarp) return go(W{}, P32{});
  if (h <= 16 * kThreads) return go(B{}, P16{});
  if (h <= kPerMax * kThreads) return go(B{}, P32{});
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int vec_of(long long h, std::initializer_list<Operand> ops) {
  constexpr int kWide = 16 / static_cast<int>(sizeof(T));
  return pick_vec(kWide, h, ops) == kWide ? kWide : 1;
}

template <int TPR>
unsigned fwd_blocks(long long rows) {
  return static_cast<unsigned>((rows + kThreads / TPR - 1) / (kThreads / TPR));
}

template <typename T>
int ln_fwd(const void* x, const float* w, const float* b, float* y, long long rows, int h,
           float eps, cudaStream_t s) {
  const int vec = vec_of<T>(h, {{x, sizeof(T)}, {w, 4}, {b, 4}, {y, 4}});
  return with_row_geometry<T>(vec, h, [&](auto v, auto tpr, auto per) {
    constexpr int V = decltype(v)::value, TPR = decltype(tpr)::value, PER = decltype(per)::value;
    layer_norm_fwd<T, V, TPR, PER><<<fwd_blocks<TPR>(rows), kThreads, 0, s>>>(
        static_cast<const T*>(x), w, b, y, rows, h, eps);
    return static_cast<int>(cudaGetLastError());
  });
}

template <typename T>
int rms_fwd(const void* x, const float* w, void* y, long long rows, int h, float eps,
            cudaStream_t s) {
  const int vec = vec_of<T>(h, {{x, sizeof(T)}, {w, 4}, {y, sizeof(T)}});
  return with_row_geometry<T>(vec, h, [&](auto v, auto tpr, auto per) {
    constexpr int V = decltype(v)::value, TPR = decltype(tpr)::value, PER = decltype(per)::value;
    rms_norm_fwd<T, V, TPR, PER><<<fwd_blocks<TPR>(rows), kThreads, 0, s>>>(
        static_cast<const T*>(x), w, static_cast<T*>(y), rows, h, eps);
    return static_cast<int>(cudaGetLastError());
  });
}

template <typename T>
int ln_bwd(const void* x, const float* w, const float* dy, void* dx, float* partial,
           float* dwdb, long long rows, int h, int row_tile, float eps, cudaStream_t s) {
  const long long n_tiles = (rows + row_tile - 1) / row_tile;
  const int vec = vec_of<T>(h, {{x, sizeof(T)}, {w, 4}, {dy, 4}, {dx, sizeof(T)}, {partial, 4}});
  const int rc = with_row_geometry<T>(vec, h, [&](auto v, auto tpr, auto per) {
    constexpr int V = decltype(v)::value, TPR = decltype(tpr)::value, PER = decltype(per)::value;
    layer_norm_bwd<T, V, TPR, PER><<<static_cast<unsigned>(n_tiles), kThreads, 0, s>>>(
        static_cast<const T*>(x), w, dy, static_cast<T*>(dx), partial, rows, h, row_tile, eps);
    return static_cast<int>(cudaGetLastError());
  });
  if (rc != 0) return rc;
  return launch_column_fold(partial, dwdb, n_tiles, 2LL * h, s);
}

template <typename T>
int rms_bwd(const void* x, const float* w, const void* dy, void* dx, float* partial, float* dw,
            long long rows, int h, int row_tile, float eps, cudaStream_t s) {
  const long long n_tiles = (rows + row_tile - 1) / row_tile;
  const int vec = vec_of<T>(
      h, {{x, sizeof(T)}, {w, 4}, {dy, sizeof(T)}, {dx, sizeof(T)}, {partial, 4}});
  const int rc = with_row_geometry<T>(vec, h, [&](auto v, auto tpr, auto per) {
    constexpr int V = decltype(v)::value, TPR = decltype(tpr)::value, PER = decltype(per)::value;
    rms_norm_bwd<T, V, TPR, PER><<<static_cast<unsigned>(n_tiles), kThreads, 0, s>>>(
        static_cast<const T*>(x), w, static_cast<const T*>(dy), static_cast<T*>(dx), partial,
        rows, h, row_tile, eps);
    return static_cast<int>(cudaGetLastError());
  });
  if (rc != 0) return rc;
  return launch_column_fold(partial, dw, n_tiles, h, s);
}

bool bad_shape(long long rows, int h) {
  return rows <= 0 || h <= 0 || h > kPerMax * kThreads || rows > 0x7fffffffLL;
}

bool bad_tile(long long rows, int row_tile) {
  return row_tile <= 0 || (rows + row_tile - 1) / row_tile > 0x7fffffffLL;
}

}  // namespace

// x: contiguous (rows, h), dtype 1 = bf16, 0 = f32; w, b: fp32 (h,); y: fp32 (rows, h).
extern "C" int bigdl_layer_norm_fwd(const void* x, const float* w, const float* b, float* y,
                                    int dtype, long long rows, int h, float eps, void* stream) {
  if (bad_shape(rows, h)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return ln_fwd<__nv_bfloat16>(x, w, b, y, rows, h, eps, s);
  if (dtype == 0) return ln_fwd<float>(x, w, b, y, rows, h, eps, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// dy fp32 (rows, h); dx in x's dtype; partial: fp32 scratch of
// ceil(rows / row_tile) x 2h; dwdb: fp32 (2h,), dw then db.
extern "C" int bigdl_layer_norm_bwd(const void* x, const float* w, const float* dy, void* dx,
                                    float* partial, float* dwdb, int dtype, long long rows, int h,
                                    int row_tile, float eps, void* stream) {
  if (bad_shape(rows, h) || bad_tile(rows, row_tile))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return ln_bwd<__nv_bfloat16>(x, w, dy, dx, partial, dwdb, rows, h, row_tile, eps, s);
  if (dtype == 0) return ln_bwd<float>(x, w, dy, dx, partial, dwdb, rows, h, row_tile, eps, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// x, y: contiguous (rows, h) in one dtype; w: fp32 (h,).
extern "C" int bigdl_rms_norm_fwd(const void* x, const float* w, void* y, int dtype,
                                  long long rows, int h, float eps, void* stream) {
  if (bad_shape(rows, h)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return rms_fwd<__nv_bfloat16>(x, w, y, rows, h, eps, s);
  if (dtype == 0) return rms_fwd<float>(x, w, y, rows, h, eps, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// x, dy, dx in one dtype; partial: fp32 scratch of ceil(rows / row_tile) x h;
// dw: fp32 (h,).
extern "C" int bigdl_rms_norm_bwd(const void* x, const float* w, const void* dy, void* dx,
                                  float* partial, float* dw, int dtype, long long rows, int h,
                                  int row_tile, float eps, void* stream) {
  if (bad_shape(rows, h) || bad_tile(rows, row_tile))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return rms_bwd<__nv_bfloat16>(x, w, dy, dx, partial, dw, rows, h, row_tile, eps, s);
  if (dtype == 0) return rms_bwd<float>(x, w, dy, dx, partial, dw, rows, h, row_tile, eps, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
