// Fused bias + activation epilogue for Hopper (sm_90a): one forward kernel
// and two backward kernels, bound to Python through plain C entry points
// (ctypes; see bigdl_tpu_torch/ops/_build.py and ops/fused_epilogue.py).
//
// Replaces the Pallas TPU kernels of bigdl_tpu/ops/fused_epilogue.py:
//   bias_act_fwd          <- _fwd_kernel          (launched by _fwd_call)
//   bias_act_bwd_feature  <- _bwd_feature_kernel  (launched by _vjp_bwd)
//   bias_act_bwd_row      <- _bwd_row_kernel      (launched by _vjp_bwd)
// Same function: z = float(x) + b with the fp32 master bias b, y = act(z)
// in fp32 rounded once to x's dtype; act is none, relu, gelu (the tanh
// approximation) or tanh. The backward recomputes z from x (no saved
// pre-activation), writes dx = dy * act'(z) in x's dtype and sums
// dz = dy * act'(z) in fp32 for db. The ReLU derivative is (z > 0): 0 at
// z == 0. Two layouts, both of a contiguous (rows, cols) view:
//   feature mode (Linear): bias over columns; db sums every row;
//   row mode (NCHW conv): the tensor viewed as (N*C, H*W), the bias of row r
//     is b[r % C]; db is a per-row fp32 partial, folded (N, C) -> (C,) by
//     the caller, as the TPU code folds it outside its kernel.
//
// Bound on this card: a few flops per element against 4 (forward) or 6
// (backward) bytes per bf16 element, so bytes bound all three: the forward
// reads x and writes y, the backward reads x and dy and writes dx, once each
// (the bias, db and the partials are a few hundred KB at most). At VGG-16's
// first conv at batch 64 (x 64x64x224x224 bf16) that is 822 MB forward,
// 1.23 GB backward: 0.25 ms and 0.37 ms at 3.35 TB/s.
//
// Design. The TPU kernels walk row blocks in order on one core, and the
// feature backward carries db across that sequential grid in its output
// block. Here blocks run in parallel and in no order, and float atomics
// would change the bits from run to run, so every sum has a fixed order:
// - forward: a grid-stride pass over vectors of VEC elements that never
//   straddle a row (VEC is the widest of 16, 8, 4, 2 bytes that divides the
//   row and the pointers' alignment, else 1); the bias index is computed
//   once per vector.
// - row backward: TPR threads own one row (a warp for rows under 4096
//   elements, a 256-thread block above), each sums its elements in order,
//   then a fixed shuffle tree (and, for a block, shared memory summed in
//   warp order) gives the row's partial.
// - feature backward, two launches: stage 1 blocks of 32 x 8 threads own a
//   tile of (row_tile rows) x (32*VEC columns); each thread walks every 8th
//   row of the tile for its VEC columns, the 8 thread rows are summed in
//   order through shared memory, and the tile's fp32 partial db row is
//   written to a (row tiles, cols) scratch; stage 2 (column_fold, in
//   vec_common.cuh) sums each column's partials in row-tile order. row_tile is chosen by the caller from the
//   shape alone (about 1000 blocks), so 64-row fc layers still spread over
//   the SMs and the bits depend only on the shape.
// Activation math uses round-to-nearest intrinsics in the order the plain
// PyTorch version writes it (no contraction into FMAs) and tanhf, not a fast
// intrinsic. Later work: 32-bit index math, TMA or cp.async staging.

#include "vec_common.cuh"

namespace {

constexpr int kWideRow = 4096;  // rows this long get a whole block in the row backward
constexpr float kGeluC = static_cast<float>(0.7978845608028654);  // sqrt(2/pi)
constexpr float kGeluA = static_cast<float>(0.044715);
constexpr float kGeluA3 = static_cast<float>(3.0 * 0.044715);

enum Act { kNone = 0, kRelu = 1, kGelu = 2, kTanh = 3 };

// gelu's inner argument sqrt(2/pi) * (z + 0.044715 z^3)
__device__ __forceinline__ float gelu_u(float z) {
  return __fmul_rn(kGeluC, __fadd_rn(z, __fmul_rn(__fmul_rn(__fmul_rn(kGeluA, z), z), z)));
}

__device__ __forceinline__ float act_fwd(int act, float z) {
  switch (act) {
    case kRelu:
      return z < 0.f ? 0.f : z;  // NaN passes through, as max(z, 0) does
    case kGelu:
      return __fmul_rn(__fmul_rn(0.5f, z), __fadd_rn(1.f, tanhf(gelu_u(z))));
    case kTanh:
      return tanhf(z);
    default:
      return z;
  }
}

__device__ __forceinline__ float act_grad(int act, float z) {
  switch (act) {
    case kRelu:
      return z > 0.f ? 1.f : 0.f;  // 0 at z == 0
    case kGelu: {
      const float t = tanhf(gelu_u(z));
      const float du = __fmul_rn(kGeluC, __fadd_rn(1.f, __fmul_rn(__fmul_rn(kGeluA3, z), z)));
      return __fadd_rn(__fmul_rn(0.5f, __fadd_rn(1.f, t)),
                       __fmul_rn(__fmul_rn(__fmul_rn(0.5f, z), __fsub_rn(1.f, __fmul_rn(t, t))),
                                 du));
    }
    case kTanh: {
      const float t = tanhf(z);
      return __fsub_rn(1.f, __fmul_rn(t, t));
    }
    default:
      return 1.f;
  }
}

template <typename T, int VEC, bool ROW>
__global__ void __launch_bounds__(kThreads)
    bias_act_fwd(const T* __restrict__ x, const float* __restrict__ b, T* __restrict__ y,
                 int act, long long n_vec, long long cols, long long channels) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long v = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; v < n_vec;
       v += stride) {
    const long long i = v * VEC;
    const Pack<T, VEC> in = load<T, VEC>(x + i);
    Pack<T, VEC> out;
    if constexpr (ROW) {
      const float bias = b[(i / cols) % channels];
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        out.v[j] = from_float<T>(act_fwd(act, __fadd_rn(to_float(in.v[j]), bias)));
    } else {
      const float* bc = b + i % cols;
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        out.v[j] = from_float<T>(act_fwd(act, __fadd_rn(to_float(in.v[j]), bc[j])));
    }
    store<T, VEC>(y + i, out);
  }
}

// dz of VEC elements: dx written, dz returned for the sums
template <typename T, int VEC>
__device__ __forceinline__ void dz_pack(const T* x, const T* dy, T* dx, long long i,
                                        const float* bias, bool one_bias, int act,
                                        float (&dz)[VEC]) {
  const Pack<T, VEC> xv = load<T, VEC>(x + i);
  const Pack<T, VEC> gv = load<T, VEC>(dy + i);
  Pack<T, VEC> out;
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    const float z = __fadd_rn(to_float(xv.v[j]), one_bias ? bias[0] : bias[j]);
    dz[j] = __fmul_rn(to_float(gv.v[j]), act_grad(act, z));
    out.v[j] = from_float<T>(dz[j]);
  }
  store<T, VEC>(dx + i, out);
}

template <typename T, int VEC, int TPR>
__global__ void __launch_bounds__(kThreads)
    bias_act_bwd_row(const T* __restrict__ x, const float* __restrict__ b,
                     const T* __restrict__ dy, T* __restrict__ dx, float* __restrict__ db_rows,
                     int act, long long rows, long long cols, long long channels) {
  static_assert(TPR == 32 || TPR == kThreads, "a warp or the whole block owns a row");
  const int lane = threadIdx.x % TPR;
  const long long row = static_cast<long long>(blockIdx.x) * (kThreads / TPR) + threadIdx.x / TPR;
  float acc = 0.f;
  if (row < rows) {  // uniform over the TPR threads of the row
    const float bias = b[row % channels];
    const long long base = row * cols;
    const long long n_vec = cols / VEC;
    for (long long v = lane; v < n_vec; v += TPR) {
      float dz[VEC];
      dz_pack<T, VEC>(x, dy, dx, base + v * VEC, &bias, true, act, dz);
#pragma unroll
      for (int j = 0; j < VEC; ++j) acc = __fadd_rn(acc, dz[j]);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off /= 2)
    acc = __fadd_rn(acc, __shfl_down_sync(0xffffffffu, acc, off));
  if constexpr (TPR == 32) {
    if (lane == 0 && row < rows) db_rows[row] = acc;
  } else {
    __shared__ float warp_sum[kThreads / 32];
    if (threadIdx.x % 32 == 0) warp_sum[threadIdx.x / 32] = acc;
    __syncthreads();
    if (threadIdx.x == 0 && row < rows) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kThreads / 32; ++w) s = __fadd_rn(s, warp_sum[w]);
      db_rows[row] = s;
    }
  }
}

constexpr int kFeatLanes = 32;                     // threads across columns
constexpr int kFeatRows = kThreads / kFeatLanes;   // thread rows of a block

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
    bias_act_bwd_feature(const T* __restrict__ x, const float* __restrict__ b,
                         const T* __restrict__ dy, T* __restrict__ dx,
                         float* __restrict__ partial, int act, long long rows, long long cols,
                         int row_tile) {
  __shared__ float red[kFeatRows][kFeatLanes * VEC];
  const int tx = threadIdx.x % kFeatLanes, ty = threadIdx.x / kFeatLanes;
  const long long col0 = static_cast<long long>(blockIdx.x) * kFeatLanes * VEC;
  const long long col = col0 + static_cast<long long>(tx) * VEC;
  const long long r0 = static_cast<long long>(blockIdx.y) * row_tile;
  const long long r1 = min(r0 + row_tile, rows);
  float acc[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) acc[j] = 0.f;
  if (col < cols) {  // cols % VEC == 0: the whole vector is inside the row
    float bias[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) bias[j] = b[col + j];
    for (long long r = r0 + ty; r < r1; r += kFeatRows) {
      float dz[VEC];
      dz_pack<T, VEC>(x, dy, dx, r * cols + col, bias, false, act, dz);
#pragma unroll
      for (int j = 0; j < VEC; ++j) acc[j] = __fadd_rn(acc[j], dz[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < VEC; ++j) red[ty][tx * VEC + j] = acc[j];
  __syncthreads();
  for (int k = threadIdx.x; k < kFeatLanes * VEC; k += kThreads) {
    if (col0 + k < cols) {
      float s = 0.f;
#pragma unroll
      for (int r = 0; r < kFeatRows; ++r) s = __fadd_rn(s, red[r][k]);
      partial[static_cast<long long>(blockIdx.y) * cols + col0 + k] = s;
    }
  }
}

bool bad_act(int act) { return act < kNone || act > kTanh; }

template <typename T>
int fwd(const void* x, const float* b, void* y, int act, int row_mode, long long rows,
        long long cols, long long channels, cudaStream_t s) {
  const int vec = pick_vec(16 / sizeof(T), cols, {{x, sizeof(T)}, {y, sizeof(T)}});
  return with_vec<T>(vec, [&](auto v) {
    constexpr int V = decltype(v)::value;
    const long long n_vec = rows * cols / V;
    const int blocks = grid_blocks(n_vec);
    const T* xt = static_cast<const T*>(x);
    T* yt = static_cast<T*>(y);
    if (row_mode)
      bias_act_fwd<T, V, true><<<blocks, kThreads, 0, s>>>(xt, b, yt, act, n_vec, cols, channels);
    else
      bias_act_fwd<T, V, false><<<blocks, kThreads, 0, s>>>(xt, b, yt, act, n_vec, cols, channels);
    return static_cast<int>(cudaGetLastError());
  });
}

template <typename T>
int bwd_row(const void* x, const float* b, const void* dy, void* dx, float* db_rows, int act,
            long long rows, long long cols, long long channels, cudaStream_t s) {
  const int vec =
      pick_vec(16 / sizeof(T), cols, {{x, sizeof(T)}, {dy, sizeof(T)}, {dx, sizeof(T)}});
  return with_vec<T>(vec, [&](auto v) {
    constexpr int V = decltype(v)::value;
    const T* xt = static_cast<const T*>(x);
    const T* gt = static_cast<const T*>(dy);
    T* dxt = static_cast<T*>(dx);
    if (cols >= kWideRow) {
      bias_act_bwd_row<T, V, kThreads><<<static_cast<unsigned>(rows), kThreads, 0, s>>>(
          xt, b, gt, dxt, db_rows, act, rows, cols, channels);
    } else {
      const long long blocks = (rows + kThreads / 32 - 1) / (kThreads / 32);
      bias_act_bwd_row<T, V, 32><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
          xt, b, gt, dxt, db_rows, act, rows, cols, channels);
    }
    return static_cast<int>(cudaGetLastError());
  });
}

template <typename T>
int bwd_feature(const void* x, const float* b, const void* dy, void* dx, float* partial,
                float* db, int act, long long rows, long long cols, int row_tile,
                cudaStream_t s) {
  const int vec =
      pick_vec(16 / sizeof(T), cols, {{x, sizeof(T)}, {dy, sizeof(T)}, {dx, sizeof(T)}});
  const long long n_tiles = (rows + row_tile - 1) / row_tile;
  return with_vec<T>(vec, [&](auto v) {
    constexpr int V = decltype(v)::value;
    const long long col_tiles = (cols + kFeatLanes * V - 1) / (kFeatLanes * V);
    if (col_tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid(static_cast<unsigned>(col_tiles), static_cast<unsigned>(n_tiles));
    bias_act_bwd_feature<T, V><<<grid, kThreads, 0, s>>>(
        static_cast<const T*>(x), b, static_cast<const T*>(dy), static_cast<T*>(dx), partial,
        act, rows, cols, row_tile);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    return launch_column_fold(partial, db, n_tiles, cols, s);
  });
}

}  // namespace

// x, y: contiguous (rows, cols) in one dtype (1 = bf16, 0 = f32); b: fp32,
// cols entries (feature mode) or channels entries (row_mode = 1, bias of
// row r is b[r % channels]).
extern "C" int bigdl_bias_act_fwd(const void* x, const float* b, void* y, int dtype, int act,
                                  int row_mode, long long rows, long long cols,
                                  long long channels, void* stream) {
  if (rows <= 0 || cols <= 0 || channels <= 0 || bad_act(act) || (row_mode != 0 && row_mode != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return fwd<__nv_bfloat16>(x, b, y, act, row_mode, rows, cols, channels, s);
  if (dtype == 0) return fwd<float>(x, b, y, act, row_mode, rows, cols, channels, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Row mode backward: dx (rows, cols) in x's dtype and db_rows (rows,) fp32,
// the sum of dz over each row.
extern "C" int bigdl_bias_act_bwd_row(const void* x, const float* b, const void* dy, void* dx,
                                      float* db_rows, int dtype, int act, long long rows,
                                      long long cols, long long channels, void* stream) {
  if (rows <= 0 || cols <= 0 || channels <= 0 || bad_act(act) || rows > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return bwd_row<__nv_bfloat16>(x, b, dy, dx, db_rows, act, rows, cols, channels, s);
  if (dtype == 0) return bwd_row<float>(x, b, dy, dx, db_rows, act, rows, cols, channels, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Feature mode backward: dx (rows, cols) in x's dtype and db (cols,) fp32;
// partial is fp32 scratch of ceil(rows / row_tile) x cols.
extern "C" int bigdl_bias_act_bwd_feature(const void* x, const float* b, const void* dy,
                                          void* dx, float* partial, float* db, int dtype,
                                          int act, long long rows, long long cols, int row_tile,
                                          void* stream) {
  if (rows <= 0 || cols <= 0 || row_tile <= 0 || bad_act(act) ||
      (rows + row_tile - 1) / row_tile > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return bwd_feature<__nv_bfloat16>(x, b, dy, dx, partial, db, act, rows, cols, row_tile, s);
  if (dtype == 0)
    return bwd_feature<float>(x, b, dy, dx, partial, db, act, rows, cols, row_tile, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
