// Helpers shared by the row-wise kernels (fused_epilogue.cu, fused_norm.cu):
// bf16/f32 conversions, 16-byte vector loads and stores, the choice of vector
// width, grid sizing and the fixed-order column fold of fp32 partials.
// Everything sits in an unnamed namespace: each translation unit that
// includes this header gets its own copy.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>
#include <type_traits>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's .to(bfloat16)
}

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

template <typename T, int VEC>
__device__ __forceinline__ Pack<T, VEC> load(const T* p) {
  return *reinterpret_cast<const Pack<T, VEC>*>(p);
}

template <typename T, int VEC>
__device__ __forceinline__ void store(T* p, const Pack<T, VEC>& v) {
  *reinterpret_cast<Pack<T, VEC>*>(p) = v;
}

// An array a kernel reads or writes in vectors: its base and element size.
struct Operand {
  const void* ptr;
  int bytes;
};

// The widest vector (in elements, at most max_vec) that divides cols and
// keeps every operand's base aligned to a whole vector of its own elements,
// so that no vector straddles a row.
inline int pick_vec(int max_vec, long long cols, std::initializer_list<Operand> ops) {
  for (int vec = max_vec; vec > 1; vec /= 2) {
    bool ok = cols % vec == 0;
    for (const Operand& o : ops)
      ok = ok && reinterpret_cast<uintptr_t>(o.ptr) % (static_cast<uintptr_t>(vec) * o.bytes) == 0;
    if (ok) return vec;
  }
  return 1;
}

// Calls f(std::integral_constant<int, vec>) for a vec of pick_vec.
template <typename T, typename F>
int with_vec(int vec, F&& f) {
  switch (vec) {
    case 1:
      return f(std::integral_constant<int, 1>{});
    case 2:
      return f(std::integral_constant<int, 2>{});
    case 4:
      return f(std::integral_constant<int, 4>{});
    case 8:
      if constexpr (sizeof(T) == 2) return f(std::integral_constant<int, 8>{});
      break;
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

inline int grid_blocks(long long work) {  // grid-stride launches: at most 32 blocks per SM
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long want = (work + kThreads - 1) / kThreads;
  return static_cast<int>(want < 32LL * sms ? (want > 0 ? want : 1) : 32LL * sms);
}

// out[c] = sum over t of partial[t * cols + c], t in increasing order: the
// second pass of a cross-row sum whose first pass wrote one fp32 partial row
// per row tile, so the result depends on the shape alone (no atomics).
__global__ void __launch_bounds__(kThreads)
    column_fold(const float* __restrict__ partial, float* __restrict__ out, long long n_tiles,
                long long cols) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long c = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; c < cols;
       c += stride) {
    float s = 0.f;
    for (long long t = 0; t < n_tiles; ++t) s = __fadd_rn(s, partial[t * cols + c]);
    out[c] = s;
  }
}

inline int launch_column_fold(const float* partial, float* out, long long n_tiles,
                              long long cols, cudaStream_t s) {
  column_fold<<<grid_blocks(cols), kThreads, 0, s>>>(partial, out, n_tiles, cols);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
