// Max-pool backward for Hopper (sm_90a), bound to Python through a plain C
// entry point (ctypes; see bigdl_tpu_torch/ops/_build.py).
//
// Replaces: bigdl_tpu/ops/maxpool.py::_bwd_kernel (the Pallas TPU kernel
// launched by _maxpool_grad_nchw). Same function: for an NCHW input x padded
// with -inf by (ph_lo, pw_lo) on the low sides (the high sides are implied by
// the output size Ho x Wo), dx[n,c,h,w] is the sum of dy[n,c,oh,ow] over the
// windows whose FIRST maximum (row-major over the kh x kw window offsets,
// strict >) sits at (h, w). Positions that no window covers get 0; a window
// whose maximum falls on a padded cell routes its gradient nowhere. The
// argmax is recomputed from x: no indices are saved by the forward.
//
// Bound on this card: the work is a handful of compares per element, so the
// bound is bytes: read x and dy once, write dx once. At the ResNet stem
// (x 128x64x112x112 bf16, dy 128x64x56x56, 3x3/s2/p1) that is 462 MB, about
// 0.14 ms at 3.35 TB/s.
//
// Why a gather where the TPU kernel scatters: the TPU kernel walks channel
// slabs in order on one core and scatters dy into a VMEM accumulator of x's
// dtype, one window offset at a time. Here blocks run in parallel and in no
// order; a scatter would need atomics, and bf16 atomics make the bits change
// from run to run. So each input position GATHERS the dy of the at most
// ceil(kh/sh) * ceil(kw/sw) windows that cover it and chose it, in a fixed
// order (oh, then ow ascending), in fp32, and rounds once to x's dtype. That
// accumulates more exactly than the TPU kernel (which sums in bf16 for bf16
// inputs), and two runs give the same bits.
//
// Design: one block per (n*c plane, tile of input rows x columns; at the stem
// a tile is 18 whole rows, so 8192 planes x 7 tiles fill the 132 SMs many
// times over). The block stages in shared memory, as fp32, the x rows and
// columns that its tile's covering windows read (the tile plus its halo,
// -inf outside the input), computes each covering window's argmax offset once
// into shared memory as a 16-bit int, then each thread owns input positions
// and gathers. In device memory it reads x once (plus the halo rows, mostly
// from L2) and dy once, and writes dx once. Later work: 16-byte vector loads
// and stores, cp.async staging of the next tile.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
constexpr int kTilePositions = 2048;  // input positions a block aims to own
constexpr int kMaxTileW = 256;
constexpr int kDefaultSmem = 48 * 1024;
constexpr int kMaxSmem = 227 * 1024;

struct Geom {
  long long planes;
  int h, w, ho, wo;
  int kh, kw, sh, sw, ph, pw;
  int th, tw, tiles_h, tiles_w;
};

__host__ __device__ inline int floor_div(int a, int b) {  // b > 0
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}

__host__ __device__ inline int ceil_div(int a, int b) { return -floor_div(-a, b); }

__device__ inline float to_float(float v) { return v; }
__device__ inline float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ inline T from_float(float v);
template <>
__device__ inline float from_float<float>(float v) { return v; }
template <>
__device__ inline __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's .to(bfloat16)
}

// Shared memory a tile of th x tw input positions can need: the x region its
// covering windows read (fp32) and one 16-bit argmax per covering window.
size_t smem_bytes(const Geom& g, int th, int tw) {
  const int n_oh = std::min(g.ho, (th + g.kh - 2) / g.sh + 1);
  const int n_ow = std::min(g.wo, (tw + g.kw - 2) / g.sw + 1);
  const size_t n_xr = static_cast<size_t>(n_oh - 1) * g.sh + g.kh;
  const size_t n_xc = static_cast<size_t>(n_ow - 1) * g.sw + g.kw;
  return 4 * n_xr * n_xc + 2 * static_cast<size_t>(n_oh) * n_ow;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    maxpool2d_bwd(const T* __restrict__ x, const T* __restrict__ dy, T* __restrict__ dx,
                  Geom g) {
  extern __shared__ float smem[];
  const int tiles = g.tiles_h * g.tiles_w;
  const long long plane = blockIdx.x / tiles;
  const int tile = static_cast<int>(blockIdx.x % tiles);
  const int r0 = (tile / g.tiles_w) * g.th, c0 = (tile % g.tiles_w) * g.tw;
  const int r1 = min(r0 + g.th, g.h), c1 = min(c0 + g.tw, g.w);
  const int tile_w = c1 - c0, tile_n = (r1 - r0) * tile_w;
  const T* xp = x + plane * g.h * g.w;
  const T* dyp = dy + plane * g.ho * g.wo;
  T* dxp = dx + plane * g.h * g.w;

  // the windows that cover some position of the tile
  const int oh0 = max(0, ceil_div(r0 + g.ph - g.kh + 1, g.sh));
  const int oh1 = min(g.ho - 1, floor_div(r1 - 1 + g.ph, g.sh));
  const int ow0 = max(0, ceil_div(c0 + g.pw - g.kw + 1, g.sw));
  const int ow1 = min(g.wo - 1, floor_div(c1 - 1 + g.pw, g.sw));
  const int n_oh = oh1 - oh0 + 1, n_ow = ow1 - ow0 + 1;
  if (n_oh <= 0 || n_ow <= 0) {  // e.g. trailing rows when the stride exceeds the window
    for (int i = threadIdx.x; i < tile_n; i += blockDim.x)
      dxp[static_cast<long long>(r0 + i / tile_w) * g.w + c0 + i % tile_w] = from_float<T>(0.f);
    return;
  }

  // 1. stage the x region those windows read, -inf outside the input
  const int xr0 = oh0 * g.sh - g.ph, xc0 = ow0 * g.sw - g.pw;
  const int n_xr = (n_oh - 1) * g.sh + g.kh, n_xc = (n_ow - 1) * g.sw + g.kw;
  float* xs = smem;
  uint16_t* arg = reinterpret_cast<uint16_t*>(smem + n_xr * n_xc);
  for (int i = threadIdx.x; i < n_xr * n_xc; i += blockDim.x) {
    const int r = xr0 + i / n_xc, c = xc0 + i % n_xc;
    xs[i] = (r >= 0 && r < g.h && c >= 0 && c < g.w)
                ? to_float(xp[static_cast<long long>(r) * g.w + c])
                : -INFINITY;
  }
  __syncthreads();

  // 2. each covering window's first argmax offset, once
  for (int i = threadIdx.x; i < n_oh * n_ow; i += blockDim.x) {
    const float* win = xs + (i / n_ow) * g.sh * n_xc + (i % n_ow) * g.sw;
    float best = win[0];
    int best_k = 0;
    for (int a = 0; a < g.kh; ++a)
      for (int b = 0; b < g.kw; ++b) {
        const float v = win[a * n_xc + b];
        if (v > best) {  // strict: the earliest offset keeps a tie
          best = v;
          best_k = a * g.kw + b;
        }
      }
    arg[i] = static_cast<uint16_t>(best_k);
  }
  __syncthreads();

  // 3. each input position gathers the dy of the windows that chose it
  for (int i = threadIdx.x; i < tile_n; i += blockDim.x) {
    const int hh = r0 + i / tile_w, ww = c0 + i % tile_w;
    const int lo_oh = max(oh0, ceil_div(hh + g.ph - g.kh + 1, g.sh));
    const int hi_oh = min(oh1, floor_div(hh + g.ph, g.sh));
    const int lo_ow = max(ow0, ceil_div(ww + g.pw - g.kw + 1, g.sw));
    const int hi_ow = min(ow1, floor_div(ww + g.pw, g.sw));
    float acc = 0.f;
    for (int oh = lo_oh; oh <= hi_oh; ++oh) {
      const int a = hh + g.ph - oh * g.sh;
      for (int ow = lo_ow; ow <= hi_ow; ++ow) {
        const int b = ww + g.pw - ow * g.sw;
        if (arg[(oh - oh0) * n_ow + (ow - ow0)] == a * g.kw + b)
          acc += to_float(dyp[static_cast<long long>(oh) * g.wo + ow]);
      }
    }
    dxp[static_cast<long long>(hh) * g.w + ww] = from_float<T>(acc);
  }
}

template <typename T>
int launch(const void* x, const void* dy, void* dx, const Geom& g, size_t smem,
           cudaStream_t stream) {
  if (smem > kDefaultSmem) {
    const cudaError_t e = cudaFuncSetAttribute(
        maxpool2d_bwd<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const long long blocks = g.planes * g.tiles_h * g.tiles_w;
  maxpool2d_bwd<T><<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), static_cast<T*>(dx), g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, dy, dx: contiguous (planes, h, w) / (planes, ho, wo) / (planes, h, w) in
// one dtype (1 = bf16, 0 = f32); (ph, pw) are the low-side paddings.
extern "C" int bigdl_maxpool2d_bwd(const void* x, const void* dy, void* dx, int dtype,
                                   long long planes, int h, int w, int ho, int wo, int kh,
                                   int kw, int sh, int sw, int ph, int pw, void* stream) {
  if (planes <= 0 || h <= 0 || w <= 0 || ho <= 0 || wo <= 0 || kh <= 0 || kw <= 0 ||
      sh <= 0 || sw <= 0 || ph < 0 || pw < 0 || kh * kw > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Geom g{planes, h, w, ho, wo, kh, kw, sh, sw, ph, pw, 1, 1, 1, 1};
  g.tw = std::min(w, kMaxTileW);
  g.th = std::max(1, std::min(h, kTilePositions / g.tw));
  // shrink the tile until its shared memory fits the default 48 KB, and past
  // that the card's 227 KB (only very large windows get there)
  while (smem_bytes(g, g.th, g.tw) > kDefaultSmem && (g.th > 1 || g.tw > 1)) {
    if (g.th >= g.tw)
      g.th = (g.th + 1) / 2;
    else
      g.tw = (g.tw + 1) / 2;
  }
  const size_t smem = smem_bytes(g, g.th, g.tw);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  g.tiles_h = (h + g.th - 1) / g.th;
  g.tiles_w = (w + g.tw - 1) / g.tw;
  if (planes * g.tiles_h * g.tiles_w > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return launch<__nv_bfloat16>(x, dy, dx, g, smem, s);
  if (dtype == 0) return launch<float>(x, dy, dx, g, smem, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
