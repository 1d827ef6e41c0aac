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
// Bound on this card: a handful of compares per element, so the bound is
// bytes: read x and dy once, write dx once, at 3.35 TB/s. bf16, at the
// shapes the main paths run: the flagship's stem pool (128, 64, 112, 112)
// 3x3/s2/p1 462 MB, 0.1380 ms; VGG-16's 2x2/s2 pools at batch 64, (64, 64,
// 224, 224) 0.2761 ms, (64, 128, 112, 112) 0.1380, (64, 256, 56, 56)
// 0.0690, (64, 512, 28, 28) 0.0345, (64, 512, 14, 14) 0.0086. A copy of the
// same bytes with 16-byte accesses takes 0.166 ms at the stem on an H100
// (2.8 TB/s; tools/torch_maxpool_bwd_ablation.py `copy16`).
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
// What held the first design (one block per plane tile) at 10-12x the
// bound (1.598 ms at the stem, 5.25 ms over VGG-16's five pools): it was
// bound by instruction issue, not memory. Its geometry was all runtime
// values, so every staging, argmax and gather step paid runtime integer
// divides (~20 instructions each, four calls of floor/ceil division per
// position); x, dy and dx moved 2 bytes an instruction; x was widened to
// fp32 in shared memory; a block loaded, computed and wrote with nothing in
// flight between the phases. Taking out any one part saved only 5-15%
// (at the stem: no argmax search 1.43 ms, no dy reads 1.36, no x reads
// 1.45; the ablation tool on an H100).
//
// This design:
// - Work items, one a block. An item is a group of whole planes (planes
//   smaller than the item size: the stem's 112x112, VGG-16's 56x56 to
//   14x14) or a band of dx rows of one plane (VGG-16's 224x224 and
//   112x112). The item size is the largest of 16384, 8192 or 4096 dx
//   elements that leaves at least kItemsPerSm items an SM (items of at
//   most 8192 or 4096 took 4-29% longer at the stem and VGG-16's pool2, of
//   32768 2-8% longer: items8k / items4k / items32k in the ablation tool
//   on an H100). Its x
//   rows, dy rows and dx rows are each ONE contiguous range of device
//   memory, whatever the row width: staged by 16-byte cp.async copies and
//   written in 16-byte chunks aligned in device memory, element by element
//   only where a chunk would leave the range (dx) or the tensor (x, dy). So
//   rows of 56 or 28 bytes, 392-byte planes and a data_ptr at any element
//   offset need no other path.
// - A band owns its dx rows and computes the argmax of every window that
//   covers one of them; overlapping windows on a band's edge (3x3/s2) are
//   computed by both bands, re-reading one dy row and three x rows (from
//   L2). Whole planes and 2x2/s2 re-read nothing. Each argmax goes into
//   shared memory once, as a 16-bit offset.
// - x and dy are staged in their own dtype (bf16 compares are exact) and
//   dx is written in 16-byte chunks (8 bf16 or 4 f32). The argmax of a
//   window is its first offset with a strictly larger value, starting from
//   offset 0 (so a NaN at offset 0 keeps it, as the plain version does);
//   windows with no padded cell skip the bounds tests.
// - Compile-time geometry: instances for 3x3/s2 and 2x2/s2 (the padding
//   stays a runtime value) and one general instance of the same code for
//   every other window and stride. No integer divide is left: the fixed
//   instances divide by constants, and every runtime divisor (W, H*W, Wo,
//   Ho, the strides of the general instance, bands a plane) is a
//   FastDivmod, a multiply-high and a shift. In the fixed instances a dx
//   chunk in one row (or across two) reads the argmaxes and dy of the
//   window columns it touches once into registers, and each element's
//   windows are then compile-time register indices.
// - Measured and not kept: a persistent grid whose blocks walk the items
//   through a ring of 2 or 3 staging buffers, the next item's cp.async
//   copies in flight while one is computed, was 8-16% slower at the stem
//   and 14-50% slower at VGG-16's pool2 than one item a block, whose
//   neighbours on the SM overlap its loads instead (ring2 / ring3).
//
// 3x3 windows at stride 1 (Inception-v1's branch pools, 28-, 14- and
// 7-wide planes) have an instance of their own, maxpool2d_bwd_s1: one
// window per position, so the argmax search and the gather cost four times
// what they cost at s2, and its rows are 56, 28 or 14 bytes. Same items and
// staging; then three phases, with the padding a runtime value:
// - Frame: window (oh, ow) sits at the shifted position (sr, s) = (oh + 2 -
//   ph, ow + 2 - pw). Its cells are x rows sr - 2 .. sr, columns s - 2 ..
//   s, and its offset (a, b) is dx (sr - 2 + a, s - 2 + b); dx (r, c)
//   gathers the windows at shifted rows r .. r + 2, columns c .. c + 2.
//   Each window's argmax, as a one-hot 16-bit mask (bit a * 3 + b), and its
//   dy (fp32) live in shared memory in a frame of (rows + 2) x cs slots a
//   plane, cs = 8 * ceil(w / 8) + 4; slots that hold no window keep mask 0,
//   so the gather needs no bounds test and reads aligned vectors.
// - 1. Argmax: a thread walks one run of window rows of 4 adjacent windows,
//   reading each x cell of a row once into registers. The search is
//   separable: the first maximum of each row's three cells (NaN counted as
//   -inf), then strict > down the three rows, the first two rows' result
//   carried to the next window row. A NaN at a window's offset 0 keeps it
//   at offset 0 (the first row's maximum counts as +inf and its offset as
//   0), as the plain version's strict > from offset 0 does. Only the column
//   groups that hold windows get threads, and a column's window rows are
//   split into as many runs of equal length (within one) as let all of a
//   block's runs go at once: a run costs two rows of start-up, a second
//   round of runs or a warp of idle lanes costs more.
// - 2. Gather: a thread takes 8 dx columns of one row (a row's last 8 run
//   past its end): 3 x 10 masks and dy into registers, 72 bit tests at
//   compile-time positions, fp32 sums in a fixed order, rounded once,
//   written into the x staging buffer (x is no longer read).
// - 3. The item's dx range goes out in 16-byte chunks aligned in device
//   memory, element by element at its ends: rows narrower than a chunk
//   (7 wide) and chunks across rows or planes need no other path.
// - Bound by the block's own work, not by memory: with nothing staged it
//   still takes 95% of its time at Inception's 3a shape (`noload` in the
//   ablation tool, on an H100); phase 1 takes about 43% of it, phase 2
//   about 22% (`s1no1`, `s1no2`). A persistent grid that stages the next
//   item while one is computed was 43% slower there (`s1ring2`).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

#include "vec_common.cuh"

namespace {

// dx elements an item aims to own: the most, unless that leaves fewer than
// kItemsPerSm items an SM, then halved down to the least
constexpr int kItemElemsMax = 16384;
constexpr int kItemElemsMin = 4096;
constexpr int kItemsPerSm = 16;
constexpr int kDefaultSmem = 48 * 1024;
constexpr int kMaxSmem = 227 * 1024;
constexpr int kSmemTarget = 48 * 1024;  // shrink bands above this (four blocks an SM)

// n / d and n % d for 0 <= n < 2^31 and a divisor d >= 1 fixed at launch:
// q = umulhi(n, mul) >> shr with mul = ceil(2^(31 + l) / d), l = ceil(log2 d)
// (CUTLASS's FastDivmod).
struct FastDivmod {
  int d;
  uint32_t mul, shr;
  FastDivmod() = default;
  explicit FastDivmod(int divisor) : d(divisor), mul(0), shr(0) {
    if (divisor > 1) {
      const uint32_t l = 32 - __builtin_clz(static_cast<uint32_t>(divisor) - 1);
      mul = static_cast<uint32_t>(((1ull << (31 + l)) + divisor - 1) / divisor);
      shr = l - 1;
    }
  }
  __device__ __forceinline__ int div(int n) const {
    return mul ? static_cast<int>(__umulhi(static_cast<uint32_t>(n), mul) >> shr) : n;
  }
  __device__ __forceinline__ void divmod(int n, int& q, int& r) const {
    q = div(n);
    r = n - q * d;
  }
};

struct Params {
  long long planes, x_total, dy_total;  // planes; elements of x (and dx) and of dy
  int h, w, ho, wo, kh, kw, sh, sw, ph, pw;
  int nj, ni;       // ceil(kh/sh), ceil(kw/sw): windows that cover one row, one column
  int hw, howo;     // h*w, ho*wo
  int group;        // planes an item holds; 0: items are row bands of one plane
  int band_rows;    // dx rows a band owns
  long long items;
  int x_stage, dy_stage;  // elements of the x and dy staging buffers (multiples of 16 bytes)
  int windows;            // windows an item computes at most
  FastDivmod fd_w, fd_hw, fd_wo, fd_ho, fd_sh, fd_sw, fd_bands;
  // the 3x3/s1 instance: slots a frame row, frame rows a plane (dx rows + 2),
  // bytes of the masks' frame; phase-1 column groups and runs a column,
  // phase-2 column groups, rows a plane
  int cs, pad_rows, mask_bytes;
  int g_lo;  // the first phase-1 column group, -1: none
  FastDivmod fd_groups1, fd_runs, fd_groups2, fd_h;
};

// One item: planes [p0, p0 + np); dx rows [hr0, hr1) of each; windows of
// rows [oh_lo, oh_lo + n_oh); x rows [xr_lo, xr_lo + n_xr) staged.
struct Item {
  long long p0;
  int np, hr0, hr1, oh_lo, n_oh, xr_lo, n_xr;
};

__host__ __device__ __forceinline__ int imin(int a, int b) { return a < b ? a : b; }
__host__ __device__ __forceinline__ int imax(int a, int b) { return a > b ? a : b; }

// n / sh and n / sw for n >= 0: by a constant in the fixed instances, by a
// FastDivmod in the general one (on the host, a plain divide).
template <int SH>
__host__ __device__ __forceinline__ int div_sh(const Params& p, int n) {
  if constexpr (SH > 0) return static_cast<int>(static_cast<unsigned>(n) / SH);
#ifdef __CUDA_ARCH__
  return p.fd_sh.div(n);
#else
  return n / p.sh;
#endif
}

template <int SW>
__device__ __forceinline__ int div_sw(const Params& p, int n) {
  if constexpr (SW > 0) return static_cast<int>(static_cast<unsigned>(n) / SW);
  return p.fd_sw.div(n);
}

// The window rows that cover dx rows [hr0, hr1) and the x rows they read.
template <int SH>
__host__ __device__ inline void cover_rows(const Params& p, int hr0, int hr1, Item& t) {
  const int num = hr0 + p.ph - p.kh + 1;  // oh*sh - ph + kh - 1 >= hr0
  const int lo = num <= 0 ? 0 : div_sh<SH>(p, num + p.sh - 1);
  const int hi = imin(p.ho - 1, div_sh<SH>(p, hr1 - 1 + p.ph));
  t.oh_lo = lo;
  t.n_oh = imax(0, hi - lo + 1);
  t.xr_lo = imax(0, lo * p.sh - p.ph);
  t.n_xr = t.n_oh > 0 ? imax(0, imin(p.h, hi * p.sh - p.ph + p.kh) - t.xr_lo) : 0;
}

template <int SH>
__device__ __forceinline__ Item item_at(const Params& p, long long it) {
  Item t;
  if (p.group) {
    t.p0 = it * p.group;
    t.np = static_cast<int>(min(static_cast<long long>(p.group), p.planes - t.p0));
    t.hr0 = 0;
    t.hr1 = p.h;
    t.oh_lo = 0;
    t.n_oh = p.ho;
    t.xr_lo = 0;
    t.n_xr = p.h;
  } else {
    int plane, band;
    p.fd_bands.divmod(static_cast<int>(it), plane, band);
    t.p0 = plane;
    t.np = 1;
    t.hr0 = band * p.band_rows;
    t.hr1 = imin(t.hr0 + p.band_rows, p.h);
    cover_rows<SH>(p, t.hr0, t.hr1, t);
  }
  return t;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Elements of src before src + start back to the last 16-byte boundary.
template <typename T>
__device__ __forceinline__ int head_of(const T* src, long long start) {
  return static_cast<int>(reinterpret_cast<uintptr_t>(src + start) % 16 / sizeof(T));
}

// Copies src[start, start + len) to dst[head, head + len), dst 16-byte
// aligned: the 16-byte chunks that lie inside the tensor (total elements) by
// cp.async, the elements of the others one at a time.
template <typename T>
__device__ __forceinline__ void stage(T* dst, const T* src, long long total, long long start,
                                      int len) {
  constexpr int VEC = 16 / sizeof(T);
  const int head = head_of(src, start);
  const long long a0 = start - head;
  const int chunks = (head + len + VEC - 1) / VEC;
  for (int k = threadIdx.x; k < chunks; k += kThreads) {
    const long long g0 = a0 + static_cast<long long>(k) * VEC;
    if (g0 >= 0 && g0 + VEC <= total) {
      cp_async16(dst + k * VEC, src + g0);
    } else {
      const long long e1 = min(g0 + VEC, start + len);
      for (long long e = max(g0, start); e < e1; ++e) dst[e - a0] = src[e];
    }
  }
}

// Starts the copies that stage item it's x rows and dy rows in buf.
template <typename T, int SH>
__device__ __forceinline__ void issue(const T* x, const T* dy, T* buf, const Params& p,
                                      long long it) {
  const Item t = item_at<SH>(p, it);
  const long long x0 = t.p0 * p.hw + static_cast<long long>(t.xr_lo) * p.w;
  const long long y0 = t.p0 * p.howo + static_cast<long long>(t.oh_lo) * p.wo;
  if (t.n_oh > 0) {
    stage(buf, x, p.x_total, x0, (t.np - 1) * p.hw + t.n_xr * p.w);
    stage(buf + p.x_stage, dy, p.dy_total, y0, (t.np - 1) * p.howo + t.n_oh * p.wo);
  }
}

// The gradient at plane-local pl, row r, column c of an item: the dy of each
// window that covers (r, c) and chose it, oh then ow ascending, in fp32.
template <typename T, int KH, int KW, int SH, int SW>
__device__ __forceinline__ float grad_at(const Params& p, const Item& t, const uint16_t* am,
                                         const T* ys, int pl, int r, int c) {
  const int kh = KH ? KH : p.kh, kw = KW ? KW : p.kw;
  const int sh = SH ? SH : p.sh, sw = SW ? SW : p.sw;
  const int nj = KH ? (KH + SH - 1) / SH : p.nj, ni = KW ? (KW + SW - 1) / SW : p.ni;
  const int oht = div_sh<SH>(p, r + p.ph), ra = r + p.ph - oht * sh;
  const int owt = div_sw<SW>(p, c + p.pw), cb = c + p.pw - owt * sw;
  float acc = 0.f;
#pragma unroll
  for (int j = nj - 1; j >= 0; --j) {
    const int oh = oht - j, a = ra + j * sh;
    if (a >= kh || oh < 0 || oh >= p.ho) continue;
    const int row = (pl * t.n_oh + oh - t.oh_lo) * p.wo;
#pragma unroll
    for (int i = ni - 1; i >= 0; --i) {
      const int ow = owt - i, b = cb + i * sw;
      if (b >= kw || ow < 0 || ow >= p.wo) continue;
      if (am[row + ow] == a * kw + b) acc += to_float(ys[row + ow]);
    }
  }
  return acc;
}

// The gradient of VEC dx elements in row r of plane pl at columns c, c+1,
// ..., for a fixed geometry (SW a power of 2), P = (c + pw) mod SW: the
// argmax codes and dy of the window columns these touch are read once into
// registers (a code relative to the row offset a, so that a compare with
// the compile-time b decides; -1 where no window is), then each element adds
// the dy of the windows that chose it, oh then ow ascending, with every
// index fixed at compile time. c may be negative and c + VEC may pass the
// row's end: columns outside [0, w) get whatever their windows give, and
// the caller drops them.
template <typename T, int KH, int KW, int SH, int SW, int P>
__device__ __forceinline__ void grad_row_chunk(const Params& p, const Item& t,
                                               const uint16_t* am, const T* ys, int pl, int r,
                                               int c, Pack<T, 16 / sizeof(T)>& v) {
  static_assert((SW & (SW - 1)) == 0, "the column phase takes SW a power of 2");
  constexpr int VEC = 16 / sizeof(T);
  constexpr int NJ = (KH + SH - 1) / SH, NI = (KW + SW - 1) / SW;
  constexpr int OWN = (P + VEC - 1) / SW + NI;  // window columns from owt(c) - (NI - 1) on
  constexpr int LOG_SW = SW == 1 ? 0 : SW == 2 ? 1 : SW == 4 ? 2 : 3;
  const int oht = static_cast<int>(static_cast<unsigned>(r + p.ph) / SH);
  const int ra = r + p.ph - oht * SH;
  const int ow_min = ((c + p.pw) >> LOG_SW) - (NI - 1);  // floor, also for c + pw < 0
  int code[NJ][OWN];
  float val[NJ][OWN];
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int oh = oht - j, a = ra + j * SH;
    const bool row_ok = a < KH && oh >= 0 && oh < p.ho;
    const int row = (pl * t.n_oh + oh - t.oh_lo) * p.wo;
#pragma unroll
    for (int q = 0; q < OWN; ++q) {
      const int ow = ow_min + q;
      const bool ok = row_ok && ow >= 0 && ow < p.wo;
      code[j][q] = ok ? static_cast<int>(am[row + ow]) - a * KW : -1;
      val[j][q] = ok ? to_float(ys[row + ow]) : 0.f;
    }
  }
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    float acc = 0.f;
#pragma unroll
    for (int j = NJ - 1; j >= 0; --j) {
#pragma unroll
      for (int i = NI - 1; i >= 0; --i) {
        const int b = (P + e) % SW + i * SW;
        const int q = (P + e) / SW + (NI - 1) - i;
        if (b < KW && code[j][q] == b) acc += val[j][q];
      }
    }
    v.v[e] = from_float<T>(acc);
  }
}

// grad_row_chunk for the column phase of c (SW <= 2).
template <typename T, int KH, int KW, int SH, int SW>
__device__ __forceinline__ void row_chunk(const Params& p, const Item& t, const uint16_t* am,
                                          const T* ys, int pl, int r, int c,
                                          Pack<T, 16 / sizeof(T)>& v) {
  static_assert(SW <= 2, "row_chunk: add a phase for SW > 2");
  if (((c + p.pw) & (SW - 1)) == 0)
    grad_row_chunk<T, KH, KW, SH, SW, 0>(p, t, am, ys, pl, r, c, v);
  else
    grad_row_chunk<T, KH, KW, SH, SW, SW - 1>(p, t, am, ys, pl, r, c, v);
}

template <typename T, int KH, int KW, int SH, int SW>
__device__ __forceinline__ void compute(T* __restrict__ dx, const T* buf, uint16_t* am,
                                        const T* x, const T* dy, const Params& p, long long it) {
  constexpr int VEC = 16 / sizeof(T);
  const int kh = KH ? KH : p.kh, kw = KW ? KW : p.kw;
  const int sh = SH ? SH : p.sh, sw = SW ? SW : p.sw;
  const Item t = item_at<SH>(p, it);
  const T* xs =
      buf + head_of(x, t.p0 * p.hw + static_cast<long long>(t.xr_lo) * p.w);
  const T* ys = buf + p.x_stage +
                head_of(dy, t.p0 * p.howo + static_cast<long long>(t.oh_lo) * p.wo);

  // 1. each window's first argmax offset, once
  const int n_win = t.np * t.n_oh * p.wo;
  for (int i = threadIdx.x; i < n_win; i += kThreads) {
    int q, ow, pl, ohl;
    p.fd_wo.divmod(i, q, ow);
    if (t.np == 1) {
      pl = 0;
      ohl = q;
    } else {
      p.fd_ho.divmod(q, pl, ohl);
    }
    const int r0 = (t.oh_lo + ohl) * sh - p.ph, c0 = ow * sw - p.pw;
    const T* win = xs + pl * p.hw + (r0 - t.xr_lo) * p.w + c0;
    float best = -INFINITY;
    int best_k = 0;
    if (r0 >= 0 && r0 + kh <= p.h && c0 >= 0 && c0 + kw <= p.w) {  // no padded cell
#pragma unroll
      for (int a = 0; a < kh; ++a)
#pragma unroll
        for (int b = 0; b < kw; ++b) {
          const float v = to_float(win[a * p.w + b]);
          if ((a == 0 && b == 0) || v > best) {
            best = v;
            best_k = a * kw + b;
          }
        }
    } else {
#pragma unroll
      for (int a = 0; a < kh; ++a) {
        const bool row_in = r0 + a >= 0 && r0 + a < p.h;
#pragma unroll
        for (int b = 0; b < kw; ++b) {
          const float v = row_in && c0 + b >= 0 && c0 + b < p.w ? to_float(win[a * p.w + b])
                                                               : -INFINITY;
          if ((a == 0 && b == 0) || v > best) {  // strict: the earliest offset keeps a tie
            best = v;
            best_k = a * kw + b;
          }
        }
      }
    }
    am[i] = static_cast<uint16_t>(best_k);
  }
  __syncthreads();

  // 2. dx over the item's rows: 16-byte chunks aligned in device memory,
  // element by element at the ends of the range
  const long long d0 = t.p0 * p.hw + static_cast<long long>(t.hr0) * p.w;
  const int len = (t.np - 1) * p.hw + (t.hr1 - t.hr0) * p.w;
  const int head = min(len, (VEC - head_of(dx, d0)) % VEC);
  const int body = (len - head) / VEC;
  const int ends = len - body * VEC;  // head + tail elements
  const int base = t.hr0 * p.w;       // offset of d0 from plane p0's start
  for (int u = threadIdx.x; u < body + ends; u += kThreads) {
    const bool chunk = u < body;
    const int off = chunk ? head + u * VEC : (u - body < head ? u - body : u - body + body * VEC);
    int pl, rem, r, c;
    if (t.np == 1) {
      pl = 0;
      rem = base + off;
    } else {
      p.fd_hw.divmod(base + off, pl, rem);
    }
    p.fd_w.divmod(rem, r, c);
    if (chunk) {
      Pack<T, VEC> v;
      if constexpr (KH > 0) {
        if (c + VEC <= p.w) {  // the chunk lies in one row
          row_chunk<T, KH, KW, SH, SW>(p, t, am, ys, pl, r, c, v);
          store<T, VEC>(dx + d0 + off, v);
          continue;
        }
        if (VEC <= p.w) {  // in two rows: the first's columns, then the next row's
          Pack<T, VEC> next;
          row_chunk<T, KH, KW, SH, SW>(p, t, am, ys, pl, r, c, v);
          const bool wrap = r + 1 == p.h;  // the next row opens the next plane
          row_chunk<T, KH, KW, SH, SW>(p, t, am, ys, pl + wrap, wrap ? 0 : r + 1, c - p.w, next);
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            if (c + e >= p.w) v.v[e] = next.v[e];
          store<T, VEC>(dx + d0 + off, v);
          continue;
        }
      }
      // element by element: the general instance (whose loops over the
      // covering windows keep this loop rolled: its elements are stored one
      // at a time rather than packed through local memory), rows shorter
      // than a chunk
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const T g = from_float<T>(grad_at<T, KH, KW, SH, SW>(p, t, am, ys, pl, r, c));
        if constexpr (KH > 0)
          v.v[e] = g;
        else
          dx[d0 + off + e] = g;
        if (++c == p.w) {
          c = 0;
          if (++r == p.h) {
            r = 0;
            ++pl;
          }
        }
      }
      if constexpr (KH > 0) store<T, VEC>(dx + d0 + off, v);
    } else {
      dx[d0 + off] = from_float<T>(grad_at<T, KH, KW, SH, SW>(p, t, am, ys, pl, r, c));
    }
  }
}

// KH, KW, SH, SW > 0: a fixed geometry; all 0: the general instance.
// (With the one-block minimum, ptxas gives the general bf16 instance the
// registers it needs; without it, it spilled 32 bytes.)
template <typename T, int KH, int KW, int SH, int SW>
__global__ void __launch_bounds__(kThreads, 1)
    maxpool2d_bwd(const T* __restrict__ x, const T* __restrict__ dy, T* __restrict__ dx,
                  Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* buf = reinterpret_cast<T*>(smem);
  uint16_t* am = reinterpret_cast<uint16_t*>(smem + sizeof(T) * (p.x_stage + p.dy_stage));
  issue<T, SH>(x, dy, buf, p, blockIdx.x);
  cp_async_wait_all();
  __syncthreads();
  compute<T, KH, KW, SH, SW>(dx, buf, am, x, dy, p, blockIdx.x);
}

// ---- the 3x3/s1 instance (see the note at the top)

// The three-cell maxima of one x row at the window columns s0 .. s0 + 3 of
// a phase-1 thread (cells s - 2 .. s, read from xr[0 .. 5], which lie in
// shared memory whatever they hold; ok: bit k set where column s0 - 2 + k
// is a cell of a staged row): m, the largest cell with NaN as -inf; t, the
// first of the three offsets that holds it; nan, whether the cell at
// offset 0 is a NaN.
template <typename T>
__device__ __forceinline__ void row_triples(const T* xr, unsigned ok, float (&m)[4],
                                            int (&t)[4], bool (&nan)[4]) {
  float v[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    const float raw = to_float(xr[k]);
    const bool in = ok >> k & 1u;
    if (k < 4) nan[k] = in && raw != raw;
    v[k] = in ? fmaxf(raw, -INFINITY) : -INFINITY;  // NaN -> -inf
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    m[j] = fmaxf(fmaxf(v[j], v[j + 1]), v[j + 2]);
    t[j] = v[j] == m[j] ? 0 : v[j + 1] == m[j] ? 1 : 2;
  }
}

// Phase 1 for plane pl, run `run` of the item's window rows (its frame rows
// that hold windows, split into p.fd_runs.d runs whose lengths differ by at
// most one) and the frame columns [4 * group, + 4): each window's argmax
// offset as a one-hot mask, 1 << (a * 3 + b), and its dy into the frame.
// Slots that hold no window keep the mask 0 they were cleared to.
template <typename T>
__device__ __forceinline__ void s1_windows(const Params& p, const Item& t, const T* xs,
                                           const T* ys, uint16_t* masks, float* dyw, int pl,
                                           int run, int group) {
  // frame rows [v0, v1) hold windows: oh = hr0 + sr + ph - 2 in [0, ho)
  const int v0 = imax(0, 2 - p.ph - t.hr0);
  const int nv = imin(t.hr1 - t.hr0 + 2, p.ho + 2 - p.ph - t.hr0) - v0;
  const int sr_lo = v0 + p.fd_runs.div(run * nv), sr_hi = v0 + p.fd_runs.div((run + 1) * nv);
  if (sr_lo >= sr_hi) return;
  const int s0 = group * 4;
  const int frame = pl * p.pad_rows * p.cs + s0;
  uint2* mw = reinterpret_cast<uint2*>(masks + frame);
  float4* dw = reinterpret_cast<float4*>(dyw + frame);
  const int step = p.cs / 4;  // a frame row, in 4-slot vectors
  const int ow0 = s0 + p.pw - 2;
  bool win[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) win[j] = ow0 + j >= 0 && ow0 + j < p.wo;
  // x row g at xp + g * w (a row outside the staged ones reads the nearest
  // staged row, masked); the dy of frame row sr at yp + sr * wo
  const T* xp = xs + pl * p.hw + s0 - 2 - t.xr_lo * p.w;
  const int g_last = t.xr_lo + t.n_xr - 1;
  unsigned cols = 0;  // bit k: column s0 - 2 + k lies in the row
#pragma unroll
  for (int k = 0; k < 6; ++k)
    cols |= static_cast<unsigned>(s0 - 2 + k >= 0 && s0 - 2 + k < p.w) << k;
  auto row = [&](int g, float (&m)[4], int (&tt)[4], bool (&nan)[4]) {
    row_triples(xp + imin(imax(g, t.xr_lo), g_last) * p.w,
                g >= t.xr_lo && g <= g_last ? cols : 0u, m, tt, nan);
  };
  const T* yp = ys + (pl * t.n_oh - t.oh_lo + t.hr0 + p.ph - 2) * p.wo + ow0;
  // carried from row to row: d (dm, dc), the first two rows of the next
  // window row, combined; f (fm, ft), the last x row as a first row
  float dm[4], fm[4], m[4];
  int dc[4], ft[4], tt[4];
  bool nan[4];
  int g = t.hr0 + sr_lo - 2;  // the first x row of the run's first window row
  row(g, m, tt, nan);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    fm[j] = nan[j] ? INFINITY : m[j];
    ft[j] = nan[j] ? 0 : tt[j];
  }
  row(g + 1, m, tt, nan);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    dm[j] = fmaxf(fm[j], m[j]);
    dc[j] = fm[j] == dm[j] ? ft[j] : 3 + tt[j];
    fm[j] = nan[j] ? INFINITY : m[j];
    ft[j] = nan[j] ? 0 : tt[j];
  }
#pragma unroll 2
  for (int sr = sr_lo; sr < sr_hi; ++sr) {
    row(t.hr0 + sr, m, tt, nan);
    // the dy of slots that hold no window is read within shared memory and
    // never used (their mask is 0)
    const T* yr = yp + sr * p.wo;
    uint32_t mask[4];
    float val[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float mx = fmaxf(dm[j], m[j]);
      mask[j] = win[j] ? 1u << static_cast<uint32_t>(dm[j] == mx ? dc[j] : 6 + tt[j]) : 0u;
      val[j] = to_float(yr[j]);
      dm[j] = fmaxf(fm[j], m[j]);
      dc[j] = fm[j] == dm[j] ? ft[j] : 3 + tt[j];
      fm[j] = nan[j] ? INFINITY : m[j];
      ft[j] = nan[j] ? 0 : tt[j];
    }
    mw[sr * step] = make_uint2(mask[0] | mask[1] << 16, mask[2] | mask[3] << 16);
    dw[sr * step] = make_float4(val[0], val[1], val[2], val[3]);
  }
}

// Phase 2 for dx row r of plane pl (item-relative), columns c .. c + 7:
// the windows at frame rows r .. r + 2 and slots c .. c + 9, each one's
// mask tested at the compile-time offset that lands on the element; the
// sums go to out[0 .. 7] (columns at or past w are not written).
template <typename T>
__device__ __forceinline__ void s1_gather(const Params& p, const uint16_t* masks,
                                          const float* dyw, T* out, int pl, int r, int c) {
  float acc[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) acc[e] = 0.f;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const int a = 2 - i;  // the window offset row that lands on row r
    const int slot = (pl * p.pad_rows + r + i) * p.cs + c;
    const uint2 m0 = *reinterpret_cast<const uint2*>(masks + slot);
    const uint2 m1 = *reinterpret_cast<const uint2*>(masks + slot + 4);
    const uint32_t m2 = *reinterpret_cast<const uint32_t*>(masks + slot + 8);
    const float4 d0 = *reinterpret_cast<const float4*>(dyw + slot);
    const float4 d1 = *reinterpret_cast<const float4*>(dyw + slot + 4);
    const float2 d2 = *reinterpret_cast<const float2*>(dyw + slot + 8);
    const uint32_t mask[5] = {m0.x, m0.y, m1.x, m1.y, m2};  // two slots a word
    const float val[10] = {d0.x, d0.y, d0.z, d0.w, d1.x, d1.y, d1.z, d1.w, d2.x, d2.y};
#pragma unroll
    for (int q = 0; q < 10; ++q)
#pragma unroll
      for (int b = 0; b < 3; ++b) {
        const int e = q - 2 + b;  // the window at slot c + q lands on column c + e at offset (a, b)
        if (e >= 0 && e < 8 && (mask[q / 2] >> (16 * (q % 2) + 3 * a + b) & 1u)) acc[e] += val[q];
      }
  }
#pragma unroll
  for (int e = 0; e < 8; ++e)
    if (c + e < p.w) out[e] = from_float<T>(acc[e]);
}

template <typename T>
__device__ __forceinline__ void compute_s1(T* __restrict__ dx, T* buf, unsigned char* smem,
                                           const T* x, const T* dy, const Params& p,
                                           long long it) {
  constexpr int VEC = 16 / sizeof(T);
  const Item t = item_at<1>(p, it);
  const T* xs = buf + head_of(x, t.p0 * p.hw + static_cast<long long>(t.xr_lo) * p.w);
  const T* ys = buf + p.x_stage +
                head_of(dy, t.p0 * p.howo + static_cast<long long>(t.oh_lo) * p.wo);
  uint16_t* masks = reinterpret_cast<uint16_t*>(smem);
  float* dyw = reinterpret_cast<float*>(smem + p.mask_bytes +
                                        sizeof(T) * (p.x_stage + p.dy_stage));

  // 1. each window's argmax offset (a one-hot mask) and dy into the frame,
  // for the column groups [g_lo, + fd_groups1.d) that hold windows
  const int n1 = p.g_lo < 0 ? 0 : t.np * p.fd_runs.d * p.fd_groups1.d;
  for (int u = threadIdx.x; u < n1; u += kThreads) {
    int q, group, pl, run;
    p.fd_groups1.divmod(u, q, group);
    p.fd_runs.divmod(q, pl, run);
    s1_windows<T>(p, t, xs, ys, masks, dyw, pl, run, p.g_lo + group);
  }
  __syncthreads();

  // 2. dx rows into the x buffer, at the alignment dx has in device memory
  const long long d0 = t.p0 * p.hw + static_cast<long long>(t.hr0) * p.w;
  const int head = head_of(dx, d0);
  const int rows = t.hr1 - t.hr0;
  const int n2 = t.np * rows * p.fd_groups2.d;
  for (int u = threadIdx.x; u < n2; u += kThreads) {
    int q, group, pl, r;
    p.fd_groups2.divmod(u, q, group);
    if (t.np == 1) {
      pl = 0;
      r = q;
    } else {
      p.fd_h.divmod(q, pl, r);
    }
    s1_gather<T>(p, masks, dyw, buf + head + pl * p.hw + r * p.w + group * 8, pl, r, group * 8);
  }
  __syncthreads();

  // 3. out in 16-byte chunks aligned in device memory, element by element at the ends
  const int len = (t.np - 1) * p.hw + rows * p.w;
  const long long a0 = d0 - head;
  const int chunks = (head + len + VEC - 1) / VEC;
  for (int k = threadIdx.x; k < chunks; k += kThreads) {
    const long long g0 = a0 + static_cast<long long>(k) * VEC;
    if (g0 >= d0 && g0 + VEC <= d0 + len) {
      store<T, VEC>(dx + g0, load<T, VEC>(buf + k * VEC));
    } else {
      const long long e1 = min(g0 + VEC, d0 + len);
      for (long long e = max(g0, d0); e < e1; ++e) dx[e] = buf[e - a0];
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 4)
    maxpool2d_bwd_s1(const T* __restrict__ x, const T* __restrict__ dy, T* __restrict__ dx,
                     Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* buf = reinterpret_cast<T*>(smem + p.mask_bytes);  // x, then dy
  issue<T, 1>(x, dy, buf, p, blockIdx.x);
  for (int k = threadIdx.x; k < p.mask_bytes / 16; k += kThreads)  // no window: mask 0
    reinterpret_cast<uint4*>(smem)[k] = make_uint4(0, 0, 0, 0);
  cp_async_wait_all();
  __syncthreads();
  compute_s1<T>(dx, buf, smem, x, dy, p, blockIdx.x);
}

int round_up(int n, int m) { return (n + m - 1) / m * m; }

// Sizes the items for geometry p (plane groups or row bands) and their
// staging buffers; returns the shared memory a block needs.
int item_elems(long long total) {
  static int sms = 0;  // of the first card asked
  if (sms == 0) {
    int dev = 0, n = 0;
    sms = cudaGetDevice(&dev) == cudaSuccess &&
                  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) == cudaSuccess
              ? n
              : 132;
  }
  int e = kItemElemsMax;
  while (e > kItemElemsMin && total / e < static_cast<long long>(kItemsPerSm) * sms) e /= 2;
  return e;
}

size_t plan(Params& p, int vec, int elem) {
  auto smem = [&] {
    return static_cast<size_t>(p.x_stage + p.dy_stage) * elem +
           static_cast<size_t>(round_up(p.windows, 8)) * 2;
  };
  const int target = item_elems(p.x_total);
  if (p.hw < target) {
    p.group = std::max(1, target / p.hw);
    p.band_rows = p.h;
    p.items = (p.planes + p.group - 1) / p.group;
    p.x_stage = round_up(p.group * p.hw + vec - 1, vec);
    p.dy_stage = round_up(p.group * p.howo + vec - 1, vec);
    p.windows = p.group * p.howo;
    return smem();
  }
  p.group = 0;
  const int bands = std::min(p.h, (p.hw + target - 1) / target);
  p.band_rows = round_up((p.h + bands - 1) / bands, p.sh);
  for (;;) {
    int x_max = 0, win_max = 0;
    for (int r0 = 0; r0 < p.h; r0 += p.band_rows) {
      Item t;
      cover_rows<0>(p, r0, std::min(r0 + p.band_rows, p.h), t);
      x_max = std::max(x_max, t.n_xr * p.w);
      win_max = std::max(win_max, t.n_oh * p.wo);
    }
    p.x_stage = round_up(x_max + vec - 1, vec);
    p.dy_stage = round_up(win_max + vec - 1, vec);
    p.windows = win_max;
    if (smem() <= kSmemTarget || p.band_rows == 1) break;
    p.band_rows = std::max(1, p.band_rows / 2);
  }
  p.items = p.planes * ((p.h + p.band_rows - 1) / p.band_rows);
  return smem();
}

template <typename T, int KH, int KW, int SH, int SW>
int launch(const void* x, const void* dy, void* dx, Params p, cudaStream_t stream) {
  const size_t smem = plan(p, 16 / sizeof(T), sizeof(T));
  if (smem > kMaxSmem || p.items > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  p.fd_bands = FastDivmod(p.group ? 1 : (p.h + p.band_rows - 1) / p.band_rows);
  auto kernel = maxpool2d_bwd<T, KH, KW, SH, SW>;
  if (smem > kDefaultSmem) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<static_cast<unsigned>(p.items), kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), static_cast<T*>(dx), p);
  return static_cast<int>(cudaGetLastError());
}

// plan() for the 3x3/s1 instance, whose block also holds the frame of window
// argmax masks (16 bits) and dy (fp32): plane groups shrink, and row bands
// halve, until a block's shared memory is at most kS1SmemTarget (four blocks
// an SM; 24 or 96 KB were slower: s1smem24k / s1smem96k).
constexpr int kS1SmemTarget = 56 * 1024;

size_t plan_s1(Params& p, int vec, int elem) {
  p.cs = 8 * ((p.w + 7) / 8) + 4;
  auto bytes = [&](int planes) {
    const int slots = planes * p.pad_rows * p.cs;
    p.mask_bytes = round_up(2 * slots, 16);
    return static_cast<size_t>(p.mask_bytes) + sizeof(float) * slots +
           static_cast<size_t>(elem) * (p.x_stage + p.dy_stage);
  };
  const int target = item_elems(p.x_total);
  size_t smem;
  if (p.hw < target) {
    p.band_rows = p.h;
    p.pad_rows = p.h + 2;
    for (p.group = std::max(1, target / p.hw);; --p.group) {
      p.x_stage = round_up(p.group * p.hw + vec - 1, vec);
      p.dy_stage = round_up(p.group * p.howo + vec - 1, vec);
      smem = bytes(p.group);
      if (smem <= kS1SmemTarget || p.group == 1) break;
    }
    p.items = (p.planes + p.group - 1) / p.group;
  } else {
    p.group = 0;
    const int bands = std::min(p.h, (p.hw + target - 1) / target);
    for (p.band_rows = (p.h + bands - 1) / bands;; p.band_rows = std::max(1, p.band_rows / 2)) {
      int x_max = 0, y_max = 0;
      for (int r0 = 0; r0 < p.h; r0 += p.band_rows) {
        Item t;
        cover_rows<1>(p, r0, std::min(r0 + p.band_rows, p.h), t);
        x_max = std::max(x_max, t.n_xr * p.w);
        y_max = std::max(y_max, t.n_oh * p.wo);
      }
      p.pad_rows = p.band_rows + 2;
      p.x_stage = round_up(x_max + vec - 1, vec);
      p.dy_stage = round_up(y_max + vec - 1, vec);
      smem = bytes(1);
      if (smem <= kS1SmemTarget || p.band_rows == 1) break;
    }
    p.items = p.planes * ((p.h + p.band_rows - 1) / p.band_rows);
  }
  // phase 1: the column groups that hold windows (ow = s + pw - 2 in [0, wo)),
  // and as many runs a column as let all of a block's units run at once
  const int s_lo = std::max(0, 2 - p.pw), s_hi = std::min(p.cs, p.wo + 2 - p.pw);
  const int groups = s_hi > s_lo ? (s_hi + 3) / 4 - s_lo / 4 : 0;
  p.g_lo = groups ? s_lo / 4 : -1;
  p.fd_groups1 = FastDivmod(std::max(1, groups));
  p.fd_runs = FastDivmod(
      std::max(1, std::min(p.band_rows, kThreads / std::max(1, std::max(1, p.group) * groups))));
  p.fd_groups2 = FastDivmod((p.w + 7) / 8);
  p.fd_h = FastDivmod(p.h);
  return smem;
}

template <typename T>
int launch_s1(const void* x, const void* dy, void* dx, Params p, cudaStream_t stream) {
  const size_t smem = plan_s1(p, 16 / sizeof(T), sizeof(T));
  if (smem > kMaxSmem || p.items > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  p.fd_bands = FastDivmod(p.group ? 1 : (p.h + p.band_rows - 1) / p.band_rows);
  if (smem > kDefaultSmem) {
    const cudaError_t e = cudaFuncSetAttribute(
        maxpool2d_bwd_s1<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  maxpool2d_bwd_s1<T><<<static_cast<unsigned>(p.items), kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), static_cast<T*>(dx), p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* x, const void* dy, void* dx, const Params& p, cudaStream_t s) {
  if (p.kh == 3 && p.kw == 3 && p.sh == 1 && p.sw == 1)
    return launch_s1<T>(x, dy, dx, p, s);  // Inception's branch pools
  if (p.kh == 3 && p.kw == 3 && p.sh == 2 && p.sw == 2)
    return launch<T, 3, 3, 2, 2>(x, dy, dx, p, s);  // the ResNet stem pool
  if (p.kh == 2 && p.kw == 2 && p.sh == 2 && p.sw == 2)
    return launch<T, 2, 2, 2, 2>(x, dy, dx, p, s);  // VGG's pools
  return launch<T, 0, 0, 0, 0>(x, dy, dx, p, s);
}

}  // namespace

// x, dy, dx: contiguous (planes, h, w) / (planes, ho, wo) / (planes, h, w) in
// one dtype (1 = bf16, 0 = f32); (ph, pw) are the low-side paddings. Returns
// cudaErrorInvalidValue for a geometry outside the kernel's range (a plane of
// 2^30 elements or more, or one row band's staging beyond 227 KB of shared
// memory).
extern "C" int bigdl_maxpool2d_bwd(const void* x, const void* dy, void* dx, int dtype,
                                   long long planes, int h, int w, int ho, int wo, int kh,
                                   int kw, int sh, int sw, int ph, int pw, void* stream) {
  if (planes <= 0 || h <= 0 || w <= 0 || ho <= 0 || wo <= 0 || kh <= 0 || kw <= 0 ||
      sh <= 0 || sw <= 0 || ph < 0 || pw < 0 || kh * kw > 65535 ||
      static_cast<long long>(h) * w >= (1LL << 30) || ph >= (1 << 20) || pw >= (1 << 20))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{};
  p.planes = planes;
  p.h = h, p.w = w, p.ho = ho, p.wo = wo, p.kh = kh, p.kw = kw, p.sh = sh, p.sw = sw;
  p.ph = ph, p.pw = pw;
  p.nj = (kh + sh - 1) / sh;
  p.ni = (kw + sw - 1) / sw;
  p.hw = h * w;
  p.howo = ho * wo;
  p.x_total = planes * p.hw;
  p.dy_total = planes * p.howo;
  p.fd_w = FastDivmod(w);
  p.fd_hw = FastDivmod(p.hw);
  p.fd_wo = FastDivmod(wo);
  p.fd_ho = FastDivmod(ho);
  p.fd_sh = FastDivmod(sh);
  p.fd_sw = FastDivmod(sw);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return dispatch<__nv_bfloat16>(x, dy, dx, p, s);
  if (dtype == 0) return dispatch<float>(x, dy, dx, p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
