// Native host runtime of bigdl_tpu_torch (a copy of the JAX package's
// csrc/bigdl_host.cpp; reference: the bigdl-core C/C++ JNI libraries). Card
// compute belongs to the CUDA kernels beside this file; what stays native on
// the HOST is the data-plane work around them: the TFRecord framing
// checksum, image batch preprocessing, and minibatch gather for the input
// pipeline. Built with g++ at first use and loaded with ctypes by
// bigdl_tpu_torch/native.py, which has no fallback: a failed build raises.
//
// All entry points are extern "C", operate on caller-owned buffers, and
// release the GIL by construction (ctypes drops it around foreign calls).

#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// ------------------------------------------------------------------ crc32c
// Castagnoli CRC, slice-by-8: ~8 bytes per table step vs the byte-at-a-time
// Python loop of native._py_crc32c (the TFRecord framing checksum).
uint32_t g_tbl[8][256];

// built once at library load — no first-use race
struct TableInit {
  TableInit() {
    const uint32_t poly = 0x82F63B78u;
    for (int n = 0; n < 256; ++n) {
      uint32_t c = static_cast<uint32_t>(n);
      for (int k = 0; k < 8; ++k) c = (c & 1) ? (c >> 1) ^ poly : c >> 1;
      g_tbl[0][n] = c;
    }
    for (int n = 0; n < 256; ++n) {
      uint32_t c = g_tbl[0][n];
      for (int s = 1; s < 8; ++s) {
        c = g_tbl[0][c & 0xFF] ^ (c >> 8);
        g_tbl[s][n] = c;
      }
    }
  }
};
const TableInit g_table_init;

int hw_threads() {
  unsigned n = std::thread::hardware_concurrency();
  return n ? static_cast<int>(n) : 4;
}

// Run fn(i) for i in [0, n) across up to hw threads; stays serial when the
// per-item work is too small to amortize thread spawn/join.
template <typename F>
void parallel_for(int64_t n, int64_t bytes_per_item, F fn) {
  int workers = hw_threads();
  if (workers > n) workers = static_cast<int>(n);
  if (n * bytes_per_item < (1 << 20)) workers = 1;
  if (workers <= 1) {
    for (int64_t i = 0; i < n; ++i) fn(i);
    return;
  }
  std::vector<std::thread> pool;
  pool.reserve(workers);
  std::atomic<int64_t> next{0};
  for (int w = 0; w < workers; ++w) {
    pool.emplace_back([&] {
      for (;;) {
        int64_t i = next.fetch_add(1, std::memory_order_relaxed);
        if (i >= n) return;
        fn(i);
      }
    });
  }
  for (auto& t : pool) t.join();
}

}  // namespace

extern "C" {

uint32_t bigdl_crc32c(const uint8_t* data, uint64_t len) {
  uint32_t crc = 0xFFFFFFFFu;
  const uint8_t* p = data;
  while (len >= 8) {
    uint64_t word;
    std::memcpy(&word, p, 8);
    crc ^= static_cast<uint32_t>(word);
    uint32_t hi = static_cast<uint32_t>(word >> 32);
    crc = g_tbl[7][crc & 0xFF] ^ g_tbl[6][(crc >> 8) & 0xFF] ^
          g_tbl[5][(crc >> 16) & 0xFF] ^ g_tbl[4][crc >> 24] ^
          g_tbl[3][hi & 0xFF] ^ g_tbl[2][(hi >> 8) & 0xFF] ^
          g_tbl[1][(hi >> 16) & 0xFF] ^ g_tbl[0][hi >> 24];
    p += 8;
    len -= 8;
  }
  while (len--) crc = g_tbl[0][(crc ^ *p++) & 0xFF] ^ (crc >> 8);
  return crc ^ 0xFFFFFFFFu;
}

// u8 HWC image batch -> f32 CHW with per-channel (x - mean) / std.
// src: n * h * w * c bytes; dst: n * c * h * w floats; mean/std: c floats.
// The fused decode-normalize-transpose step of the host input pipeline
// (reference: OpenCV mat ops + BGRImgNormalizer + MatToTensor).
void bigdl_u8hwc_to_f32chw(const uint8_t* src, float* dst, int64_t n,
                           int64_t h, int64_t w, int64_t c, const float* mean,
                           const float* std_) {
  const int64_t plane = h * w;
  const int64_t img_in = plane * c;
  const int64_t img_out = c * plane;
  std::vector<float> inv(c);
  for (int64_t k = 0; k < c; ++k) inv[k] = 1.0f / std_[k];
  parallel_for(n, img_in * 5, [&](int64_t i) {
    const uint8_t* s = src + i * img_in;
    float* d = dst + i * img_out;
    for (int64_t px = 0; px < plane; ++px)
      for (int64_t k = 0; k < c; ++k)
        d[k * plane + px] = (static_cast<float>(s[px * c + k]) - mean[k]) * inv[k];
  });
}

// f32 row gather: dst[i] = src[indices[i]] for row-major (rows, row_len)
// matrices — the shuffled-minibatch assembly step of the data loader,
// multithreaded across destination rows.
void bigdl_gather_f32(const float* src, const int64_t* indices, float* dst,
                      int64_t n, int64_t row_len) {
  parallel_for(n, row_len * 4, [&](int64_t i) {
    std::memcpy(dst + i * row_len, src + indices[i] * row_len,
                sizeof(float) * static_cast<size_t>(row_len));
  });
}

int bigdl_host_abi_version() { return 1; }

}  // extern "C"
