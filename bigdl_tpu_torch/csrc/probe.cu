// Runtime probe kernel: y = x + 1 over n float32 elements.
//
// Replaces: bigdl_tpu/ops/pallas_probe.py::_probe_once (the Pallas kernel
// that adds 1 to an (8, 128) f32 block, launched at :40), which asks once
// whether kernels compile and run on the runtime at hand. Here the question
// is whether the kernel library built from these sources loads and runs on
// the card: bigdl_tpu_torch/ops/probe.py launches this kernel once when
// the library is first loaded and checks every element.
//
// Bound on this card: bytes (read 4 KiB, write 4 KiB at the probe's shape;
// ~2.4 ns at 3.35 TB/s), far under the launch's own cost. What the design
// does about it: nothing; it is one element a thread, in a single pass.

#include <cuda_runtime.h>

namespace {

__global__ void probe_add_one(const float* __restrict__ x, float* __restrict__ y,
                              long long n) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < n) y[i] = x[i] + 1.f;
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 when n == 0: nothing to do).
extern "C" int bigdl_probe_add_one(const float* x, float* y, long long n, void* stream) {
  if (n <= 0) return 0;
  constexpr int kThreads = 256;
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  probe_add_one<<<static_cast<unsigned>(blocks), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(x, y, n);
  return static_cast<int>(cudaGetLastError());
}
