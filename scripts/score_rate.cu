// The card's rate for repro::score_body alone: every thread scores `iters`
// slots whose six inputs it makes in registers (a linear congruential
// generator, drawn like chip_smoke.py's synthetic lanes), with all blocks
// resident at once: no loads, one checksum store a thread, and clock64()
// around the loop. MODE 0 makes the same inputs and folds them into the
// checksum without scoring, to show what the input generation costs; the
// score floor is MODE 1 less MODE 0. Built with the port's flags
// (-fmad=false) and run by scripts/score_rate.py.
#include <cuda_runtime.h>
#include <cstdint>

#include "assoc_score.cuh"

namespace {

__device__ __forceinline__ float unit(uint32_t& x) {
  x = x * 1664525u + 1013904223u;
  return (float)(x >> 8) * (1.0f / 16777216.0f);  // [0, 1)
}

template <int MODE>
__global__ void __launch_bounds__(256)
    score_rate_kernel(uint32_t* out, long long* cycles, int iters,
                      uint32_t seed, float total_w, float total_c, float c0,
                      float c1, float c2, float c3) {
  uint32_t x = seed ^ ((blockIdx.x * blockDim.x + threadIdx.x) * 2654435761u);
  uint32_t chk = 0;
  __syncthreads();
  const long long t0 = clock64();
  for (int i = 0; i < iters; ++i) {
    const float w_ab = unit(x) * 5.0f;
    const float c_ab = floorf(unit(x) * 20.0f);
    const float w_a = unit(x) * 50.0f;
    const float w_b = unit(x) * 50.0f;
    const float c_a = fmaxf(c_ab, floorf(unit(x) * 100.0f));
    const float c_b = fmaxf(c_ab, floorf(unit(x) * 100.0f));
    if (MODE == 1) {
      chk ^= __float_as_uint(repro::score_body(w_ab, c_ab, w_a, w_b, c_a,
                                               c_b, total_w, total_c, c0, c1,
                                               c2, c3));
    } else {
      chk ^= __float_as_uint(w_ab) ^ __float_as_uint(c_ab) ^
             __float_as_uint(w_a) ^ __float_as_uint(w_b) ^
             __float_as_uint(c_a) ^ __float_as_uint(c_b);
    }
  }
  const long long t1 = clock64();
  out[blockIdx.x * blockDim.x + threadIdx.x] = chk;
  if (threadIdx.x == 0) cycles[blockIdx.x] = t1 - t0;
}

}  // namespace

// Blocks of 256 threads that fit on one SM at once for this mode.
extern "C" int score_rate_blocks_per_sm(int mode) {
  int n = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, mode ? score_rate_kernel<1> : score_rate_kernel<0>, 256, 0);
  return n;
}

extern "C" int score_rate(int mode, void* out, void* cycles, int blocks,
                          int iters, float total_w, float total_c, float c0,
                          float c1, float c2, float c3, void* stream) {
  auto kernel = mode ? score_rate_kernel<1> : score_rate_kernel<0>;
  kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(out), static_cast<long long*>(cycles), iters,
      12345u, total_w, total_c, c0, c1, c2, c3);
  return (int)cudaGetLastError();
}
