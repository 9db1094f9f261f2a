// Stand-alone association scoring over full lanes, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/assoc_score.py:assoc_score, the Pallas TPU
// kernel of the four association scores and their combination (no gates,
// no decay). Neither package's engine calls it; the ranking cycles fuse the
// same body into score_gate and region_rank.
//
// What bounds it on an H100: bytes. Per slot it reads six f32 lanes and
// writes one f32 score: 28 B. The arithmetic, some 60 operations and nine
// libm calls per slot, needs a fifth of the time the bytes do.
//
// Design: one thread per slot over a grid-stride loop, coalesced 4-byte
// loads, repro::score_body (assoc_score.cuh) in registers under
// -fmad=false, so the kernel rounds like its plain torch version; one
// store. The two totals are read from device memory so the caller never
// synchronises to pass them.
#include <cuda_runtime.h>
#include <cstdint>

#include "assoc_score.cuh"

namespace {

__global__ void assoc_score_kernel(const float* __restrict__ w_ab,
                                   const float* __restrict__ c_ab,
                                   const float* __restrict__ w_a,
                                   const float* __restrict__ w_b,
                                   const float* __restrict__ c_a,
                                   const float* __restrict__ c_b,
                                   const float* __restrict__ totals, float c0,
                                   float c1, float c2, float c3,
                                   float* __restrict__ out, int64_t n) {
  const float total_w = totals[0];
  const float total_c = totals[1];
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    out[i] = repro::score_body(w_ab[i], c_ab[i], w_a[i], w_b[i], c_a[i],
                               c_b[i], total_w, total_c, c0, c1, c2, c3);
  }
}

}  // namespace

// totals: device f32[2] = (total_w, total_c). Returns a cudaError_t code (0
// on a clean launch).
extern "C" int repro_assoc_score(const void* w_ab, const void* c_ab,
                                 const void* w_a, const void* w_b,
                                 const void* c_a, const void* c_b,
                                 const void* totals, float c0, float c1,
                                 float c2, float c3, void* out, int64_t n,
                                 void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  const int threads = 256;
  int64_t blocks = (n + threads - 1) / threads;
  if (blocks > (int64_t)1 << 20) blocks = (int64_t)1 << 20;
  assoc_score_kernel<<<(unsigned)blocks, threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(w_ab), static_cast<const float*>(c_ab),
      static_cast<const float*>(w_a), static_cast<const float*>(w_b),
      static_cast<const float*>(c_a), static_cast<const float*>(c_b),
      static_cast<const float*>(totals), c0, c1, c2, c3,
      static_cast<float*>(out), n);
  return (int)cudaGetLastError();
}
