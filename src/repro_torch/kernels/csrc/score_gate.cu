// Fused (lazy decay +) association scoring + evidence gating, for Hopper.
//
// Replaces: src/repro/kernels/topk_select.py:score_gate, the Pallas TPU
// kernel of the segmented ranking cycle's elementwise stage
// (core/ranking._score_and_gate).
//
// What bounds it on an H100: bytes. Per table slot it reads six f32 lanes
// (pair weight and count, both marginals' weight and count), the one-byte
// base gate and, under the lazy policy, the i32 last_tick lane, and writes
// one f32 score: 29 B (33 B lazy) per slot. The arithmetic is some 40 flops
// and nine transcendentals per slot, far below the card's rate, so the
// kernel is a single streaming pass.
//
// Design: one thread per slot over a grid-stride loop, coalesced 4-byte
// loads, the whole decay -> score -> gate chain in registers, one store. The
// three scalars (total weight, total count, now) are read from device memory
// so the caller never synchronises to pass them. The exponential read-time
// decay is the same exp2f(-dt / half_life) as the JAX kernel's.
#include <cuda_runtime.h>
#include <cstdint>
#include <math.h>

#include "assoc_score.cuh"

namespace {

struct Params {
  float c0, c1, c2, c3;
  float min_pair_weight, min_src_weight, min_pair_count;
  float half_life;  // <= 0: no in-kernel decay
};

__global__ void score_gate_kernel(const float* __restrict__ w_ab,
                                  const float* __restrict__ c_ab,
                                  const float* __restrict__ w_a,
                                  const float* __restrict__ w_b,
                                  const float* __restrict__ c_a,
                                  const float* __restrict__ c_b,
                                  const uint8_t* __restrict__ ok,
                                  const int32_t* __restrict__ last_tick,
                                  const float* __restrict__ scalars,
                                  Params p, float* __restrict__ out,
                                  int64_t n) {
  const float total_w = scalars[0];
  const float total_c = scalars[1];
  const float now = scalars[2];
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    float w = w_ab[i];
    if (p.half_life > 0.0f) {
      const float dt = fmaxf(now - (float)last_tick[i], 0.0f);
      w = w * exp2f(-dt / p.half_life);
    }
    const float c = c_ab[i];
    const float wa = w_a[i];
    const float s = repro::score_body(w, c, wa, w_b[i], c_a[i], c_b[i],
                                      total_w, total_c, p.c0, p.c1, p.c2,
                                      p.c3);
    const bool pass = ok[i] != 0 && w >= p.min_pair_weight &&
                      c >= p.min_pair_count && wa >= p.min_src_weight;
    out[i] = pass ? s : -INFINITY;
  }
}

}  // namespace

// scalars: device f32[3] = (total_w, total_c, now). last_tick may be null
// when half_life <= 0. Returns a cudaError_t code (0 on a clean launch).
extern "C" int repro_score_gate(const void* w_ab, const void* c_ab,
                                const void* w_a, const void* w_b,
                                const void* c_a, const void* c_b,
                                const void* ok, const void* last_tick,
                                const void* scalars, float c0, float c1,
                                float c2, float c3, float min_pair_weight,
                                float min_src_weight, float min_pair_count,
                                float half_life, void* out, int64_t n,
                                void* stream) {
  if (n < 0 || (half_life > 0.0f && last_tick == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  if (n == 0) return (int)cudaSuccess;
  Params p = {c0, c1, c2, c3, min_pair_weight, min_src_weight,
              min_pair_count, half_life};
  const int threads = 256;
  int64_t blocks = (n + threads - 1) / threads;
  if (blocks > (int64_t)1 << 20) blocks = (int64_t)1 << 20;
  score_gate_kernel<<<(unsigned)blocks, threads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(w_ab), static_cast<const float*>(c_ab),
      static_cast<const float*>(w_a), static_cast<const float*>(w_b),
      static_cast<const float*>(c_a), static_cast<const float*>(c_b),
      static_cast<const uint8_t*>(ok), static_cast<const int32_t*>(last_tick),
      static_cast<const float*>(scalars), p, static_cast<float*>(out), n);
  return (int)cudaGetLastError();
}
