// Fused (lazy decay +) scoring, gating and per-region top-k over the region
// layout's [R, W] grid, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/topk_select.py:region_rank, the Pallas TPU
// kernel of the region ranking cycle (core/ranking.ranking_cycle_region).
//
// What bounds it on an H100: bytes. Per slot it reads four f32 lanes (pair
// weight and count, the dst marginals' weight and count) and the one-byte
// base gate, plus the i32 last_tick lane under the lazy policy: 17 B
// (21 B) per slot. Per region it reads the source's two marginals (one
// [R] vector each, where the Pallas kernel read them broadcast to [R, W])
// and writes K values, K columns and the pass count. The arithmetic, some
// 60 operations and nine libm calls per slot, needs a fifth of the time
// the bytes do.
//
// Design: one warp per region row, lane l holding slots l, l + 32, ...
// (NPER = ceil(W / 32) <= 4, a template constant, so the row stays in
// registers). Each slot runs score_gate's chain, the same
// repro::score_body (assoc_score.cuh) under -fmad=false, so the kernel
// rounds like its plain torch version; the pass count is the popcount of
// one warp ballot per 32-slot chunk; then repro::warp_topk (warp_topk.cuh,
// shared with bucket_topk) takes K rounds of (value, lowest column)
// argmax. Exhausted rounds give -inf and the sentinel column W. The three
// scalars (total weight, total count, now) are read from device memory so
// the caller never synchronises to pass them.
#include <cuda_runtime.h>
#include <cstdint>
#include <math.h>

#include "assoc_score.cuh"
#include "warp_topk.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kMaxWidth = 128;

struct Params {
  float c0, c1, c2, c3;
  float min_pair_weight, min_src_weight, min_pair_count;
  float half_life;  // <= 0: no in-kernel decay
};

template <int NPER>
__global__ void region_rank_kernel(const float* __restrict__ w_ab,
                                   const float* __restrict__ c_ab,
                                   const float* __restrict__ w_a,
                                   const float* __restrict__ w_b,
                                   const float* __restrict__ c_a,
                                   const float* __restrict__ c_b,
                                   const uint8_t* __restrict__ ok,
                                   const int32_t* __restrict__ last_tick,
                                   const float* __restrict__ scalars,
                                   Params p, int64_t rows, int W, int K,
                                   float* __restrict__ vals,
                                   int32_t* __restrict__ args,
                                   int32_t* __restrict__ npass) {
  const int64_t row = (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // uniform across the warp
  const float total_w = scalars[0];
  const float total_c = scalars[1];
  const float now = scalars[2];
  const float wa = w_a[row];
  const float ca = c_a[row];
  float v[NPER];
  int n_pass = 0;
#pragma unroll
  for (int j = 0; j < NPER; ++j) {
    const int c = lane + 32 * j;
    bool pass = false;
    float s = -INFINITY;
    if (c < W) {
      const int64_t i = row * (int64_t)W + c;
      float w = w_ab[i];
      if (p.half_life > 0.0f) {
        const float dt = fmaxf(now - (float)last_tick[i], 0.0f);
        w = w * exp2f(-dt / p.half_life);
      }
      const float cab = c_ab[i];
      const float score = repro::score_body(w, cab, wa, w_b[i], ca, c_b[i],
                                            total_w, total_c, p.c0, p.c1,
                                            p.c2, p.c3);
      pass = ok[i] != 0 && w >= p.min_pair_weight &&
             cab >= p.min_pair_count && wa >= p.min_src_weight;
      s = pass ? score : -INFINITY;
    }
    v[j] = s;
    n_pass += __popc(__ballot_sync(0xffffffffu, pass));
  }
  if (lane == 0) npass[row] = n_pass;
  repro::warp_topk<NPER>(v, lane, K, W, vals + row * K, args + row * K);
}

template <int NPER>
void launch(const float* const* lanes, const uint8_t* ok, const int32_t* lt,
            const float* scalars, Params p, int64_t rows, int W, int K,
            float* vals, int32_t* args, int32_t* npass, cudaStream_t stream) {
  const int64_t blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  region_rank_kernel<NPER><<<(unsigned)blocks, kWarpsPerBlock * 32, 0, stream>>>(
      lanes[0], lanes[1], lanes[2], lanes[3], lanes[4], lanes[5], ok, lt,
      scalars, p, rows, W, K, vals, args, npass);
}

}  // namespace

extern "C" int repro_region_rank_max_width() { return kMaxWidth; }

// w_ab, c_ab, w_b, c_b: f32[rows, W]; w_a, c_a: f32[rows]; ok: bool[rows, W];
// last_tick: i32[rows, W], or null when half_life <= 0; scalars: device
// f32[3] = (total_w, total_c, now); vals f32[rows, K], args i32[rows, K],
// npass i32[rows]. Returns a cudaError_t code (0 on a clean launch).
extern "C" int repro_region_rank(const void* w_ab, const void* c_ab,
                                 const void* w_a, const void* w_b,
                                 const void* c_a, const void* c_b,
                                 const void* ok, const void* last_tick,
                                 const void* scalars, float c0, float c1,
                                 float c2, float c3, float min_pair_weight,
                                 float min_src_weight, float min_pair_count,
                                 float half_life, int64_t rows, int W, int K,
                                 void* vals, void* args, void* npass,
                                 void* stream) {
  if (rows < 0 || W < 1 || W > kMaxWidth || K < 0 ||
      rows > (int64_t)kWarpsPerBlock * 0x7fffffff ||
      (half_life > 0.0f && last_tick == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  if (rows == 0) return (int)cudaSuccess;
  const float* lanes[6] = {
      static_cast<const float*>(w_ab), static_cast<const float*>(c_ab),
      static_cast<const float*>(w_a),  static_cast<const float*>(w_b),
      static_cast<const float*>(c_a),  static_cast<const float*>(c_b)};
  Params p = {c0, c1, c2, c3, min_pair_weight, min_src_weight,
              min_pair_count, half_life};
  const uint8_t* o = static_cast<const uint8_t*>(ok);
  const int32_t* lt = static_cast<const int32_t*>(last_tick);
  const float* sc = static_cast<const float*>(scalars);
  float* v = static_cast<float*>(vals);
  int32_t* a = static_cast<int32_t*>(args);
  int32_t* np = static_cast<int32_t*>(npass);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (W <= 32) launch<1>(lanes, o, lt, sc, p, rows, W, K, v, a, np, s);
  else if (W <= 64) launch<2>(lanes, o, lt, sc, p, rows, W, K, v, a, np, s);
  else launch<4>(lanes, o, lt, sc, p, rows, W, K, v, a, np, s);
  return (int)cudaGetLastError();
}
