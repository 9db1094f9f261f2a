// Stand-alone association scoring over full lanes, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/assoc_score.py:assoc_score, the Pallas TPU
// kernel of the four association scores and their combination (no gates,
// no decay). Neither package's engine calls it; the ranking cycles fuse the
// same body into score_gate and region_rank.
//
// What bounds it on an H100: the scoring chain, where most slots have a
// positive pair count. Read whole, a slot is 28 B (six f32 lanes and the
// score), but repro::score_body (assoc_score.cuh), nine libm calls and some
// 60 f32 operations under -fmad=false, takes the issue slots of ~545
// instructions a score (scripts/score_rate.py: ~0.275 ms per 2^24 scores
// on an H100). Where c_ab <= 0 (or NaN) score_body zeroes all four lanes,
// so such a slot's score depends on the coefficients alone; on the
// engine's store (dead and never-seen slots have c_ab = 0) that is nearly
// every slot, and the bytes a launch needs are the c_ab lane and the score
// of every slot. The design is tuned for such lanes; no caller runs the
// kernel, so no real lanes confirm it, and where most slots have c_ab > 0
// it is a few % slower than one thread a slot.
//
// Design: score_gate.cu's tiles (score_tile.cuh) with the gate c_ab > 0. A
// thread reads its slots' c_ab with 16-byte loads; ballots and popcounts
// place the offset of each slot with c_ab > 0 in the block's list in slot
// order. After a barrier every thread scores list items, loading that
// slot's six lanes, so the chain runs with full warps, and writes the
// score. One extra item evaluates score_body on zeros once per block,
// beside the others: that is the value of every other slot, from the same
// operations the plain version runs on such a slot, so it is bit-equal to
// it whatever the other lanes hold.
// After a second barrier each thread writes it into its slots outside the
// list (16-byte stores for a group with none in it; 4-byte ones where a base
// is not 16-byte aligned, and on a ragged last tile). The two totals are
// read from device memory so the caller never synchronises.
#include <cuda_runtime.h>
#include <cstdint>

#include "assoc_score.cuh"
#include "score_tile.cuh"

namespace {

using namespace repro::tile;

struct Coefs {
  float c0, c1, c2, c3;
};

__global__ void __launch_bounds__(kThreads)
    assoc_score_tile_kernel(const float* __restrict__ w_ab,
                            const float* __restrict__ c_ab,
                            const float* __restrict__ w_a,
                            const float* __restrict__ w_b,
                            const float* __restrict__ c_a,
                            const float* __restrict__ c_b,
                            const float* __restrict__ totals, Coefs cf,
                            float* __restrict__ out, int64_t n, bool vec) {
  constexpr int G = kGroups;
  constexpr int P = kPerThread;
  __shared__ uint16_t off_s[kSlots];
  __shared__ int cnt_s[kWarps];
  __shared__ float zero_s;  // score_body on zeros: every other slot's score
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int seg = (t >> 5) * kSegment;
  const int64_t t0 = (int64_t)blockIdx.x * kSlots;
  const int m = (int)min((int64_t)kSlots, n - t0);
  const bool full = vec && m == kSlots;  // uniform across the block

  // 1. Gate: c_ab > 0.
  int count = 0;
  uint32_t mask = 0;
  if (full) {
    float c[P];  // every load issued before the first ballot
#pragma unroll
    for (int j = 0; j < G; ++j) {
      load4(c_ab + t0 + 4 * (t + kThreads * j), &c[4 * j]);
    }
#pragma unroll
    for (int k = 0; k < P; ++k) mask |= (uint32_t)(c[k] > 0.0f) << k;
#pragma unroll
    for (int j = 0; j < G; ++j) {
      const uint32_t bits = (mask >> (4 * j)) & 15u;
      int at = seg + place4(bits, lane, count);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if ((bits >> k) & 1u) {
          off_s[at++] = (uint16_t)(4 * (t + kThreads * j) + k);
        }
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < P; ++j) {
      const int s = t + kThreads * j;
      mask |= (uint32_t)(s < m && c_ab[t0 + s] > 0.0f) << j;
    }
#pragma unroll
    for (int j = 0; j < P; ++j) {
      const bool pass = (mask >> j) & 1u;
      const int at = seg + place(pass, lane, count);
      if (pass) off_s[at] = (uint16_t)(t + kThreads * j);
    }
  }
  if (lane == 0) cnt_s[t >> 5] = count;
  __syncthreads();

  // 2. Every thread scores items of the dense list; the item after the last
  // is the zeros.
  int off[kWarps + 1];
  segment_offsets(cnt_s, off);
  const float total_w = totals[0];
  const float total_c = totals[1];
  for (int q = t; q <= off[kWarps]; q += kThreads) {
    float x[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    int64_t i = -1;
    if (q < off[kWarps]) {
      i = t0 + off_s[item_index(q, off)];
      x[0] = w_ab[i];
      x[1] = c_ab[i];
      x[2] = w_a[i];
      x[3] = w_b[i];
      x[4] = c_a[i];
      x[5] = c_b[i];
    }
    const float v = repro::score_body(x[0], x[1], x[2], x[3], x[4], x[5],
                                      total_w, total_c, cf.c0, cf.c1, cf.c2,
                                      cf.c3);
    if (i >= 0) {
      out[i] = v;
    } else {
      zero_s = v;
    }
  }
  __syncthreads();

  // 3. The zeros' score into every other slot.
  if (full) {
    fill_vec(mask, zero_s, out + t0, t);
  } else {
    fill_scalar(mask, zero_s, out + t0, t, m);
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
  const int64_t blocks = (n + kSlots - 1) / kSlots;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const float* lanes[6] = {
      static_cast<const float*>(w_ab), static_cast<const float*>(c_ab),
      static_cast<const float*>(w_a),  static_cast<const float*>(w_b),
      static_cast<const float*>(c_a),  static_cast<const float*>(c_b)};
  bool vec = aligned16(out);
  for (const float* lane : lanes) vec = vec && aligned16(lane);
  assoc_score_tile_kernel<<<(unsigned)blocks, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      lanes[0], lanes[1], lanes[2], lanes[3], lanes[4], lanes[5],
      static_cast<const float*>(totals), Coefs{c0, c1, c2, c3},
      static_cast<float*>(out), n, vec);
  return (int)cudaGetLastError();
}
