// Fused (lazy decay +) association scoring + evidence gating, for Hopper.
//
// Replaces: src/repro/kernels/topk_select.py:score_gate, the Pallas TPU
// kernel of the segmented ranking cycle's elementwise stage
// (core/ranking._score_and_gate).
//
// What bounds it on an H100: the scoring chain and the items' loads where
// many slots pass, bytes where few do. Read whole, a slot is 29 B (33 B
// lazy): six f32 lanes, the one-byte base gate (and the i32 last_tick
// lane) and the f32 score written. repro::score_body (assoc_score.cuh), nine
// libm calls and some 60 f32 operations under -fmad=false, takes the issue
// slots of ~545 instructions a score (scripts/score_rate.py: ~0.275 ms per
// 2^24 scores on an H100), twice what 29 B a slot take to stream. On the
// engine's store few slots are live (1.4% at tick 16): there the bytes are
// the gate byte and the score of every slot, and random 16-byte reads of
// the groups that hold a live slot.
//
// Design (score_tile.cuh): a block of 256 threads owns a tile of 2,048
// slots. Gate first: each thread reads a 4-slot group's gate bytes in one
// 4-byte load and, only for a group with a base gate set, w_ab, c_ab and
// w_a with 16-byte loads (and last_tick under the lazy policy,
// decaying w_ab in-pass with the same exp2f(-dt / half_life) as the JAX
// kernel); the three threshold gates are the plain version's f32 compares.
// Where a slot fails, its owner writes -inf at once (16-byte stores for a
// group with none passing). Ballots and popcounts place each passing slot
// in the block's list in shared memory, in slot order: its offset and
// decayed weight. After one barrier every thread scores list items: it loads
// that slot's other five lanes (c_ab and w_a again, from L1 or L2), runs the
// chain and writes the score.
// So the chain runs only on passing slots, with full warps. Where a base is
// not 16-byte aligned, and on a ragged last tile, the same phases run one
// slot at a time (the 4-byte route). The three scalars (total weight, total
// count, now) are read from device memory so the caller never synchronises.
#include <cuda_runtime.h>
#include <cstdint>
#include <math.h>

#include "assoc_score.cuh"
#include "score_tile.cuh"

namespace {

using namespace repro::tile;

struct Params {
  float c0, c1, c2, c3;
  float min_pair_weight, min_src_weight, min_pair_count;
  float half_life;  // <= 0: no in-kernel decay
};

// Slot i's pair weight as the gates and the score see it: decayed to `now`
// under the lazy policy.
template <bool LAZY>
__device__ __forceinline__ float weight(float w, int32_t lt, float now,
                                        float half_life) {
  if (!LAZY) return w;
  const float dt = fmaxf(now - (float)lt, 0.0f);
  return w * exp2f(-dt / half_life);
}

template <bool LAZY>
__global__ void __launch_bounds__(kThreads)
    score_gate_tile_kernel(const float* __restrict__ w_ab,
                           const float* __restrict__ c_ab,
                           const float* __restrict__ w_a,
                           const float* __restrict__ w_b,
                           const float* __restrict__ c_a,
                           const float* __restrict__ c_b,
                           const uint8_t* __restrict__ ok,
                           const int32_t* __restrict__ last_tick,
                           const float* __restrict__ scalars, Params p,
                           float* __restrict__ out, int64_t n, bool vec) {
  constexpr int G = kGroups;
  constexpr int P = kPerThread;
  __shared__ uint16_t off_s[kSlots];  // the list: slot offsets
  __shared__ float w_s[kSlots];       // and their decayed weights
  __shared__ int cnt_s[kWarps];
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int seg = (t >> 5) * kSegment;
  const int64_t t0 = (int64_t)blockIdx.x * kSlots;
  const int m = (int)min((int64_t)kSlots, n - t0);
  const bool full = vec && m == kSlots;  // uniform across the block
  const float now = scalars[2];

  // 1. Gate first; -inf into every slot that fails. All of a thread's loads
  // are issued before its first ballot, so a warp waits for one round trip
  // of gate bytes and one of lanes.
  int count = 0;
  uint32_t mask = 0;
  float wd[P];  // the thread's decayed weights, where its base gate is set
  if (full) {
    uint32_t gb[G];
#pragma unroll
    for (int j = 0; j < G; ++j) {
      const int s0 = 4 * (t + kThreads * j);
      gb[j] = *reinterpret_cast<const uint32_t*>(ok + t0 + s0);
    }
#pragma unroll
    for (int j = 0; j < G; ++j) {
      const int s0 = 4 * (t + kThreads * j);
      if (gb[j] != 0) {
        float c[4], wa[4];
        load4(w_ab + t0 + s0, &wd[4 * j]);
        load4(c_ab + t0 + s0, c);
        load4(w_a + t0 + s0, wa);
        int lt[4] = {0, 0, 0, 0};
        if (LAZY) {
          const int4 v = *reinterpret_cast<const int4*>(last_tick + t0 + s0);
          lt[0] = v.x;
          lt[1] = v.y;
          lt[2] = v.z;
          lt[3] = v.w;
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if ((gb[j] >> (8 * k)) & 0xffu) {
            const float w = weight<LAZY>(wd[4 * j + k], lt[k], now,
                                         p.half_life);
            wd[4 * j + k] = w;
            const bool pass = w >= p.min_pair_weight &&
                              c[k] >= p.min_pair_count &&
                              wa[k] >= p.min_src_weight;
            mask |= (uint32_t)pass << (4 * j + k);
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < G; ++j) {
      const uint32_t bits = (mask >> (4 * j)) & 15u;
      int at = seg + place4(bits, lane, count);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if ((bits >> k) & 1u) {
          off_s[at] = (uint16_t)(4 * (t + kThreads * j) + k);
          w_s[at++] = wd[4 * j + k];
        }
      }
    }
    fill_vec(mask, -INFINITY, out + t0, t);
  } else {
#pragma unroll
    for (int j = 0; j < P; ++j) {
      const int s = t + kThreads * j;
      const int64_t i = t0 + s;
      if (s < m && ok[i] != 0) {
        wd[j] = weight<LAZY>(w_ab[i], LAZY ? last_tick[i] : 0, now,
                             p.half_life);
        const bool pass = wd[j] >= p.min_pair_weight &&
                          c_ab[i] >= p.min_pair_count &&
                          w_a[i] >= p.min_src_weight;
        mask |= (uint32_t)pass << j;
      }
    }
#pragma unroll
    for (int j = 0; j < P; ++j) {
      const bool pass = (mask >> j) & 1u;
      const int at = seg + place(pass, lane, count);
      if (pass) {
        off_s[at] = (uint16_t)(t + kThreads * j);
        w_s[at] = wd[j];
      }
    }
    fill_scalar(mask, -INFINITY, out + t0, t, m);
  }
  if (lane == 0) cnt_s[t >> 5] = count;
  __syncthreads();

  // 2. Every thread scores items of the dense list.
  int off[kWarps + 1];
  segment_offsets(cnt_s, off);
  const float total_w = scalars[0];
  const float total_c = scalars[1];
  for (int q = t; q < off[kWarps]; q += kThreads) {
    const int k = item_index(q, off);
    const int64_t i = t0 + off_s[k];
    out[i] = repro::score_body(w_s[k], c_ab[i], w_a[i], w_b[i], c_a[i],
                               c_b[i], total_w, total_c, p.c0, p.c1, p.c2,
                               p.c3);
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
  const int64_t blocks = (n + kSlots - 1) / kSlots;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const float* lanes[6] = {
      static_cast<const float*>(w_ab), static_cast<const float*>(c_ab),
      static_cast<const float*>(w_a),  static_cast<const float*>(w_b),
      static_cast<const float*>(c_a),  static_cast<const float*>(c_b)};
  bool vec = aligned16(ok) && aligned16(out) &&
             (half_life <= 0.0f || aligned16(last_tick));
  for (const float* lane : lanes) vec = vec && aligned16(lane);
  const Params p = {c0, c1, c2, c3, min_pair_weight, min_src_weight,
                    min_pair_count, half_life};
  auto kernel = half_life > 0.0f ? score_gate_tile_kernel<true>
                                 : score_gate_tile_kernel<false>;
  kernel<<<(unsigned)blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      lanes[0], lanes[1], lanes[2], lanes[3], lanes[4], lanes[5],
      static_cast<const uint8_t*>(ok), static_cast<const int32_t*>(last_tick),
      static_cast<const float*>(scalars), p, static_cast<float*>(out), n, vec);
  return (int)cudaGetLastError();
}
