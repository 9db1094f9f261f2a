// Variants of src/repro_torch/kernels/csrc/score_gate.cu (the sweep policy,
// full tiles on the 16-byte route) that its design left out or that take
// part of its work away, so scripts/score_tile_probe.py can time each
// beside the kernel itself. A block of 256 threads owns 256 * 4 * G slots.
//   MODE 0, "design": score_gate.cu's phases at G groups a thread (G 1, 2,
//           4: tiles of 1,024, 2,048 and 4,096 slots). At G = 2 it is the
//           committed kernel.
//   MODE 1, "staged": the list also holds c_ab and w_a, the tile's output is
//           staged in shared memory (set to -inf), the scores go there and
//           the block writes the tile with 16-byte stores after a barrier.
//   MODE 2, "sum": MODE 0 with the chain swapped for the sum of its six
//           inputs: the items' loads stay, the chain goes.
//   MODE 3, "no items": MODE 0 whose scoring phase writes the listed
//           slot's decayed weight: no item loads, no chain.
//   MODE 4, "gate bytes": every thread reads its gate words and writes -inf
//           into all its slots with 16-byte stores; nothing else.
// MODES 0 and 1 compute score_gate; 2-4 do not (they are timings only).
#include <cuda_runtime.h>
#include <cstdint>
#include <math.h>

#include "assoc_score.cuh"
#include "score_tile.cuh"

namespace {

using repro::tile::kThreads;
using repro::tile::kWarps;
using repro::tile::load4;
using repro::tile::place4;
using repro::tile::segment_offsets;

struct Params {
  float c0, c1, c2, c3;
  float min_pair_weight, min_src_weight, min_pair_count;
};

template <int SEGMENT>
__device__ __forceinline__ int item_at(int q, const int (&off)[kWarps + 1]) {
  int seg = 0, base = 0;
#pragma unroll
  for (int w = 1; w < kWarps; ++w) {
    if (q >= off[w]) {
      seg = w;
      base = off[w];
    }
  }
  return seg * SEGMENT + (q - base);
}

template <int G, int MODE>
__global__ void __launch_bounds__(kThreads)
    probe_kernel(const float* __restrict__ w_ab,
                 const float* __restrict__ c_ab,
                 const float* __restrict__ w_a,
                 const float* __restrict__ w_b,
                 const float* __restrict__ c_a,
                 const float* __restrict__ c_b,
                 const uint8_t* __restrict__ ok,
                 const float* __restrict__ scalars, Params p,
                 float* __restrict__ out) {
  constexpr int P = 4 * G;
  constexpr int S = kThreads * P;
  constexpr int SEG = 32 * P;
  constexpr bool STAGED = MODE == 1;
  __shared__ uint16_t off_s[S];
  __shared__ float w_s[S];
  __shared__ float c_s[STAGED ? S : 1];
  __shared__ float a_s[STAGED ? S : 1];
  __shared__ __align__(16) float out_s[STAGED ? S : 4];
  __shared__ int cnt_s[kWarps];
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int seg = (t >> 5) * SEG;
  const int64_t t0 = (int64_t)blockIdx.x * S;
  out += t0;

  uint32_t gb[G];
#pragma unroll
  for (int j = 0; j < G; ++j) {
    const int s0 = 4 * (t + kThreads * j);
    gb[j] = *reinterpret_cast<const uint32_t*>(ok + t0 + s0);
  }
  if (MODE == 4) {
    uint32_t any = 0;
#pragma unroll
    for (int j = 0; j < G; ++j) any |= gb[j];
    const float v = any == 0xffffffffu ? 0.0f : -INFINITY;  // keeps the loads
#pragma unroll
    for (int j = 0; j < G; ++j) {
      *reinterpret_cast<float4*>(out + 4 * (t + kThreads * j)) =
          make_float4(v, v, v, v);
    }
    return;
  }
  int count = 0;
  uint32_t mask = 0;
  float wd[P], cd[P], ad[P];
#pragma unroll
  for (int j = 0; j < G; ++j) {
    const int s0 = 4 * (t + kThreads * j);
    if (gb[j] != 0) {
      load4(w_ab + t0 + s0, &wd[4 * j]);
      load4(c_ab + t0 + s0, &cd[4 * j]);
      load4(w_a + t0 + s0, &ad[4 * j]);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if ((gb[j] >> (8 * k)) & 0xffu) {
          const bool pass = wd[4 * j + k] >= p.min_pair_weight &&
                            cd[4 * j + k] >= p.min_pair_count &&
                            ad[4 * j + k] >= p.min_src_weight;
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
        if (STAGED) {
          c_s[at] = cd[4 * j + k];
          a_s[at] = ad[4 * j + k];
        }
        w_s[at++] = wd[4 * j + k];
      }
    }
  }
  if (STAGED) {
#pragma unroll
    for (int j = 0; j < G; ++j) {
      *reinterpret_cast<float4*>(out_s + 4 * (t + kThreads * j)) =
          make_float4(-INFINITY, -INFINITY, -INFINITY, -INFINITY);
    }
  } else {
#pragma unroll
    for (int j = 0; j < G; ++j) {
      const int s0 = 4 * (t + kThreads * j);
      const uint32_t bits = (mask >> (4 * j)) & 15u;
      if (bits == 0) {
        *reinterpret_cast<float4*>(out + s0) =
            make_float4(-INFINITY, -INFINITY, -INFINITY, -INFINITY);
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (!((bits >> k) & 1u)) out[s0 + k] = -INFINITY;
        }
      }
    }
  }
  if (lane == 0) cnt_s[t >> 5] = count;
  __syncthreads();

  int off[kWarps + 1];
  segment_offsets(cnt_s, off);
  const float total_w = scalars[0];
  const float total_c = scalars[1];
  for (int q = t; q < off[kWarps]; q += kThreads) {
    const int k = item_at<SEG>(q, off);
    const int s = off_s[k];
    const int64_t i = t0 + s;
    if (MODE == 3) {
      out[s] = w_s[k];
    } else if (MODE == 2) {
      out[s] = w_s[k] + c_ab[i] + w_a[i] + w_b[i] + c_a[i] + c_b[i];
    } else if (STAGED) {
      out_s[s] = repro::score_body(w_s[k], c_s[k], a_s[k], w_b[i], c_a[i],
                                   c_b[i], total_w, total_c, p.c0, p.c1,
                                   p.c2, p.c3);
    } else {
      out[s] = repro::score_body(w_s[k], c_ab[i], w_a[i], w_b[i], c_a[i],
                                 c_b[i], total_w, total_c, p.c0, p.c1, p.c2,
                                 p.c3);
    }
  }
  if (STAGED) {
    __syncthreads();
#pragma unroll
    for (int j = 0; j < G; ++j) {
      const int s0 = 4 * (t + kThreads * j);
      *reinterpret_cast<float4*>(out + s0) =
          *reinterpret_cast<const float4*>(out_s + s0);
    }
  }
}

template <int G, int MODE>
int launch(const void* const* lanes, const void* ok, const void* scalars,
           Params p, void* out, int64_t n, cudaStream_t stream) {
  constexpr int S = kThreads * 4 * G;
  if (n % S != 0) return (int)cudaErrorInvalidValue;
  probe_kernel<G, MODE><<<(unsigned)(n / S), kThreads, 0, stream>>>(
      static_cast<const float*>(lanes[0]), static_cast<const float*>(lanes[1]),
      static_cast<const float*>(lanes[2]), static_cast<const float*>(lanes[3]),
      static_cast<const float*>(lanes[4]), static_cast<const float*>(lanes[5]),
      static_cast<const uint8_t*>(ok), static_cast<const float*>(scalars), p,
      static_cast<float*>(out));
  return (int)cudaGetLastError();
}

}  // namespace

// variant: 0 design G=1, 1 design G=2, 2 design G=4, 3 staged, 4 sum,
// 5 no items, 6 gate bytes (the last four at G = 2). n must be a multiple
// of the variant's tile and every base 16-byte aligned.
extern "C" int score_tile_probe(int variant, const void* w_ab,
                                const void* c_ab, const void* w_a,
                                const void* w_b, const void* c_a,
                                const void* c_b, const void* ok,
                                const void* scalars, float c0, float c1,
                                float c2, float c3, float min_pair_weight,
                                float min_src_weight, float min_pair_count,
                                void* out, int64_t n, void* stream) {
  const void* lanes[6] = {w_ab, c_ab, w_a, w_b, c_a, c_b};
  const Params p = {c0, c1, c2, c3, min_pair_weight, min_src_weight,
                    min_pair_count};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case 0: return launch<1, 0>(lanes, ok, scalars, p, out, n, s);
    case 1: return launch<2, 0>(lanes, ok, scalars, p, out, n, s);
    case 2: return launch<4, 0>(lanes, ok, scalars, p, out, n, s);
    case 3: return launch<2, 1>(lanes, ok, scalars, p, out, n, s);
    case 4: return launch<2, 2>(lanes, ok, scalars, p, out, n, s);
    case 5: return launch<2, 3>(lanes, ok, scalars, p, out, n, s);
    case 6: return launch<2, 4>(lanes, ok, scalars, p, out, n, s);
  }
  return (int)cudaErrorInvalidValue;
}
