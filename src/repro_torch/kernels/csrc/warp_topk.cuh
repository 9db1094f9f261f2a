// K rounds of warp-wide (value, lowest column) argmax over one row held in
// registers, shared by the bucket_topk and region_rank kernels.
//
// Lane l holds columns l + 32 * j in v[j] (columns past the row's width
// hold -INFINITY). Each round is a local scan (strictly greater keeps the
// lowest column among a lane's ties) followed by a five-step butterfly
// shuffle on (value, then lowest column), so ties resolve to the lowest
// column exactly like lax.top_k and the Pallas kernels' min-iota argmax.
// The owning lane retires the winner with a compile-time-indexed write (no
// local-memory spill). A round that finds only -inf is exhausted and emits
// -inf with the sentinel column.
#pragma once

#include <cstdint>
#include <math.h>

namespace repro {

template <int NPER>
__device__ __forceinline__ void warp_topk(float (&v)[NPER], int lane, int K,
                                          int sentinel,
                                          float* __restrict__ vals,
                                          int32_t* __restrict__ args) {
  for (int k = 0; k < K; ++k) {
    float best = -INFINITY;
    int col = sentinel;
#pragma unroll
    for (int j = 0; j < NPER; ++j) {
      if (v[j] > best) {
        best = v[j];
        col = lane + 32 * j;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, best, off);
      const int oc = __shfl_xor_sync(0xffffffffu, col, off);
      if (ov > best || (ov == best && oc < col)) {
        best = ov;
        col = oc;
      }
    }
    if (lane == 0) {
      vals[k] = best;
      args[k] = col;
    }
#pragma unroll
    for (int j = 0; j < NPER; ++j) {
      if (lane + 32 * j == col) v[j] = -INFINITY;
    }
  }
}

}  // namespace repro
