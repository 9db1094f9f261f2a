// Per-bucket top-k over the segmented ranking cycle's [R, L] grid, for Hopper.
//
// Replaces: src/repro/kernels/topk_select.py:bucket_topk, the Pallas TPU
// kernel of the ranking cycle's selection stage (core/ranking.ranking_cycle)
// and of the region ranking cycle's per-source chain merge
// (core/ranking.ranking_cycle_region).
//
// What bounds it on an H100: bytes. The grid is read once (R * L * 4 B) and
// K values and K columns are written per row (R * K * 8 B); the K rounds of
// comparisons run on registers.
//
// Design: one warp per row. Lane l holds columns l, l + 32, ... in
// registers (NPER = ceil(L / 32) values, a template constant so the array
// stays in registers), loaded with coalesced 4-byte reads. Rows up to 128
// wide are instantiated: the engine's grid is max(bucket_rows, top_k) = 64
// wide at RankConfig's defaults, and the chain merge's max_chain * K1 = 64
// at the deployment configuration. The K rounds of selection are
// repro::warp_topk (warp_topk.cuh), shared with region_rank.
#include <cuda_runtime.h>
#include <cstdint>
#include <math.h>

#include "warp_topk.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kMaxWidth = 128;

template <int NPER>
__global__ void bucket_topk_kernel(const float* __restrict__ grid, int64_t rows,
                                   int L, int K, float* __restrict__ vals,
                                   int32_t* __restrict__ args) {
  const int64_t row = (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // uniform across the warp
  const float* g = grid + row * (int64_t)L;
  float v[NPER];
#pragma unroll
  for (int j = 0; j < NPER; ++j) {
    const int c = lane + 32 * j;
    v[j] = c < L ? g[c] : -INFINITY;
  }
  repro::warp_topk<NPER>(v, lane, K, L, vals + row * K, args + row * K);
}

template <int NPER>
void launch(const float* grid, int64_t rows, int L, int K, float* vals,
            int32_t* args, cudaStream_t stream) {
  const int64_t blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  bucket_topk_kernel<NPER><<<(unsigned)blocks, kWarpsPerBlock * 32, 0, stream>>>(
      grid, rows, L, K, vals, args);
}

}  // namespace

extern "C" int repro_bucket_topk_max_width() { return kMaxWidth; }

// grid: f32[rows, L] row-major; vals f32[rows, K]; args i32[rows, K].
// Returns a cudaError_t code (0 on a clean launch).
extern "C" int repro_bucket_topk(const void* grid, int64_t rows, int L, int K,
                                 void* vals, void* args, void* stream) {
  if (rows < 0 || L < 1 || L > kMaxWidth || K < 0 ||
      rows > (int64_t)kWarpsPerBlock * 0x7fffffff) {
    return (int)cudaErrorInvalidValue;
  }
  if (rows == 0 || K == 0) return (int)cudaSuccess;
  const float* g = static_cast<const float*>(grid);
  float* v = static_cast<float*>(vals);
  int32_t* a = static_cast<int32_t*>(args);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (L <= 32) launch<1>(g, rows, L, K, v, a, s);
  else if (L <= 64) launch<2>(g, rows, L, K, v, a, s);
  else launch<4>(g, rows, L, K, v, a, s);
  return (int)cudaGetLastError();
}
