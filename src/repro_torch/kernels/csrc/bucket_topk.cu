// Per-bucket top-k over the segmented ranking cycle's [R, L] grid, for Hopper.
//
// Replaces: src/repro/kernels/topk_select.py:bucket_topk, the Pallas TPU
// kernel of the ranking cycle's selection stage (core/ranking.ranking_cycle)
// and of the region ranking cycle's per-source chain merge
// (core/ranking.ranking_cycle_region).
//
// What bounds it on an H100: bytes. The grid is read once (R * L * 4 B) and
// K values and K columns are written per row (R * K * 8 B); the selection
// runs on registers.
//
// Both routes take ties to the lowest column and emit -inf with the
// sentinel column L on rounds past a row's finite values, exactly like
// lax.top_k and the Pallas kernel. A row that holds a NaN gives NaN with
// the sentinel column in every round, as the Pallas kernel does (lax.top_k
// orders NaNs by sign instead); no engine score is NaN. Rows up to
// 128 wide are taken: the engine's grid is max(bucket_rows, top_k) = 64
// wide at RankConfig's defaults, and the chain merge's max_chain * K1 = 64
// at the deployment configuration. The wrapper picks the route by K.
//
// Row route (bucket_topk_row_kernel, K <= 32, the engine's K 8): one thread
// per row. A block owns a tile of consecutive rows, one contiguous span of
// the grid, and copies it into shared memory with cp.async: 16-byte copies
// where the span's base and L allow them, else 4-byte copies; both are
// coalesced. Each row sits at a padded stride (a multiple of 4 floats,
// whose quarter is odd) so the 8 threads of a quarter-warp reading their
// rows with 16-byte shared loads hit 32 distinct banks; the columns from L
// to L rounded up to 4 are filled with -inf. The thread then scans its row
// in ascending column order, keeping a KMAX-long descending (value,
// column) list in registers (KMAX 8, 16 or 32, a template constant, so
// every index is a compile-time constant), started at (-inf, L). A value
// is inserted only when it is strictly greater than the list's last entry;
// a compare-and-shift puts it behind the entries equal to it, which keeps
// ties in column order (row_topk.cuh, shared with region_rank). That one
// compare rejects most columns, and every
// column of an all -inf row, so the hash path's grid (nearly all rows
// empty) costs little more than its bytes. No shuffle, no local memory.
// The first K entries are written as 16-byte stores where K and the output
// bases allow, so a warp writes 32 consecutive rows' outputs as one span.
// A partial last tile is masked inside the kernel.
//
// Warp route (bucket_topk_kernel, any K): one warp per row. Lane l holds
// columns l, l + 32, ... in registers (NPER = ceil(L / 32) values, a
// template constant so the array stays in registers), loaded with
// coalesced 4-byte reads; K rounds of repro::warp_topk (warp_topk.cuh,
// shared with region_rank), each a local scan and a five-step butterfly.
#include <cuda_runtime.h>
#include <cstdint>
#include <math.h>

#include "row_topk.cuh"
#include "warp_topk.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kMaxWidth = 128;
constexpr int kMaxTileRows = 128;
constexpr int kMaxSharedBytes = 232448;  // 227 KB a block on sm_90

// ---------------------------------------------------------------------------
// Warp route: one warp per row.
// ---------------------------------------------------------------------------

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

// ---------------------------------------------------------------------------
// Row route: one thread per row over a shared-memory tile.
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Copies elements [0, n) of src into the tile, element e at
// (e / L) * stride + e % L; the n elements are W-element chunks (W 4 or 1)
// that never straddle a row, so a thread steps (row, col) by the block's
// size instead of dividing.
template <int W>
__device__ __forceinline__ void stage(const float* __restrict__ src, int n,
                                      int L, int stride, uint32_t tile) {
  const int T = blockDim.x;
  const int lw = L / W;  // chunks a row
  int row = threadIdx.x / lw, col = threadIdx.x % lw;
  const int drow = T / lw, dcol = T % lw;
  for (int i = threadIdx.x; i < n / W; i += T) {
    const uint32_t dst = tile + 4u * (uint32_t)(row * stride + col * W);
    if constexpr (W == 4) {
      cp_async16(dst, src + 4 * i);
    } else {
      cp_async4(dst, src + i);
    }
    row += drow;
    col += dcol;
    if (col >= lw) {
      col -= lw;
      ++row;
    }
  }
}

template <int KMAX>
__global__ void __launch_bounds__(kMaxTileRows)
    bucket_topk_row_kernel(const float* __restrict__ grid, int64_t rows, int L,
                           int K, int stride, bool vec_in, bool vec_out,
                           float* __restrict__ vals,
                           int32_t* __restrict__ args) {
  extern __shared__ float4 smem[];
  float* tile = reinterpret_cast<float*>(smem);
  const int64_t r0 = (int64_t)blockIdx.x * blockDim.x;
  const int n = (int)min((int64_t)blockDim.x, rows - r0);
  const int t = threadIdx.x;
  const float* src = grid + r0 * L;
  const uint32_t base = (uint32_t)__cvta_generic_to_shared(tile);
  if (vec_in) {
    stage<4>(src, n * L, L, stride, base);
  } else {
    stage<1>(src, n * L, L, stride, base);
  }
  const int lp = (L + 3) & ~3;
  if (t < n) {
    for (int c = L; c < lp; ++c) tile[t * stride + c] = -INFINITY;
  }
  cp_async_wait_all();
  __syncthreads();
  if (t >= n) return;

  float v[KMAX];
  int c[KMAX];
  repro::init_topk<KMAX>(v, c, L);
  const float4* rowp = reinterpret_cast<const float4*>(tile + t * stride);
  bool any_nan = false;
  for (int q = 0; q < lp / 4; ++q) {
    const float4 x = rowp[q];
    any_nan |= repro::either_nan(x.x, x.y) | repro::either_nan(x.z, x.w);
    repro::insert<KMAX>(v, c, x.x, 4 * q);
    repro::insert<KMAX>(v, c, x.y, 4 * q + 1);
    repro::insert<KMAX>(v, c, x.z, 4 * q + 2);
    repro::insert<KMAX>(v, c, x.w, 4 * q + 3);
  }
  if (any_nan) repro::fill_nan<KMAX>(v, c, L);

  repro::write_topk<KMAX>(v, c, K, vec_out, vals + (r0 + t) * K,
                          args + (r0 + t) * K);
}

template <int KMAX>
int launch_rows(const float* grid, int64_t rows, int L, int K, int tile_rows,
                int stride, bool vec_in, bool vec_out, float* vals,
                int32_t* args, cudaStream_t stream) {
  const int smem = tile_rows * stride * 4;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        bucket_topk_row_kernel<KMAX>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int64_t blocks = (rows + tile_rows - 1) / tile_rows;
  bucket_topk_row_kernel<KMAX><<<(unsigned)blocks, tile_rows, smem, stream>>>(
      grid, rows, L, K, stride, vec_in, vec_out, vals, args);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

}  // namespace

extern "C" int repro_bucket_topk_max_width() { return kMaxWidth; }

// The warp route. grid: f32[rows, L] row-major; vals f32[rows, K]; args
// i32[rows, K]. Returns a cudaError_t code (0 on a clean launch).
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

// The row route: the same arguments, plus the list length kmax (8, 16 or
// 32, at least K), and the tile the wrapper chose: tile_rows rows a block
// (a multiple of 32, at most 128) at a stride of `stride` floats (a
// multiple of 4, at least L rounded up to 4), tile_rows * stride * 4 bytes
// of shared memory.
extern "C" int repro_bucket_topk_rows(const void* grid, int64_t rows, int L,
                                      int K, int kmax, int tile_rows,
                                      int stride, void* vals, void* args,
                                      void* stream) {
  const int lp = (L + 3) & ~3;
  if (rows < 0 || L < 1 || L > kMaxWidth || K < 0 || K > kmax ||
      (kmax != 8 && kmax != 16 && kmax != 32) || tile_rows < 32 ||
      tile_rows > kMaxTileRows || tile_rows % 32 != 0 || stride < lp ||
      stride % 4 != 0 || (int64_t)tile_rows * stride * 4 > kMaxSharedBytes ||
      rows > (int64_t)tile_rows * 0x7fffffff) {
    return (int)cudaErrorInvalidValue;
  }
  if (rows == 0 || K == 0) return (int)cudaSuccess;
  const float* g = static_cast<const float*>(grid);
  float* v = static_cast<float*>(vals);
  int32_t* a = static_cast<int32_t*>(args);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec_in = L % 4 == 0 && aligned16(g);
  const bool vec_out = K % 4 == 0 && aligned16(v) && aligned16(a);
  if (kmax == 8) {
    return launch_rows<8>(g, rows, L, K, tile_rows, stride, vec_in, vec_out,
                          v, a, s);
  }
  if (kmax == 16) {
    return launch_rows<16>(g, rows, L, K, tile_rows, stride, vec_in, vec_out,
                           v, a, s);
  }
  return launch_rows<32>(g, rows, L, K, tile_rows, stride, vec_in, vec_out,
                         v, a, s);
}
