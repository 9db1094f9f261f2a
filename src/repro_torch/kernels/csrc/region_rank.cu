// Fused (lazy decay +) scoring, gating and per-region top-k over the region
// layout's [R, W] grid, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/topk_select.py:region_rank, the Pallas TPU
// kernel of the region ranking cycle (core/ranking.ranking_cycle_region).
//
// What bounds it on an H100: bytes. Per slot it reads the one-byte base
// gate; per slot the gate lets through it reads the pair weight and count
// (and the i32 last_tick lane under the lazy policy), and per slot that
// passes all gates the dst marginals' weight and count: at most 17 B (21 B)
// a slot, far fewer on the engine's grid, where 1.4% of slots are live at
// tick 16. Per region it reads the source's two marginals (one [R] vector
// each, where the Pallas kernel read them broadcast to [R, W]) and writes K
// values, K columns and the pass count. A scored slot costs some 60 f32
// operations and nine libm calls under -fmad=false, the kernel's largest
// instruction count, so slots that are gated are never scored.
//
// Row route (region_rank_row_kernel, K <= 32, the engine's K1 = 8): a block
// of 256 threads owns a tile of 32 region rows.
//   1. Gate first: warp w takes rows 4w..4w+3, lane l slots l, l + 32, ...
//      (NPER = ceil(W / 32)). The lane reads the row's source weight and
//      its slots' base gate bytes (a warp's 32 bytes one coalesced
//      request); where the base gate is set and the source passes
//      min_src_weight, it loads w_ab and c_ab (and last_tick, decaying w
//      in-pass as the plain version does before it), then the three
//      threshold gates, f32 compares as in score_gate. A ballot and __popc
//      of the lanes below give each passing slot its place in the row's
//      list in shared memory (ascending columns): its w, c_ab and column.
//      The list's length is the row's npass. (Staging the tile's gate
//      bytes in shared memory first, with 16-byte loads, was slower on
//      both the synthetic and the engine's grid: one more barrier and
//      4 KB more shared memory a block.)
//   2. One warp turns the 32 lengths into offsets; then every thread of the
//      block scores the tile's passing slots from that dense list (item q
//      is found by a binary search of the offsets), loading w_b and c_b and
//      running repro::score_body (assoc_score.cuh) under -fmad=false, so a
//      warp with one passing slot in its row does not run the libm chain
//      with 31 lanes idle. Each score replaces its list entry's w.
//   3. Thread t takes row t's list in column order into the row route's
//      insertion list (row_topk.cuh, shared with bucket_topk) and writes K
//      values, K columns (16-byte stores where K and the bases allow) and
//      npass. Scanning only the passing slots equals scanning the whole row
//      with -inf elsewhere, since a -inf is never taken; a row with none
//      writes K x (-inf, W).
// Warp route (region_rank_kernel, any K): one warp per region
// row, every slot scored, then K rounds of repro::warp_topk (warp_topk.cuh).
// Both routes give exhausted rounds -inf and the sentinel column W, and read
// the three scalars (total weight, total count, now) from device memory so
// the caller never synchronises to pass them. The wrapper picks the route by
// K.
#include <cuda_runtime.h>
#include <cstdint>
#include <math.h>

#include "assoc_score.cuh"
#include "row_topk.cuh"
#include "warp_topk.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kMaxWidth = 128;
constexpr unsigned kFull = 0xffffffffu;
// Row route: a block of kRowThreads threads owns kTileRows region rows.
constexpr int kRowThreads = 256;
constexpr int kTileRows = 32;
constexpr int kRowsPerWarp = kTileRows / (kRowThreads / 32);
constexpr int kStride = kMaxWidth + 1;  // odd: thread t's row t in its own bank

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

// ---------------------------------------------------------------------------
// Row route: gate first, score the passing slots, one thread a row's top-k.
// ---------------------------------------------------------------------------

template <int NPER, int KMAX>
__global__ void __launch_bounds__(kRowThreads)
    region_rank_row_kernel(const float* __restrict__ w_ab,
                           const float* __restrict__ c_ab,
                           const float* __restrict__ w_a,
                           const float* __restrict__ w_b,
                           const float* __restrict__ c_a,
                           const float* __restrict__ c_b,
                           const uint8_t* __restrict__ ok,
                           const int32_t* __restrict__ last_tick,
                           const float* __restrict__ scalars, Params p,
                           int64_t rows, int W, int K, bool vec_out,
                           float* __restrict__ vals,
                           int32_t* __restrict__ args,
                           int32_t* __restrict__ npass) {
  // Row r's list of passing slots: w (then the score), c_ab (then the
  // column), and the column.
  __shared__ float w_s[kTileRows][kStride];
  __shared__ float c_s[kTileRows][kStride];
  __shared__ uint8_t col_s[kTileRows][kMaxWidth];
  __shared__ float wa_s[kTileRows], ca_s[kTileRows];
  __shared__ int cnt_s[kTileRows];
  __shared__ int off_s[kTileRows + 1];
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int64_t r0 = (int64_t)blockIdx.x * kTileRows;
  const int n = (int)min((int64_t)kTileRows, rows - r0);

  const float total_w = scalars[0];
  const float total_c = scalars[1];
  const float now = scalars[2];

  // 1. Gate first: each passing slot into its row's list, in column order.
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = warp * kRowsPerWarp + i;
    if (r >= n) break;  // uniform across the warp
    const float wa = w_a[r0 + r];
    if (lane == 0) {
      wa_s[r] = wa;
      ca_s[r] = c_a[r0 + r];
    }
    const bool src_ok = wa >= p.min_src_weight;
    const int64_t base = (r0 + r) * (int64_t)W;
    bool need[NPER];
    float w[NPER], cab[NPER];
#pragma unroll
    for (int j = 0; j < NPER; ++j) {
      const int c = lane + 32 * j;
      need[j] = src_ok && c < W && ok[base + c] != 0;
      w[j] = 0.0f;
      cab[j] = 0.0f;
      if (need[j]) {
        w[j] = w_ab[base + c];
        cab[j] = c_ab[base + c];
      }
    }
    if (p.half_life > 0.0f) {
#pragma unroll
      for (int j = 0; j < NPER; ++j) {
        if (need[j]) {
          const float dt =
              fmaxf(now - (float)last_tick[base + lane + 32 * j], 0.0f);
          w[j] = w[j] * exp2f(-dt / p.half_life);
        }
      }
    }
    int count = 0;
#pragma unroll
    for (int j = 0; j < NPER; ++j) {
      const bool pass = need[j] && w[j] >= p.min_pair_weight &&
                        cab[j] >= p.min_pair_count && wa >= p.min_src_weight;
      const unsigned b = __ballot_sync(kFull, pass);
      if (pass) {
        const int k = count + __popc(b & ((1u << lane) - 1u));
        w_s[r][k] = w[j];
        c_s[r][k] = cab[j];
        col_s[r][k] = (uint8_t)(lane + 32 * j);
      }
      count += __popc(b);
    }
    if (lane == 0) cnt_s[r] = count;
  }
  if (t < kTileRows && t >= n) cnt_s[t] = 0;
  __syncthreads();
  if (warp == 0) {
    int x = cnt_s[lane];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(kFull, x, d);
      if (lane >= d) x += y;
    }
    off_s[lane + 1] = x;
    if (lane == 0) off_s[0] = 0;
  }
  __syncthreads();

  // 2. Every thread scores passing slots from the dense list.
  const int total = off_s[kTileRows];
  for (int q = t; q < total; q += kRowThreads) {
    int r = 0;
#pragma unroll
    for (int step = kTileRows / 2; step > 0; step >>= 1) {
      if (off_s[r + step] <= q) r += step;
    }
    const int k = q - off_s[r];
    const int c = col_s[r][k];
    const int64_t i = (r0 + r) * (int64_t)W + c;
    w_s[r][k] = repro::score_body(w_s[r][k], c_s[r][k], wa_s[r], w_b[i],
                                  ca_s[r], c_b[i], total_w, total_c, p.c0,
                                  p.c1, p.c2, p.c3);
    c_s[r][k] = __int_as_float(c);
  }
  __syncthreads();

  // 3. Thread t: row t's top-k over its list.
  if (t >= n) return;
  const int m = cnt_s[t];
  float v[KMAX];
  int cv[KMAX];
  repro::init_topk<KMAX>(v, cv, W);
  bool any_nan = false;
  for (int k = 0; k < m; ++k) {
    const float x = w_s[t][k];
    any_nan |= x != x;
    repro::insert<KMAX>(v, cv, x, __float_as_int(c_s[t][k]));
  }
  if (any_nan) repro::fill_nan<KMAX>(v, cv, W);
  repro::write_topk<KMAX>(v, cv, K, vec_out, vals + (r0 + t) * K,
                          args + (r0 + t) * K);
  npass[r0 + t] = m;
}

template <int NPER, int KMAX>
void launch_rows(const float* const* lanes, const uint8_t* ok,
                 const int32_t* lt, const float* scalars, Params p,
                 int64_t rows, int W, int K, bool vec_out, float* vals,
                 int32_t* args, int32_t* npass, cudaStream_t stream) {
  const int64_t blocks = (rows + kTileRows - 1) / kTileRows;
  region_rank_row_kernel<NPER, KMAX>
      <<<(unsigned)blocks, kRowThreads, 0, stream>>>(
          lanes[0], lanes[1], lanes[2], lanes[3], lanes[4], lanes[5], ok, lt,
          scalars, p, rows, W, K, vec_out, vals, args, npass);
}

template <int NPER>
void launch_rows_k(int kmax, const float* const* lanes, const uint8_t* ok,
                   const int32_t* lt, const float* scalars, Params p,
                   int64_t rows, int W, int K, bool vec_out, float* vals,
                   int32_t* args, int32_t* npass, cudaStream_t stream) {
  if (kmax == 8) {
    launch_rows<NPER, 8>(lanes, ok, lt, scalars, p, rows, W, K, vec_out,
                         vals, args, npass, stream);
  } else if (kmax == 16) {
    launch_rows<NPER, 16>(lanes, ok, lt, scalars, p, rows, W, K, vec_out,
                          vals, args, npass, stream);
  } else {
    launch_rows<NPER, 32>(lanes, ok, lt, scalars, p, rows, W, K, vec_out,
                          vals, args, npass, stream);
  }
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

}  // namespace

extern "C" int repro_region_rank_max_width() { return kMaxWidth; }

// The warp route. w_ab, c_ab, w_b, c_b: f32[rows, W]; w_a, c_a: f32[rows];
// ok: bool[rows, W];
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

// The row route: the same arguments, plus the list length kmax (8, 16 or
// 32, at least K).
extern "C" int repro_region_rank_rows(
    const void* w_ab, const void* c_ab, const void* w_a, const void* w_b,
    const void* c_a, const void* c_b, const void* ok, const void* last_tick,
    const void* scalars, float c0, float c1, float c2, float c3,
    float min_pair_weight, float min_src_weight, float min_pair_count,
    float half_life, int64_t rows, int W, int K, int kmax, void* vals,
    void* args, void* npass, void* stream) {
  if (rows < 0 || W < 1 || W > kMaxWidth || K < 0 || K > kmax ||
      (kmax != 8 && kmax != 16 && kmax != 32) ||
      rows > (int64_t)kTileRows * 0x7fffffff ||
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
  const bool vec_out = K % 4 == 0 && aligned16(vals) && aligned16(args);
  if (W <= 32) {
    launch_rows_k<1>(kmax, lanes, o, lt, sc, p, rows, W, K, vec_out, v, a,
                     np, s);
  } else if (W <= 64) {
    launch_rows_k<2>(kmax, lanes, o, lt, sc, p, rows, W, K, vec_out, v, a,
                     np, s);
  } else {
    launch_rows_k<4>(kmax, lanes, o, lt, sc, p, rows, W, K, vec_out, v, a,
                     np, s);
  }
  return (int)cudaGetLastError();
}
