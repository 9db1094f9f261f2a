// Region-layout chain find, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/region_probe.py:chain_find_depth and the
// chain_find loop over it, the Pallas TPU kernel behind the region store's
// insert (core/stores.region_insert_accumulate) and lookup.
//
// What bounds it on an H100: bytes. Per active batch row it reads the
// row's chain of region ids (MC i32), its dst key and, at each chain depth
// it visits, one region row of keys (W u32 hi + W u32 lo); every row reads
// its active flag and writes one i32. The compares are nothing beside that.
// On the engine's batches few rows are active (3.8% of the region path's
// largest), so what a design has to avoid is latency: a round trip per
// inactive row, and a chain of dependent round trips per active one.
//
// Design: one launch for the whole chain (the Pallas version launches once
// per depth behind a lax.cond; the plain version syncs the host once per
// depth), and a warp owns rpw consecutive batch rows, a power of two up to
// 32 that the wrapper sets by the batch size (region_probe.rows_per_warp):
// 16 on the engine's largest batches, whose rows are mostly inactive, one
// on its small dense ones. Lane l < rpw reads row0 + l's active flag (one
// coalesced request) and a __ballot_sync gives the warp its active set; a
// warp with none writes its rows' -1 and is done, so inactive rows cost one
// round trip a warp, not one a row. Each active lane then issues its own
// dst key and its first kHeldDepths region ids together, so those round
// trips overlap. The warp walks its active rows one at a time (__ffs over
// the ballot), the whole warp on each row: the row's key and region ids
// are passed to every lane with __shfl_sync; depths past kHeldDepths are
// read at the walk (all lanes one address). At each depth the warp reads
// the region's key_hi/key_lo row and finds the lowest matching position,
// the same position as jnp.argmax over the match mask:
//   - 16-byte route (W % 4 == 0 and both key bases 16-byte aligned): lane l
//     loads slots 4l..4l+3 of each lane array as one uint4 (W = 128: every
//     lane one uint4 of each); a ballot on "any of my four match", __ffs,
//     then that lane's first matching j;
//   - 4-byte route (any W up to 128, any base): lane l loads slots
//     l, l + 32, ... (NPER = ceil(W / 32), a template constant), one ballot
//     per 32-slot chunk, the first chunk with a match giving the position.
// The wrapper picks the route (region_probe.kernel_route). The walk skips a
// depth whose region is -1 and stops at the first hit. Chains are
// -1-terminated prefixes, so skipping a -1 depth equals ending the walk
// there, as stores._chain_find_jnp does. Each lane keeps its own row's
// result and the warp writes them as one coalesced store.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kMaxRowsPerWarp = 32;
constexpr int kMaxWidth = 128;
constexpr int kHeldDepths = 8;   // region ids a lane prefetches into registers
constexpr unsigned kFull = 0xffffffffu;

// The lowest position of (h, l) in region row `reg`, as a global slot, or
// -1. Called by the whole warp with warp-uniform arguments.
template <bool VEC, int NPER>
__device__ __forceinline__ int32_t find_in_region(
    const uint32_t* __restrict__ key_hi, const uint32_t* __restrict__ key_lo,
    int W, int32_t reg, uint32_t h, uint32_t l, int lane) {
  const int64_t base = (int64_t)reg * W;
  if constexpr (VEC) {
    int first = 4;
    if (4 * lane < W) {
      const uint4 kh = *reinterpret_cast<const uint4*>(key_hi + base + 4 * lane);
      const uint4 kl = *reinterpret_cast<const uint4*>(key_lo + base + 4 * lane);
      first = (kh.x == h && kl.x == l)   ? 0
              : (kh.y == h && kl.y == l) ? 1
              : (kh.z == h && kl.z == l) ? 2
              : (kh.w == h && kl.w == l) ? 3
                                         : 4;
    }
    const unsigned b = __ballot_sync(kFull, first < 4);
    if (b == 0u) return -1;
    const int p = __ffs(b) - 1;
    const int j = __shfl_sync(kFull, first, p);
    return (int32_t)(base + 4 * p + j);
  } else {
    bool m[NPER];
#pragma unroll
    for (int j = 0; j < NPER; ++j) {
      const int c = lane + 32 * j;
      const bool in = c < W;
      const uint32_t kh = in ? key_hi[base + c] : 0u;
      const uint32_t kl = in ? key_lo[base + c] : 0u;
      m[j] = in && kh == h && kl == l;
    }
    int pos = -1;
#pragma unroll
    for (int j = 0; j < NPER; ++j) {
      const unsigned b = __ballot_sync(kFull, m[j]);
      if (pos < 0 && b != 0u) pos = 32 * j + __ffs(b) - 1;
    }
    return pos < 0 ? -1 : (int32_t)(base + pos);
  }
}

template <bool VEC, int NPER>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    chain_find_kernel(const uint32_t* __restrict__ key_hi,
                      const uint32_t* __restrict__ key_lo, int W,
                      const int32_t* __restrict__ regs, int MC,
                      const uint32_t* __restrict__ dst_hi,
                      const uint32_t* __restrict__ dst_lo,
                      const uint8_t* __restrict__ active,
                      int32_t* __restrict__ out, int64_t rows, int rpw) {
  const int lane = threadIdx.x & 31;
  const int64_t row0 =
      ((int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5)) * rpw;
  if (row0 >= rows) return;  // uniform across the warp
  const int64_t row = row0 + lane;
  const bool in = lane < rpw && row < rows;
  const bool act = in && active[row] != 0;
  unsigned todo = __ballot_sync(kFull, act);
  int32_t found = -1;
  if (todo != 0u) {
    uint32_t dh = 0u, dl = 0u;
    int32_t reg[kHeldDepths];
#pragma unroll
    for (int d = 0; d < kHeldDepths; ++d) reg[d] = -1;
    if (act) {
      dh = dst_hi[row];
      dl = dst_lo[row];
#pragma unroll
      for (int d = 0; d < kHeldDepths; ++d) {
        if (d < MC) reg[d] = regs[row * MC + d];
      }
    }
    while (todo != 0u) {
      const int src = __ffs(todo) - 1;
      todo &= todo - 1u;
      const uint32_t h = __shfl_sync(kFull, dh, src);
      const uint32_t l = __shfl_sync(kFull, dl, src);
      int32_t hit = -1;
#pragma unroll
      for (int d = 0; d < kHeldDepths; ++d) {
        if (hit >= 0 || d >= MC) break;  // uniform across the warp
        const int32_t r = __shfl_sync(kFull, reg[d], src);
        if (r >= 0) {  // uniform: every lane holds the same r
          hit = find_in_region<VEC, NPER>(key_hi, key_lo, W, r, h, l, lane);
        }
      }
      for (int d = kHeldDepths; hit < 0 && d < MC; ++d) {
        const int32_t r = regs[(row0 + src) * MC + d];
        if (r >= 0) {
          hit = find_in_region<VEC, NPER>(key_hi, key_lo, W, r, h, l, lane);
        }
      }
      if (lane == src) found = hit;
    }
  }
  if (in) out[row] = found;
}

template <bool VEC, int NPER>
void launch(const uint32_t* kh, const uint32_t* kl, int W, const int32_t* regs,
            int MC, const uint32_t* dh, const uint32_t* dl, const uint8_t* act,
            int32_t* out, int64_t rows, int rpw, cudaStream_t stream) {
  const int64_t rows_per_block = (int64_t)kWarpsPerBlock * rpw;
  const int64_t blocks = (rows + rows_per_block - 1) / rows_per_block;
  chain_find_kernel<VEC, NPER>
      <<<(unsigned)blocks, kWarpsPerBlock * 32, 0, stream>>>(
          kh, kl, W, regs, MC, dh, dl, act, out, rows, rpw);
}

// Warps of one instance resident on an SM, from the runtime's occupancy
// calculator (registers and block size as built); -1 on an error.
template <bool VEC, int NPER>
int resident_warps() {
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, chain_find_kernel<VEC, NPER>, kWarpsPerBlock * 32, 0) !=
      cudaSuccess) {
    return -1;
  }
  return blocks * kWarpsPerBlock;
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

}  // namespace

extern "C" int repro_chain_find_max_width() { return kMaxWidth; }

// Warps an SM holds at once of the instance repro_chain_find launches for
// width W on the route vec names; -1 for a width it refuses or an error.
extern "C" int repro_chain_find_resident_warps(int W, int vec) {
  if (W < 1 || W > kMaxWidth || (vec && W % 4 != 0)) return -1;
  if (vec) return resident_warps<true, 1>();
  if (W <= 32) return resident_warps<false, 1>();
  if (W <= 64) return resident_warps<false, 2>();
  return resident_warps<false, 4>();
}

// key_hi/key_lo: u32[n_regions, W] row-major; regs: i32[rows, MC] (-1 =
// no region); dst_hi/dst_lo: u32[rows]; active: bool[rows]; out: i32[rows]
// = global slot (region * W + position) of the first hit, or -1; vec: 1 for
// the 16-byte route (W % 4 == 0 and both key bases 16-byte aligned, else
// refused), 0 for the 4-byte route; rpw: the rows a warp owns, a power of
// two up to 32. Returns a cudaError_t code (0 on a clean launch).
extern "C" int repro_chain_find(const void* key_hi, const void* key_lo, int W,
                                const void* regs, int MC, const void* dst_hi,
                                const void* dst_lo, const void* active,
                                void* out, int64_t rows, int vec, int rpw,
                                void* stream) {
  if (rows < 0 || W < 1 || W > kMaxWidth || MC < 1 || rpw < 1 ||
      rpw > kMaxRowsPerWarp || (rpw & (rpw - 1)) != 0 ||
      rows > (int64_t)kWarpsPerBlock * rpw * 0x7fffffff ||
      (vec && (W % 4 != 0 || !aligned16(key_hi) || !aligned16(key_lo)))) {
    return (int)cudaErrorInvalidValue;
  }
  if (rows == 0) return (int)cudaSuccess;
  const uint32_t* kh = static_cast<const uint32_t*>(key_hi);
  const uint32_t* kl = static_cast<const uint32_t*>(key_lo);
  const int32_t* r = static_cast<const int32_t*>(regs);
  const uint32_t* dh = static_cast<const uint32_t*>(dst_hi);
  const uint32_t* dl = static_cast<const uint32_t*>(dst_lo);
  const uint8_t* a = static_cast<const uint8_t*>(active);
  int32_t* o = static_cast<int32_t*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec) {
    launch<true, 1>(kh, kl, W, r, MC, dh, dl, a, o, rows, rpw, s);
  } else if (W <= 32) {
    launch<false, 1>(kh, kl, W, r, MC, dh, dl, a, o, rows, rpw, s);
  } else if (W <= 64) {
    launch<false, 2>(kh, kl, W, r, MC, dh, dl, a, o, rows, rpw, s);
  } else {
    launch<false, 4>(kh, kl, W, r, MC, dh, dl, a, o, rows, rpw, s);
  }
  return (int)cudaGetLastError();
}
