// Region-layout chain find, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/region_probe.py:chain_find_depth and the
// chain_find loop over it, the Pallas TPU kernel behind the region store's
// insert (core/stores.region_insert_accumulate) and lookup.
//
// What bounds it on an H100: bytes. Per active batch row it reads the
// row's chain of region ids (MC i32), its dst key and, at each chain depth
// it visits, one region row of keys (W u32 hi + W u32 lo); it writes one
// i32. The compares are nothing beside that.
//
// Design: one warp per batch row, and one launch for the whole chain (the
// Pallas version launches once per depth behind a lax.cond; the plain
// version syncs the host once per depth). At each depth the lanes load the
// region's key_hi/key_lo row with coalesced 4-byte reads, NPER = W / 32
// slots a lane (up to 4 at W = 128, a template constant so the compares
// stay in registers), and a __ballot_sync per 32-slot chunk gives the
// lowest matching position, the same position as jnp.argmax over the
// match mask. The walk skips a depth whose region is -1 and stops at the
// first hit. Chains are -1-terminated prefixes, so skipping a -1 depth
// equals ending the walk there, as stores._chain_find_jnp does.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kMaxWidth = 128;

template <int NPER>
__global__ void chain_find_kernel(const uint32_t* __restrict__ key_hi,
                                  const uint32_t* __restrict__ key_lo, int W,
                                  const int32_t* __restrict__ regs, int MC,
                                  const uint32_t* __restrict__ dst_hi,
                                  const uint32_t* __restrict__ dst_lo,
                                  const uint8_t* __restrict__ active,
                                  int32_t* __restrict__ out, int64_t rows) {
  const int64_t row = (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // uniform across the warp
  int64_t found = -1;
  if (active[row]) {
    const uint32_t dh = dst_hi[row];
    const uint32_t dl = dst_lo[row];
    for (int d = 0; d < MC; ++d) {
      const int32_t reg = regs[row * MC + d];
      if (reg < 0) continue;  // uniform: every lane read the same id
      const int64_t base = (int64_t)reg * W;
      bool m[NPER];
#pragma unroll
      for (int j = 0; j < NPER; ++j) {
        const int c = lane + 32 * j;
        const bool in = c < W;
        const uint32_t h = in ? key_hi[base + c] : 0u;
        const uint32_t l = in ? key_lo[base + c] : 0u;
        m[j] = in && h == dh && l == dl;
      }
      int pos = -1;
#pragma unroll
      for (int j = 0; j < NPER; ++j) {
        const unsigned b = __ballot_sync(0xffffffffu, m[j]);
        if (pos < 0 && b != 0u) pos = 32 * j + __ffs(b) - 1;
      }
      if (pos >= 0) {
        found = base + pos;
        break;
      }
    }
  }
  if (lane == 0) out[row] = (int32_t)found;
}

template <int NPER>
void launch(const uint32_t* kh, const uint32_t* kl, int W, const int32_t* regs,
            int MC, const uint32_t* dh, const uint32_t* dl, const uint8_t* act,
            int32_t* out, int64_t rows, cudaStream_t stream) {
  const int64_t blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  chain_find_kernel<NPER><<<(unsigned)blocks, kWarpsPerBlock * 32, 0, stream>>>(
      kh, kl, W, regs, MC, dh, dl, act, out, rows);
}

}  // namespace

extern "C" int repro_chain_find_max_width() { return kMaxWidth; }

// key_hi/key_lo: u32[n_regions, W] row-major; regs: i32[rows, MC] (-1 =
// no region); dst_hi/dst_lo: u32[rows]; active: bool[rows]; out: i32[rows]
// = global slot (region * W + position) of the first hit, or -1. Returns a
// cudaError_t code (0 on a clean launch).
extern "C" int repro_chain_find(const void* key_hi, const void* key_lo, int W,
                                const void* regs, int MC, const void* dst_hi,
                                const void* dst_lo, const void* active,
                                void* out, int64_t rows, void* stream) {
  if (rows < 0 || W < 1 || W > kMaxWidth || MC < 1 ||
      rows > (int64_t)kWarpsPerBlock * 0x7fffffff) {
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
  if (W <= 32) launch<1>(kh, kl, W, r, MC, dh, dl, a, o, rows, s);
  else if (W <= 64) launch<2>(kh, kl, W, r, MC, dh, dl, a, o, rows, s);
  else launch<4>(kh, kl, W, r, MC, dh, dl, a, o, rows, s);
  return (int)cudaGetLastError();
}
