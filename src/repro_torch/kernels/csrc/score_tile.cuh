// The tile machinery shared by score_gate.cu and assoc_score.cu: gate first,
// then score a dense list of the slots that pass.
//
// A block of kThreads threads owns a tile of kSlots = kThreads * 4 * kGroups
// consecutive slots. Each kernel runs these phases over it:
//   1. Gate. On the 16-byte route (every base 16-byte aligned and the tile
//      full) thread t owns the 4-slot groups t + 256 j (j < kGroups), each
//      read with one 4-byte load of its gate bytes and 16-byte loads of the
//      lanes; on the 4-byte route it owns slots t + 256 j (j < kPerThread),
//      read one by one, and the ragged last tile is masked slot by slot. Either
//      way a warp's loads are coalesced, and all of a thread's loads are
//      issued before its first ballot, so a warp waits for one round trip
//      of each kind. Ballots and the popcount of the lanes below (place4,
//      place) put each passing slot in its warp's segment of the block's
//      list in shared memory, in slot order within each j, and the thread
//      keeps a bit mask of its passing slots.
//   2. Score. After a barrier every thread takes list items q = t, t + 256,
//      ... of the block's dense item range; item_index() maps q to its warp
//      segment from the eight segment lengths, so every lane of a warp runs
//      the scoring chain while any item is left. The item's thread loads
//      the slot's other lanes (those the gate read come again from L1 or
//      L2) and writes its score to the output.
//   3. Fill. The owner of each slot left out of the list writes the
//      kernel's fill value there (fill_vec, fill_scalar): 16-byte stores for
//      groups with no listed slot. So every slot of the tile is written
//      once. A kernel whose fill is known up front fills during phase 1.
// The list holds 2-byte offsets (and score_gate's decayed weights), 12 KB
// at 2,048 slots, so eight blocks fit on an SM. scripts/score_tile_probe.py
// times other tile sizes and the variants this design left out.
#pragma once

#include <cstdint>

namespace repro {
namespace tile {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

constexpr int kGroups = 2;                     // 4-slot groups a thread owns
constexpr int kPerThread = 4 * kGroups;        // slots a thread owns
constexpr int kSlots = kThreads * kPerThread;  // slots a tile holds
constexpr int kSegment = 32 * kPerThread;      // a warp's list room

// The list position of this lane's slot among its warp's passing slots
// (valid where ``pass``); adds the warp's passes to ``count``. Every lane of
// the warp calls it.
__device__ __forceinline__ int place(bool pass, int lane, int& count) {
  const unsigned b = __ballot_sync(kFull, pass);
  const int pos = count + __popc(b & ((1u << lane) - 1u));
  count += __popc(b);
  return pos;
}

// The same for a 4-slot group: ``bits`` has bit k where slot k passes. One
// ballot a slot position; the lane's passing slots go to the returned
// position and on, in slot order, after those of the lanes below, so the
// warp's list follows the slots' order.
__device__ __forceinline__ int place4(uint32_t bits, int lane, int& count) {
  const unsigned below_mask = (1u << lane) - 1u;
  int below = 0, all = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const unsigned b = __ballot_sync(kFull, (bits >> k) & 1u);
    below += __popc(b & below_mask);
    all += __popc(b);
  }
  const int pos = count + below;
  count += all;
  return pos;
}

// The exclusive prefix of the warps' list lengths, off[0..kWarps]; read
// after the barrier that follows the gate phase.
__device__ __forceinline__ void segment_offsets(const int* cnt_s,
                                                int (&off)[kWarps + 1]) {
  off[0] = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) off[w + 1] = off[w] + cnt_s[w];
}

// The list index of dense item q (q < off[kWarps]): the last segment that
// starts at or before q, then q's place in it. Only static indices, so
// ``off`` stays in registers.
__device__ __forceinline__ int item_index(int q,
                                          const int (&off)[kWarps + 1]) {
  int seg = 0, base = 0;
#pragma unroll
  for (int w = 1; w < kWarps; ++w) {
    if (q >= off[w]) {
      seg = w;
      base = off[w];
    }
  }
  return seg * kSegment + (q - base);
}

// Four floats from a 16-byte aligned address into x[0..3].
__device__ __forceinline__ void load4(const float* p, float* x) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x[0] = v.x;
  x[1] = v.y;
  x[2] = v.z;
  x[3] = v.w;
}

// The fill value into the thread's slots that ``mask`` leaves out, on the
// 16-byte route: one 16-byte store for a group with no slot in the list,
// 4-byte stores beside the listed slots of the others.
__device__ __forceinline__ void fill_vec(uint32_t mask, float fill,
                                         float* out, int t) {
#pragma unroll
  for (int j = 0; j < kGroups; ++j) {
    const int s0 = 4 * (t + kThreads * j);
    const uint32_t bits = (mask >> (4 * j)) & 15u;
    if (bits == 0) {
      *reinterpret_cast<float4*>(out + s0) = make_float4(fill, fill, fill,
                                                         fill);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (!((bits >> k) & 1u)) out[s0 + k] = fill;
      }
    }
  }
}

// The same on the 4-byte route: slots t + 256 j below ``m``.
__device__ __forceinline__ void fill_scalar(uint32_t mask, float fill,
                                            float* out, int t, int m) {
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int s = t + kThreads * j;
    if (s < m && !((mask >> j) & 1u)) out[s] = fill;
  }
}

inline bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

}  // namespace tile
}  // namespace repro
