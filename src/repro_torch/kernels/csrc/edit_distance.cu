// Batched weighted optimal-string-alignment distance, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/edit_distance.py:107 edit_distance, the
// Pallas TPU kernel behind the spelling job (core/spelling.spelling_cycle
// through ops.edit_distance).
//
// What bounds it on an H100: instruction issue. Per pair it reads 2L + 8
// bytes (two u8[L] strings, two i32 lengths) and writes one f32, but it
// fills a_len x b_len DP cells of about 7 adds and mins each; at the
// spelling job's L = 24 that is up to 576 cells against 60 bytes. The
// integer pipe issues 64 lanes an SM a clock, DPX, IADD3 and LOP3 alike
// (scripts/dpx_rate.py), half the f32 add rate.
//
// Two routes, chosen by the wrapper from first_char_cost (fc):
//
//  * ed_half_kernel, when 2 fc is an integer w in [0, 1024]. Then every
//    cell of the f32 table is an exact multiple of 1/2 far below 2^24, so
//    the table equals an integer table in half units (edits cost 2, edits
//    touching a first character w), halved, bit for bit. Each thread runs
//    two pairs as the low and high 16-bit lanes of each register, on
//    Hopper's DPX instructions (add-then-min and min-of-three on s16x2).
//    Characters are kept shifted left by 2, so the XOR of two of them is
//    0 on a match and at least 4 otherwise; an interior cell (i, j >= 3)
//    is then six instructions for the two pairs (five on the integer
//    pipe; ptxas issues the add as IMAD.IADD on the FMA pipe):
//        x = a_i ^ b_j                           (reused as the next
//                                                 column's transposition
//                                                 test)
//        y = P1[j-1] + x                         (substitution: x >= 4 on a
//                                                 mismatch never beats P1+2)
//        t = (a_{i-1} | 2) ^ b_{j-1} | x_{j-1}   (2 if the transposition
//                                                 matches, else >= 6)
//        y = min(P2[j-2] + t, y)                 viaddmin
//        m = min(P1[j-1], P1[j], C[j-1])         vimin3
//        C[j] = min(m + 2, y)                    viaddmin
//    A non-matching transposition may cost anything >= 4 there, since a
//    cell never exceeds P2[j-2] + 4 (two substitutions). Rows 1 and 2 are
//    peeled and columns 1 and 2 fixed by the unrolled j, so the w-weighted
//    edits cost nothing in the interior. The largest lane sum, at L 32 and
//    w 1024, is below 3,200, far from s16's 32,767. The result is 0.5f * d.
//  * ed_f32_kernel otherwise: one thread per pair, three f32 DP rows in
//    registers, each cell the plain version's sequence of f32 adds and
//    mins in its order (row 0 as fc + (j - 1), column 0 built row by row),
//    so the two agree bit for bit (the build passes -fmad=false).
//
// Both routes: the j loop is unrolled to the kernel's maximum length LMAX
// (a template constant: 16, 24 or 32), so every row index is a
// compile-time constant and nothing spills, and it ends at the warp's
// largest b_len, a warp-uniform value from __reduce_max_sync (the half
// route breaks out, testing every second column; the f32 route skips the
// columns past it). The row loop stops at the largest
// a_len of the thread's pairs, and each pair's cell (a_len, b_len) is
// picked as its row goes by. A block's pairs are one contiguous span of
// both string arrays: it is staged in shared memory with 16-byte loads
// (bytes at either end of a span not 16-byte aligned are loaded one by
// one, so any base is taken), and each thread reads its characters from
// there. A tail block and an odd B are masked inside the kernel.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kMaxLen = 32;
constexpr int kThreads = 128;
constexpr int kMaxHalfWeight = 1 << 10;
constexpr unsigned kFull = 0xffffffffu;

// Copies bytes [0, nbytes) of g into s, byte k at s[(g & 15) + k]; s is
// 16-byte aligned with room for nbytes + 16.
__device__ __forceinline__ void stage(const uint8_t* __restrict__ g,
                                      int64_t nbytes, uint8_t* s) {
  const int mis = (int)((uintptr_t)g & 15);
  const int64_t n_chunks = (mis + nbytes + 15) >> 4;
  for (int64_t c = threadIdx.x; c < n_chunks; c += blockDim.x) {
    const int64_t k0 = c * 16 - mis;  // byte of g at the chunk's start
    if (k0 >= 0 && k0 + 16 <= nbytes) {
      *reinterpret_cast<uint4*>(s + c * 16) =
          __ldg(reinterpret_cast<const uint4*>(g + k0));
    } else {
#pragma unroll
      for (int t = 0; t < 16; ++t) {
        const int64_t k = k0 + t;
        if (k >= 0 && k < nbytes) s[c * 16 + t] = g[k];
      }
    }
  }
}

__device__ __forceinline__ int clamp_len(const int32_t* len, int64_t p,
                                         bool live, int L) {
  return live ? min(max(len[p], 0), L) : 0;
}

// ---------------------------------------------------------------------------
// f32 route: one pair a thread.
// ---------------------------------------------------------------------------

template <int LMAX>
__global__ void __launch_bounds__(kThreads)
    ed_f32_kernel(const uint8_t* __restrict__ a,
                  const int32_t* __restrict__ a_len,
                  const uint8_t* __restrict__ b,
                  const int32_t* __restrict__ b_len, float* __restrict__ out,
                  int64_t n, int L, float fc) {
  __shared__ __align__(16) uint8_t sa[kThreads * LMAX + 16];
  __shared__ __align__(16) uint8_t sb[kThreads * LMAX + 16];
  const int64_t base = (int64_t)blockIdx.x * kThreads;
  const int np = (int)min((int64_t)kThreads, n - base);
  const uint8_t* ga = a + base * L;
  const uint8_t* gb = b + base * L;
  stage(ga, (int64_t)np * L, sa);
  stage(gb, (int64_t)np * L, sb);
  __syncthreads();
  const int q = threadIdx.x;
  const bool live = q < np;
  const int al = clamp_len(a_len, base + q, live, L);
  const int bl = clamp_len(b_len, base + q, live, L);
  const int jmax = __reduce_max_sync(kFull, bl);
  const uint8_t* ap = sa + ((uintptr_t)ga & 15) + q * L;
  const uint8_t* bp = sb + ((uintptr_t)gb & 15) + q * L;
  int bc[LMAX];
#pragma unroll
  for (int j = 0; j < LMAX; ++j) bc[j] = j < L ? (int)bp[j] : 0;
  // rows i-2, i-1 and i of the table; row 0 is D[0][j] = fc + (j - 1)
  float p2[LMAX + 1], p1[LMAX + 1], cur[LMAX + 1];
#pragma unroll
  for (int j = 0; j <= LMAX; ++j) {
    const float r = j == 0 ? 0.0f : fc + (float)(j - 1);
    p2[j] = r;
    p1[j] = r;
    cur[j] = r;
  }
  int a_prev = 0;  // a[i-2]
  for (int i = 1; i <= al; ++i) {
    const int ai = ap[i - 1];
    const float del_w = i == 1 ? fc : 1.0f;  // also sub_w for j >= 2
    cur[0] = i == 1 ? fc : p1[0] + 1.0f;
#pragma unroll
    for (int j = 1; j <= LMAX; ++j) {
      if (j <= jmax) {
        const int bj = bc[j - 1];
        const float sub_w = j == 1 ? fc : del_w;
        const float ins_w = j == 1 ? fc : 1.0f;
        const float sub = p1[j - 1] + (ai == bj ? 0.0f : sub_w);
        const float ins = cur[j - 1] + ins_w;
        const float del = p1[j] + del_w;
        float d = fminf(fminf(sub, ins), del);
        if (j >= 2 && i >= 2) {
          const float tw = (i == 2 || j == 2) ? fc : 1.0f;
          if (a_prev == bj && ai == bc[j - 2]) d = fminf(d, p2[j - 2] + tw);
        }
        cur[j] = d;
      }
    }
#pragma unroll
    for (int j = 0; j <= LMAX; ++j) {
      p2[j] = p1[j];
      p1[j] = cur[j];
    }
    a_prev = ai;
  }
  float r = p1[0];
#pragma unroll
  for (int j = 1; j <= LMAX; ++j) {
    if (j == bl) r = p1[j];
  }
  if (live) out[base + q] = r;
}

// ---------------------------------------------------------------------------
// Half-unit route: two pairs a thread, as the s16 lanes of each register.
// ---------------------------------------------------------------------------

constexpr uint32_t kTwo = 0x00020002u;
constexpr uint32_t kOne = 0x00010001u;
// The column cut-off is tested every kColStep columns.
constexpr int kColStep = 2;

// Row i of the table into C from rows i-1 (P1) and i-2 (P2). KIND 1 is
// row 1, KIND 2 row 2, KIND 3 any later row. ai = a[i-1] << 2 and
// ap = a[i-2] << 2 in both lanes; w the first-character cost, wpk it in
// both lanes.
template <int LMAX, int KIND>
__device__ __forceinline__ void half_row(uint32_t (&C)[LMAX + 1],
                                         const uint32_t (&P1)[LMAX + 1],
                                         const uint32_t (&P2)[LMAX + 1],
                                         const uint32_t (&bp)[LMAX],
                                         uint32_t ai, uint32_t ap, int jmax,
                                         uint32_t w, uint32_t wpk) {
  const uint32_t ap2 = ap | kTwo;
  C[0] = KIND == 1 ? wpk : P1[0] + kTwo;
  uint32_t x_prev = 0;  // a[i-1] ^ b[j-2], shifted
#pragma unroll
  for (int j = 1; j <= LMAX; ++j) {
    if ((j - 1) % kColStep == 0 && j > jmax) break;
    const uint32_t x = ai ^ bp[j - 1];
    uint32_t d;
    if (KIND == 1) {
      // row 1: substitution and deletion cost w; insertion w at j = 1
      const uint32_t s = __vminu2(x, kOne) * w;
      d = __viaddmin_s16x2(P1[j], wpk, P1[j - 1] + s);
      d = __viaddmin_s16x2(C[j - 1], j == 1 ? wpk : kTwo, d);
    } else if (j == 1) {
      // column 1: substitution and insertion cost w, deletion 2
      const uint32_t s = __vminu2(x, kOne) * w;
      d = __viaddmin_s16x2(P1[1], kTwo, P1[0] + s);
      d = __viaddmin_s16x2(C[0], wpk, d);
    } else {
      uint32_t y = P1[j - 1] + x;
      if (KIND == 2 || j == 2) {
        // the transposition touches a first character: w on a match,
        // w + 2 (never below the cell) otherwise
        const uint32_t o = (ap ^ bp[j - 1]) | x_prev;
        y = __viaddmin_s16x2(P2[j - 2], wpk + __vminu2(o, kTwo), y);
      } else {
        y = __viaddmin_s16x2(P2[j - 2], (ap2 ^ bp[j - 1]) | x_prev, y);
      }
      d = __viaddmin_s16x2(__vimin3_s16x2(P1[j - 1], P1[j], C[j - 1]), kTwo,
                           y);
    }
    C[j] = d;
    x_prev = x;
  }
}

// C[k] with k a run-time index into a register row.
template <int LMAX>
__device__ __forceinline__ uint32_t pick(const uint32_t (&C)[LMAX + 1],
                                         int k) {
  uint32_t v = C[0];
#pragma unroll
  for (int j = 1; j <= LMAX; ++j) v = j == k ? C[j] : v;
  return v;
}

template <int LMAX>
__device__ __forceinline__ void take(const uint32_t (&C)[LMAX + 1], int i,
                                     int al0, int bl0, int al1, int bl1,
                                     uint32_t& r0, uint32_t& r1) {
  if (i == al0) r0 = pick<LMAX>(C, bl0) & 0xffffu;
  if (i == al1) r1 = pick<LMAX>(C, bl1) >> 16;
}

template <int LMAX>
__global__ void __launch_bounds__(kThreads)
    ed_half_kernel(const uint8_t* __restrict__ a,
                   const int32_t* __restrict__ a_len,
                   const uint8_t* __restrict__ b,
                   const int32_t* __restrict__ b_len,
                   float* __restrict__ out, int64_t n, int L, int w_half) {
  constexpr int kPairs = 2 * kThreads;
  __shared__ __align__(16) uint8_t sa[kPairs * LMAX + 16];
  __shared__ __align__(16) uint8_t sb[kPairs * LMAX + 16];
  const int64_t base = (int64_t)blockIdx.x * kPairs;
  const int np = (int)min((int64_t)kPairs, n - base);
  const uint8_t* ga = a + base * L;
  const uint8_t* gb = b + base * L;
  stage(ga, (int64_t)np * L, sa);
  stage(gb, (int64_t)np * L, sb);
  __syncthreads();
  const int q = 2 * threadIdx.x;  // pairs q (low lane) and q + 1 (high)
  const int al0 = clamp_len(a_len, base + q, q < np, L);
  const int bl0 = clamp_len(b_len, base + q, q < np, L);
  const int al1 = clamp_len(a_len, base + q + 1, q + 1 < np, L);
  const int bl1 = clamp_len(b_len, base + q + 1, q + 1 < np, L);
  const int imax = max(al0, al1);
  const int jmax = __reduce_max_sync(kFull, max(bl0, bl1));
  const uint8_t* ra = sa + ((uintptr_t)ga & 15) + q * L;
  const uint8_t* rb = sb + ((uintptr_t)gb & 15) + q * L;
  uint32_t bp[LMAX];
#pragma unroll
  for (int j = 0; j < LMAX; ++j) {
    bp[j] = 0;
    if (j < jmax) bp[j] = (uint32_t)rb[j] << 2 | (uint32_t)rb[L + j] << 18;
  }
  const uint32_t w = (uint32_t)w_half;
  const uint32_t wpk = w * kOne;
  uint32_t R0[LMAX + 1], R1[LMAX + 1], R2[LMAX + 1];
#pragma unroll
  for (int j = 0; j <= LMAX; ++j) {
    R0[j] = j == 0 ? 0u : wpk + (uint32_t)(2 * (j - 1)) * kOne;
    R1[j] = 0;
    R2[j] = 0;
  }
  uint32_t r0 = 0, r1 = 0;
  take<LMAX>(R0, 0, al0, bl0, al1, bl1, r0, r1);
  auto chr = [&](int k) {
    return (uint32_t)ra[k] << 2 | (uint32_t)ra[L + k] << 18;
  };
  uint32_t ap = 0, ai;
  if (imax >= 1) {
    ai = chr(0);
    half_row<LMAX, 1>(R1, R0, R2, bp, ai, ap, jmax, w, wpk);
    take<LMAX>(R1, 1, al0, bl0, al1, bl1, r0, r1);
    ap = ai;
  }
  if (imax >= 2) {
    ai = chr(1);
    half_row<LMAX, 2>(R2, R1, R0, bp, ai, ap, jmax, w, wpk);
    take<LMAX>(R2, 2, al0, bl0, al1, bl1, r0, r1);
    ap = ai;
  }
  // rows 3.. in turns, so the three rows rotate without copies
  for (int i = 3; i <= imax; i += 3) {
    ai = chr(i - 1);
    half_row<LMAX, 3>(R0, R2, R1, bp, ai, ap, jmax, w, wpk);
    take<LMAX>(R0, i, al0, bl0, al1, bl1, r0, r1);
    ap = ai;
    if (i + 1 > imax) break;
    ai = chr(i);
    half_row<LMAX, 3>(R1, R0, R2, bp, ai, ap, jmax, w, wpk);
    take<LMAX>(R1, i + 1, al0, bl0, al1, bl1, r0, r1);
    ap = ai;
    if (i + 2 > imax) break;
    ai = chr(i + 1);
    half_row<LMAX, 3>(R2, R1, R0, bp, ai, ap, jmax, w, wpk);
    take<LMAX>(R2, i + 2, al0, bl0, al1, bl1, r0, r1);
    ap = ai;
  }
  if (q < np) out[base + q] = 0.5f * (float)r0;
  if (q + 1 < np) out[base + q + 1] = 0.5f * (float)r1;
}

template <int LMAX>
int launch_f32(const void* a, const void* al, const void* b, const void* bl,
               void* out, int64_t n, int L, float fc, cudaStream_t stream) {
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  ed_f32_kernel<LMAX><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const uint8_t*>(a), static_cast<const int32_t*>(al),
      static_cast<const uint8_t*>(b), static_cast<const int32_t*>(bl),
      static_cast<float*>(out), n, L, fc);
  return (int)cudaGetLastError();
}

template <int LMAX>
int launch_half(const void* a, const void* al, const void* b, const void* bl,
                void* out, int64_t n, int L, int w, cudaStream_t stream) {
  const int64_t blocks = (n + 2 * kThreads - 1) / (2 * kThreads);
  ed_half_kernel<LMAX><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const uint8_t*>(a), static_cast<const int32_t*>(al),
      static_cast<const uint8_t*>(b), static_cast<const int32_t*>(bl),
      static_cast<float*>(out), n, L, w);
  return (int)cudaGetLastError();
}

bool bad_shape(int64_t n, int L) {
  return L < 0 || L > kMaxLen || n < 0 || n > (int64_t)0x7fffffff * kThreads;
}

}  // namespace

extern "C" int repro_edit_distance_max_len() { return kMaxLen; }

// a, b: u8[n, L] row-major; al, bl: i32[n]; out: f32[n]. The f32 route,
// for any first_char_cost fc. Returns a cudaError_t code (0 on a clean
// launch).
extern "C" int repro_edit_distance(const void* a, const void* al,
                                   const void* b, const void* bl, void* out,
                                   int64_t n, int L, float fc, void* stream) {
  if (bad_shape(n, L)) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (L <= 16) return launch_f32<16>(a, al, b, bl, out, n, L, fc, s);
  if (L <= 24) return launch_f32<24>(a, al, b, bl, out, n, L, fc, s);
  return launch_f32<32>(a, al, b, bl, out, n, L, fc, s);
}

// The half-unit route, for first_char_cost = w / 2 with w an integer in
// [0, 1024]: the same arguments, and w in place of fc.
extern "C" int repro_edit_distance_half(const void* a, const void* al,
                                        const void* b, const void* bl,
                                        void* out, int64_t n, int L, int w,
                                        void* stream) {
  if (bad_shape(n, L) || w < 0 || w > kMaxHalfWeight) {
    return (int)cudaErrorInvalidValue;
  }
  if (n == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (L <= 16) return launch_half<16>(a, al, b, bl, out, n, L, w, s);
  if (L <= 24) return launch_half<24>(a, al, b, bl, out, n, L, w, s);
  return launch_half<32>(a, al, b, bl, out, n, L, w, s);
}
