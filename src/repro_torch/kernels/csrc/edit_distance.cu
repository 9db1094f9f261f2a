// Batched weighted optimal-string-alignment distance, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/edit_distance.py:107 edit_distance, the
// Pallas TPU kernel behind the spelling job (core/spelling.spelling_cycle
// through ops.edit_distance).
//
// What bounds it on an H100: operations. Per pair it reads 2L + 8 bytes
// (two u8[L] strings, two i32 lengths) and writes one f32, but it fills
// a_len x b_len DP cells of about 7 f32 adds and mins each; at the spelling
// job's L = 24 that is up to 576 cells against 60 bytes.
//
// Design: one thread per pair. The Pallas kernel runs an anti-diagonal
// wavefront over a 128-pair block because the TPU wants wide vector ops;
// here each thread walks its own table row by row, as the plain version
// (ref.edit_distance_ref) does, and keeps three DP rows (i-2, i-1, i) and
// b's bytes in registers. The j loop is unrolled to the kernel's maximum
// length LMAX (a template constant: 16, 24 or 32), so every row index is a
// compile-time constant and nothing spills to local memory; cells past
// b_len are skipped. The row loop stops at a_len. Each cell is the plain
// version's sequence of f32 adds and mins, in its order (row 0 as
// fc + (j - 1), column 0 built row by row), so the two agree bit for bit.
// The output cell (a_len, b_len) is picked by an unrolled select.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kMaxLen = 32;
constexpr int kThreads = 128;

template <int LMAX>
__global__ void edit_distance_kernel(const uint8_t* __restrict__ a,
                                     const int32_t* __restrict__ a_len,
                                     const uint8_t* __restrict__ b,
                                     const int32_t* __restrict__ b_len,
                                     float* __restrict__ out, int64_t n, int L,
                                     float fc) {
  const int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  const uint8_t* ap = a + p * L;
  const uint8_t* bp = b + p * L;
  const int al = min(max(a_len[p], 0), L);
  const int bl = min(max(b_len[p], 0), L);
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
      if (j <= bl) {
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
  out[p] = r;
}

template <int LMAX>
void launch(const void* a, const void* al, const void* b, const void* bl,
            void* out, int64_t n, int L, float fc, cudaStream_t stream) {
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  edit_distance_kernel<LMAX><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const uint8_t*>(a), static_cast<const int32_t*>(al),
      static_cast<const uint8_t*>(b), static_cast<const int32_t*>(bl),
      static_cast<float*>(out), n, L, fc);
}

}  // namespace

extern "C" int repro_edit_distance_max_len() { return kMaxLen; }

// a, b: u8[n, L] row-major; al, bl: i32[n]; out: f32[n]. Returns a
// cudaError_t code (0 on a clean launch).
extern "C" int repro_edit_distance(const void* a, const void* al,
                                   const void* b, const void* bl, void* out,
                                   int64_t n, int L, float fc, void* stream) {
  if (L < 0 || L > kMaxLen || n < 0 || n > (int64_t)0x7fffffff * kThreads) {
    return (int)cudaErrorInvalidValue;
  }
  if (n == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (L <= 16) {
    launch<16>(a, al, b, bl, out, n, L, fc, s);
  } else if (L <= 24) {
    launch<24>(a, al, b, bl, out, n, L, fc, s);
  } else {
    launch<32>(a, al, b, bl, out, n, L, fc, s);
  }
  return (int)cudaGetLastError();
}
