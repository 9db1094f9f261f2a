// The row route's top-k: one thread keeps one row's K best (value, column)
// in a descending register list, shared by the bucket_topk and region_rank
// kernels.
//
// The thread starts the list at (-inf, sentinel) and offers the row's
// values in ascending column order. A value is taken only when it is
// strictly greater than the list's last entry, and a compare-and-shift puts
// it behind the entries equal to it, so ties keep the lowest column, exactly
// like lax.top_k and the Pallas kernels' min-iota argmax; -inf is never
// taken, and rounds past a row's finite values give -inf with the sentinel
// column. A row that holds a NaN gives NaN with the sentinel column in every
// round, as the Pallas kernels do (their row max is NaN, which no element
// equals, so no round retires anything): insert never takes a NaN, and the
// caller, which spots the row's NaNs, overwrites the list with fill_nan.
// KMAX (8, 16 or 32) is a template constant, so every index is a
// compile-time constant and the list stays in registers.
#pragma once

#include <cstdint>
#include <math.h>

namespace repro {

template <int KMAX>
__device__ __forceinline__ void init_topk(float (&v)[KMAX], int (&c)[KMAX],
                                          int sentinel) {
#pragma unroll
  for (int i = 0; i < KMAX; ++i) {
    v[i] = -INFINITY;
    c[i] = sentinel;
  }
}

// Insert (x, col) into the descending list (v, c) behind the entries equal
// to x, if x is greater than the last entry. Going from the end, entry i
// takes entry i-1 where x beats that too, else x where x beats entry i.
// A NaN is never greater, so it is never inserted (see fill_nan).
template <int KMAX>
__device__ __forceinline__ void insert(float (&v)[KMAX], int (&c)[KMAX],
                                       float x, int col) {
  if (!(x > v[KMAX - 1])) return;
#pragma unroll
  for (int i = KMAX - 1; i > 0; --i) {
    const bool up = x > v[i - 1];
    const bool here = x > v[i];
    v[i] = up ? v[i - 1] : (here ? x : v[i]);
    c[i] = up ? c[i - 1] : (here ? col : c[i]);
  }
  if (x > v[0]) {
    v[0] = x;
    c[0] = col;
  }
}

// Whether a or b is NaN, in one compare (PTX setp.nan).
__device__ __forceinline__ bool either_nan(float a, float b) {
  int r;
  asm("{\n\t.reg .pred p;\n\tsetp.nan.f32 p, %1, %2;\n\t"
      "selp.s32 %0, 1, 0, p;\n\t}"
      : "=r"(r)
      : "f"(a), "f"(b));
  return r != 0;
}

// A row that holds a NaN: every entry becomes NaN with the sentinel column
// (the rare path; a row without NaN never takes it).
template <int KMAX>
__device__ __forceinline__ void fill_nan(float (&v)[KMAX], int (&c)[KMAX],
                                         int sentinel) {
#pragma unroll
  for (int i = 0; i < KMAX; ++i) {
    v[i] = __int_as_float(0x7fc00000);
    c[i] = sentinel;
  }
}

// Writes the list's first K entries to vo/ao: as 16-byte stores where `vec`
// (K % 4 == 0 and both bases 16-byte aligned), else one by one.
template <int KMAX>
__device__ __forceinline__ void write_topk(const float (&v)[KMAX],
                                           const int (&c)[KMAX], int K,
                                           bool vec, float* __restrict__ vo,
                                           int32_t* __restrict__ ao) {
  if (vec) {
#pragma unroll
    for (int q = 0; q < KMAX / 4; ++q) {
      if (4 * q < K) {
        reinterpret_cast<float4*>(vo)[q] =
            make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
        reinterpret_cast<int4*>(ao)[q] =
            make_int4(c[4 * q], c[4 * q + 1], c[4 * q + 2], c[4 * q + 3]);
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < KMAX; ++i) {
      if (i < K) {
        vo[i] = v[i];
        ao[i] = c[i];
      }
    }
  }
}

}  // namespace repro
