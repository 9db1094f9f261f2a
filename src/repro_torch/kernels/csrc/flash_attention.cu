// Flash attention forward (causal, sliding window, GQA), for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/flash_attention.py:86 flash_attention, the
// Pallas TPU kernel behind the LM's cache-free forward
// (models/layers.attention through ops.flash_attention).
//
// What bounds it on an H100: operations. Each (query, key) pair in the
// causal/window band costs 2D multiply-adds (q.k and p.v) and one
// exponential, against 2D bytes a row of q, k, v and o read or written once.
// At h2o-danube-1.8b's scoring shape (B 4, 32 query heads over 8 KV heads,
// T 8192, window 4096, D 80) that is 1.03e12 FLOPs (1.04 ms at the 989
// TFLOP/s bf16 tensor-core peak), 3.2e9 exponentials and 419 MB (0.125 ms).
//
// Design, simple and right before fast: CUDA-core f32 FMAs, no tensor
// cores (a later version moves S = QK^T and O = PV to wgmma, rounding P to
// bf16). One block of 256 threads per (q tile of 64 rows, query head,
// batch row); it stages its q tile once in shared memory as f32 and loops
// over 64-key K/V tiles, visiting only the tiles that intersect the
// causal/window band of its rows (the Pallas kernel sweeps every K block).
// Thread (ty, tx) of a 16 x 16 grid owns rows 4ty..4ty+3 and, for scores,
// keys tx + 16j (j < 4), for the output dims tx + 16c (c < DP/16).
// Online softmax keeps each row's running max m and sum l in registers in
// f32 (row reductions are shuffles over the 16 threads of a row group); P
// goes through shared memory to the P.V product, which stays in f32 as in
// the Pallas kernel. Masked scores are -inf and a row whose running max is
// still -inf adds nothing, so the result does not depend on the tile size.
// Ragged Tq/Tk edges are masked in the kernel and head dims up to DP are
// zero-filled in shared memory: no padding copies. Strides are the
// caller's (the last dim contiguous), so the model's [B, T, H, D]
// projections go in as [B, H, T, D] views with no copy.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cmath>
#include <cstdint>

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per K/V tile
constexpr int kThreads = 256;  // 16 x 16 threads
constexpr int kPad = 4;        // row padding (floats) against bank conflicts
constexpr int kMaxD = 128;

struct Strides {
  int64_t b, h, t;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

constexpr size_t smem_bytes(int dp) {
  return sizeof(float) *
         (size_t)(kBQ * (dp + kPad) + kBK * (dp + kPad) + kBK * dp +
                  kBQ * (kBK + kPad));
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads, 2)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o, int rep,
                     int Tq, int Tk, int D, Strides sq, Strides sk, Strides sv,
                     Strides so, int causal, int window, float scale) {
  constexpr int QS = DP + kPad;   // row stride of Qs and Ks
  constexpr int PS = kBK + kPad;  // row stride of Ps
  constexpr int DPT = DP / 16;    // output dims per thread
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // [kBQ][QS]
  float* Ks = Qs + kBQ * QS;                    // [kBK][QS]
  float* Vs = Ks + kBK * QS;                    // [kBK][DP]
  float* Ps = Vs + kBK * DP;                    // [kBQ][PS]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * kBQ;
  const int hq = blockIdx.y, b = blockIdx.z, hk = hq / rep;
  const T* qp = q + b * sq.b + hq * sq.h;
  const T* kp = k + b * sk.b + hk * sk.h;
  const T* vp = v + b * sv.b + hk * sv.h;
  T* op = o + b * so.b + hq * so.h;
  const int off = Tk - Tq;  // end alignment: qpos = row + off

  for (int i = tid; i < kBQ * DP; i += kThreads) {
    const int r = i / DP, d = i % DP;
    float x = 0.0f;
    if (q0 + r < Tq && d < D) x = to_f32(qp[(int64_t)(q0 + r) * sq.t + d]);
    Qs[r * QS + d] = x;
  }

  // Keys that any row of this tile may see.
  const int qpos_lo = q0 + off;
  const int qpos_hi = min(q0 + kBQ, Tq) - 1 + off;
  const int k_lo = window > 0 ? max(0, qpos_lo - window + 1) : 0;
  const int k_hi = causal ? min(Tk, qpos_hi + 1) : Tk;

  float m[4], l[4], acc[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < DPT; ++c) acc[i][c] = 0.0f;
  }

  for (int kt = (k_lo / kBK) * kBK; kt < k_hi; kt += kBK) {
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < kBK * DP; i += kThreads) {
      const int r = i / DP, d = i % DP, kk = kt + r;
      float kx = 0.0f, vx = 0.0f;
      if (kk < Tk && d < D) {
        kx = to_f32(kp[(int64_t)kk * sk.t + d]);
        vx = to_f32(vp[(int64_t)kk * sv.t + d]);
      }
      Ks[r * QS + d] = kx;
      Vs[r * DP + d] = vx;
    }
    __syncthreads();

    // S = Q K^T for rows 4ty+i, keys tx+16j.
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < DP; d += 4) {
      float4 qa[4], kb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qa[i] = *reinterpret_cast<const float4*>(&Qs[(ty * 4 + i) * QS + d]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kb[j] = *reinterpret_cast<const float4*>(&Ks[(tx + 16 * j) * QS + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = __fmaf_rn(qa[i].x, kb[j].x, s[i][j]);
          s[i][j] = __fmaf_rn(qa[i].y, kb[j].y, s[i][j]);
          s[i][j] = __fmaf_rn(qa[i].z, kb[j].z, s[i][j]);
          s[i][j] = __fmaf_rn(qa[i].w, kb[j].w, s[i][j]);
        }
    }

    // Mask, online softmax, P to shared memory.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i + off;
      float mt = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = kt + tx + 16 * j;
        bool ok = kpos < Tk;
        if (causal) ok = ok && kpos <= qpos;
        if (window > 0) ok = ok && kpos > qpos - window;
        s[i][j] = ok ? s[i][j] * scale : -INFINITY;
        mt = fmaxf(mt, s[i][j]);
      }
#pragma unroll
      for (int w = 8; w > 0; w >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, w));
      const float mn = fmaxf(m[i], mt);
      float corr = 1.0f, ps = 0.0f, p[4];
      if (mn == -INFINITY) {
#pragma unroll
        for (int j = 0; j < 4; ++j) p[j] = 0.0f;
      } else {
        corr = expf(m[i] - mn);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          p[j] = expf(s[i][j] - mn);
          ps += p[j];
        }
      }
#pragma unroll
      for (int w = 8; w > 0; w >>= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, w);
      l[i] = l[i] * corr + ps;
      m[i] = mn;
#pragma unroll
      for (int c = 0; c < DPT; ++c) acc[i][c] *= corr;
#pragma unroll
      for (int j = 0; j < 4; ++j) Ps[(ty * 4 + i) * PS + tx + 16 * j] = p[j];
    }
    __syncthreads();

    // O += P V for rows 4ty+i, dims tx+16c.
#pragma unroll 2
    for (int kk = 0; kk < kBK; kk += 4) {
      float4 pa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pa[i] = *reinterpret_cast<const float4*>(&Ps[(ty * 4 + i) * PS + kk]);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float vv[DPT];
#pragma unroll
        for (int c = 0; c < DPT; ++c) vv[c] = Vs[(kk + u) * DP + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float pi = u == 0 ? pa[i].x
                         : u == 1 ? pa[i].y
                         : u == 2 ? pa[i].z
                                  : pa[i].w;
#pragma unroll
          for (int c = 0; c < DPT; ++c) acc[i][c] = __fmaf_rn(pi, vv[c], acc[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= Tq) continue;
#pragma unroll
    for (int c = 0; c < DPT; ++c) {
      const int d = tx + 16 * c;
      if (d < D) {
        const float x = l[i] > 0.0f ? acc[i][c] / l[i] : 0.0f;
        store(&op[(int64_t)r * so.t + d], x);
      }
    }
  }
}

template <typename T, int DP>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Hq, int rep, int Tq, int Tk, int D, Strides sq, Strides sk,
           Strides sv, Strides so, int causal, int window, float scale,
           cudaStream_t stream) {
  constexpr size_t smem = smem_bytes(DP);
  auto kernel = flash_fwd_kernel<T, DP>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)((Tq + kBQ - 1) / kBQ), (unsigned)Hq,
                  (unsigned)B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), rep, Tq, Tk, D, sq, sk,
      sv, so, causal, window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int B,
             int Hq, int rep, int Tq, int Tk, int D, Strides sq, Strides sk,
             Strides sv, Strides so, int causal, int window, float scale,
             cudaStream_t s) {
#define REPRO_FA_CASE(n)                                                    \
  case n:                                                                   \
    return launch<T, 16 * n>(q, k, v, o, B, Hq, rep, Tq, Tk, D, sq, sk, sv, \
                             so, causal, window, scale, s);
  switch ((D + 15) / 16) {
    REPRO_FA_CASE(1)
    REPRO_FA_CASE(2)
    REPRO_FA_CASE(3)
    REPRO_FA_CASE(4)
    REPRO_FA_CASE(5)
    REPRO_FA_CASE(6)
    REPRO_FA_CASE(7)
    REPRO_FA_CASE(8)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef REPRO_FA_CASE
}

}  // namespace

extern "C" int repro_flash_attention_max_d() { return kMaxD; }

// q, o: [B, Hq, Tq, D]; k, v: [B, Hkv, Tk, D], each with the given b/h/t
// strides (elements) and a contiguous last dim. dtype 0 = f32, 1 = bf16.
// Returns a cudaError_t code (0 on a clean launch).
extern "C" int repro_flash_attention(
    const void* q, const void* k, const void* v, void* o, int dtype, int B,
    int Hq, int Hkv, int Tq, int Tk, int D, int64_t sqb, int64_t sqh,
    int64_t sqt, int64_t skb, int64_t skh, int64_t skt, int64_t svb,
    int64_t svh, int64_t svt, int64_t sob, int64_t soh, int64_t sot,
    int causal, int window, float scale, void* stream) {
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Hq > 65535 ||
      B > 65535 || Tq <= 0 || Tk <= 0 || D <= 0 || D > kMaxD || D % 8 != 0 ||
      (causal && Tq > Tk)) {
    return (int)cudaErrorInvalidValue;
  }
  const Strides sq{sqb, sqh, sqt}, sk{skb, skh, skt}, sv{svb, svh, svt},
      so{sob, soh, sot};
  const int rep = Hq / Hkv;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return dispatch<float>(q, k, v, o, B, Hq, rep, Tq, Tk, D, sq, sk, sv, so,
                           causal, window, scale, s);
  }
  if (dtype == 1) {
    return dispatch<__nv_bfloat16>(q, k, v, o, B, Hq, rep, Tq, Tk, D, sq, sk,
                                   sv, so, causal, window, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}
