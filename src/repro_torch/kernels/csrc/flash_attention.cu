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
// Two routes, fixed by the input type (never a fallback of one another):
//
// bf16: tensor cores. One block of 384 threads per (q tile of 128 rows,
// query head, batch row), q tiles with the most keys launched first. Warps
// 0-3 are the producer warpgroup: one thread loads the q tile once and then
// the K/V tiles of 128 keys of the block's causal/window band, by TMA, into
// a ring of two shared-memory stages, each with a full and an empty
// mbarrier; the producer gives its registers to the consumers (setmaxnreg).
// Warpgroups 1 and 2 are consumers, 64 q rows each: S = Q K^T by wgmma
// (bf16 in, f32 accumulators, Q and K read from shared memory), the online
// softmax in f32 registers (scale and log2(e) folded into one multiply,
// exp2; row max over the quad of threads that share a row; the row sum l
// from the f32 p), then P rounded once to bf16 and O += P V by wgmma with P
// as the register operand and V read transposed from shared memory. Tiles
// fully inside the band run unmasked; edge tiles mask to -inf, and a row
// whose running max is still -inf adds nothing, so the result does not
// depend on the tile size. O leaves through shared memory by TMA store.
// Shared-memory layout: head dims are cut into atoms of 16 bf16 (32 bytes),
// each atom a [rows x 32 B] block in the 32-byte swizzle that TMA writes
// and wgmma reads, so D 80 needs no padding to 64-element rows; head dims
// that are not a multiple of 16 are zero-filled by TMA. The tensor maps
// (d, t, h, b) take the caller's strides, so the model's [B, T, H, D]
// projections go in as [B, H, T, D] views with no copy; ragged T is TMA's
// zero fill on loads, its clipping on stores and the kernel's masks.
//
// f32: CUDA cores (wgmma on f32 would be TF32, too coarse for f32 callers).
// One block of 256 threads per (q tile of 64 rows, query head, batch row)
// stages its q tile in shared memory and loops over the 64-key K/V tiles of
// its band; thread (ty, tx) of a 16 x 16 grid owns rows 4ty..4ty+3 and, for
// scores, keys tx + 16j (j < 4), for the output dims tx + 16c (c < DP/16).
// Online softmax in f32, P through shared memory, P.V in f32 FMAs, the
// same -inf masking. Ragged Tq/Tk edges are masked in the kernel and head
// dims up to DP are zero-filled in shared memory.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cmath>
#include <cstdint>

namespace {

constexpr int kMaxD = 128;

struct Strides {
  int64_t b, h, t;
};

// Calls LAUNCH<DP>(args...) for the head dim D padded to DP, a multiple of
// 16 up to kMaxD.
#define REPRO_FA_DISPATCH(D, LAUNCH, ...)      \
  switch (((D) + 15) / 16) {                   \
    case 1: return LAUNCH<16>(__VA_ARGS__);    \
    case 2: return LAUNCH<32>(__VA_ARGS__);    \
    case 3: return LAUNCH<48>(__VA_ARGS__);    \
    case 4: return LAUNCH<64>(__VA_ARGS__);    \
    case 5: return LAUNCH<80>(__VA_ARGS__);    \
    case 6: return LAUNCH<96>(__VA_ARGS__);    \
    case 7: return LAUNCH<112>(__VA_ARGS__);   \
    case 8: return LAUNCH<128>(__VA_ARGS__);   \
    default: return (int)cudaErrorInvalidValue; \
  }

// ---------------------------------------------------------------------------
// f32: CUDA cores.
// ---------------------------------------------------------------------------
namespace cudacore {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per K/V tile
constexpr int kThreads = 256;  // 16 x 16 threads
constexpr int kPad = 4;        // row padding (floats) against bank conflicts
constexpr size_t smem_bytes(int dp) {
  return sizeof(float) *
         (size_t)(kBQ * (dp + kPad) + kBK * (dp + kPad) + kBK * dp +
                  kBQ * (kBK + kPad));
}

template <int DP>
__global__ void __launch_bounds__(kThreads, 2)
    flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o, int rep,
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
  const float* qp = q + b * sq.b + hq * sq.h;
  const float* kp = k + b * sk.b + hk * sk.h;
  const float* vp = v + b * sv.b + hk * sv.h;
  float* op = o + b * so.b + hq * so.h;
  const int off = Tk - Tq;  // end alignment: qpos = row + off

  for (int i = tid; i < kBQ * DP; i += kThreads) {
    const int r = i / DP, d = i % DP;
    float x = 0.0f;
    if (q0 + r < Tq && d < D) x = qp[(int64_t)(q0 + r) * sq.t + d];
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
        kx = kp[(int64_t)kk * sk.t + d];
        vx = vp[(int64_t)kk * sv.t + d];
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
        op[(int64_t)r * so.t + d] = l[i] > 0.0f ? acc[i][c] / l[i] : 0.0f;
      }
    }
  }
}

template <int DP>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Hq, int rep, int Tq, int Tk, int D, Strides sq, Strides sk,
           Strides sv, Strides so, int causal, int window, float scale,
           cudaStream_t stream) {
  constexpr size_t smem = smem_bytes(DP);
  auto kernel = flash_fwd_kernel<DP>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)((Tq + kBQ - 1) / kBQ), (unsigned)Hq,
                  (unsigned)B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), rep, Tq, Tk, D, sq, sk,
      sv, so, causal, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace cudacore

// ---------------------------------------------------------------------------
// bf16: tensor cores (wgmma), TMA ring, warp-specialised.
// ---------------------------------------------------------------------------
namespace tc {

constexpr int kBQ = 128;         // q rows per block: two consumers of 64
constexpr int kBK = 128;         // keys per K/V stage
constexpr int kStages = 2;       // K/V ring depth
constexpr int kThreads = 384;    // producer warpgroup + two consumers
constexpr int kAtom = 16;        // bf16 per 32-byte swizzled row
constexpr int kRowBytes = 32;
constexpr int kEmptyArrivals = 8;   // lane 0 of each consumer warp
constexpr int kProducerRegs = 24, kConsumerRegs = 240;
// A wait that never completes is a fault: trap (the launch fails) instead
// of spinning forever. Far above any real wait.
constexpr uint32_t kSpinLimit = 1u << 26;

// Shared memory of one block: the q tile, then kStages x (K, V), each as
// DP / 16 atoms of [rows x 32 B]; then the mbarriers; 1 KB of slack for
// aligning the start to the swizzle's 1 KB.
__host__ __device__ constexpr int q_bytes(int dp) {
  return dp / kAtom * kBQ * kRowBytes;
}
__host__ __device__ constexpr int kv_bytes(int dp) {
  return dp / kAtom * kBK * kRowBytes;
}
constexpr int smem_bytes(int dp) {
  return 1024 + q_bytes(dp) + kStages * 2 * kv_bytes(dp) +
         8 * (1 + 2 * kStages);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Waits until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t n = 0;; ++n) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (n == kSpinLimit) __trap();
  }
}

// One box of [rows x 16] bf16 at (d, t, h, b) into shared memory, counted
// on `bar` as its full box size (out-of-bounds elements are zero-filled).
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int d, int t, int h,
                                         int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(d), "r"(t), "r"(h),
      "r"(b)
      : "memory");
}

// The reverse: out-of-bounds elements of the box are not written.
__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          uint32_t src, int d, int t, int h,
                                          int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(d), "r"(t), "r"(h), "r"(b)
      : "memory");
}

// wgmma shared-memory descriptor, 32-byte swizzle. Byte offsets: `lbo`
// between atoms along M/N (MN-major operands; unused K-major), `sbo`
// between groups of 8 rows.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(lbo >> 4) << 16 |
         static_cast<uint64_t>(sbo >> 4) << 32 | 3ull << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Orders the reads of wgmma results after wgmma_wait().
template <int N>
__device__ __forceinline__ void fence_regs(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// S[64] (+)= Q (smem, K-major) x K^T (smem, K-major): m64n128k16.
__device__ __forceinline__ void wgmma_qk(float* d, uint64_t a, uint64_t b,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

// O[N/2] += P (registers, bf16) x V (smem, MN-major): m64nNk16.
template <int N>
__device__ __forceinline__ void wgmma_pv(float* d, const uint32_t* a, uint64_t b);

template <>
__device__ __forceinline__ void wgmma_pv<16>(float* d, const uint32_t* a,
                                                uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_pv<32>(float* d, const uint32_t* a,
                                                uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_pv<48>(float* d, const uint32_t* a,
                                                uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23}, "
      "{%24, %25, %26, %27}, %28, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_pv<64>(float* d, const uint32_t* a,
                                                uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_pv<80>(float* d, const uint32_t* a,
                                                uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39}, "
      "{%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_pv<96>(float* d, const uint32_t* a,
                                                uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
      "{%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_pv<112>(float* d, const uint32_t* a,
                                                uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %61, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55}, "
      "{%56, %57, %58, %59}, %60, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_pv<128>(float* d, const uint32_t* a,
                                                uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(1));
}

template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_tc(const __grid_constant__ CUtensorMap qmap,
                 const __grid_constant__ CUtensorMap kmap,
                 const __grid_constant__ CUtensorMap vmap,
                 const __grid_constant__ CUtensorMap omap, int rep, int Tq,
                 int Tk, int causal, int window, float scale) {
  constexpr int NA = DP / kAtom;  // 32-byte atoms along the head dim
  constexpr int QB = q_bytes(DP), KB = kv_bytes(DP);
  constexpr int QA = kBQ * kRowBytes, KA = kBK * kRowBytes;  // per atom
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sq = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t skv = sq + QB;  // stage s: K at skv + 2 s KB, V after it
  const uint32_t q_full = skv + kStages * 2 * KB;
  const uint32_t full = q_full + 8, empty = full + 8 * kStages;
  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kEmptyArrivals);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // The keys any row of this tile may see, in kBK tiles from kt0.
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;  // most keys first
  const int hq = blockIdx.y, b = blockIdx.z, hk = hq / rep;
  const int off = Tk - Tq;  // end alignment: qpos = row + off
  const int qpos_lo = q0 + off;
  const int qpos_hi = min(q0 + kBQ, Tq) - 1 + off;
  const int k_lo = window > 0 ? max(0, qpos_lo - window + 1) : 0;
  const int k_hi = causal ? min(Tk, qpos_hi + 1) : Tk;
  const int kt0 = (k_lo / kBK) * kBK;
  const int n_tiles = (k_hi - kt0 + kBK - 1) / kBK;

  if (tid < 128) {
    // ---- producer warpgroup: one thread issues every load ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (tid == 0) {
      mbar_expect_tx(q_full, QB);
      for (int a = 0; a < NA; ++a)
        tma_load(sq + a * QA, &qmap, q_full, a * kAtom, q0, hq, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kStages;
        const uint32_t round = it / kStages;
        mbar_wait(empty + 8 * s, (round & 1) ^ 1);
        const uint32_t sk = skv + s * 2 * KB, sv = sk + KB;
        const int kt = kt0 + it * kBK;
        mbar_expect_tx(full + 8 * s, 2 * KB);
        for (int a = 0; a < NA; ++a) {
          tma_load(sk + a * KA, &kmap, full + 8 * s, a * kAtom, kt, hk, b);
          tma_load(sv + a * KA, &vmap, full + 8 * s, a * kAtom, kt, hk, b);
        }
      }
    }
  } else {
    // ---- consumer warpgroups: 64 q rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int c = tid / 128 - 1;
    const int lane = tid & 31, warp = (tid / 32) & 3;
    const int g = lane / 4, t = lane % 4;
    const int r_lo = q0 + 64 * c;              // this consumer's rows
    const int r_hi = min(r_lo + 64, Tq) - 1;
    const bool live = r_lo < Tq;
    const int row = r_lo + 16 * warp + g;      // this thread's: row, row + 8
    const uint32_t sq_c = sq + 64 * c * kRowBytes;
    const float sl2 = scale * 1.44269504088896340736f;  // log2(e)
    float o[DP / 2];
#pragma unroll
    for (int x = 0; x < DP / 2; ++x) o[x] = 0.0f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
    mbar_wait(q_full, 0);

    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % kStages;
      const uint32_t round = it / kStages;
      const int kt = kt0 + it * kBK;
      mbar_wait(full + 8 * s, round & 1);
      const bool outside =
          !live || (causal && kt > r_hi + off) ||
          (window > 0 && kt + kBK - 1 <= r_lo + off - window);
      if (!outside) {
        const uint32_t sk = skv + s * 2 * KB, sv = sk + KB;
        // S = Q K^T: accumulator x = 4j + 2i + e is row `row + 8i`, key
        // kt + 8j + 2t + e.
        float sc[kBK / 2];
        wgmma_fence();
#pragma unroll
        for (int a = 0; a < NA; ++a)
          wgmma_qk(sc, smem_desc(sq_c + a * QA, 16, 256),
                   smem_desc(sk + a * KA, 16, 256), a > 0);
        wgmma_commit();
        wgmma_wait();
        fence_regs<kBK / 2>(sc);

        const bool edge = kt + kBK > Tk ||
                          (causal && kt + kBK - 1 > r_lo + off) ||
                          (window > 0 && kt <= r_hi + off - window);
        if (edge) {
#pragma unroll
          for (int x = 0; x < kBK / 2; ++x) {
            const int kpos = kt + 8 * (x / 4) + 2 * t + (x % 2);
            const int qpos = row + 8 * ((x / 2) % 2) + off;
            bool ok = kpos < Tk;
            if (causal) ok = ok && kpos <= qpos;
            if (window > 0) ok = ok && kpos > qpos - window;
            sc[x] = ok ? sc[x] * sl2 : -INFINITY;
          }
        } else {
#pragma unroll
          for (int x = 0; x < kBK / 2; ++x) sc[x] *= sl2;
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float mt = -INFINITY;
#pragma unroll
          for (int j = 0; j < kBK / 8; ++j)
            mt = fmaxf(mt, fmaxf(sc[4 * j + 2 * i], sc[4 * j + 2 * i + 1]));
          mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
          mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
          const float mn = fmaxf(m[i], mt);
          float corr = 1.0f, ps = 0.0f;
          if (mn == -INFINITY) {
#pragma unroll
            for (int j = 0; j < kBK / 8; ++j)
              sc[4 * j + 2 * i] = sc[4 * j + 2 * i + 1] = 0.0f;
          } else {
            corr = ex2(m[i] - mn);
#pragma unroll
            for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const float pe = ex2(sc[4 * j + 2 * i + e] - mn);
                sc[4 * j + 2 * i + e] = pe;
                ps += pe;
              }
            }
          }
          l[i] = l[i] * corr + ps;  // this thread's share of the row
          m[i] = mn;
#pragma unroll
          for (int j = 0; j < DP / 8; ++j) {
            o[4 * j + 2 * i] *= corr;
            o[4 * j + 2 * i + 1] *= corr;
          }
        }
        // P to bf16 in the A-operand layout: keys 16kk.. are sc[8kk..8kk+7].
        uint32_t p[kBK / 4];
#pragma unroll
        for (int x = 0; x < kBK / 4; ++x)
          p[x] = pack_bf16(sc[2 * x], sc[2 * x + 1]);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk)
          wgmma_pv<DP>(o, p + 4 * kk,
                       smem_desc(sv + kk * 16 * kRowBytes, KA, 256));
        wgmma_commit();
        wgmma_wait();
        fence_regs<DP / 2>(o);
      }
      if (lane == 0) mbar_arrive(empty + 8 * s);
    }

    if (live) {
      // O / l to bf16 into this consumer's q rows (swizzled as TMA reads
      // them), then one thread stores the tile.
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
        l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
      }
      const int r = 16 * warp + g;
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float x0 = l[i] > 0.0f ? o[4 * j + 2 * i] / l[i] : 0.0f;
          const float x1 = l[i] > 0.0f ? o[4 * j + 2 * i + 1] / l[i] : 0.0f;
          const uint32_t chunk = (j & 1) ^ ((g >> 2) & 1);
          const uint32_t addr = sq_c + (j / 2) * QA + (r + 8 * i) * kRowBytes +
                                chunk * 16 + 4 * t;
          asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr),
                       "r"(pack_bf16(x0, x1))
                       : "memory");
        }
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + c) : "memory");
      if (tid % 128 == 0) {
        for (int a = 0; a < NA; ++a)
          tma_store(&omap, sq_c + a * QA, a * kAtom, r_lo, hq, b);
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
        asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      }
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled (libcuda), reached through the runtime so that
// the library needs no -lcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A bf16 [B, H, T, D] tensor with element strides `st` as a 4-D map over
// (d, t, h, b) with boxes of [rows x 16] in the 32-byte swizzle. The stride
// of a dimension of size 1 is never used; TMA still needs a multiple of 16
// bytes there, so it is replaced by one.
bool make_map(CUtensorMap* map, const void* ptr, int B, int H, int T, int D,
              Strides st, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  auto bytes = [](int64_t s, int n) -> cuuint64_t {
    const int64_t x = 2 * s;
    return n > 1 ? (cuuint64_t)x : (cuuint64_t)((x + 31) / 16 * 16);
  };
  const cuuint64_t dim[4] = {(cuuint64_t)D, (cuuint64_t)T, (cuuint64_t)H,
                             (cuuint64_t)B};
  const cuuint64_t stride[3] = {bytes(st.t, T), bytes(st.h, H),
                                bytes(st.b, B)};
  const cuuint32_t box[4] = {(cuuint32_t)kAtom, (cuuint32_t)rows, 1, 1};
  const cuuint32_t one[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dim, stride, box, one,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_32B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DP>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Hq, int Hkv, int Tq, int Tk, int D, Strides sq, Strides sk,
           Strides sv, Strides so, int causal, int window, float scale,
           cudaStream_t stream) {
  CUtensorMap qm, km, vm, om;
  if (!make_map(&qm, q, B, Hq, Tq, D, sq, kBQ) ||
      !make_map(&km, k, B, Hkv, Tk, D, sk, kBK) ||
      !make_map(&vm, v, B, Hkv, Tk, D, sv, kBK) ||
      !make_map(&om, o, B, Hq, Tq, D, so, 64)) {
    return (int)cudaErrorInvalidValue;
  }
  constexpr int smem = smem_bytes(DP);
  auto kernel = flash_fwd_tc<DP>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)((Tq + kBQ - 1) / kBQ), (unsigned)Hq,
                  (unsigned)B);
  kernel<<<grid, kThreads, smem, stream>>>(qm, km, vm, om, Hq / Hkv, Tq, Tk,
                                           causal, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace tc

}  // namespace

extern "C" int repro_flash_attention_max_d() { return kMaxD; }

// q, o: [B, Hq, Tq, D]; k, v: [B, Hkv, Tk, D], each with the given b/h/t
// strides (elements) and a contiguous last dim. dtype 0 = f32 (CUDA
// cores), 1 = bf16 (tensor cores: base addresses and the strides of
// dimensions longer than 1 must be multiples of 16 bytes, for TMA).
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    REPRO_FA_DISPATCH(D, cudacore::launch, q, k, v, o, B, Hq, Hq / Hkv, Tq,
                      Tk, D, sq, sk, sv, so, causal, window, scale, s)
  }
  if (dtype == 1) {
    REPRO_FA_DISPATCH(D, tc::launch, q, k, v, o, B, Hq, Hkv, Tq, Tk, D, sq,
                      sk, sv, so, causal, window, scale, s)
  }
  return (int)cudaErrorInvalidValue;
}
