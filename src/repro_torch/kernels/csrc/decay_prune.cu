// Fused decay + prune sweep over a hash store's lanes, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/decay_prune.py:decay_prune_multi, the Pallas
// TPU kernel behind the engine's decay cycle (core/decay.sweep_decay_prune).
//
// What bounds it on an H100: bytes. Each slot reads its two key words, its
// weight and its aux lanes once and writes each of them once; there are two
// flops per slot (the decay multiply and the threshold compare). At the hash cooc store's 9 lanes
// (2 keys + weight + count, last_tick, src_hi, src_lo, dst_hi, dst_lo) that
// is 72 B per slot against 3.35 TB/s of HBM.
//
// Design: one thread per slot over a grid-stride loop, so neighbouring
// threads touch neighbouring 4-byte words and every lane streams fully
// coalesced. Aux lanes are cleared as raw 32-bit words (the clear is
// type-agnostic, so f32, i32 and u32 lanes share one path); their pointers
// ride in a by-value struct, so any number of aux lanes up to the limit
// below costs one launch. Every store has one weight lane, so it is passed
// directly. The outputs are written out of place, mirroring the JAX
// kernel's functional semantics. The Pallas kernel's per-block live/total
// partials are gone: the wrapper reduces the output lanes instead, which
// keeps the two scalars identical to the plain sweep's.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kMaxAux = 8;

struct AuxLanes {
  const uint32_t* in[kMaxAux];
  uint32_t* out[kMaxAux];
};

__global__ void decay_prune_multi_kernel(const uint32_t* __restrict__ key_hi,
                                         const uint32_t* __restrict__ key_lo,
                                         const float* __restrict__ w_in,
                                         uint32_t* __restrict__ out_hi,
                                         uint32_t* __restrict__ out_lo,
                                         float* __restrict__ w_out,
                                         AuxLanes aux, int n_aux, float f,
                                         float threshold, int64_t n) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const uint32_t hi = key_hi[i];
    const uint32_t lo = key_lo[i];
    const float w = w_in[i] * f;
    const bool keep = ((hi | lo) != 0u) && (w >= threshold);
    out_hi[i] = keep ? hi : 0u;
    out_lo[i] = keep ? lo : 0u;
    w_out[i] = keep ? w : 0.0f;
#pragma unroll
    for (int j = 0; j < kMaxAux; ++j) {
      if (j < n_aux) aux.out[j][i] = keep ? aux.in[j][i] : 0u;
    }
  }
}

}  // namespace

// a_ptrs holds n_aux input pointers then n_aux output pointers. Returns a
// cudaError_t code (0 on a clean launch).
extern "C" int repro_decay_prune_multi(const void* key_hi, const void* key_lo,
                                       const void* w_in, void* out_hi,
                                       void* out_lo, void* w_out,
                                       const uint64_t* a_ptrs, int n_aux,
                                       float f, float threshold, int64_t n,
                                       void* stream) {
  if (n_aux < 0 || n_aux > kMaxAux || n < 0) {
    return (int)cudaErrorInvalidValue;
  }
  AuxLanes aux = {};
  for (int j = 0; j < n_aux; ++j) {
    aux.in[j] = reinterpret_cast<const uint32_t*>(a_ptrs[j]);
    aux.out[j] = reinterpret_cast<uint32_t*>(a_ptrs[n_aux + j]);
  }
  if (n == 0) return (int)cudaSuccess;
  const int threads = 256;
  int64_t blocks = (n + threads - 1) / threads;
  if (blocks > (int64_t)1 << 20) blocks = (int64_t)1 << 20;
  decay_prune_multi_kernel<<<(unsigned)blocks, threads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(key_hi), static_cast<const uint32_t*>(key_lo),
      static_cast<const float*>(w_in), static_cast<uint32_t*>(out_hi),
      static_cast<uint32_t*>(out_lo), static_cast<float*>(w_out), aux, n_aux,
      f, threshold, n);
  return (int)cudaGetLastError();
}
