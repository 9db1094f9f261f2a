// Issue rate of Hopper's 16x2 DPX instructions against plain integer ones:
// every thread runs 8 independent chains of one instruction, with all
// blocks resident at once, and times itself with clock64(). Built and run
// by scripts/dpx_rate.py.
#include <cuda_runtime.h>
#include <cstdint>

template <int OP>
__global__ void rate_kernel(uint32_t* out, long long* cycles, int iters,
                            uint32_t seed) {
  uint32_t a[8], c[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    a[k] = seed * (threadIdx.x + 3 * k + 1);
    c[k] = seed ^ (blockIdx.x * 7 + k);
  }
  uint32_t b = seed + threadIdx.x;
  __syncthreads();
  const long long t0 = clock64();
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      if (OP == 0) a[k] = __viaddmin_s16x2(a[k], b, c[k]);  // VIADDMNMX
      if (OP == 1) a[k] = __vimin3_s16x2(a[k], b, c[k]);    // VIMNMX3
      if (OP == 2) a[k] = __vminu2(a[k], b + k);            // VIMNMX
      if (OP == 3) a[k] = a[k] + b + c[k];                  // IADD3
      if (OP == 4) a[k] = (a[k] ^ b) | c[k];                // LOP3
    }
    b += 0x00010001u;
  }
  const long long t1 = clock64();
  uint32_t r = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) r ^= a[k];
  out[blockIdx.x * blockDim.x + threadIdx.x] = r;
  if (threadIdx.x == 0) cycles[blockIdx.x] = t1 - t0;
}

extern "C" int dpx_rate(int op, void* out, void* cycles, int blocks,
                        int threads, int iters, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint32_t* o = static_cast<uint32_t*>(out);
  long long* c = static_cast<long long*>(cycles);
  void (*kernel)(uint32_t*, long long*, int, uint32_t) = nullptr;
  switch (op) {
    case 0: kernel = rate_kernel<0>; break;
    case 1: kernel = rate_kernel<1>; break;
    case 2: kernel = rate_kernel<2>; break;
    case 3: kernel = rate_kernel<3>; break;
    case 4: kernel = rate_kernel<4>; break;
    default: return (int)cudaErrorInvalidValue;
  }
  kernel<<<blocks, threads, 0, s>>>(o, c, iters, 12345u);
  return (int)cudaGetLastError();
}
