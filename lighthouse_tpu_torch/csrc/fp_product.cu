// The register-resident Fp product of lanes.cuh, measured alone: each
// thread runs one dependent chain x <- x * y (Montgomery) of `len`
// products of lanes::fp_mul. One thread gives the product's latency; every
// SM full of chains gives the card's product rate. Not a kernel of the main
// path: ops/fp_product.py times it for chip_smoke.py and PERF.md.

#include <cuda_runtime.h>

#include "lanes.cuh"

using namespace lanes;

constexpr int THREADS = 128;

__global__ void __launch_bounds__(THREADS)
    fp_chain_kernel(const int32_t* __restrict__ x_in, const int32_t* __restrict__ y_in, int n,
                    int len, int32_t* x_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  u32 x[NW], y[NW];
#pragma unroll
  for (int j = 0; j < NW; j++) {
    x[j] = (u32)x_in[(size_t)j * n + i];
    y[j] = (u32)y_in[(size_t)j * n + i];
  }
  for (int k = 0; k < len; k++) fp_mul(x, x, y);
#pragma unroll
  for (int j = 0; j < NW; j++) x_out[(size_t)j * n + i] = (int32_t)x[j];
}

extern "C" int lh_fp_chain(const void* x, const void* y, int n, int len, void* x_out,
                           void* stream) {
  const int blocks = (n + THREADS - 1) / THREADS;
  const int threads = n < THREADS ? n : THREADS;
  fp_chain_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)x, (const int32_t*)y, n, len, (int32_t*)x_out);
  return (int)cudaGetLastError();
}
