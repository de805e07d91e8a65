// K1 -- the windowed RLC scalar ladder, [k_i] P_i per lane, for G1 and G2.
//
// Replaces the TPU kernel lighthouse_tpu/ops/pallas_ladder.py
// `_ladder_kernel_w4` (reached through `ladder_pallas`, kind "window"):
// the signed-digit window ladder, c = 4, MSB first -- per window four
// complete doublings and one complete addition of +-table[|d|], with the
// table [0..8] P built in the kernel.
//
// What bounds it on the H100: integer multiply-adds. A 64-bit scalar
// costs 17 windows x (4 doublings + 1 addition) plus the 8-entry table,
// ~828 Fp products per G1 lane and ~2,484 per G2 lane (Karatsuba Fp2),
// each product 288 32x32->64 multiply-adds; the bytes (one read of the
// point and digits, one write of the result) are ~1% of that time.
//
// Design: one thread per lane, the point and the running sum in registers
// and the table in local memory (9 x 72 words a lane for G2, L1-cached).
// Digits arrive pre-recoded, window-major (W, B), as the JAX kernel takes
// them. The formulas are the header's RCB Algorithm 7/9 in the stage order
// of curve.ProjectiveGroup, so the projective X:Y:Z equal the plain
// version's word for word.
//
// ptxas -v (nvcc 12.9, sm_90a): G1 94 registers, G2 190 registers, 0 bytes
// of register spills; the table and the point structs passed to the
// __noinline__ field functions live in a per-thread stack frame of 2,352
// bytes (G1) and 4,944 bytes (G2) in local memory.

#include <cuda_runtime.h>

#include "bls12_381.cuh"

using namespace bls;

template <class F>
__global__ void ladder_kernel(const int32_t* __restrict__ X,
                              const int32_t* __restrict__ Y,
                              const int32_t* __restrict__ Z,
                              const int32_t* __restrict__ mags,
                              const int32_t* __restrict__ negs, int n_windows,
                              int B, int32_t* oX, int32_t* oY, int32_t* oZ) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  Proj<F> table[9];
  proj_identity(table[0]);
  proj_load(table[1], X, Y, Z, lane, B);
  // even entries by doubling, odd by one addition (tcurve.window_table)
  for (int d = 2; d <= 8; d++) {
    if (d % 2 == 0)
      proj_dbl(table[d], table[d / 2]);
    else
      proj_add(table[d], table[d - 1], table[1]);
  }
  Proj<F> acc;
  proj_identity(acc);
  for (int j = 0; j < n_windows; j++) {
    const int wi = n_windows - 1 - j;  // MSB-first over LSB-first storage
    for (int k = 0; k < 4; k++) proj_dbl(acc, acc);
    int mag = mags[(size_t)wi * B + lane];
    mag = mag < 0 ? 0 : (mag > 8 ? 8 : mag);  // recode_bits keeps |d| <= 8
    Proj<F> t = table[mag];
    if (negs[(size_t)wi * B + lane]) f_neg(t.Y, t.Y);
    proj_add(acc, acc, t);
  }
  proj_store(oX, oY, oZ, lane, B, acc);
}

template <class F>
static int launch(const void* X, const void* Y, const void* Z, const void* mags,
                  const void* negs, int n_windows, int B, void* oX, void* oY,
                  void* oZ, void* stream) {
  const int threads = 128;
  const int blocks = (B + threads - 1) / threads;
  ladder_kernel<F><<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)X, (const int32_t*)Y, (const int32_t*)Z,
      (const int32_t*)mags, (const int32_t*)negs, n_windows, B, (int32_t*)oX,
      (int32_t*)oY, (int32_t*)oZ);
  return (int)cudaGetLastError();
}

extern "C" int lh_ladder_g1(const void* X, const void* Y, const void* Z,
                            const void* mags, const void* negs, int n_windows,
                            int B, void* oX, void* oY, void* oZ, void* stream) {
  return launch<Fp>(X, Y, Z, mags, negs, n_windows, B, oX, oY, oZ, stream);
}

extern "C" int lh_ladder_g2(const void* X, const void* Y, const void* Z,
                            const void* mags, const void* negs, int n_windows,
                            int B, void* oX, void* oY, void* oZ, void* stream) {
  return launch<Fp2>(X, Y, Z, mags, negs, n_windows, B, oX, oY, oZ, stream);
}
