// K1 -- the per-lane RLC scalar ladders, [k_i] P_i per lane, for G1 and G2,
// in three bodies: the signed-digit window (the verify path's default), the
// per-bit double-add chain and the 2-bit unsigned window.
//
// Replaces the TPU kernels of lighthouse_tpu/ops/pallas_ladder.py, all
// reached through `ladder_pallas(kind=...)`:
//   window -- `_ladder_kernel_w4`: signed digits, c = 4, MSB first; per
//             window four complete doublings and one complete addition of
//             +-table[|d|], with the table [0..8] P built in the kernel;
//   chain  -- `_ladder_kernel`: LSB first over the bits, per bit
//             acc += addend when the bit is set, addend doubles
//             (tcurve.ladder_step);
//   w2     -- `_ladder_kernel_w2`: MSB-first 2-bit digits, per window two
//             doublings and one complete addition of table[d] from
//             {O, P, 2P, 3P} (tcurve.window2_table / window2_step).
//
// What bounds them on the H100: integer multiply-adds. For a 64-bit scalar
// the window body costs 17 x (4 doublings + 1 addition) plus the 8-entry
// table, ~828 Fp products per G1 lane and ~2,484 per G2 lane (Karatsuba
// Fp2); the chain 63 doublings and one addition per set bit (~32), ~888 /
// 2,664; w2 32 x (2 doublings + 1 addition) plus its table, ~916 / 2,748.
// Each product is 288 32x32->64 multiply-adds; the bytes (one read of the
// point and the digits or bits, one write of the result) are ~1% of that.
//
// Design: one thread per lane, the point and the running sum in registers,
// a table in local memory (9 x 72 words a lane for the window body on G2,
// 4 x 72 for w2, none for the chain). Digits arrive pre-recoded -- signed
// window-major (W, B) for `window`, MSB-first 2-bit (W, B) for `w2`, as the
// JAX kernels take them -- and the chain reads the (n_bits, B) bits. The
// formulas are the header's RCB Algorithm 7/9 in the stage order of
// curve.ProjectiveGroup, and each body applies them in the order of its
// JAX counterpart, so the projective X:Y:Z equal the plain version's word
// for word. w2's digit 0 adds the identity entry, with no branch, as
// window2_step does; the chain skips the addition of a clear bit, which
// leaves the same words as the JAX select.
//
// ptxas -v (nvcc 12.9, sm_90a), window body: G1 94 registers, G2 190
// registers, 0 bytes of register spills; the table and the point structs
// passed to the __noinline__ field functions live in a per-thread stack
// frame of 2,352 bytes (G1) and 4,944 bytes (G2) in local memory.

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

// the per-bit double-add chain, LSB first (tcurve.mul_scalar_bits); the
// last doubling of the addend is never used, so it is not computed
template <class F>
__global__ void ladder_chain_kernel(const int32_t* __restrict__ X,
                                    const int32_t* __restrict__ Y,
                                    const int32_t* __restrict__ Z,
                                    const int32_t* __restrict__ bits, int n_bits,
                                    int B, int32_t* oX, int32_t* oY, int32_t* oZ) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  Proj<F> addend, acc;
  proj_load(addend, X, Y, Z, lane, B);
  proj_identity(acc);
  for (int i = 0; i < n_bits; i++) {
    if (bits[(size_t)i * B + lane] == 1) proj_add(acc, acc, addend);
    if (i + 1 < n_bits) proj_dbl(addend, addend);
  }
  proj_store(oX, oY, oZ, lane, B, acc);
}

// the 2-bit unsigned window, MSB-first digits in 0..3 (window2_step)
template <class F>
__global__ void ladder_w2_kernel(const int32_t* __restrict__ X,
                                 const int32_t* __restrict__ Y,
                                 const int32_t* __restrict__ Z,
                                 const int32_t* __restrict__ digits,
                                 int n_windows, int B, int32_t* oX, int32_t* oY,
                                 int32_t* oZ) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  Proj<F> table[4];
  proj_identity(table[0]);
  proj_load(table[1], X, Y, Z, lane, B);
  proj_dbl(table[2], table[1]);
  proj_add(table[3], table[2], table[1]);
  Proj<F> acc;
  proj_identity(acc);
  for (int j = 0; j < n_windows; j++) {
    proj_dbl(acc, acc);
    proj_dbl(acc, acc);
    proj_add(acc, acc, table[digits[(size_t)j * B + lane] & 3]);
  }
  proj_store(oX, oY, oZ, lane, B, acc);
}

// the chain and w2 bodies: the point (X, Y, Z) and one (n, B) operand, the
// bits or the digits
template <class F, bool W2>
static int launch(const void* X, const void* Y, const void* Z,
                  const void* digits, int n, int B, void* oX, void* oY,
                  void* oZ, void* stream) {
  const int threads = 128;
  const int blocks = (B + threads - 1) / threads;
  if (W2)
    ladder_w2_kernel<F><<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)X, (const int32_t*)Y, (const int32_t*)Z,
        (const int32_t*)digits, n, B, (int32_t*)oX, (int32_t*)oY, (int32_t*)oZ);
  else
    ladder_chain_kernel<F><<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)X, (const int32_t*)Y, (const int32_t*)Z,
        (const int32_t*)digits, n, B, (int32_t*)oX, (int32_t*)oY, (int32_t*)oZ);
  return (int)cudaGetLastError();
}

template <class F>
static int launch_window(const void* X, const void* Y, const void* Z,
                         const void* mags, const void* negs, int n_windows,
                         int B, void* oX, void* oY, void* oZ, void* stream) {
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
  return launch_window<Fp>(X, Y, Z, mags, negs, n_windows, B, oX, oY, oZ, stream);
}

extern "C" int lh_ladder_g2(const void* X, const void* Y, const void* Z,
                            const void* mags, const void* negs, int n_windows,
                            int B, void* oX, void* oY, void* oZ, void* stream) {
  return launch_window<Fp2>(X, Y, Z, mags, negs, n_windows, B, oX, oY, oZ, stream);
}

extern "C" int lh_ladder_g1_chain(const void* X, const void* Y, const void* Z,
                                  const void* bits, int n_bits, int B, void* oX,
                                  void* oY, void* oZ, void* stream) {
  return launch<Fp, false>(X, Y, Z, bits, n_bits, B, oX, oY, oZ, stream);
}

extern "C" int lh_ladder_g2_chain(const void* X, const void* Y, const void* Z,
                                  const void* bits, int n_bits, int B, void* oX,
                                  void* oY, void* oZ, void* stream) {
  return launch<Fp2, false>(X, Y, Z, bits, n_bits, B, oX, oY, oZ, stream);
}

extern "C" int lh_ladder_g1_w2(const void* X, const void* Y, const void* Z,
                               const void* digits, int n_windows, int B, void* oX,
                               void* oY, void* oZ, void* stream) {
  return launch<Fp, true>(X, Y, Z, digits, n_windows, B, oX, oY, oZ, stream);
}

extern "C" int lh_ladder_g2_w2(const void* X, const void* Y, const void* Z,
                               const void* digits, int n_windows, int B, void* oX,
                               void* oY, void* oZ, void* stream) {
  return launch<Fp2, true>(X, Y, Z, digits, n_windows, B, oX, oY, oZ, stream);
}
