// K3 -- product fold of the per-pair Miller outputs and the final
// exponentiation f^(3 (p^12 - 1) / r), one launch, returning the Fp12 value
// and the verdict (value == 1).
//
// Replaces the TPU kernel lighthouse_tpu/ops/pallas_tail.py `_kernel`
// (reached through `final_exp_pallas` / `fold_final_exp_pallas`, which put
// the XLA lane fold `tfexp.fold_lanes` in front). On the TPU the fold stays
// at XLA level; the port has no XLA, so the fold is in this kernel too.
//
// What bounds it on the H100: the latency of one thread's chain. The fold
// is B - 1 Fp12 products spread over one block (log2 B dependent levels);
// the exponentiation is ~320 Fp12 squarings, ~40 Fp12 products, one Fp12
// inversion (a 381-bit Fermat chain in Fp) and four Frobenius maps, all
// dependent, on one thread: ~14k Fp products one after another.
//
// Design: one block. The fold walks the lane-halving tree of
// tfexp.fold_lanes (product of lanes i and i + half, an odd count carries
// its last lane), level by level between two scratch buffers in device
// memory, with a block barrier between levels; then thread 0 runs the
// addition chain of tfexp.final_exponentiation_t -- the exponent is
// 3 (p^12 - 1) / r, not the textbook (p^12 - 1) / r, so the value equals the
// JAX package's bit for bit. The single-thread tail is slow by design and
// stays so in this first port.
//
// ptxas -v (nvcc 12.9, sm_90a): 255 registers, 0 bytes of register spills,
// an 8,592-byte per-thread stack frame in local memory (the Fp12
// temporaries of the chain), one block barrier.

#include <cuda_runtime.h>

#include "bls12_381.cuh"

using namespace bls;

// g^|x|, square-and-multiply from the top bit of |x|
__device__ __noinline__ void pow_x_abs(Fp12& r, const Fp12& g) {
  Fp12 acc = g;
  for (int i = 62; i >= 0; i--) {
    fp12_sqr(acc, acc);
    if ((X_ABS >> i) & 1ull) fp12_mul(acc, acc, g);
  }
  r = acc;
}

// g^x = conj(g^|x|) for the unitary values of the hard part (x < 0)
__device__ __noinline__ void pow_neg_x(Fp12& r, const Fp12& g) {
  Fp12 t;
  pow_x_abs(t, g);
  fp12_conj(r, t);
}

// the addition chain of tfexp.final_exponentiation_t
__device__ __noinline__ void final_exponentiation(Fp12& r, const Fp12& f_in) {
  Fp12 f, t, u, t0, t1, t2, t3;
  // easy part: f^((p^6 - 1)(p^2 + 1))
  fp12_conj(t, f_in);
  fp12_inv(u, f_in);
  fp12_mul(f, t, u);
  fp12_frobenius2(t, f);
  fp12_mul(f, t, f);
  // hard part, scaled by 3
  pow_neg_x(t, f);
  fp12_conj(u, f);
  fp12_mul(t0, t, u);
  pow_neg_x(t, t0);
  fp12_conj(u, t0);
  fp12_mul(t1, t, u);
  pow_neg_x(t, t1);
  fp12_frobenius(u, t1);
  fp12_mul(t2, t, u);
  pow_neg_x(t, t2);
  pow_neg_x(t, t);
  fp12_frobenius2(u, t2);
  fp12_conj(t3, t2);
  fp12_mul(u, u, t3);
  fp12_mul(t3, t, u);
  fp12_mul(t, f, f);
  fp12_mul(t, t, f);
  fp12_mul(r, t3, t);
}

__global__ void fold_final_exp_kernel(const int32_t* __restrict__ f_in, int B,
                                      int32_t* buf_a, int32_t* buf_b,
                                      int32_t* out, int32_t* verdict) {
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  Fp12 a, b;
  for (int i = tid; i < B; i += nt) {
    fp12_load(a, f_in, i, B);
    fp12_store(buf_a, i, B, a);
  }
  __syncthreads();
  int32_t* src = buf_a;
  int32_t* dst = buf_b;
  int n = B;
  while (n > 1) {
    const int half = n / 2;
    for (int i = tid; i < half; i += nt) {
      fp12_load(a, src, i, B);
      fp12_load(b, src, i + half, B);
      fp12_mul(a, a, b);
      fp12_store(dst, i, B, a);
    }
    if ((n & 1) && tid == 0) {  // an odd count carries its last lane
      fp12_load(a, src, n - 1, B);
      fp12_store(dst, half, B, a);
    }
    __syncthreads();
    int32_t* tmp = src;
    src = dst;
    dst = tmp;
    n = half + (n & 1);
  }
  if (tid == 0) {
    fp12_load(a, src, 0, B);
    final_exponentiation(b, a);
    fp12_store(out, 0, 1, b);
    verdict[0] = fp12_is_one(b) ? 1 : 0;
  }
}

extern "C" int lh_fold_final_exp(const void* f_in, int B, void* buf_a,
                                 void* buf_b, void* out, void* verdict,
                                 void* stream) {
  fold_final_exp_kernel<<<1, 128, 0, (cudaStream_t)stream>>>(
      (const int32_t*)f_in, B, (int32_t*)buf_a, (int32_t*)buf_b,
      (int32_t*)out, (int32_t*)verdict);
  return (int)cudaGetLastError();
}
