// The Reed-Solomon extension: every (point, blob) pair's Horner chain in
// Fr (mod r), one thread a pair.
//
// Replaces lighthouse_tpu/ops/rs_extend.py `eval_poly_batch` (:36), which is
// XLA on the TPU, no Pallas kernel: a `fori_loop` over the coefficients,
// highest degree first, of acc <- rf.add(rf.mul_lazy(acc, x), c) (rfield.py
// :207 and :247) on every (point, blob) lane at once, in relaxed 12-bit limbs.
// Here a value is 8 little-endian 32-bit words in Montgomery form with
// R = 2^256 (lighthouse_tpu_torch/ops/rfield.py). The plain version is
// lighthouse_tpu_torch/ops/rs_extend.py `eval_poly_batch_plain`; the word
// model of `fr_mul` and of a step is rfield.py `mul_words` and
// `horner_step_words`.
//
// What it computes: out[p, b] = sum_i coeffs[i, b] * (x[p] 2^-256)^i mod r,
// by Horner, acc <- acc x 2^-256 + c. With the points in Montgomery form
// (x = X 2^256 mod r) that is sum_i c_i X^i in the coefficients' own domain:
// Montgomery coefficients give Montgomery values, plain ones plain values.
// `plain_out` ends every chain with one more product, by 1, which leaves the
// Montgomery domain.
//
// What bounds it on the H100: 32-bit multiply-adds. A step is one Fr
// product, 2 x 64 word products (a x and m r), each a low and a high half,
// 256 multiply-adds, against 32 bytes of coefficient a step that every
// point of a blob shares: at a blob's 8,192 points the operations outweigh
// the bytes some ten thousand times.
//
// Design: one thread a (point, blob) chain, the accumulator and the point
// in registers, the product CIOS with 64-bit multiply-adds. A block is
// 128 threads: a tile of up to 8 blobs (the blob index varies fastest) by
// as many points as fill it. At step i every point of a blob reads the same
// coefficient, so a block stages the coefficients of its blobs for 32
// steps at a time in shared memory, loaded by the whole block in 16-byte
// rows, and each thread reads its blob's from there. The accumulator stays
// lazy, below 2r: the product needs no final subtraction (for any 8-word
// a and x < r its value is below x + r < 2r), and the sum with the
// coefficient, below 3r and so wider than 8 words, loses r once when its
// carry is set or it is >= r. One conditional subtraction a step, one more
// at the end.

#include <cuda_runtime.h>
#include <stdint.h>

namespace rs {

constexpr int NW = 8;
constexpr int THREADS = 128;
constexpr int MAX_BLOB_TILE = 8;
constexpr int STEPS = 32;  // coefficients of a shared tile
constexpr uint32_t N0 = 0xffffffffu;  // -r^-1 mod 2^32

// r, little-endian 32-bit words
__host__ __device__ constexpr uint32_t r_word(int j) {
  return j == 0 ? 0x00000001u
       : j == 1 ? 0xffffffffu
       : j == 2 ? 0xfffe5bfeu
       : j == 3 ? 0x53bda402u
       : j == 4 ? 0x09a1d805u
       : j == 5 ? 0x3339d808u
       : j == 6 ? 0x299d7d48u
       :          0x73eda753u;
}

// t + a b + c in 64 bits: the low word, the high word into c
__device__ __forceinline__ uint32_t mad(uint32_t t, uint32_t a, uint32_t b, uint32_t& c) {
  const uint64_t v = (uint64_t)a * b + t + c;
  c = (uint32_t)(v >> 32);
  return (uint32_t)v;
}

// t = a b 2^-256 mod r, lazy: below b + r < 2r for any 8-word a and b < r
__device__ __forceinline__ void fr_mul(uint32_t (&t)[NW], const uint32_t (&a)[NW],
                                       const uint32_t (&b)[NW]) {
#pragma unroll
  for (int j = 0; j < NW; ++j) t[j] = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    uint32_t c = 0;
#pragma unroll
    for (int j = 0; j < NW; ++j) t[j] = mad(t[j], a[i], b[j], c);
    const uint32_t top = c;  // the ninth word
    const uint32_t m = t[0] * N0;
    c = 0;
    mad(t[0], m, r_word(0), c);  // the low word is 0
#pragma unroll
    for (int j = 1; j < NW; ++j) t[j - 1] = mad(t[j], m, r_word(j), c);
    t[NW - 1] = top + c;  // no carry out: the row leaves t below 2^256
  }
}

// acc = s - r when `carry` is set or s >= r, else s
__device__ __forceinline__ void sub_r_if(uint32_t (&acc)[NW], const uint32_t (&s)[NW],
                                         uint32_t carry) {
  uint32_t d[NW];
  uint32_t borrow = 0;
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    const uint64_t v = (uint64_t)s[j] - r_word(j) - borrow;
    d[j] = (uint32_t)v;
    borrow = (uint32_t)(v >> 63);
  }
  const bool take = carry || !borrow;
#pragma unroll
  for (int j = 0; j < NW; ++j) acc[j] = take ? d[j] : s[j];
}

// acc <- acc x 2^-256 + c, acc below 2r in and out, x and c below r
__device__ __forceinline__ void horner_step(uint32_t (&acc)[NW], const uint32_t (&x)[NW],
                                            const uint32_t (&c)[NW]) {
  uint32_t s[NW];
  fr_mul(s, acc, x);
  uint32_t carry = 0;
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    const uint64_t v = (uint64_t)s[j] + c[j] + carry;
    s[j] = (uint32_t)v;
    carry = (uint32_t)(v >> 32);
  }
  sub_r_if(acc, s, carry);
}

// coeffs (n_coeff, blobs, 8), points (pts, 8), out (pts, blobs, 8): words;
// blob_tile a power of two <= MAX_BLOB_TILE
__global__ void __launch_bounds__(THREADS) horner_kernel(
    const uint32_t* __restrict__ coeffs, const uint32_t* __restrict__ points, int n_coeff,
    int blobs, int pts, int blob_tile, int plain_out, uint32_t* __restrict__ out) {
  __shared__ uint4 tile[STEPS][MAX_BLOB_TILE][2];
  const int bl = threadIdx.x % blob_tile;
  const int b = blockIdx.y * blob_tile + bl;
  const int p = blockIdx.x * (THREADS / blob_tile) + threadIdx.x / blob_tile;
  uint32_t x[NW], acc[NW];
#pragma unroll
  for (int j = 0; j < NW; ++j) acc[j] = 0;
  if (p < pts) {
    const uint4* xp = reinterpret_cast<const uint4*>(points + (size_t)p * NW);
    const uint4 lo = xp[0], hi = xp[1];
    x[0] = lo.x; x[1] = lo.y; x[2] = lo.z; x[3] = lo.w;
    x[4] = hi.x; x[5] = hi.y; x[6] = hi.z; x[7] = hi.w;
  } else {
#pragma unroll
    for (int j = 0; j < NW; ++j) x[j] = 0;
  }
  for (int k0 = 0; k0 < n_coeff; k0 += STEPS) {
    const int steps = min(STEPS, n_coeff - k0);
    __syncthreads();  // every thread is done with the previous tile
    for (int e = threadIdx.x; e < steps * blob_tile * 2; e += THREADS) {
      const int half = e & 1;
      const int j = (e >> 1) % blob_tile;
      const int s = (e >> 1) / blob_tile;
      const int bj = blockIdx.y * blob_tile + j;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (bj < blobs)  // step s of the tile is coefficient n_coeff - 1 - (k0 + s)
        v = reinterpret_cast<const uint4*>(
            coeffs + ((size_t)(n_coeff - 1 - k0 - s) * blobs + bj) * NW)[half];
      tile[s][j][half] = v;
    }
    __syncthreads();
    for (int s = 0; s < steps; ++s) {
      const uint4 lo = tile[s][bl][0], hi = tile[s][bl][1];
      const uint32_t c[NW] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
      horner_step(acc, x, c);
    }
  }
  if (plain_out) {
    const uint32_t one[NW] = {1, 0, 0, 0, 0, 0, 0, 0};
    uint32_t t[NW];
    fr_mul(t, acc, one);
#pragma unroll
    for (int j = 0; j < NW; ++j) acc[j] = t[j];
  }
  sub_r_if(acc, acc, 0);  // below 2r -> canonical
  if (p < pts && b < blobs) {
    uint4* o = reinterpret_cast<uint4*>(out + ((size_t)p * blobs + b) * NW);
    o[0] = make_uint4(acc[0], acc[1], acc[2], acc[3]);
    o[1] = make_uint4(acc[4], acc[5], acc[6], acc[7]);
  }
}

}  // namespace rs

extern "C" int lh_rs_extend(const void* coeffs, const void* points, int n_coeff, int blobs,
                            int pts, int plain_out, void* out, void* stream) {
  if (n_coeff <= 0 || blobs <= 0 || pts <= 0) return (int)cudaErrorInvalidValue;
  int tile = 1;
  while (tile < blobs && tile < rs::MAX_BLOB_TILE) tile <<= 1;
  const int per_block = rs::THREADS / tile;
  const dim3 grid((pts + per_block - 1) / per_block, (blobs + tile - 1) / tile);
  rs::horner_kernel<<<grid, rs::THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)coeffs, (const uint32_t*)points, n_coeff, blobs, pts, tile, plain_out,
      (uint32_t*)out);
  return (int)cudaGetLastError();
}
