// The Reed-Solomon extension: every (point, blob) pair's Horner chain in
// Fr (mod r), each chain split into S segments of the coefficient axis.
//
// Replaces lighthouse_tpu/ops/rs_extend.py `eval_poly_batch` (:36), which is
// XLA on the TPU, no Pallas kernel: a `fori_loop` over the coefficients,
// highest degree first, of acc <- rf.add(rf.mul_lazy(acc, x), c) (rfield.py
// :207 and :247) on every (point, blob) lane at once, in relaxed 12-bit limbs.
// Here a value is 8 little-endian 32-bit words in Montgomery form with
// R = 2^256 (lighthouse_tpu_torch/ops/rfield.py). The plain version is
// lighthouse_tpu_torch/ops/rs_extend.py `eval_poly_batch_plain`; the word
// models are rfield.py `mul_words` (the product's carry chains),
// `horner_step_words` (a step) and `split_eval_words` (a split chain).
//
// What it computes: out[p, b] = sum_i coeffs[i, b] * (x[p] 2^-256)^i mod r.
// With the points in Montgomery form (x = X 2^256 mod r) that is
// sum_i c_i X^i in the coefficients' own domain: Montgomery coefficients
// give Montgomery values, plain ones plain values. `plain_out` ends every
// chain with one more product, by 1, which leaves the Montgomery domain.
//
// What bounds it on the H100: 32-bit multiply-adds. A step is one Fr
// product, 2 x 64 word products (a x and m r), each a low and a high half,
// 256 multiply-adds, against 32 bytes of coefficient a step that every
// point of a blob shares: at a blob's 8,192 points the operations outweigh
// the bytes some ten thousand times.
//
// Design.
// * Only live chains: the blob axis is the caller's, with no padding.
// * A chain is S threads, adjacent lanes of one warp. With L = ceil(n / S),
//   segment s runs Horner over coefficients [s L, s L + L) (those at n and
//   above are zero: leading zeros of the top segment), so its value is
//   part_s = sum_k c_{sL+k} X^k. Every lane then computes y = X^L (in
//   Montgomery form, from x by square-and-multiply over L's bits, each
//   result made canonical) and the lanes combine the canonical parts with
//   shuffles in a second Horner, out = sum_s part_s y^s: S - 1 steps.
//   The split adds floor(log2 L) squarings, popcount(L) - 1 products and
//   S - 1 combine steps to every lane (ops/rs_extend.py `split_products`).
// * S is 4 or 8, chosen at the launch from the resident blocks an SM that
//   the CUDA runtime reports for each, so that the grid is closest to
//   whole waves (`lh_rs_extend_plan`). The kernel compiles for S = 1 too
//   (one thread a chain, no combine), which only
//   lighthouse_tpu_torch/probes/horner_split.py instantiates.
// * A block is 128 threads: 128 / S points of one blob. Every point of the
//   blob reads the same coefficients, so the block stages them in shared
//   memory, STEPS steps of every segment at a time: tile[buf][step][half]
//   [segment], 16 bytes an entry, so that the S segments' reads of one
//   step fall on distinct banks. Two buffers, filled with cp.async: the
//   copy of tile k + 1 is issued right after the barrier that opens tile
//   k and lands while the chains run tile k, so the one barrier a tile
//   waits for no memory read.
// * The product is CIOS over 8 words, each row four PTX carry chains of
//   mad.lo.cc / madc.hi.cc (two instructions a word product): a_i b's even
//   words, its odd words, then m r's even and odd words with
//   m = t_0 (-r^-1) mod 2^32; the row's 9 words then shift down one. For
//   any 8-word a and b < r every row leaves t below b + r (t + a_i b + m r
//   < 2^32 (b + r) before the shift), so t needs 9 words, no chain carries
//   out of word 8 (the value before the shift is below 2^288 and every
//   chain adds a non-negative amount), and the product is below b + r < 2r
//   with no final subtraction. A step adds the coefficient (< r), below
//   3r, and subtracts r once when the sum's carry is set or it is >= r:
//   the accumulator stays below 2r. One subtraction more makes a value
//   canonical (a segment's part, y, the result).
// * No local memory: every array is indexed by unrolled constants.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace rs {

constexpr int NW = 8;
constexpr int THREADS = 128;
constexpr int STEPS = 32;  // steps of a staged tile, a segment
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

// t[0..7] += y (w0, w2, w4, w6): the low half of y w_{2k} into word 2k,
// the high half into word 2k + 1, one carry chain; `tail` ends it in the
// same asm statement (word 8 at %8)
#define RS_EVEN(t, y, w0, w2, w4, w6, tail)                                       \
  asm("mad.lo.cc.u32 %0, %9, %10, %0;\n\tmadc.hi.cc.u32 %1, %9, %10, %1;\n\t"     \
      "madc.lo.cc.u32 %2, %9, %11, %2;\n\tmadc.hi.cc.u32 %3, %9, %11, %3;\n\t"    \
      "madc.lo.cc.u32 %4, %9, %12, %4;\n\tmadc.hi.cc.u32 %5, %9, %12, %5;\n\t"    \
      "madc.lo.cc.u32 %6, %9, %13, %6;\n\tmadc.hi.cc.u32 %7, %9, %13, %7;\n\t" tail \
      : "+r"(t[0]), "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]), "+r"(t[5]),  \
        "+r"(t[6]), "+r"(t[7]), "+r"(t[8])                                        \
      : "r"(y), "r"(w0), "r"(w2), "r"(w4), "r"(w6))

// t[1..8] += y (w1, w3, w5, w7) likewise, ending in word 8 with no carry out
#define RS_ODD(t, y, w1, w3, w5, w7)                                              \
  asm("mad.lo.cc.u32 %0, %8, %9, %0;\n\tmadc.hi.cc.u32 %1, %8, %9, %1;\n\t"       \
      "madc.lo.cc.u32 %2, %8, %10, %2;\n\tmadc.hi.cc.u32 %3, %8, %10, %3;\n\t"    \
      "madc.lo.cc.u32 %4, %8, %11, %4;\n\tmadc.hi.cc.u32 %5, %8, %11, %5;\n\t"    \
      "madc.lo.cc.u32 %6, %8, %12, %6;\n\tmadc.hi.u32 %7, %8, %12, %7;"           \
      : "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]), "+r"(t[5]), "+r"(t[6]),  \
        "+r"(t[7]), "+r"(t[8])                                                    \
      : "r"(y), "r"(w1), "r"(w3), "r"(w5), "r"(w7))

// out = a b 2^-256 mod r, lazy: below b + r < 2r for any 8-word a and b < r
// (out may alias a or b)
__device__ __forceinline__ void fr_mul(uint32_t (&out)[NW], const uint32_t (&a)[NW],
                                       const uint32_t (&b)[NW]) {
  uint32_t t[NW + 1];
#pragma unroll
  for (int j = 0; j <= NW; ++j) t[j] = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    // word 8 is 0 here: t < b + r < 2^256
    RS_EVEN(t, a[i], b[0], b[2], b[4], b[6], "addc.u32 %8, 0, 0;");
    RS_ODD(t, a[i], b[1], b[3], b[5], b[7]);
    const uint32_t m = t[0] * N0;
    RS_EVEN(t, m, r_word(0), r_word(2), r_word(4), r_word(6), "addc.u32 %8, %8, 0;");
    RS_ODD(t, m, r_word(1), r_word(3), r_word(5), r_word(7));
#pragma unroll
    for (int j = 0; j < NW; ++j) t[j] = t[j + 1];  // word 0 is 0
    t[NW] = 0;
  }
#pragma unroll
  for (int j = 0; j < NW; ++j) out[j] = t[j];
}

// acc = s - r where s + top 2^256 >= r, else s; top is 0 or 1, and s +
// top 2^256 < 3r. The borrow chain ends in top - borrow: 0 (take s - r)
// or all ones (keep s), as the value fits 8 words either way.
__device__ __forceinline__ void sub_r_select(uint32_t (&acc)[NW], const uint32_t (&s)[NW],
                                             uint32_t top) {
  uint32_t d[NW];
  asm("sub.cc.u32 %0, %9, %17;\n\tsubc.cc.u32 %1, %10, %18;\n\t"
      "subc.cc.u32 %2, %11, %19;\n\tsubc.cc.u32 %3, %12, %20;\n\t"
      "subc.cc.u32 %4, %13, %21;\n\tsubc.cc.u32 %5, %14, %22;\n\t"
      "subc.cc.u32 %6, %15, %23;\n\tsubc.cc.u32 %7, %16, %24;\n\t"
      "subc.u32 %8, %8, 0;"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3]), "=r"(d[4]), "=r"(d[5]), "=r"(d[6]),
        "=r"(d[7]), "+r"(top)
      : "r"(s[0]), "r"(s[1]), "r"(s[2]), "r"(s[3]), "r"(s[4]), "r"(s[5]), "r"(s[6]), "r"(s[7]),
        "r"(r_word(0)), "r"(r_word(1)), "r"(r_word(2)), "r"(r_word(3)), "r"(r_word(4)),
        "r"(r_word(5)), "r"(r_word(6)), "r"(r_word(7)));
#pragma unroll
  for (int j = 0; j < NW; ++j) acc[j] = top ? s[j] : d[j];
}

// acc <- acc x 2^-256 + c: acc below 2r in and out, x and c below r
__device__ __forceinline__ void horner_step(uint32_t (&acc)[NW], const uint32_t (&x)[NW],
                                            const uint32_t (&c)[NW]) {
  uint32_t t[NW], s[NW], top;
  fr_mul(t, acc, x);
  asm("add.cc.u32 %0, %9, %17;\n\taddc.cc.u32 %1, %10, %18;\n\t"
      "addc.cc.u32 %2, %11, %19;\n\taddc.cc.u32 %3, %12, %20;\n\t"
      "addc.cc.u32 %4, %13, %21;\n\taddc.cc.u32 %5, %14, %22;\n\t"
      "addc.cc.u32 %6, %15, %23;\n\taddc.cc.u32 %7, %16, %24;\n\t"
      "addc.u32 %8, 0, 0;"
      : "=r"(s[0]), "=r"(s[1]), "=r"(s[2]), "=r"(s[3]), "=r"(s[4]), "=r"(s[5]), "=r"(s[6]),
        "=r"(s[7]), "=r"(top)
      : "r"(t[0]), "r"(t[1]), "r"(t[2]), "r"(t[3]), "r"(t[4]), "r"(t[5]), "r"(t[6]), "r"(t[7]),
        "r"(c[0]), "r"(c[1]), "r"(c[2]), "r"(c[3]), "r"(c[4]), "r"(c[5]), "r"(c[6]), "r"(c[7]));
  sub_r_select(acc, s, top);
}

// v below 2r -> canonical
__device__ __forceinline__ void canon(uint32_t (&v)[NW]) { sub_r_select(v, v, 0); }

// y = X^L in Montgomery form for x = X 2^256 mod r (canonical): left to
// right over L's bits, each square and product made canonical, as a
// product's second operand must be below r
__device__ __forceinline__ void pow_mont(uint32_t (&y)[NW], const uint32_t (&x)[NW], int L) {
#pragma unroll
  for (int j = 0; j < NW; ++j) y[j] = x[j];
  for (int bit = 30 - __clz(L); bit >= 0; --bit) {
    fr_mul(y, y, y);
    canon(y);
    if ((L >> bit) & 1) {
      fr_mul(y, y, x);
      canon(y);
    }
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned addr = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(addr), "l"(gmem));
}

// issue the copies of one tile: steps [q0, q0 + STEPS) of every segment,
// step q of segment s being coefficient s L + L - 1 - q, zero from n_coeff
// up (stored directly), then commit them as one cp.async group
template <int S>
__device__ __forceinline__ void stage(uint4 (*buf)[2][S], const uint32_t* __restrict__ coeffs,
                                      int n_coeff, int blobs, int b, int L, int q0) {
  const int steps = min(STEPS, L - q0);
  for (int e = threadIdx.x; e < steps * 2 * S; e += THREADS) {
    const int s = e % S, half = (e / S) & 1, q = e / (2 * S);
    const int i = s * L + L - 1 - (q0 + q);
    if (i < n_coeff)
      cp_async16(&buf[q][half][s], coeffs + ((size_t)i * blobs + b) * NW + 4 * half);
    else
      buf[q][half][s] = make_uint4(0, 0, 0, 0);
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// coeffs (n_coeff, blobs, 8), points (pts, 8), out (pts, blobs, 8): words;
// block x is THREADS / S points of blob x / blocks_x, S lanes a chain
template <int S>
__global__ void __launch_bounds__(THREADS) horner_kernel(
    const uint32_t* __restrict__ coeffs, const uint32_t* __restrict__ points, int n_coeff,
    int blobs, int pts, int L, int blocks_x, int plain_out, uint32_t* __restrict__ out) {
  __shared__ uint4 tile[2][STEPS][2][S];
  const int seg = threadIdx.x % S;
  const int b = blockIdx.x / blocks_x;
  const int p = (blockIdx.x % blocks_x) * (THREADS / S) + threadIdx.x / S;
  uint32_t x[NW], acc[NW];
#pragma unroll
  for (int j = 0; j < NW; ++j) acc[j] = 0;
  if (p < pts) {
    const uint4* xp = reinterpret_cast<const uint4*>(points + (size_t)p * NW);
    const uint4 lo = xp[0], hi = xp[1];
    x[0] = lo.x; x[1] = lo.y; x[2] = lo.z; x[3] = lo.w;
    x[4] = hi.x; x[5] = hi.y; x[6] = hi.z; x[7] = hi.w;
  } else {  // a lane past the last point runs on x = 0 and stores nothing
#pragma unroll
    for (int j = 0; j < NW; ++j) x[j] = 0;
  }

  const int tiles = (L + STEPS - 1) / STEPS;
  stage<S>(tile[0], coeffs, n_coeff, blobs, b, L, 0);
  for (int k = 0; k < tiles; ++k) {
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();  // tile k is in; every chain is done with tile k - 1
    if (k + 1 < tiles) stage<S>(tile[(k + 1) & 1], coeffs, n_coeff, blobs, b, L, (k + 1) * STEPS);
    const int steps = min(STEPS, L - k * STEPS);
#pragma unroll 2
    for (int q = 0; q < steps; ++q) {
      const uint4 lo = tile[k & 1][q][0][seg], hi = tile[k & 1][q][1][seg];
      const uint32_t c[NW] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
      horner_step(acc, x, c);
    }
  }

  if constexpr (S > 1) {
    // the combine: out = sum_s part_s y^s over the chain's S lanes
    canon(acc);
    uint32_t y[NW], part[NW];
    pow_mont(y, x, L);
    const int base = (threadIdx.x & 31) & ~(S - 1);
#pragma unroll
    for (int j = 0; j < NW; ++j) part[j] = acc[j];
#pragma unroll
    for (int j = 0; j < NW; ++j) acc[j] = __shfl_sync(0xffffffffu, part[j], base + S - 1);
#pragma unroll
    for (int s = S - 2; s >= 0; --s) {
      uint32_t c[NW];
#pragma unroll
      for (int j = 0; j < NW; ++j) c[j] = __shfl_sync(0xffffffffu, part[j], base + s);
      horner_step(acc, y, c);
    }
  }
  if (plain_out) {
    const uint32_t one[NW] = {1, 0, 0, 0, 0, 0, 0, 0};
    fr_mul(acc, acc, one);
  }
  canon(acc);
  if (seg == 0 && p < pts) {
    uint4* o = reinterpret_cast<uint4*>(out + ((size_t)p * blobs + b) * NW);
    o[0] = make_uint4(acc[0], acc[1], acc[2], acc[3]);
    o[1] = make_uint4(acc[4], acc[5], acc[6], acc[7]);
  }
}

// the launch plan of S segments: blocks, the kernel's resident blocks an
// SM on the current device, the SMs
struct Plan {
  int segments, blocks_per_sm, sms, blocks_x, blocks, L;
};

constexpr int MAX_DEVICES = 64;

template <int S>
cudaError_t plan_for(int n_coeff, int blobs, int pts, Plan& pl) {
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return rc;
  rc = cudaDeviceGetAttribute(&pl.sms, cudaDevAttrMultiProcessorCount, dev);
  if (rc != cudaSuccess) return rc;
  // asked once a device; 0 until a thread publishes the runtime's answer
  static std::atomic<int> cached[MAX_DEVICES];
  pl.blocks_per_sm = dev < MAX_DEVICES ? cached[dev].load() : 0;
  if (pl.blocks_per_sm == 0) {
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&pl.blocks_per_sm, horner_kernel<S>, THREADS, 0);
    if (rc != cudaSuccess) return rc;
    if (pl.blocks_per_sm <= 0 || pl.sms <= 0) return cudaErrorInvalidConfiguration;
    if (dev < MAX_DEVICES) cached[dev].store(pl.blocks_per_sm);
  }
  pl.segments = S;
  pl.L = (n_coeff + S - 1) / S;
  pl.blocks_x = (pts + THREADS / S - 1) / (THREADS / S);
  if ((long long)pl.blocks_x * blobs > 0x7fffffffLL) return cudaErrorInvalidValue;  // grid x
  pl.blocks = pl.blocks_x * blobs;
  return cudaSuccess;
}

// waves / ceil(waves): 1 for a grid of whole waves
inline double wave_fill(const Plan& pl) {
  const double waves = (double)pl.blocks / ((double)pl.blocks_per_sm * pl.sms);
  return waves / ceil(waves);
}

// S = 4 or 8, whichever fills its last wave better (8 on a tie)
inline cudaError_t plan(int n_coeff, int blobs, int pts, Plan& pl) {
  Plan p4, p8;
  cudaError_t rc = plan_for<4>(n_coeff, blobs, pts, p4);
  if (rc != cudaSuccess) return rc;
  rc = plan_for<8>(n_coeff, blobs, pts, p8);
  if (rc != cudaSuccess) return rc;
  pl = wave_fill(p4) > wave_fill(p8) ? p4 : p8;
  return cudaSuccess;
}

template <int S>
cudaError_t launch(const Plan& pl, const void* coeffs, const void* points, int n_coeff,
                   int blobs, int pts, int plain_out, void* out, cudaStream_t stream) {
  horner_kernel<S><<<pl.blocks, THREADS, 0, stream>>>(
      (const uint32_t*)coeffs, (const uint32_t*)points, n_coeff, blobs, pts, pl.L, pl.blocks_x,
      plain_out, (uint32_t*)out);
  return cudaGetLastError();
}

}  // namespace rs

// out[6] (host ints) = the plan of a launch: segments, resident blocks an
// SM, SMs, blocks along the points, blocks, segment length L
extern "C" int lh_rs_extend_plan(int n_coeff, int blobs, int pts, void* out, void* stream) {
  (void)stream;
  if (n_coeff <= 0 || blobs <= 0 || pts <= 0) return (int)cudaErrorInvalidValue;
  rs::Plan pl;
  const cudaError_t rc = rs::plan(n_coeff, blobs, pts, pl);
  if (rc != cudaSuccess) return (int)rc;
  int* o = (int*)out;
  o[0] = pl.segments; o[1] = pl.blocks_per_sm; o[2] = pl.sms;
  o[3] = pl.blocks_x; o[4] = pl.blocks; o[5] = pl.L;
  return 0;
}

extern "C" int lh_rs_extend(const void* coeffs, const void* points, int n_coeff, int blobs,
                            int pts, int plain_out, void* out, void* stream) {
  if (n_coeff <= 0 || blobs <= 0 || pts <= 0) return (int)cudaErrorInvalidValue;
  rs::Plan pl;
  const cudaError_t rc = rs::plan(n_coeff, blobs, pts, pl);
  if (rc != cudaSuccess) return (int)rc;
  const cudaStream_t s = (cudaStream_t)stream;
  return (int)(pl.segments == 4
                   ? rs::launch<4>(pl, coeffs, points, n_coeff, blobs, pts, plain_out, out, s)
                   : rs::launch<8>(pl, coeffs, points, n_coeff, blobs, pts, plain_out, out, s));
}
