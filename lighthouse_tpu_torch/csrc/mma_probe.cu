// The tensor-core probe: out[s, k, b] = sum_l M[k, l] * X[s, l, b], exact,
// in two operand types -- int8 with int32 sums and bf16 with float32 sums.
//
// Replaces the TPU kernel scripts/probe_mxu_forms.py `kernel` (the
// `pl.pallas_call` in its `run`), which timed the int8 and bf16 forms of the
// same contraction on the TPU's matrix unit. Its shapes: S, L, K, B = 18,
// 32, 64, 128, values 0..126. The bf16 form is exact there and here: the
// operands have 7 bits and every sum is at most 32 x 126 x 126 < 2^19 <
// 2^24, the float32 significand. It is the measured starting point for a
// later tensor-core field product (digit products of the Montgomery
// multiply as a small integer matrix product).
//
// What bounds it on the H100: at the probe's size nothing but the launch
// and one pass over memory. The contraction is 9.4M multiply-adds (5 ns at
// the int8 rate) and 0.67 MB of operands and results (0.2 us at 3.35 TB/s).
//
// Design: hand-written `mma.sync` (Hopper runs the Ampere warp-level MMA):
//   int8 -- mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32
//   bf16 -- mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32
// SPLIT blocks per s, each a quarter of the columns b. X[s] is stored
// l-major, but a B fragment register holds consecutive l of one column, so
// a block stages its columns of X[s], transposed, in shared memory (each
// element is read by one block): each thread reads 4-byte words of 4 rows
// (int8) or 2 rows (bf16) and transposes the 4 x 4 bytes or 2 x 2 halves
// in registers (`__byte_perm`), one 4-byte store per column; rows of the
// transposed copy are padded by 16 bytes, so the fragment loads of a warp
// (8 columns x 4 words) fall in distinct banks. Warp w takes the 16-row
// bands w, w + 4, .. of M and reads their A fragments from M as it is (k
// is contiguous there), the first band's before the staging so the loads
// overlap; it walks the block's 8-column tiles of the output, accumulating
// over L in steps of 32 (int8) or 16 (bf16); each thread writes its 2 x 2
// results as two 8-byte stores. The float32 sums of the bf16 form are exact integers
// and leave as int32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

constexpr int THREADS = 128;  // 4 warps: the 4 bands of 16 rows of M
constexpr int SPLIT = 4;  // blocks an s, each a quarter of the columns
constexpr int MAX_L = 64;  // A fragments for up to 64 k stay in registers
constexpr int PAD = 16;  // bytes after each row of the transposed X[s]

template <class T>
__device__ __forceinline__ uint32_t ld32(const T* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// columns [b0, b0 + nb) of X[s] (L x B, l-major) -> XT (nb rows of L
// elements, `stride` bytes apart): int8 in 4 x 4 blocks, bf16 in 2 x 2
// blocks, one block a thread at a time
__device__ __forceinline__ void stage_t(unsigned char* XT, const int8_t* X, int L, int B, int b0,
                                        int nb, int stride) {
  X += b0;
  for (int i = threadIdx.x; i < (L / 4) * (nb / 4); i += THREADS) {
    const int l = 4 * (i / (nb / 4)), b = 4 * (i % (nb / 4));
    const uint32_t r0 = ld32(X + (size_t)l * B + b), r1 = ld32(X + (size_t)(l + 1) * B + b);
    const uint32_t r2 = ld32(X + (size_t)(l + 2) * B + b), r3 = ld32(X + (size_t)(l + 3) * B + b);
    const uint32_t lo01 = __byte_perm(r0, r1, 0x5140), lo23 = __byte_perm(r2, r3, 0x5140);
    const uint32_t hi01 = __byte_perm(r0, r1, 0x7362), hi23 = __byte_perm(r2, r3, 0x7362);
    *reinterpret_cast<uint32_t*>(XT + (size_t)b * stride + l) = __byte_perm(lo01, lo23, 0x5410);
    *reinterpret_cast<uint32_t*>(XT + (size_t)(b + 1) * stride + l) = __byte_perm(lo01, lo23, 0x7632);
    *reinterpret_cast<uint32_t*>(XT + (size_t)(b + 2) * stride + l) = __byte_perm(hi01, hi23, 0x5410);
    *reinterpret_cast<uint32_t*>(XT + (size_t)(b + 3) * stride + l) = __byte_perm(hi01, hi23, 0x7632);
  }
}

__device__ __forceinline__ void stage_t(unsigned char* XT, const __nv_bfloat16* X, int L, int B,
                                        int b0, int nb, int stride) {
  X += b0;
  for (int i = threadIdx.x; i < (L / 2) * (nb / 2); i += THREADS) {
    const int l = 2 * (i / (nb / 2)), b = 2 * (i % (nb / 2));
    const uint32_t r0 = ld32(X + (size_t)l * B + b), r1 = ld32(X + (size_t)(l + 1) * B + b);
    *reinterpret_cast<uint32_t*>(XT + (size_t)b * stride + 2 * l) = __byte_perm(r0, r1, 0x5410);
    *reinterpret_cast<uint32_t*>(XT + (size_t)(b + 1) * stride + 2 * l) = __byte_perm(r0, r1, 0x7632);
  }
}

// one warp-level MMA: c += a b on fragments
__device__ __forceinline__ void mma(int32_t (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// T the operand type, Acc the accumulator, DEPTH the k of one MMA; a
// fragment register holds 4 / sizeof(T) consecutive k. Block (s, q) stages
// and writes columns [q B / SPLIT, (q + 1) B / SPLIT) of out[s]; each warp
// loads its band's A fragments first, so their loads overlap the staging.
template <class T, class Acc, int DEPTH>
__global__ void __launch_bounds__(THREADS)
    mma_probe_kernel(const T* __restrict__ M, const T* __restrict__ X, int L, int K, int B,
                     int32_t* out) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int PER = 4 / sizeof(T);  // elements a 32-bit register
  constexpr int STEPS = MAX_L / DEPTH;
  const int s = blockIdx.x, nb = B / SPLIT, b0 = blockIdx.y * nb;
  const int stride = L * (int)sizeof(T) + PAD;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  uint32_t a[STEPS][4];
  auto load_a = [&](int m0) {  // the band's A fragments, from M as it is
    const T* arow = M + (size_t)(m0 + g) * L;
    const T* arow8 = arow + (size_t)8 * L;
#pragma unroll
    for (int ks = 0; ks < STEPS; ks++) {
      const int k0 = ks * DEPTH;
      if (k0 < L) {
        a[ks][0] = ld32(arow + k0 + PER * t);
        a[ks][1] = ld32(arow8 + k0 + PER * t);
        a[ks][2] = ld32(arow + k0 + DEPTH / 2 + PER * t);
        a[ks][3] = ld32(arow8 + k0 + DEPTH / 2 + PER * t);
      }
    }
  };
  load_a(16 * warp);  // issued before the staging, so the loads overlap
  stage_t(smem, X + (size_t)s * L * B, L, B, b0, nb, stride);
  __syncthreads();
  for (int m0 = 16 * warp; m0 < K; m0 += 16 * (THREADS / 32)) {
    if (m0 != 16 * warp) load_a(m0);
    int32_t* o = out + ((size_t)s * K + m0 + g) * B + b0;
#pragma unroll 4
    for (int n0 = 0; n0 < nb; n0 += 8) {
      const unsigned char* bcol = smem + (size_t)(n0 + g) * stride;
      Acc c[4] = {0, 0, 0, 0};
#pragma unroll
      for (int ks = 0; ks < STEPS; ks++) {
        const int k0 = ks * DEPTH;
        if (k0 < L) {
          const uint32_t b[2] = {ld32(bcol + sizeof(T) * (k0 + PER * t)),
                                 ld32(bcol + sizeof(T) * (k0 + DEPTH / 2 + PER * t))};
          mma(c, a[ks], b);
        }
      }
      *reinterpret_cast<int2*>(o + n0 + 2 * t) = make_int2((int32_t)c[0], (int32_t)c[1]);
      *reinterpret_cast<int2*>(o + (size_t)8 * B + n0 + 2 * t) =
          make_int2((int32_t)c[2], (int32_t)c[3]);
    }
  }
}

// shapes: K a multiple of 64 (a band for every warp), B of 8 SPLIT, L of
// 32 (int8) or 16 (bf16) and at most MAX_L; the wrapper checks them
static int launch_checks(int S, int L, int K, int B, int elem, int depth, size_t* smem) {
  *smem = (size_t)(B / SPLIT) * (L * elem + PAD);
  if (S < 1 || K < 16 * (THREADS / 32) || K % (16 * (THREADS / 32)) || B % (8 * SPLIT) ||
      L % depth || L > MAX_L)
    return (int)cudaErrorInvalidValue;
  return 0;
}

extern "C" int lh_mma_probe_i8(const void* M, const void* X, int S, int L,
                               int K, int B, void* out, void* stream) {
  size_t smem;
  const int rc = launch_checks(S, L, K, B, 1, 32, &smem);
  if (rc) return rc;
  mma_probe_kernel<int8_t, int32_t, 32><<<dim3(S, SPLIT), THREADS, smem, (cudaStream_t)stream>>>(
      (const int8_t*)M, (const int8_t*)X, L, K, B, (int32_t*)out);
  return (int)cudaGetLastError();
}

extern "C" int lh_mma_probe_bf16(const void* M, const void* X, int S, int L,
                                 int K, int B, void* out, void* stream) {
  size_t smem;
  const int rc = launch_checks(S, L, K, B, 2, 16, &smem);
  if (rc) return rc;
  mma_probe_kernel<__nv_bfloat16, float, 16><<<dim3(S, SPLIT), THREADS, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)M, (const __nv_bfloat16*)X, L, K, B, (int32_t*)out);
  return (int)cudaGetLastError();
}
