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
// What bounds it on the H100: at the probe's size nothing but the launch.
// The contraction is 9.4M multiply-adds (5 ns at the int8 rate) and 0.67 MB
// of operands and results (0.2 us at 3.35 TB/s), far under a launch.
//
// Design: hand-written `mma.sync` (Hopper runs the Ampere warp-level MMA;
// `wgmma` needs 64-row tiles, which this probe does not have):
//   int8 -- mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32
//   bf16 -- mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32
// One block per (16-row band of M, s): it stages the band of M (16 x L,
// row-major) and X[s] transposed (B x L, so each fragment register holds
// consecutive k of one column) in shared memory; each warp then owns 16 x 8
// output tiles, loads its fragments from shared memory in the PTX ISA's
// fragment layouts (groupID = lane / 4, threadID_in_group = lane % 4) and
// accumulates over L in steps of 32 (int8) or 16 (bf16). The float32 sums
// of the bf16 form are exact integers and leave as int32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

template <class T>
__device__ __forceinline__ uint32_t ld32(const T* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// band [m0, m0 + 16) of M and X[s] transposed into shared memory
template <class T>
__device__ __forceinline__ void stage(T* sA, T* sBT, const T* M, const T* X,
                                      int s, int m0, int L, int B) {
  for (int i = threadIdx.x; i < 16 * L; i += blockDim.x)
    sA[i] = M[(size_t)m0 * L + i];
  const T* Xs = X + (size_t)s * L * B;
  for (int i = threadIdx.x; i < L * B; i += blockDim.x) {
    const int l = i / B, b = i % B;  // read along b: coalesced
    sBT[b * L + l] = Xs[i];
  }
  __syncthreads();
}

template <class Acc>
__device__ __forceinline__ void store_tile(int32_t* out, const Acc (&c)[4],
                                           int s, int m0, int n0, int K, int B,
                                           int g, int t) {
  int32_t* o = out + ((size_t)s * K + m0) * B + n0;
  o[g * B + 2 * t] = (int32_t)c[0];
  o[g * B + 2 * t + 1] = (int32_t)c[1];
  o[(g + 8) * B + 2 * t] = (int32_t)c[2];
  o[(g + 8) * B + 2 * t + 1] = (int32_t)c[3];
}

__global__ void mma_probe_i8_kernel(const int8_t* __restrict__ M,
                                    const int8_t* __restrict__ X, int L, int K,
                                    int B, int32_t* out) {
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* sA = reinterpret_cast<int8_t*>(smem);
  int8_t* sBT = sA + 16 * L;
  const int m0 = blockIdx.x * 16, s = blockIdx.y;
  stage(sA, sBT, M, X, s, m0, L, B);
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  for (int nt = threadIdx.x >> 5; nt < B / 8; nt += blockDim.x >> 5) {
    const int8_t* bcol = sBT + (nt * 8 + g) * L;
    int32_t c[4] = {0, 0, 0, 0};
    for (int k0 = 0; k0 < L; k0 += 32) {
      const uint32_t a0 = ld32(sA + g * L + k0 + 4 * t);
      const uint32_t a1 = ld32(sA + (g + 8) * L + k0 + 4 * t);
      const uint32_t a2 = ld32(sA + g * L + k0 + 16 + 4 * t);
      const uint32_t a3 = ld32(sA + (g + 8) * L + k0 + 16 + 4 * t);
      const uint32_t b0 = ld32(bcol + k0 + 4 * t);
      const uint32_t b1 = ld32(bcol + k0 + 16 + 4 * t);
      asm volatile(
          "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
          : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
          : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
    }
    store_tile(out, c, s, m0, nt * 8, K, B, g, t);
  }
}

__global__ void mma_probe_bf16_kernel(const __nv_bfloat16* __restrict__ M,
                                      const __nv_bfloat16* __restrict__ X,
                                      int L, int K, int B, int32_t* out) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sA = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sBT = sA + 16 * L;
  const int m0 = blockIdx.x * 16, s = blockIdx.y;
  stage(sA, sBT, M, X, s, m0, L, B);
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  for (int nt = threadIdx.x >> 5; nt < B / 8; nt += blockDim.x >> 5) {
    const __nv_bfloat16* bcol = sBT + (nt * 8 + g) * L;
    float c[4] = {0.f, 0.f, 0.f, 0.f};
    for (int k0 = 0; k0 < L; k0 += 16) {
      const uint32_t a0 = ld32(sA + g * L + k0 + 2 * t);
      const uint32_t a1 = ld32(sA + (g + 8) * L + k0 + 2 * t);
      const uint32_t a2 = ld32(sA + g * L + k0 + 8 + 2 * t);
      const uint32_t a3 = ld32(sA + (g + 8) * L + k0 + 8 + 2 * t);
      const uint32_t b0 = ld32(bcol + k0 + 2 * t);
      const uint32_t b1 = ld32(bcol + k0 + 8 + 2 * t);
      asm volatile(
          "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
          : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
          : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
    }
    store_tile(out, c, s, m0, nt * 8, K, B, g, t);
  }
}

// shapes: K a multiple of 16, B of 8, L of 32 (int8) or 16 (bf16); the
// wrapper checks them, and the staged operands must fit in 48 KB
static int grid_for(int S, int L, int K, int B, int elem, dim3* grid,
                    size_t* smem) {
  *smem = (size_t)(16 + B) * L * elem;
  if (S < 1 || K % 16 || B % 8 || *smem > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  *grid = dim3(K / 16, S);
  return 0;
}

extern "C" int lh_mma_probe_i8(const void* M, const void* X, int S, int L,
                               int K, int B, void* out, void* stream) {
  dim3 grid;
  size_t smem;
  if (L % 32) return (int)cudaErrorInvalidValue;
  int rc = grid_for(S, L, K, B, 1, &grid, &smem);
  if (rc) return rc;
  mma_probe_i8_kernel<<<grid, 128, smem, (cudaStream_t)stream>>>(
      (const int8_t*)M, (const int8_t*)X, L, K, B, (int32_t*)out);
  return (int)cudaGetLastError();
}

extern "C" int lh_mma_probe_bf16(const void* M, const void* X, int S, int L,
                                 int K, int B, void* out, void* stream) {
  dim3 grid;
  size_t smem;
  if (L % 16) return (int)cudaErrorInvalidValue;
  int rc = grid_for(S, L, K, B, 2, &grid, &smem);
  if (rc) return rc;
  mma_probe_bf16_kernel<<<grid, 128, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)M, (const __nv_bfloat16*)X, L, K, B,
      (int32_t*)out);
  return (int)cudaGetLastError();
}
