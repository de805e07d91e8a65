// Helper kernels between K1 and K2: one level of the projective lane-sum
// tree, and the batched projective -> affine conversion, for G1 and G2.
//
// On the TPU these steps are XLA, outside any Pallas kernel
// (lighthouse_tpu/ops/curve.py `_tree_fold_sum`, `tcurve.sum_lanes` and
// `ProjectiveGroup.to_affine`, called from ops/batch_verify.py). In eager
// PyTorch one Fermat inversion alone is thousands of tiny launches, so the
// port runs them as kernels built from the same header.
//
// What bounds them on the H100: integer multiply-adds. A lane-sum level is
// one complete addition per output lane (12 Fp products for G1, 36 for G2);
// the main path folds 30,720 G2 lanes in 15 levels, and the first level
// dominates. A to-affine lane is one Fermat inversion (381 squarings and
// ~190 products) and two products; the main path converts 65 lanes, so it
// is latency bound, like K2.
//
// Design: one thread per output lane. `lane_sum_level` adds lane j and lane
// j + seg/2 of every segment of `seg` lanes (power of two), so repeated
// launches reduce each segment to one point in the lane order of
// tcurve.sum_lanes; `to_affine` maps the identity to (0, 0) with its flag
// set, as ProjectiveGroup.to_affine does (inv(0) == 0).
//
// ptxas -v (nvcc 12.9, sm_90a), registers / per-thread stack frame, 0 bytes
// of register spills in all four: lane_sum G1 96 / 1,056 bytes, G2 128 /
// 2,352 bytes; to_affine G1 64 / 336 bytes, G2 80 / 816 bytes.

#include <cuda_runtime.h>

#include "bls12_381.cuh"

using namespace bls;

template <class F>
__global__ void lane_sum_level_kernel(const int32_t* __restrict__ X,
                                      const int32_t* __restrict__ Y,
                                      const int32_t* __restrict__ Z, int B_in,
                                      int seg, int32_t* oX, int32_t* oY,
                                      int32_t* oZ) {
  const int o = blockIdx.x * blockDim.x + threadIdx.x;
  const int half = seg / 2;
  const int B_out = B_in / 2;
  if (o >= B_out) return;
  const int g = o / half;
  const int j = o - g * half;
  Proj<F> a, b;
  proj_load(a, X, Y, Z, g * seg + j, B_in);
  proj_load(b, X, Y, Z, g * seg + j + half, B_in);
  proj_add(a, a, b);
  proj_store(oX, oY, oZ, o, B_out, a);
}

__device__ __forceinline__ void f_inv(Fp& r, const Fp& a) { fp_inv(r, a); }
__device__ __forceinline__ void f_inv(Fp2& r, const Fp2& a) { fp2_inv(r, a); }

template <class F>
__global__ void to_affine_kernel(const int32_t* __restrict__ X,
                                 const int32_t* __restrict__ Y,
                                 const int32_t* __restrict__ Z, int B,
                                 int32_t* ox, int32_t* oy, int32_t* inf) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  Proj<F> p;
  proj_load(p, X, Y, Z, lane, B);
  F zinv, x, y;
  f_inv(zinv, p.Z);
  f_mul(x, p.X, zinv);
  f_mul(y, p.Y, zinv);
  f_store(ox, lane, B, x);
  f_store(oy, lane, B, y);
  inf[lane] = f_is_zero(p.Z) ? 1 : 0;
}

template <class F>
static int launch_sum(const void* X, const void* Y, const void* Z, int B_in,
                      int seg, void* oX, void* oY, void* oZ, void* stream) {
  const int threads = 128;
  const int B_out = B_in / 2;
  const int blocks = (B_out + threads - 1) / threads;
  lane_sum_level_kernel<F><<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)X, (const int32_t*)Y, (const int32_t*)Z, B_in, seg,
      (int32_t*)oX, (int32_t*)oY, (int32_t*)oZ);
  return (int)cudaGetLastError();
}

template <class F>
static int launch_affine(const void* X, const void* Y, const void* Z, int B,
                         void* ox, void* oy, void* inf, void* stream) {
  const int threads = 64;
  const int blocks = (B + threads - 1) / threads;
  to_affine_kernel<F><<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)X, (const int32_t*)Y, (const int32_t*)Z, B,
      (int32_t*)ox, (int32_t*)oy, (int32_t*)inf);
  return (int)cudaGetLastError();
}

extern "C" int lh_lane_sum_level_g1(const void* X, const void* Y, const void* Z,
                                    int B_in, int seg, void* oX, void* oY,
                                    void* oZ, void* stream) {
  return launch_sum<Fp>(X, Y, Z, B_in, seg, oX, oY, oZ, stream);
}

extern "C" int lh_lane_sum_level_g2(const void* X, const void* Y, const void* Z,
                                    int B_in, int seg, void* oX, void* oY,
                                    void* oZ, void* stream) {
  return launch_sum<Fp2>(X, Y, Z, B_in, seg, oX, oY, oZ, stream);
}

extern "C" int lh_to_affine_g1(const void* X, const void* Y, const void* Z,
                               int B, void* ox, void* oy, void* inf,
                               void* stream) {
  return launch_affine<Fp>(X, Y, Z, B, ox, oy, inf, stream);
}

extern "C" int lh_to_affine_g2(const void* X, const void* Y, const void* Z,
                               int B, void* ox, void* oy, void* inf,
                               void* stream) {
  return launch_affine<Fp2>(X, Y, Z, B, ox, oy, inf, stream);
}
