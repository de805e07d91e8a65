// K2 -- the batched optimal-ate Miller loop, one lane group per pair.
//
// Replaces the TPU kernel lighthouse_tpu/ops/pallas_miller.py `_kernel`
// (reached through `miller_loop_pallas`): 63 iterations over the bits of
// |x| below its top bit, each f <- f^2 * l_{T,T}(P), T <- 2T, and on a set
// bit f <- f * l_{T,Q}(P), T <- T + Q; then the conjugate because x < 0.
// Masked pairs write f = 1, as the JAX wrapper's select does.
//
// What bounds it on the H100: the dependent chain of one pair. An
// iteration's products are independent in wide rounds -- f^2 (FP12_SQR, 36
// Fp products) beside the doubling step's first Fp2 products, the line
// product (LINE_MUL, 39) -- but the 63 iterations follow one another, so at
// the main path's 65 or 1,025 pairs the time is the chain's latency; at the
// per-set path's 61,440 pairs the card's integer multiply rate.
//
// Design: a group of G lanes (lanes.cuh, one warp) per pair runs the
// generated lane programs `dbl` and `dbl_add` of lane_programs.cuh, one
// call a bit of |x|, and `conj` at the end. They are the exact step
// formulas and line layout of ops/tpairing.py (`dbl_step`, `add_step`,
// `mul_by_line`, with f^2 by FP12_SQR), because a different line scaling
// changes f while keeping the pairing; ops/lanes.py schedules their
// products into steps: 5 steps an iteration, 7 with the addition
// (tests/test_torch_lane_programs.py emulates them against tpairing on the
// CPU). f, T, P and Q stay in the group's slot file in shared memory for
// the whole loop; each product is one lane's registers. Blocks hold GROUPS
// groups, so 61,440 pairs run as 7,680 blocks over the card's SMs.
//
// ptxas -v (nvcc 12.9, sm_90a): PERF.md lists registers and shared memory;
// no stack frame, no spills.

#include <cuda_runtime.h>

#include "lanes.cuh"

using namespace lanes;

constexpr int THREADS = K2::THREADS;
constexpr int GROUPS = THREADS / G;
constexpr int SMEM_BYTES = (K2::WORDS + GROUPS * NW * K2::NS) * 4;

__global__ void __launch_bounds__(THREADS)
    miller_kernel(const int32_t* __restrict__ px, const int32_t* __restrict__ py,
                  const int32_t* __restrict__ qx, const int32_t* __restrict__ qy,
                  const int32_t* __restrict__ mask, int B, int32_t* f_out) {
  extern __shared__ __align__(16) u32 smem[];
  copy_table<K2>(smem, K2_TABLE);
  const int group = threadIdx.x / G, lane = threadIdx.x % G;
  const int pair = blockIdx.x * GROUPS + group;
  if (pair >= B) return;  // the whole group
  u32* file = smem + K2::WORDS + group * NW * K2::NS;
  if (!mask[pair]) {
    set_one(file, K2::F, 12, lane);
  } else {
    load_value(file, K2::PX, 1, px, pair, B, lane);
    load_value(file, K2::PY, 1, py, pair, B, lane);
    load_value(file, K2::QX, 2, qx, pair, B, lane);
    load_value(file, K2::QY, 2, qy, pair, B, lane);
    load_value(file, K2::TX, 2, qx, pair, B, lane);
    load_value(file, K2::TY, 2, qy, pair, B, lane);
    set_one(file, K2::TZ, 2, lane);
    set_one(file, K2::F, 12, lane);
    group_sync();
    run_calls<K2>(smem, K2::CALLS_LOOP, K2::CALLS_LOOP_END, file, lane);
  }
  group_sync();
  store_value(f_out, pair, B, file, K2::F, 12, lane);
}

extern "C" int lh_miller(const void* px, const void* py, const void* qx,
                         const void* qy, const void* mask, int B, void* f_out,
                         void* stream) {
  cudaFuncSetAttribute(miller_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  const int blocks = (B + GROUPS - 1) / GROUPS;
  miller_kernel<<<blocks, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      (const int32_t*)px, (const int32_t*)py, (const int32_t*)qx,
      (const int32_t*)qy, (const int32_t*)mask, B, (int32_t*)f_out);
  return (int)cudaGetLastError();
}
