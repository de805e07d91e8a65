// K3 -- the final exponentiation f^(3 (p^12 - 1) / r), in two entries:
//   fold     -- the product fold of the per-pair Miller outputs, then one
//               exponentiation: the Fp12 value and the verdict (value == 1)
//               of a whole RLC batch;
//   per set  -- for the per-set verdicts after a failed batch: set i's two
//               Miller values f[i] and f[S + i] multiplied, exponentiated,
//               compared with 1, one lane group per set.
//
// Replaces the TPU kernel lighthouse_tpu/ops/pallas_tail.py `_kernel`
// (reached through `final_exp_pallas` / `fold_final_exp_pallas`, which put
// the XLA lane fold `tfexp.fold_lanes` in front). On the TPU the fold stays
// at XLA level; the port has no XLA, so the fold is in this kernel too. The
// per-set entry is the counterpart of the JAX per-set tail,
// `tower.fp12_mul(f[:S], f[S:])` then `pairing.final_exponentiation`
// (ops/batch_verify.py `verify_signature_sets_individual`), which uses the
// same exponent, so values agree as well as verdicts.
//
// What bounds it on the H100: the fold entry is one dependent chain, so
// its time is the chain's critical path: 720 steps (357 Fp12 operations:
// 5 x (63 squarings + 5 products) and the rest), each one lane's operand
// sums, one register-resident product and a barrier, plus one Fp
// inversion of 485 dependent products on a single lane (4-bit windows of
// p - 2). The per-set entry runs S such chains; at a slot's 30,720 sets
// they fill the card, and its integer multiply rate bounds it.
//
// Design: a lane group (lanes.cuh) runs each Fp12 operation as a lane
// program of lane_programs.cuh (ops/lanes.py): FP12_MUL's 54 products or
// FP12_SQR's 36 on one lane each, then the 12 output slots of C. The
// addition chain of tfexp.final_exponentiation_t is the call lists FEXP_A
// and FEXP_B with the Fp inversion between them -- the exponent is
// 3 (p^12 - 1) / r, not the textbook (p^12 - 1) / r, so the value equals
// the JAX package's bit for bit (ops/lanes.py `k3_fexp_calls` says how it
// saves three conjugations). The fold entry is one block of FOLD_THREADS /
// G groups: the lane-halving tree of tfexp.fold_lanes (lanes i and i +
// half; an odd count carries its last lane) level by level between two
// scratch buffers in device memory, one group per product, a block barrier
// between levels; then group 0 runs the chain, its lane 0 the inversion.
// The per-set entry gives a set 16 lanes, two sets a warp in lockstep
// (FP12_SQR's 36 products: 3 passes for two sets instead of 2 for one),
// and inverts the Fp values of a block's 8 sets side by side, one lane
// each, between two block barriers -- 8 chains' inversions for the issue
// slots of one.
//
// ptxas -v (nvcc 12.9, sm_90a): PERF.md lists registers and shared memory
// per entry; no stack frame, no spills.

#include <cuda_runtime.h>

#include "lanes.cuh"

using namespace lanes;

constexpr int FOLD_THREADS = K3::FOLD_THREADS;
constexpr int FOLD_GROUPS = FOLD_THREADS / G;
constexpr int SET_THREADS = K3::SET_THREADS;
// the per-set entry runs G / SET_LANES sets a group in lockstep: FP12_SQR's
// 36 products take 3 passes of 16 lanes for two sets instead of 2 passes
// of 32 for one, its 12 output rows one pass for two (PERF.md compares 16
// with 32)
constexpr int SET_LANES = K3::SET_LANES;
constexpr int SET_GROUPS = SET_THREADS / SET_LANES;
constexpr int FILE_WORDS = NW * K3::NS;
constexpr int FOLD_SMEM = (K3::WORDS + FOLD_GROUPS * FILE_WORDS) * 4;
constexpr int SET_SMEM = (K3::WORDS + SET_GROUPS * FILE_WORDS) * 4;
static_assert(K3::CALLS_MUL_END == K3::CALLS_FEXP_A, "the per-set entry runs MUL, then FEXP_A");
static_assert(SET_GROUPS <= 32, "the first warp inverts for every group of a block");

// p - 2, little-endian words: the Fermat inversion exponent
static __device__ const u32 PM2_W[NW] = {
    0xffffaaa9u, 0xb9feffffu, 0xb153ffffu, 0x1eabfffeu, 0xf6b0f624u, 0x6730d2a0u,
    0xf38512bfu, 0x64774b84u, 0x434bacd7u, 0x4b1ba7b6u, 0x397fe69au, 0x1a0111eau};

// slot INV_OUT = slot INV_IN ^ (p - 2) (0 -> 0) in one group's file, by
// one lane: the table x^1 .. x^15 in slots INV_TABLE.., then per 4-bit
// window of p - 2 below its top window (1) four squarings and one table
// product (none for a zero window): 485 dependent products, ~100 fewer
// than bit by bit, the same value as the plain field.inv
__device__ __forceinline__ void fp_inv_window(u32* file) {
  u32 x[NW], acc[NW], y[NW];
  load_slot(x, file, K3::INV_IN);
  store_slot(file, K3::INV_TABLE, x);
#pragma unroll
  for (int j = 0; j < NW; j++) acc[j] = x[j];
  for (int k = 2; k < 16; k++) {
    fp_mul(acc, acc, x);
    store_slot(file, K3::INV_TABLE + k - 1, acc);
  }
#pragma unroll
  for (int j = 0; j < NW; j++) acc[j] = x[j];
  for (int i = 94; i >= 0; i--) {
    for (int k = 0; k < 4; k++) fp_mul(acc, acc, acc);
    const u32 d = (PM2_W[i >> 3] >> (4 * (i & 7))) & 15u;
    if (d) {
      load_slot(y, file, K3::INV_TABLE + d - 1);
      fp_mul(acc, acc, y);
    }
  }
  store_slot(file, K3::INV_OUT, acc);
}

// the Frobenius constants into a chain's slots [CONST_SLOT, + NCONST)
template <int L>
__device__ __forceinline__ void load_consts(u32* file, const u32* tab, int lane) {
  for (int i = lane; i < K3::NCONST * NW; i += L) file[NW * K3::CONST_SLOT + i] = tab[K3::CONSTS + i];
}

__global__ void __launch_bounds__(FOLD_THREADS)
    fold_final_exp_kernel(const int32_t* __restrict__ f_in, int B, int32_t* buf_a,
                          int32_t* buf_b, int32_t* out, int32_t* verdict) {
  extern __shared__ __align__(16) u32 smem[];
  copy_table<K3>(smem, K3_TABLE);
  const int group = threadIdx.x / G, lane = threadIdx.x % G;
  u32* file = smem + K3::WORDS + group * FILE_WORDS;
  load_consts<G>(file, smem, lane);
  const int32_t* src = f_in;
  int32_t* dst = buf_a;
  int n = B;
  while (n > 1) {
    const int half = n / 2;
    for (int i = group; i < half; i += FOLD_GROUPS) {
      load_value(file, K3::REG_A, 12, src, i, B, lane);
      load_value(file, K3::REG_B, 12, src, i + half, B, lane);
      group_sync();
      run_calls<K3>(smem, K3::CALLS_MUL, K3::CALLS_MUL_END, file, lane);
      store_value(dst, i, B, file, K3::REG_A, 12, lane);
    }
    if ((n & 1) && group == FOLD_GROUPS - 1) {  // an odd count carries its last lane
      for (int k = lane; k < 12 * NW; k += G)
        dst[(size_t)k * B + half] = src[(size_t)k * B + n - 1];
    }
    __syncthreads();
    src = dst;
    dst = dst == buf_a ? buf_b : buf_a;
    n = half + (n & 1);
  }
  if (group != 0) return;
  load_value(file, K3::REG_A, 12, src, 0, B, lane);
  group_sync();
  run_calls<K3>(smem, K3::CALLS_FEXP_A, K3::CALLS_FEXP_A_END, file, lane);
  if (lane == 0) fp_inv_window(file);
  group_sync();
  run_calls<K3>(smem, K3::CALLS_FEXP_B, K3::CALLS_FEXP_B_END, file, lane);
  store_value(out, 0, 1, file, K3::REG_A, 12, lane);
  if (lane == 0) verdict[0] = is_one(file, K3::REG_A) ? 1 : 0;
}

extern "C" int lh_fold_final_exp(const void* f_in, int B, void* buf_a,
                                 void* buf_b, void* out, void* verdict,
                                 void* stream) {
  cudaFuncSetAttribute(fold_final_exp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       FOLD_SMEM);
  fold_final_exp_kernel<<<1, FOLD_THREADS, FOLD_SMEM, (cudaStream_t)stream>>>(
      (const int32_t*)f_in, B, (int32_t*)buf_a, (int32_t*)buf_b,
      (int32_t*)out, (int32_t*)verdict);
  return (int)cudaGetLastError();
}

__global__ void __launch_bounds__(SET_THREADS)
    pair_final_exp_kernel(const int32_t* __restrict__ f_in, int S, int32_t* out,
                          int32_t* verdicts) {
  extern __shared__ __align__(16) u32 smem[];
  copy_table<K3>(smem, K3_TABLE);
  const int chain = threadIdx.x / SET_LANES, lane = threadIdx.x % SET_LANES;
  // every chain takes part in the block's barriers: past the last set a
  // chain repeats set S - 1 and stores nothing
  const int set = blockIdx.x * SET_GROUPS + chain;
  const int i = set < S ? set : S - 1;
  u32* file = smem + K3::WORDS + chain * FILE_WORDS;
  load_consts<SET_LANES>(file, smem, lane);
  load_value<SET_LANES>(file, K3::REG_A, 12, f_in, i, 2 * S, lane);
  load_value<SET_LANES>(file, K3::REG_B, 12, f_in, S + i, 2 * S, lane);
  group_sync();
  run_calls<K3, SET_LANES>(smem, K3::CALLS_MUL, K3::CALLS_FEXP_A_END, file, lane);  // MUL, FEXP_A
  __syncthreads();
  // the block's Fp inversions side by side: lane k of the first warp
  // inverts chain k's value
  if (threadIdx.x < SET_GROUPS) fp_inv_window(smem + K3::WORDS + threadIdx.x * FILE_WORDS);
  __syncthreads();
  run_calls<K3, SET_LANES>(smem, K3::CALLS_FEXP_B, K3::CALLS_FEXP_B_END, file, lane);
  if (set >= S) return;
  store_value<SET_LANES>(out, i, S, file, K3::REG_A, 12, lane);
  if (lane == 0) verdicts[i] = is_one(file, K3::REG_A) ? 1 : 0;
}

extern "C" int lh_pair_final_exp(const void* f_in, int S, void* out,
                                 void* verdicts, void* stream) {
  cudaFuncSetAttribute(pair_final_exp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       SET_SMEM);
  const int blocks = (S + SET_GROUPS - 1) / SET_GROUPS;
  pair_final_exp_kernel<<<blocks, SET_THREADS, SET_SMEM, (cudaStream_t)stream>>>(
      (const int32_t*)f_in, S, (int32_t*)out, (int32_t*)verdicts);
  return (int)cudaGetLastError();
}
