// The G2 subgroup check: [r] P == O for each lane, on affine points of the
// twist E'(Fp2) that nobody has checked yet (gossip signatures).
//
// Replaces lighthouse_tpu/ops/batch_verify.py `g2_points_in_subgroup`,
// which is XLA on the TPU: a lax.scan over r's 255 bits, LSB first, whose
// step computes the unified Jacobian addition acc + addend on every bit,
// keeps it where the bit is set, and doubles the addend
// (ops/curve.py `JacobianGroup.add` / `double`). The plain version is
// lighthouse_tpu_torch/ops/subgroup.py `g2_in_subgroup_plain`.
//
// What bounds it on the H100: integer multiply-adds. The formulas' count is
// 254 doublings (7 Fp2 products each) and 134 additions (16 each) a lane,
// 11,766 Fp products at Karatsuba's three (subgroup.kernel_products, the
// bound's yardstick). The bytes are 48 words in and one out a lane. r's bits
// are the same for every lane, so a branch on a bit is uniform across a
// warp: the addition runs on r's 134 set bits only, and the scan's dead
// last doubling not at all.
//
// Design: lane groups (K1's, csrc/ladder.cu). T = 4 threads run one lane;
// its values live in a file of 34 Fp slots in shared memory (the
// accumulator, the addend and the temporaries, allocated by liveness); its
// products are register-resident and inlined (fp_reg.cuh, fp2_row.cuh), so
// nothing of the field arithmetic is in local memory. A bit is one program
// of rounds, each a MUL phase and a LIN phase (one canonical `lin_sum` an
// Fp output), a warp barrier after each. A set bit runs FUSED: the addition
// and the addend's doubling in six rounds of 4, 4, 4, 4, 4 and 3 Fp2
// products, where the two in sequence take nine; a clear bit runs DBL,
// three rounds; r's top bit ADD, the addition alone. A MUL round's products
// are whole Karatsuba rows (three 24-word products, two reductions: K1's
// lazy row) or, where that leaves threads idle or the products are
// squares, half rows of one Fp component each ((A0 + A1)(A0 - A1) or
// 2 A0 A1 for a square: one product, one reduction). The kernel runs every
// row as product micro-ops from the table -- two operands formed from the
// file, one 24-word product, a signed sum into T0 or T1, and after a row's
// last one its reductions -- so there is one site each for the 24-word
// product, the reduction and `lin_sum`: one phase loop runs every program.
// The product and the reduction are fp_reg.cuh's `mul_wide` and
// `mont_reduce`, as in every field kernel.
// A clear bit costs a warp 9 products and reductions where three rounds of
// whole rows cost 15, a set bit 28 where they cost 30: 4,837 a lane over r
// (subgroup_rows.lane_work), against 3,922 Fp2 products (2.5 Fp products'
// multiply-adds each, 9,805). The rows, their slots and the programs are
// generated (subgroup_rows.cuh from ops/subgroup_rows.py, which checks the
// slot map and runs the table on Python integers for the CPU tests).
//
// Why four threads a lane and not K1's two: a set bit's 23 products fit six
// rounds of four threads, the shortest chain its six dependent rounds
// allow, so a lane's chain is half of two threads' (which matters at a
// gossip batch's ~1,000 lanes, where the card has a block or so an SM);
// and a lane's 34 slots serve four threads, so shared memory holds twice
// the warps it would at two. From 2 warps a scheduler the card is issue
// bound (PERF.md), and the time follows the instructions a warp
// issues, idle threads' included: hence the half rows.
//
// The selects of JacobianGroup.add are per lane, as every value is
// canonical and a zero test is a test of the words:
//   * Z1 = 0 (the accumulator at infinity: every lane at bit 0): the sum
//     is the addend, copied into acc before the program, whose sum the
//     lane then does not keep;
//   * Z2 = 0 (the addend at infinity): the sum is acc, kept as it is;
//   * H = 0 and R = 0 (acc == addend): the doubling of acc. The program's
//     conditional rows leave acc as it was, and the warp runs DBL_ACC, the
//     doubling on acc's slots, when any of its lanes needs it (a warp vote
//     after the program); only those lanes store its result. Only
//     adversarial points take this (a point of order 13 does), so an honest
//     warp never pays for it;
//   * H = 0 and R != 0 (acc == -addend): the generic formulas give Z3 = 0.
// A lane's accumulator equals the plain ladder's words after every bit, on
// any input, points off the curve included. A masked lane passes without
// work.
//
// Occupancy: a block is one warp, 8 lanes, 13,184 bytes of static shared
// memory (8 x 412 words); __launch_bounds__ asks for 16 blocks an SM, which
// holds the registers to 128 a thread, and shared memory allows 16: 128
// lanes an SM, 16,896 lanes a wave on 132 SMs, so the slot's 30,720 lanes
// are 1.8 waves and a 1,024-lane batch one block an SM. chip_smoke.py
// prints ptxas's registers, stack frame and spills, and the blocks an SM
// that the CUDA runtime reports (`lh_g2_subgroup_blocks_per_sm`), with the
// lanes an SM and the waves they give.

#include <cuda_runtime.h>

#include "fp2_row.cuh"
#include "fp_reg.cuh"
#include "subgroup_rows.cuh"

namespace sg {

using fpr::add_words;
using fpr::fp_add;
using fpr::fp_sub;
using fpr::lin_sum;
using fpr::load_slot;
using fpr::mont_reduce;
using fpr::mul_wide;
using fpr::NW;
using fpr::ONE_W;
using fpr::store_slot;
using fpr::u32;
using sgrows::BLOCK;
using sgrows::T;
using fpr::wide_acc;

constexpr int LANES = BLOCK / T;  // lanes a block
constexpr int MIN_BLOCKS = 16;    // blocks an SM the registers must allow
static_assert(sgrows::LANE_WORDS % 4 == 0, "a lane's file starts on 16 bytes");

// whether the Fp2 value at Fp slots s, s + 1 of a file is 0
__device__ __forceinline__ bool fp2_zero(const u32* f, int s) {
  const uint4* p = reinterpret_cast<const uint4*>(f + NW * s);
  u32 o = 0u;
#pragma unroll
  for (int q = 0; q < 6; q++) {
    const uint4 v = p[q];
    o |= v.x | v.y | v.z | v.w;
  }
  return o == 0u;
}

// component c of the value at Fp slot s (plus the value at s2 unless
// NONE), canonical
__device__ __forceinline__ void component(u32 x[NW], const u32* f, u32 s, u32 s2, u32 c) {
  load_slot(x, f, s + c);
  if (s2 != sgrows::NONE) {
    u32 u[NW];
    load_slot(u, f, s2 + c);
    fp_add(x, x, u);
  }
}

// a micro-op's operand (subgroup_rows._opcode): component u, plus
// component v (below 2p) or minus it (mod p) unless v is NO_V
__device__ __forceinline__ void operand(u32 x[NW], const u32* f, u32 code) {
  const u32 s = code & 63u, s2 = (code >> 6) & 63u, v = (code >> 13) & 3u;
  component(x, f, s, s2, (code >> 12) & 1u);
  if (v != sgrows::NO_V) {
    u32 w[NW];
    component(w, f, s, s2, v);
    if ((code >> 15) & 1u)
      fp_sub(x, x, w);
    else
      add_words(x, x, w);
  }
}

// this thread's entries of global phase q. A MUL phase's are product
// micro-ops (subgroup_rows.micro_ops): each forms two operands, adds its
// 24-word product to or takes it from T0 = p^2 + .. and T1 = 2 p^2 + ..,
// and a row's last one reduces T0 into dst (a whole product: and T1 into
// dst + 1); a whole Karatsuba row is three micro-ops, a half row of one Fp
// component one or two. A LIN phase's are rows of one canonical Fp sum, a
// conditional row stored only where the lane keeps the step's sum.
__device__ __forceinline__ void phase_rows(u32* f, int q, int tid, bool keep) {
  const u32 idx = sgrows::TABLE[q * T + tid];
  const int r0 = idx & 0xffffu, n = idx >> 16;
  if ((q & 1) == 0) {
    u32 T0[2 * NW + 1], T1[2 * NW + 1];
#pragma unroll
    for (int k = 0; k < 2 * NW + 1; k++) {
      T0[k] = k < 2 * NW ? fpr::P2_W[k] : 0u;
      T1[k] = k < 2 * NW ? fpr::P2X2_W[k] : 0u;
    }
#pragma unroll 1
    for (int k = 0; k < n; k++) {
      const u32 ops = sgrows::TABLE[r0 + 2 * k], w = sgrows::TABLE[r0 + 2 * k + 1];
      u32 x[NW], y[NW], t[2 * NW + 1];
      operand(x, f, ops & 0xffffu);
      operand(y, f, ops >> 16);
      mul_wide(t, x, y);
      if (w & 3u) wide_acc(T0, t, (w & 3u) == sgrows::ACC_SUB, true);
      if ((w >> 2) & 3u) wide_acc(T1, t, ((w >> 2) & 3u) == sgrows::ACC_SUB, true);
      const int reductions = (w >> 4) & 3u;
      if (reductions) {
#pragma unroll 1
        for (int j = 0; j < reductions; j++) {
          u32 v[NW];
#pragma unroll
          for (int i = 0; i < 2 * NW + 1; i++) t[i] = j ? T1[i] : T0[i];
          mont_reduce(v, t);
          store_slot(f, (w >> 6) + j, v);
        }
#pragma unroll
        for (int i = 0; i < 2 * NW + 1; i++) {
          T0[i] = i < 2 * NW ? fpr::P2_W[i] : 0u;
          T1[i] = i < 2 * NW ? fpr::P2X2_W[i] : 0u;
        }
      }
    }
    return;
  }
#pragma unroll 1
  for (int k = 0; k < n; k++) {
    const u32 r = sgrows::TABLE[r0 + k];
    u32 x[NW];
    lin_sum(x, sgrows::TABLE + (r >> 16), (r >> 8) & 255u, f, 0u, true);
    if (keep || !(r & sgrows::COND)) store_slot(f, r & 63u, x);
  }
}

// out[lane] = 1 iff [r] (x, y) == O or the lane is masked. x, y: (2, 12, B)
// canonical Montgomery words, batch last.
__global__ void __launch_bounds__(BLOCK, MIN_BLOCKS)
    g2_subgroup_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ y,
                       const int32_t* __restrict__ mask, int B, int32_t* __restrict__ out) {
  __shared__ uint4 smem[LANES * sgrows::LANE_WORDS / 4];
  const int tid = threadIdx.x % T, g = threadIdx.x / T;
  const int lane = blockIdx.x * LANES + g;
  const bool live = lane < B && mask[lane] != 0;
  const unsigned warp = __ballot_sync(0xffffffffu, live);
  if (!live) {
    if (lane < B && tid == 0) out[lane] = 1;  // a masked lane passes
    return;
  }
  u32* f = reinterpret_cast<u32*>(smem) + g * sgrows::LANE_WORDS;
  // acc <- the point at infinity (1, 1, 0), addend <- (x, y, 1): Fp slots
  // 0..11, word i of the file on thread i mod T
  for (int i = tid; i < 12 * NW; i += T) {
    const int s = i / NW, k = i % NW;
    u32 v;
    if (s >= sgrows::X2 && s < sgrows::Y2)
      v = (u32)x[(size_t)((s - sgrows::X2) * NW + k) * B + lane];
    else if (s >= sgrows::Y2 && s < sgrows::Z2)
      v = (u32)y[(size_t)((s - sgrows::Y2) * NW + k) * B + lane];
    else
      v = s == sgrows::X1 || s == sgrows::Y1 || s == sgrows::Z2 ? ONE_W[k] : 0u;
    f[i] = v;
  }
  __syncwarp(warp);
  for (int i = 0; i < sgrows::R_BITS; i++) {
    const bool bit = (sgrows::R_W[i >> 5] >> (i & 31)) & 1u;  // the same for every lane
    int prog = bit ? (i + 1 < sgrows::R_BITS ? sgrows::FUSED : sgrows::ADD) : sgrows::DBL;
    bool inf1 = false, inf2 = false, keep = false, dbl = false;
    if (bit) {
      inf1 = fp2_zero(f, sgrows::Z1);
      inf2 = fp2_zero(f, sgrows::Z2);
      __syncwarp(warp);  // every thread has read Z1 before a copy overwrites it
      if (inf1)  // acc at infinity: the sum is the addend
        for (int w = tid; w < 6 * NW / 4; w += T)
          reinterpret_cast<uint4*>(f)[w] = reinterpret_cast<const uint4*>(f + 6 * NW)[w];
      __syncwarp(warp);
    }
    // the bit's program, then DBL_ACC where a lane of the warp has acc == addend
    for (;;) {
      const sgrows::Program pr = sgrows::PROGRAMS[prog];
#pragma unroll 1
      for (int ph = 0; ph < pr.phases; ph++) {
        phase_rows(f, pr.first + ph, tid, keep);
        __syncwarp(warp);
        if (ph == pr.test) {  // H and R in place: the selects
          const bool same = fp2_zero(f, pr.h) && fp2_zero(f, pr.r);
          dbl = !inf1 && !inf2 && same;
          keep = !inf1 && !inf2 && !same;
        }
      }
      if (prog == sgrows::DBL_ACC || !__any_sync(warp, dbl)) break;
      prog = sgrows::DBL_ACC;
      keep = dbl;
    }
  }
  if (tid == 0) out[lane] = fp2_zero(f, sgrows::Z1) ? 1 : 0;
}

}  // namespace sg

// the carveout that lets shared memory hold the blocks __launch_bounds__
// asks for, set once
static cudaError_t prefer_shared() {
  static const cudaError_t rc = cudaFuncSetAttribute(
      sg::g2_subgroup_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
      cudaSharedmemCarveoutMaxShared);
  return rc;
}

extern "C" int lh_g2_subgroup(const void* x, const void* y, const void* mask, int B, void* out,
                              void* stream) {
  if (prefer_shared() != cudaSuccess) return (int)prefer_shared();
  const int blocks = (B + sg::LANES - 1) / sg::LANES;
  sg::g2_subgroup_kernel<<<blocks, sgrows::BLOCK, 0, (cudaStream_t)stream>>>(
      (const int32_t*)x, (const int32_t*)y, (const int32_t*)mask, B, (int32_t*)out);
  return (int)cudaGetLastError();
}

// *blocks (a host int) = the kernel's resident blocks an SM on the current
// device, as the CUDA runtime reports them
extern "C" int lh_g2_subgroup_blocks_per_sm(void* blocks, void* stream) {
  (void)stream;
  if (prefer_shared() != cudaSuccess) return (int)prefer_shared();
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor((int*)blocks, sg::g2_subgroup_kernel,
                                                            sgrows::BLOCK, 0);
}
