// Lane groups for K2 (miller.cu) and K3 (final_exp.cu): a group of G lanes
// runs the tower's bilinear programs on one Fp12 chain.
//
// An Fp value is 12 little-endian 32-bit words in Montgomery form (R =
// 2^384), canonical (< p) everywhere, like fp_reg.cuh's: a kernel built on
// this header agrees with the plain PyTorch versions word for word.
//
// The group's slot file. Each group owns NS Fp slots in shared memory, laid
// out [slot][word] (word j of slot s at file[12 s + j]), so a lane reads a
// slot as three 16-byte loads; eight lanes reading eight consecutive slots
// (48-byte stride) cover all 32 banks once, so the rows of a step, whose
// slots the generator allocates consecutively, load without conflicts. The
// kernel's table (lane_programs.cuh, generated by ops/lanes.py from
// ops/programs.py) is copied into shared memory at block start: programs
// -> steps -> rows -> terms, and a call list that runs programs on regions
// of the file.
//
// One step. Lane k takes rows k, k + G, ... of the step. A row's operand
// is sum_t c_t * slot_t (small signed coefficients, L1 norm <= 64); a MUL
// row forms two operands and multiplies them (one Montgomery product, in
// registers), a LIN row writes its one operand. Then a barrier. A step's
// rows never read what another row of the same step writes (the generator
// and its emulator check that), so one barrier a step is enough.
//
// The product and the operand sum live in fp_reg.cuh. `fp_mul` is SOS over
// 12 words (64-bit carries in the product, PTX carry chains in the
// reduction), fully unrolled, nothing in local memory;
// csrc/fp_product.cu times it alone. `lin_sum` accumulates each word in a
// 64-bit register, one multiply-add a word and term (a negative coefficient -k adds k times the
// complemented words, k (2^384 - 1 - x)), resolves the carries once with
// the offsets, estimates the quotient by p from words 11-12 and subtracts
// it; the proof that the estimate is floor(S / p) or one less, so that one
// conditional subtraction finishes, is in ops/lanes.py `lin_sum_words`,
// which the CPU tests run.
//
// The width G is one warp, joined by __syncwarp: the generated header's
// LANES, so that the tables, the kernels and ops/lanes.py's shared-memory
// figures share one constant. Two warps (a named barrier) took the 54
// products of an Fp12 product in one pass and made one chain faster, but
// cost the per-set path's full card more; PERF.md has the measurement.
#pragma once

#include <stdint.h>

#include "fp_reg.cuh"
#include "lane_programs.cuh"

namespace lanes {

typedef uint32_t u32;
typedef uint64_t u64;

constexpr int G = LANES;
static_assert(G == 32, "a lane group is one warp");

using fpr::fp_mul;
using fpr::lin_sum;
using fpr::load_slot;
using fpr::NW;
using fpr::ONE_W;
using fpr::slot_of;
using fpr::store_slot;

// one barrier for the lanes of this thread's group
__device__ __forceinline__ void group_sync() { __syncwarp(); }

// one row: w0 = dst reference (bits 0-11) | kind (bit 12: MUL) | left term
// count (bits 14-19) | right term count (bits 20-25); w1 = first term
__device__ __forceinline__ void run_row(const u32* tab, int rows, int terms, int r, u32* file,
                                        u32 bases) {
  const u32 w0 = tab[rows + 2 * r];
  const u32* t = tab + terms + (tab[rows + 2 * r + 1] & 0xffffu);
  const int nl = (w0 >> 14) & 63u;
  const bool mul = (w0 >> 12) & 1u;
  u32 x[NW];
  lin_sum(x, t, nl, file, bases, !mul);
  if (mul) {
    u32 y[NW];
    lin_sum(y, t + nl, (w0 >> 20) & 63u, file, bases, false);
    fp_mul(x, x, y);
  }
  store_slot(file, slot_of(w0, bases), x);
}

// calls [c0, c1) of K's call list; each call word is program | b1 << 8 |
// b2 << 16 | b3 << 24. A chain has L lanes (lane < L), G / L chains of a
// group run the same steps in lockstep and share its barriers.
template <class K, int L = G>
__device__ __noinline__ void run_calls(const u32* tab, int c0, int c1, u32* file, int lane) {
  static_assert(G % L == 0, "the chains of a group split it evenly");
  for (int c = c0; c < c1; c++) {
    const u32 call = tab[K::CALLS + c];
    const int prog = call & 255u;
    const int s1 = tab[K::PROGS + prog + 1];
    for (int s = tab[K::PROGS + prog]; s < s1; s++) {
      const int r1 = tab[K::STEPS + s + 1];
      for (int r = tab[K::STEPS + s] + lane; r < r1; r += L)
        run_row(tab, K::ROWS, K::TERMS, r, file, call & 0xffffff00u);
      group_sync();
    }
  }
}

// the kernel's table into shared memory, by the whole block
template <class K>
__device__ __forceinline__ void copy_table(u32* smem, const u32* table) {
  static_assert(K::WORDS % 4 == 0, "the slot files after the table stay 16-byte aligned");
  for (int i = threadIdx.x; i < K::WORDS; i += blockDim.x) smem[i] = table[i];
  __syncthreads();
}

// slots [base, base + n) <- column `col` of an (n, 12, cols) word operand
// (word j of slot s is element 12 s + j of both), by a chain's L lanes
template <int L = G>
__device__ __forceinline__ void load_value(u32* file, int base, int n, const int32_t* src,
                                           int col, int cols, int lane) {
  for (int i = lane; i < n * NW; i += L) file[NW * base + i] = (u32)src[(size_t)i * cols + col];
}

// column `col` of an (n, 12, cols) word operand <- slots [base, base + n)
template <int L = G>
__device__ __forceinline__ void store_value(int32_t* dst, int col, int cols, const u32* file,
                                            int base, int n, int lane) {
  for (int i = lane; i < n * NW; i += L) dst[(size_t)i * cols + col] = (int32_t)file[NW * base + i];
}

// slot `base` = 1 (Montgomery), slots base + 1 .. base + n - 1 = 0
__device__ __forceinline__ void set_one(u32* file, int base, int n, int lane) {
  for (int i = lane; i < n * NW; i += G) file[NW * base + i] = i < NW ? ONE_W[i] : 0u;
}

// does the Fp12 value in slots [base, base + 12) equal 1? (one lane)
__device__ __forceinline__ bool is_one(const u32* file, int base) {
  u32 acc = 0u;
  for (int i = 0; i < 12 * NW; i++) acc |= file[NW * base + i] ^ (i < NW ? ONE_W[i] : 0u);
  return acc == 0u;
}

}  // namespace lanes
