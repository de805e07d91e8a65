// Lane groups for K2 (miller.cu) and K3 (final_exp.cu): a group of G lanes
// runs the tower's bilinear programs on one Fp12 chain.
//
// An Fp value is 12 little-endian 32-bit words in Montgomery form (R =
// 2^384), canonical (< p) everywhere, like bls12_381.cuh's: a kernel built
// on this header agrees with the plain PyTorch versions word for word.
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
// The product. `fp_mul` is SOS over 12 words in 64-bit registers, fully
// unrolled, nothing in local memory; csrc/fp_product.cu times it alone.
// It was faster on the card than CIOS with 64-bit carries and than CIOS
// with PTX carry chains (mad.lo.cc / madc.hi.cc): PERF.md. The
// operand sum `lin_sum` accumulates each word in a 64-bit register, one
// multiply-add a word and term (a negative coefficient -k adds k times the
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

#include "lane_programs.cuh"

namespace lanes {

typedef uint32_t u32;
typedef uint64_t u64;

constexpr int G = LANES;
static_assert(G == 32, "a lane group is one warp");

constexpr int NW = 12;  // 32-bit words per Fp element
constexpr u32 N0 = 0xfffcfffdu;  // -p^-1 mod 2^32
// floor(p / 2^352) + 1: the divisor of lin_sum's quotient estimate
constexpr u64 P_TOP1 = 0x1a0111ebull;

#define LH_P_WORDS                                                                \
  0xffffaaabu, 0xb9feffffu, 0xb153ffffu, 0x1eabfffeu, 0xf6b0f624u, 0x6730d2a0u, \
      0xf38512bfu, 0x64774b84u, 0x434bacd7u, 0x4b1ba7b6u, 0x397fe69au, 0x1a0111eau
// R mod p, the Montgomery one
static __device__ const u32 ONE_W[NW] = {
    0x0002fffdu, 0x76090000u, 0xc40c0002u, 0xebf4000bu, 0x53c758bau, 0x5f489857u,
    0x70525745u, 0x77ce5853u, 0xa256ec6du, 0x5c071a97u, 0xfa80e493u, 0x15f65ec3u};

// one barrier for the lanes of this thread's group
__device__ __forceinline__ void group_sync() { __syncwarp(); }

// t (< 2p) -> t mod p
__device__ __forceinline__ void reduce_once(u32 r[NW], const u32 t[NW]) {
  const u32 pw[NW] = {LH_P_WORDS};
  u32 s[NW];
  u64 borrow = 0;
#pragma unroll
  for (int k = 0; k < NW; k++) {
    const u64 d = (u64)t[k] - pw[k] - borrow;
    s[k] = (u32)d;
    borrow = d >> 63;
  }
#pragma unroll
  for (int k = 0; k < NW; k++) r[k] = borrow ? t[k] : s[k];  // borrow <=> t < p
}

// r = a b 2^-384 mod p for a, b < 2p (r may alias either): SOS, the
// 24-word product a b row by row, then 12 Montgomery reduction rows, each
// row's carry in a 64-bit register. Before the last subtraction the value
// is (a b + m p) / 2^384 < (4 p^2 + 2^384 p) / 2^384 < 2p, as p < 2^381.
__device__ __forceinline__ void fp_mul(u32 r[NW], const u32 a[NW], const u32 b[NW]) {
  const u32 pw[NW] = {LH_P_WORDS};
  u32 t[2 * NW + 1];
#pragma unroll
  for (int k = 0; k < 2 * NW + 1; k++) t[k] = 0u;
#pragma unroll
  for (int i = 0; i < NW; i++) {
    u64 c = 0;
#pragma unroll
    for (int j = 0; j < NW; j++) {
      c += (u64)a[j] * b[i] + t[i + j];
      t[i + j] = (u32)c;
      c >>= 32;
    }
    t[i + NW] = (u32)c;
  }
#pragma unroll
  for (int i = 0; i < NW; i++) {
    const u32 m = t[i] * N0;
    u64 c = 0;
#pragma unroll
    for (int j = 0; j < NW; j++) {
      c += (u64)m * pw[j] + t[i + j];
      t[i + j] = (u32)c;
      c >>= 32;
    }
#pragma unroll
    for (int k = i + NW; k < 2 * NW + 1; k++) {
      c += t[k];
      t[k] = (u32)c;
      c >>= 32;
    }
  }
  reduce_once(r, t + NW);
}

// slot of a 12-bit reference: offset (bits 0-9) plus the base of region r
// (bits 10-11), byte r of `bases` (the call word with its low byte, the
// program, cleared: region 0 is absolute)
__device__ __forceinline__ int slot_of(u32 ref, u32 bases) {
  return (int)(ref & 1023u) + (int)((bases >> (8u * ((ref >> 10) & 3u))) & 255u);
}

// slot s of a group's file, as three 16-byte words
__device__ __forceinline__ void load_slot(u32 x[NW], const u32* file, int s) {
  const uint4* p = reinterpret_cast<const uint4*>(file + NW * s);
#pragma unroll
  for (int q = 0; q < 3; q++) {
    const uint4 v = p[q];
    x[4 * q] = v.x;
    x[4 * q + 1] = v.y;
    x[4 * q + 2] = v.z;
    x[4 * q + 3] = v.w;
  }
}

__device__ __forceinline__ void store_slot(u32* file, int s, const u32 x[NW]) {
  uint4* p = reinterpret_cast<uint4*>(file + NW * s);
#pragma unroll
  for (int q = 0; q < 3; q++)
    p[q] = make_uint4(x[4 * q], x[4 * q + 1], x[4 * q + 2], x[4 * q + 3]);
}

// x = sum_t c_t slot_t mod p over n terms (bits 0-11 the slot reference,
// bits 12-31 the signed coefficient): canonical, or only < 2p where it is a
// product's operand (fp_mul's result stays below 2p before its subtraction
// for operands below 2p, since 4p < 2^384)
__device__ __forceinline__ void lin_sum(u32 x[NW], const u32* terms, int n, const u32* file,
                                        u32 bases, bool canonical) {
  const u32 first = terms[0];
  if (n == 1 && (first >> 12) == 1u) {  // one slot as it is
    load_slot(x, file, slot_of(first, bases));
    return;
  }
  // acc_j = sum_t k_t (word j of x_t, complemented where c_t = -k_t < 0)
  u64 acc[NW];
#pragma unroll
  for (int j = 0; j < NW; j++) acc[j] = 0ull;
  u32 kneg = 0u;
  for (int t = 0; t < n; t++) {
    const u32 term = terms[t];
    const int c = (int)term >> 12;
    const u32 m = c < 0 ? 0xffffffffu : 0u;
    const u32 k = c < 0 ? (u32)(-c) : (u32)c;
    kneg += k & m;
    u32 v[NW];
    load_slot(v, file, slot_of(term, bases));
#pragma unroll
    for (int j = 0; j < NW; j++) acc[j] += (u64)(v[j] ^ m) * k;
  }
  // sum_j acc_j 2^(32 j) = S + kneg (2^384 - 1) for S = sum_t c_t x_t, so
  // S + kneg p = that - kneg 2^384 + kneg + kneg p, in [0, 64 p]
  const u32 pw[NW] = {LH_P_WORDS};
  u32 w[NW + 1];
  u64 carry = kneg;
#pragma unroll
  for (int j = 0; j < NW; j++) {
    const u64 v = acc[j] + carry + (u64)kneg * pw[j];
    w[j] = (u32)v;
    carry = v >> 32;
  }
  w[NW] = (u32)carry - kneg;
  // q = floor((S >> 352) / (floor(p / 2^352) + 1)) is floor(S / p) or one
  // less, so r = S - q p < 2p
  const u32 q = (u32)((((u64)w[NW] << 32) | w[NW - 1]) / P_TOP1);
  u32 r[NW];
  u64 qc = 0, borrow = 0;
#pragma unroll
  for (int j = 0; j < NW; j++) {
    qc += (u64)q * pw[j];
    const u64 d = (u64)w[j] - (u32)qc - borrow;
    r[j] = (u32)d;
    borrow = d >> 63;
    qc >>= 32;
  }
  if (canonical) {
    reduce_once(x, r);
  } else {
#pragma unroll
    for (int j = 0; j < NW; j++) x[j] = r[j];
  }
}

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
