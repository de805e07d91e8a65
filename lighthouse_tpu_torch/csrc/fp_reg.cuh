// Register-resident Fp arithmetic: 12 little-endian 32-bit words in
// Montgomery form (R = 2^384), every function fully inlined, nothing in
// local memory, and a slot file's loads, stores and operand sums. K2 and K3
// (lanes.cuh), K1 (ladder.cu) and the helpers (curve_helpers.cu) run their
// products and sums here; csrc/fp_product.cu times `fp_mul` alone.
//
// `fp_mul` is SOS over 12 words with 64-bit carries. It was faster on the
// card than CIOS with 64-bit carries and than CIOS with PTX carry chains
// (mad.lo.cc / madc.hi.cc): PERF.md. It takes operands below 2p and
// returns a canonical value (< p); the sums and differences below take and
// return canonical values.
#pragma once

#include <stdint.h>

namespace fpr {

typedef uint32_t u32;
typedef uint64_t u64;

constexpr int NW = 12;  // 32-bit words per Fp element
constexpr u32 N0 = 0xfffcfffdu;  // -p^-1 mod 2^32

#define LH_P_WORDS                                                                \
  0xffffaaabu, 0xb9feffffu, 0xb153ffffu, 0x1eabfffeu, 0xf6b0f624u, 0x6730d2a0u, \
      0xf38512bfu, 0x64774b84u, 0x434bacd7u, 0x4b1ba7b6u, 0x397fe69au, 0x1a0111eau
// R mod p, the Montgomery one
static __device__ const u32 ONE_W[NW] = {
    0x0002fffdu, 0x76090000u, 0xc40c0002u, 0xebf4000bu, 0x53c758bau, 0x5f489857u,
    0x70525745u, 0x77ce5853u, 0xa256ec6du, 0x5c071a97u, 0xfa80e493u, 0x15f65ec3u};

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

// t = a b, 24 words and a zero top word, for a, b < 2p: the product rows
// of SOS, each row's carry in a 64-bit register
__device__ __forceinline__ void mul_wide(u32 t[2 * NW + 1], const u32 a[NW], const u32 b[NW]) {
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
}

// r = t 2^-384 mod p, canonical, for t < p 2^384 (t is overwritten): 12
// Montgomery reduction rows. A row's carry out of word i + 11 is not
// rippled up the words above: the next row takes it into its last step,
// which adds into that very word (p's top word is below 2^29, so m p_11 +
// a word + both carries stays below 2^62), and the last row's carry goes
// into word 23. Before the last subtraction the value is (t + m p) / 2^384
// < (p 2^384 + 2^384 p) / 2^384 = 2p, so word 23 takes that carry without
// overflow and word 24 stays 0.
__device__ __forceinline__ void mont_reduce(u32 r[NW], u32 t[2 * NW + 1]) {
  const u32 pw[NW] = {LH_P_WORDS};
  u32 carry = 0u;  // the previous row's carry into word i + 11
#pragma unroll
  for (int i = 0; i < NW; i++) {
    const u32 m = t[i] * N0;
    u64 c = 0;
#pragma unroll
    for (int j = 0; j < NW - 1; j++) {
      c += (u64)m * pw[j] + t[i + j];
      t[i + j] = (u32)c;
      c >>= 32;
    }
    c += (u64)m * pw[NW - 1] + t[i + NW - 1] + carry;
    t[i + NW - 1] = (u32)c;
    carry = (u32)(c >> 32);
  }
  t[2 * NW - 1] += carry;
  reduce_once(r, t + NW);
}

// r = a b 2^-384 mod p for a, b < 2p (r may alias either): SOS, the
// 24-word product, then its Montgomery reduction; a b < 4p^2 < p 2^384.
// ops/fp_product.py `mul_words` models it word for word.
__device__ __forceinline__ void fp_mul(u32 r[NW], const u32 a[NW], const u32 b[NW]) {
  u32 t[2 * NW + 1];
  mul_wide(t, a, b);
  mont_reduce(r, t);
}

// r = a + b as integers, for a product's operand: a, b < p give r < 2p
__device__ __forceinline__ void add_words(u32 r[NW], const u32 a[NW], const u32 b[NW]) {
  u64 c = 0;
#pragma unroll
  for (int k = 0; k < NW; k++) {
    c += (u64)a[k] + b[k];
    r[k] = (u32)c;
    c >>= 32;
  }
}

// r = a + b mod p
__device__ __forceinline__ void fp_add(u32 r[NW], const u32 a[NW], const u32 b[NW]) {
  u32 t[NW];
  add_words(t, a, b);
  reduce_once(r, t);
}

// r = a - b mod p
__device__ __forceinline__ void fp_sub(u32 r[NW], const u32 a[NW], const u32 b[NW]) {
  const u32 pw[NW] = {LH_P_WORDS};
  u32 t[NW];
  u64 borrow = 0;
#pragma unroll
  for (int k = 0; k < NW; k++) {
    const u64 d = (u64)a[k] - b[k] - borrow;
    t[k] = (u32)d;
    borrow = d >> 63;
  }
  const u32 mask = 0u - (u32)borrow;  // add p back iff a < b
  u64 c = 0;
#pragma unroll
  for (int k = 0; k < NW; k++) {
    c += (u64)t[k] + (pw[k] & mask);
    r[k] = (u32)c;
    c >>= 32;
  }
}

// ------------------------------------------------------ a slot file
//
// A file of Fp slots in shared memory, [slot][word]: word j of slot s at
// file[12 s + j], so a slot loads as three 16-byte words.

// floor(p / 2^352) + 1: the divisor of lin_sum's quotient estimate
constexpr u64 P_TOP1 = 0x1a0111ebull;

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

// x = S mod p from acc_j = sum_t k_t (word j of x_t, complemented where
// c_t = -k_t < 0) and kneg = the sum of those k_t, for S = sum_t c_t x_t
// over canonical x_t with L1 norm sum_t |c_t| <= 256: canonical, or only
// below 2p where it is a product's operand
__device__ __forceinline__ void lin_reduce(u32 x[NW], const u64 acc[NW], u32 kneg,
                                           bool canonical) {
  // sum_j acc_j 2^(32 j) = S + kneg (2^384 - 1) for S = sum_t c_t x_t, so
  // S + kneg p = that - kneg 2^384 + kneg + kneg p, in [0, L1 p] for the
  // coefficients' L1 norm L1 (lanes' rows: at most 64; K1's: at most 256;
  // the model is ops/lanes.py `lin_sum_words`)
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
  lin_reduce(x, acc, kneg, canonical);
}
// ------------------------------------------------------ the inverse
//
// `fp_inv`: a binary extended Euclid (Kaliski's almost Montgomery
// inverse, several bits a step) on the 12 words in registers, then a
// division by the 2^k it leaves. Its steps are subtractions, additions and
// shifts; a random input takes ~270 steps where a Fermat chain takes ~380
// squarings and ~100 products. Its running time depends on the input, so
// it is for public values only (curve points of signatures and keys).
// ops/fp_inverse.py `inv_words` models it word for word.

// R^2 mod p and R^3 mod p
static __device__ const u32 R2_W[NW] = {
    0x1c341746u, 0xf4df1f34u, 0x09d104f1u, 0x0a76e6a6u, 0x4c95b6d5u, 0x8de5476cu,
    0x939d83c0u, 0x67eb88a9u, 0xb519952du, 0x9a793e85u, 0x92cae3aau, 0x11988fe5u};
static __device__ const u32 R3_W[NW] = {
    0xd94ca1e0u, 0xed48ac6bu, 0x03a7adf8u, 0x315f831eu, 0x615e29ddu, 0x9a53352au,
    0x921e1761u, 0x34c04e5eu, 0x65724728u, 0x2512d435u, 0x91755d4du, 0x0aa63460u};

__device__ __forceinline__ bool is_zero_words(const u32 a[NW]) {
  u32 o = 0u;
#pragma unroll
  for (int k = 0; k < NW; k++) o |= a[k];
  return o == 0u;
}

// trailing zero bits of a != 0
__device__ __forceinline__ int ctz_words(const u32 a[NW]) {
  int t = 0;
#pragma unroll
  for (int k = NW - 1; k >= 0; k--)
    if (a[k]) t = 32 * k + __ffs(a[k]) - 1;
  return t;
}

// a >>= t, a <<= t (bits shifted out are lost), any t >= 0
__device__ __forceinline__ void shr_words(u32 a[NW], int t) {
  for (; t >= 32; t -= 32) {
#pragma unroll
    for (int k = 0; k < NW - 1; k++) a[k] = a[k + 1];
    a[NW - 1] = 0u;
  }
#pragma unroll
  for (int k = 0; k < NW - 1; k++) a[k] = __funnelshift_r(a[k], a[k + 1], t);
  a[NW - 1] >>= t;
}

__device__ __forceinline__ void shl_words(u32 a[NW], int t) {
  for (; t >= 32; t -= 32) {
#pragma unroll
    for (int k = NW - 1; k > 0; k--) a[k] = a[k - 1];
    a[0] = 0u;
  }
#pragma unroll
  for (int k = NW - 1; k > 0; k--) a[k] = __funnelshift_l(a[k - 1], a[k], t);
  a[0] <<= t;
}

// x <- x 2^-t mod p for x < p, 1 <= t <= 32: x + m p with m = -x p^-1 mod
// 2^t is divisible by 2^t and below 2^t p
__device__ __forceinline__ void div_pow2(u32 x[NW], int t) {
  const u32 pw[NW] = {LH_P_WORDS};
  const u32 m = (x[0] * N0) & (t == 32 ? 0xffffffffu : (1u << t) - 1u);
  u32 w[NW + 1];
  u64 c = 0;
#pragma unroll
  for (int k = 0; k < NW; k++) {
    c += (u64)m * pw[k] + x[k];
    w[k] = (u32)c;
    c >>= 32;
  }
  w[NW] = (u32)c;
#pragma unroll
  for (int k = 0; k < NW; k++) x[k] = t == 32 ? w[k + 1] : __funnelshift_r(w[k], w[k + 1], t);
}

// r = a^-1 R^2 mod p for a < p (the Montgomery form of the inverse of a
// Montgomery value); 0 -> 0
__device__ __forceinline__ void fp_inv(u32 out[NW], const u32 a[NW]) {
  const u32 pw[NW] = {LH_P_WORDS};
  if (is_zero_words(a)) {
#pragma unroll
    for (int k = 0; k < NW; k++) out[k] = 0u;
    return;
  }
  // Kaliski: p = u s + v r throughout, u and v odd at the top of the loop
  u32 u[NW], v[NW], r[NW], s[NW];
#pragma unroll
  for (int k = 0; k < NW; k++) {
    u[k] = pw[k];
    v[k] = a[k];
    r[k] = 0u;
    s[k] = 0u;
  }
  s[0] = 1u;
  int total = ctz_words(v);  // r = 0 takes the shift as it is
  shr_words(v, total);
  while (true) {
    u32 d[NW];
    u64 borrow = 0;
#pragma unroll
    for (int k = 0; k < NW; k++) {
      const u64 x = (u64)u[k] - v[k] - borrow;
      d[k] = (u32)x;
      borrow = x >> 63;
    }
    if (!borrow && !is_zero_words(d)) {  // u > v: u -= v, r += s
      u64 c = 0;
#pragma unroll
      for (int k = 0; k < NW; k++) {
        u[k] = d[k];
        c += (u64)r[k] + s[k];
        r[k] = (u32)c;
        c >>= 32;
      }
      const int t = ctz_words(u);
      shr_words(u, t);
      shl_words(s, t);
      total += t;
    } else {  // v >= u: v -= u (= -d), s += r
      u64 b = 0, c = 0;
#pragma unroll
      for (int k = 0; k < NW; k++) {
        const u64 x = 0ull - d[k] - b;
        v[k] = (u32)x;
        b = x >> 63;
        c += (u64)s[k] + r[k];
        s[k] = (u32)c;
        c >>= 32;
      }
      if (is_zero_words(v)) {
        shl_words(r, 1);
        total += 1;
        break;
      }
      const int t = ctz_words(v);
      shr_words(v, t);
      shl_words(r, t);
      total += t;
    }
  }
  // r < 2p and -r = a^-1 2^total mod p
  reduce_once(r, r);
  u64 b = 0;
#pragma unroll
  for (int k = 0; k < NW; k++) {
    const u64 x = (u64)pw[k] - r[k] - b;
    r[k] = (u32)x;
    b = x >> 63;
  }
  for (; total >= 32; total -= 32) div_pow2(r, 32);
  if (total) div_pow2(r, total);
  fp_mul(out, r, R3_W);  // a^-1 R^3 R^-1
}

}  // namespace fpr
