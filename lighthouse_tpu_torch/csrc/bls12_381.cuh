// BLS12-381 arithmetic for the port's hand-written Hopper kernels.
//
// One header shared by every kernel source under csrc/: the base field Fp
// as 12 little-endian 32-bit words in Montgomery form with R = 2^384 (the
// same R as the JAX package's 33 x 12-bit bundles, so a canonical value
// converts by repacking bits alone), the tower Fp2 = Fp[u]/(u^2 + 1),
// Fp6 = Fp2[v]/(v^3 - (1 + u)), Fp12 = Fp6[w]/(w^2 - v), and the
// Renes-Costello-Batina complete projective formulas (Algorithms 7 and 9,
// a = 0) for G1 over Fp and G2 over Fp2.
//
// Every function keeps its values canonical (< p), so any two exact
// implementations of the same formula sequence agree bit for bit; the
// kernels use that to match the plain PyTorch versions exactly.
//
// Memory layout of a kernel operand: int32 words (S, 12, B) with the batch
// last, so neighbouring threads (lanes) read neighbouring words.
//
// Code size: the Montgomery product and the tower multiplications are
// __noinline__, so each kernel source compiles one copy of each and the
// build stays at seconds; inlining them is a tuning step for later.
#pragma once

#include <stdint.h>

namespace bls {

typedef uint32_t u32;
typedef uint64_t u64;

constexpr int NW = 12;  // 32-bit words per Fp element

struct Fp {
  u32 v[NW];
};
struct Fp2 {
  Fp c0, c1;
};
struct Fp6 {
  Fp2 c0, c1, c2;
};
struct Fp12 {
  Fp6 c0, c1;
};

// p, little-endian words
__device__ __constant__ u32 P_W[NW] = {
    0xffffaaabu, 0xb9feffffu, 0xb153ffffu, 0x1eabfffeu, 0xf6b0f624u, 0x6730d2a0u,
    0xf38512bfu, 0x64774b84u, 0x434bacd7u, 0x4b1ba7b6u, 0x397fe69au, 0x1a0111eau};
// -p^-1 mod 2^32
constexpr u32 N0 = 0xfffcfffdu;
// R mod p (Montgomery one)
__device__ __constant__ u32 ONE_W[NW] = {
    0x0002fffdu, 0x76090000u, 0xc40c0002u, 0xebf4000bu, 0x53c758bau, 0x5f489857u,
    0x70525745u, 0x77ce5853u, 0xa256ec6du, 0x5c071a97u, 0xfa80e493u, 0x15f65ec3u};
// p - 2, the Fermat inversion exponent
__device__ __constant__ u32 PM2_W[NW] = {
    0xffffaaa9u, 0xb9feffffu, 0xb153ffffu, 0x1eabfffeu, 0xf6b0f624u, 0x6730d2a0u,
    0xf38512bfu, 0x64774b84u, 0x434bacd7u, 0x4b1ba7b6u, 0x397fe69au, 0x1a0111eau};
// |x| of the BLS parameter x = -0xd201000000010000
constexpr u64 X_ABS = 0xd201000000010000ull;

// Frobenius constants, Montgomery form, in Fp12 slot order
// [c0.c0, c0.c1, c0.c2, c1.c0, c1.c1, c1.c2] = gamma_[0, 2, 4, 1, 3, 5],
// gamma_i = (1 + u)^(i (p - 1) / 6).
__device__ __constant__ u32 GAMMA_W[6][2][NW] = {
    {{0x0002fffdu, 0x76090000u, 0xc40c0002u, 0xebf4000bu, 0x53c758bau, 0x5f489857u,
      0x70525745u, 0x77ce5853u, 0xa256ec6du, 0x5c071a97u, 0xfa80e493u, 0x15f65ec3u},
     {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0}},
    {{0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0},
     {0x8671f071u, 0xcd03c9e4u, 0x1fcda5d2u, 0x5dab2246u, 0xd3851b95u, 0x587042afu,
      0x01bacb9eu, 0x8eb60ebeu, 0x83d050d2u, 0x03f97d6eu, 0x54638741u, 0x18f02065u}},
    {{0x867545c3u, 0x890dc9e4u, 0x3285a5d5u, 0x2af32253u, 0x309b7e2cu, 0x50880866u,
      0x7e881024u, 0xa20d1b8cu, 0xe2db9068u, 0x14e4f04fu, 0x1564853au, 0x14e56d3fu},
     {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0}},
    {{0xb319d465u, 0x07089552u, 0xb50a8313u, 0xc6695f92u, 0xd117228fu, 0x97e83cccu,
      0xb2dc29eeu, 0xa35baecau, 0x5daace4du, 0x1ce393eau, 0xb0fb66ebu, 0x08f2220fu},
     {0x4ce5d646u, 0xb2f66aadu, 0xfc497cecu, 0x5842a06bu, 0x2599d394u, 0xcf4895d4u,
      0x40a8e8d0u, 0xc11b9cbau, 0xe5a0de89u, 0x2e3813cbu, 0x88847fafu, 0x110eefdau}},
    {{0x5aa30fdau, 0x7bcfa7a2u, 0x2a927e7cu, 0xdc17dec1u, 0x6b4ebef1u, 0x2f088dd8u,
      0xda74d4a7u, 0xd1ca2087u, 0x96cebc1du, 0x2da25966u, 0xbbfd87d2u, 0x0e2b7eedu},
     {0x5aa30fdau, 0x7bcfa7a2u, 0x2a927e7cu, 0xdc17dec1u, 0x6b4ebef1u, 0x2f088dd8u,
      0xda74d4a7u, 0xd1ca2087u, 0x96cebc1du, 0x2da25966u, 0xbbfd87d2u, 0x0e2b7eedu}},
    {{0x0dbce43fu, 0x82d83cf5u, 0xdf9d018fu, 0xa2813e53u, 0x3c65e181u, 0xc6f0caa5u,
      0x8d50fe95u, 0x7525cf52u, 0xf4798a6bu, 0x4a85ed50u, 0x6cf8eebdu, 0x171da0fdu},
     {0xf242c66cu, 0x3726c30au, 0xd1b6fe70u, 0x7c2ac1aau, 0xba4b14a2u, 0xa04007fbu,
      0x66341429u, 0xef517c32u, 0x4ed2226bu, 0x0095ba65u, 0xcc86f7ddu, 0x02e370ecu}},
};
// p^2-Frobenius: Fp norms gamma_i^(p + 1), same slot order
__device__ __constant__ u32 NORM_W[6][NW] = {
    {0x0002fffdu, 0x76090000u, 0xc40c0002u, 0xebf4000bu, 0x53c758bau, 0x5f489857u,
     0x70525745u, 0x77ce5853u, 0xa256ec6du, 0x5c071a97u, 0xfa80e493u, 0x15f65ec3u},
    {0x798a64e8u, 0x30f1361bu, 0x7ece5a2au, 0xf3b8ddabu, 0xc61577f7u, 0x16a8ca3au,
     0x74fd029bu, 0xc26a2ff8u, 0x60701c6eu, 0x3636b766u, 0x241b6160u, 0x051ba4abu},
    {0x8671f071u, 0xcd03c9e4u, 0x1fcda5d2u, 0x5dab2246u, 0xd3851b95u, 0x587042afu,
     0x01bacb9eu, 0x8eb60ebeu, 0x83d050d2u, 0x03f97d6eu, 0x54638741u, 0x18f02065u},
    {0x798dba3au, 0xecfb361bu, 0x91865a2cu, 0xc100ddb8u, 0x232bda8eu, 0x0ec08ff1u,
     0xf1ca4721u, 0xd5c13cc6u, 0xbf7b5c04u, 0x47222a47u, 0xe51c5f59u, 0x0110f184u},
    {0xfffcaaaeu, 0x43f5ffffu, 0xed47fffdu, 0x32b7fff2u, 0xa2e99d69u, 0x07e83a49u,
     0x8332bb7au, 0xeca8f331u, 0xa0f4c069u, 0xef148d1eu, 0x3eff0206u, 0x040ab326u},
    {0x867545c3u, 0x890dc9e4u, 0x3285a5d5u, 0x2af32253u, 0x309b7e2cu, 0x50880866u,
     0x7e881024u, 0xa20d1b8cu, 0xe2db9068u, 0x14e4f04fu, 0x1564853au, 0x14e56d3fu},
};

// ------------------------------------------------------------------- Fp

__device__ __forceinline__ void fp_zero(Fp& r) {
#pragma unroll
  for (int k = 0; k < NW; k++) r.v[k] = 0u;
}

__device__ __forceinline__ void fp_one(Fp& r) {
#pragma unroll
  for (int k = 0; k < NW; k++) r.v[k] = ONE_W[k];
}

__device__ __forceinline__ void fp_from_const(Fp& r, const u32* w) {
#pragma unroll
  for (int k = 0; k < NW; k++) r.v[k] = w[k];
}

__device__ __forceinline__ bool fp_is_zero(const Fp& a) {
  u32 acc = 0u;
#pragma unroll
  for (int k = 0; k < NW; k++) acc |= a.v[k];
  return acc == 0u;
}

__device__ __forceinline__ bool fp_eq(const Fp& a, const Fp& b) {
  u32 acc = 0u;
#pragma unroll
  for (int k = 0; k < NW; k++) acc |= a.v[k] ^ b.v[k];
  return acc == 0u;
}

// word k of element `lane` in a (.., 12, B) operand starting at `base`
__device__ __forceinline__ void fp_load(Fp& r, const int32_t* base, int lane,
                                        int B) {
#pragma unroll
  for (int k = 0; k < NW; k++) r.v[k] = (u32)base[(size_t)k * B + lane];
}

__device__ __forceinline__ void fp_store(int32_t* base, int lane, int B,
                                         const Fp& a) {
#pragma unroll
  for (int k = 0; k < NW; k++) base[(size_t)k * B + lane] = (int32_t)a.v[k];
}

// t (< 2p, 384 bits) -> t mod p
__device__ __forceinline__ void fp_reduce_once(Fp& r, const u32* t) {
  u32 s[NW];
  u64 borrow = 0;
#pragma unroll
  for (int k = 0; k < NW; k++) {
    u64 d = (u64)t[k] - P_W[k] - borrow;
    s[k] = (u32)d;
    borrow = d >> 63;
  }
  // borrow set <=> t < p: keep t
#pragma unroll
  for (int k = 0; k < NW; k++) r.v[k] = borrow ? t[k] : s[k];
}

__device__ __forceinline__ void fp_add(Fp& r, const Fp& a, const Fp& b) {
  u32 t[NW];
  u64 c = 0;
#pragma unroll
  for (int k = 0; k < NW; k++) {
    c += (u64)a.v[k] + b.v[k];
    t[k] = (u32)c;
    c >>= 32;
  }
  fp_reduce_once(r, t);  // a + b < 2p < 2^382: no carry out
}

__device__ __forceinline__ void fp_sub(Fp& r, const Fp& a, const Fp& b) {
  u32 t[NW];
  u64 borrow = 0;
#pragma unroll
  for (int k = 0; k < NW; k++) {
    u64 d = (u64)a.v[k] - b.v[k] - borrow;
    t[k] = (u32)d;
    borrow = d >> 63;
  }
  const u32 mask = 0u - (u32)borrow;  // add p back iff a < b
  u64 c = 0;
#pragma unroll
  for (int k = 0; k < NW; k++) {
    c += (u64)t[k] + (P_W[k] & mask);
    r.v[k] = (u32)c;
    c >>= 32;
  }
}

__device__ __forceinline__ void fp_neg(Fp& r, const Fp& a) {
  Fp z;
  fp_zero(z);
  fp_sub(r, z, a);
}

__device__ __forceinline__ void fp_dbl(Fp& r, const Fp& a) { fp_add(r, a, a); }

// Montgomery product a * b * 2^-384 mod p, CIOS over 32-bit words.
__device__ __noinline__ void fp_mul(Fp& r, const Fp& a, const Fp& b) {
  u32 t[NW + 2];
#pragma unroll
  for (int k = 0; k < NW + 2; k++) t[k] = 0u;
#pragma unroll
  for (int i = 0; i < NW; i++) {
    u64 c = 0;
#pragma unroll
    for (int j = 0; j < NW; j++) {
      c += (u64)a.v[j] * b.v[i] + t[j];
      t[j] = (u32)c;
      c >>= 32;
    }
    c += t[NW];
    t[NW] = (u32)c;
    t[NW + 1] = (u32)(c >> 32);
    const u32 m = t[0] * N0;
    c = ((u64)m * P_W[0] + t[0]) >> 32;
#pragma unroll
    for (int j = 1; j < NW; j++) {
      c += (u64)m * P_W[j] + t[j];
      t[j - 1] = (u32)c;
      c >>= 32;
    }
    c += t[NW];
    t[NW - 1] = (u32)c;
    t[NW] = t[NW + 1] + (u32)(c >> 32);
  }
  // inputs < p and p < 2^382 keep t < 2p < 2^384 (t[NW] == 0)
  fp_reduce_once(r, t);
}

__device__ __forceinline__ void fp_sqr(Fp& r, const Fp& a) { fp_mul(r, a, a); }

// a * k for the small constants of the formulas, by additions
__device__ __forceinline__ void fp_mul3(Fp& r, const Fp& a) {
  Fp t;
  fp_dbl(t, a);
  fp_add(r, t, a);
}

__device__ __forceinline__ void fp_mul4(Fp& r, const Fp& a) {
  Fp t;
  fp_dbl(t, a);
  fp_dbl(r, t);
}

__device__ __forceinline__ void fp_mul8(Fp& r, const Fp& a) {
  Fp t;
  fp_mul4(t, a);
  fp_dbl(r, t);
}

__device__ __forceinline__ void fp_mul12(Fp& r, const Fp& a) {
  Fp t;
  fp_mul3(t, a);
  fp_mul4(r, t);
}

// a^(p-2) = a^-1 (0 -> 0), square-and-multiply from the top bit of p - 2
__device__ __noinline__ void fp_inv(Fp& r, const Fp& a) {
  Fp acc;
  fp_one(acc);
  for (int i = 380; i >= 0; i--) {
    fp_sqr(acc, acc);
    if ((PM2_W[i >> 5] >> (i & 31)) & 1u) fp_mul(acc, acc, a);
  }
  r = acc;
}

// ------------------------------------------------------------------ Fp2

__device__ __forceinline__ void fp2_zero(Fp2& r) {
  fp_zero(r.c0);
  fp_zero(r.c1);
}

__device__ __forceinline__ void fp2_one(Fp2& r) {
  fp_one(r.c0);
  fp_zero(r.c1);
}

__device__ __forceinline__ bool fp2_is_zero(const Fp2& a) {
  return fp_is_zero(a.c0) && fp_is_zero(a.c1);
}

__device__ __forceinline__ void fp2_load(Fp2& r, const int32_t* base, int lane,
                                         int B) {
  fp_load(r.c0, base, lane, B);
  fp_load(r.c1, base + (size_t)NW * B, lane, B);
}

__device__ __forceinline__ void fp2_store(int32_t* base, int lane, int B,
                                          const Fp2& a) {
  fp_store(base, lane, B, a.c0);
  fp_store(base + (size_t)NW * B, lane, B, a.c1);
}

__device__ __forceinline__ void fp2_add(Fp2& r, const Fp2& a, const Fp2& b) {
  fp_add(r.c0, a.c0, b.c0);
  fp_add(r.c1, a.c1, b.c1);
}

__device__ __forceinline__ void fp2_sub(Fp2& r, const Fp2& a, const Fp2& b) {
  fp_sub(r.c0, a.c0, b.c0);
  fp_sub(r.c1, a.c1, b.c1);
}

__device__ __forceinline__ void fp2_neg(Fp2& r, const Fp2& a) {
  fp_neg(r.c0, a.c0);
  fp_neg(r.c1, a.c1);
}

__device__ __forceinline__ void fp2_dbl(Fp2& r, const Fp2& a) {
  fp_dbl(r.c0, a.c0);
  fp_dbl(r.c1, a.c1);
}

__device__ __forceinline__ void fp2_conj(Fp2& r, const Fp2& a) {
  r.c0 = a.c0;
  fp_neg(r.c1, a.c1);
}

// Karatsuba: (a0 b0 - a1 b1) + ((a0 + a1)(b0 + b1) - a0 b0 - a1 b1) u
__device__ __noinline__ void fp2_mul(Fp2& r, const Fp2& a, const Fp2& b) {
  Fp t0, t1, sa, sb, t2;
  fp_mul(t0, a.c0, b.c0);
  fp_mul(t1, a.c1, b.c1);
  fp_add(sa, a.c0, a.c1);
  fp_add(sb, b.c0, b.c1);
  fp_mul(t2, sa, sb);
  fp_sub(r.c0, t0, t1);
  fp_sub(t2, t2, t0);
  fp_sub(r.c1, t2, t1);
}

__device__ __forceinline__ void fp2_sqr(Fp2& r, const Fp2& a) { fp2_mul(r, a, a); }

// (c0 + c1 u) * s for s in Fp
__device__ __forceinline__ void fp2_mul_fp(Fp2& r, const Fp2& a, const Fp& s) {
  fp_mul(r.c0, a.c0, s);
  fp_mul(r.c1, a.c1, s);
}

// (c0 + c1 u)(1 + u) = (c0 - c1) + (c0 + c1) u
__device__ __forceinline__ void fp2_mul_by_xi(Fp2& r, const Fp2& a) {
  Fp t;
  fp_sub(t, a.c0, a.c1);
  fp_add(r.c1, a.c0, a.c1);
  r.c0 = t;
}

__device__ __noinline__ void fp2_inv(Fp2& r, const Fp2& a) {
  Fp s0, s1, n, ninv;
  fp_sqr(s0, a.c0);
  fp_sqr(s1, a.c1);
  fp_add(n, s0, s1);
  fp_inv(ninv, n);
  fp_mul(r.c0, a.c0, ninv);
  fp_mul(s0, a.c1, ninv);
  fp_neg(r.c1, s0);
}

// ------------------------------------------------------------------ Fp6

__device__ __forceinline__ void fp6_add(Fp6& r, const Fp6& a, const Fp6& b) {
  fp2_add(r.c0, a.c0, b.c0);
  fp2_add(r.c1, a.c1, b.c1);
  fp2_add(r.c2, a.c2, b.c2);
}

__device__ __forceinline__ void fp6_sub(Fp6& r, const Fp6& a, const Fp6& b) {
  fp2_sub(r.c0, a.c0, b.c0);
  fp2_sub(r.c1, a.c1, b.c1);
  fp2_sub(r.c2, a.c2, b.c2);
}

__device__ __forceinline__ void fp6_neg(Fp6& r, const Fp6& a) {
  fp2_neg(r.c0, a.c0);
  fp2_neg(r.c1, a.c1);
  fp2_neg(r.c2, a.c2);
}

// (a0, a1, a2) * v = (xi a2, a0, a1)
__device__ __forceinline__ void fp6_mul_by_v(Fp6& r, const Fp6& a) {
  Fp2 t;
  fp2_mul_by_xi(t, a.c2);
  r.c2 = a.c1;
  r.c1 = a.c0;
  r.c0 = t;
}

// the 6-multiplication schedule of the tower (programs._fp6_mul_sym)
__device__ __noinline__ void fp6_mul(Fp6& r, const Fp6& a, const Fp6& b) {
  Fp2 t0, t1, t2, sa, sb, m, x;
  fp2_mul(t0, a.c0, b.c0);
  fp2_mul(t1, a.c1, b.c1);
  fp2_mul(t2, a.c2, b.c2);
  Fp6 out;
  // c0 = t0 + xi ((a1 + a2)(b1 + b2) - t1 - t2)
  fp2_add(sa, a.c1, a.c2);
  fp2_add(sb, b.c1, b.c2);
  fp2_mul(m, sa, sb);
  fp2_sub(m, m, t1);
  fp2_sub(m, m, t2);
  fp2_mul_by_xi(x, m);
  fp2_add(out.c0, t0, x);
  // c1 = (a0 + a1)(b0 + b1) - t0 - t1 + xi t2
  fp2_add(sa, a.c0, a.c1);
  fp2_add(sb, b.c0, b.c1);
  fp2_mul(m, sa, sb);
  fp2_sub(m, m, t0);
  fp2_sub(m, m, t1);
  fp2_mul_by_xi(x, t2);
  fp2_add(out.c1, m, x);
  // c2 = (a0 + a2)(b0 + b2) - t0 - t2 + t1
  fp2_add(sa, a.c0, a.c2);
  fp2_add(sb, b.c0, b.c2);
  fp2_mul(m, sa, sb);
  fp2_sub(m, m, t0);
  fp2_sub(m, m, t2);
  fp2_add(out.c2, m, t1);
  r = out;
}

__device__ __noinline__ void fp6_inv(Fp6& r, const Fp6& a) {
  Fp2 s0, s1, s2, p01, p12, p02, c0, c1, c2, t, n, ninv;
  fp2_sqr(s0, a.c0);
  fp2_sqr(s1, a.c1);
  fp2_sqr(s2, a.c2);
  fp2_mul(p01, a.c0, a.c1);
  fp2_mul(p12, a.c1, a.c2);
  fp2_mul(p02, a.c0, a.c2);
  fp2_mul_by_xi(t, p12);
  fp2_sub(c0, s0, t);
  fp2_mul_by_xi(t, s2);
  fp2_sub(c1, t, p01);
  fp2_sub(c2, s1, p02);
  // norm = a0 c0 + xi (a2 c1 + a1 c2)
  Fp2 q0, q1, q2;
  fp2_mul(q0, a.c0, c0);
  fp2_mul(q1, a.c2, c1);
  fp2_mul(q2, a.c1, c2);
  fp2_add(t, q1, q2);
  fp2_mul_by_xi(t, t);
  fp2_add(n, q0, t);
  fp2_inv(ninv, n);
  fp2_mul(r.c0, c0, ninv);
  fp2_mul(r.c1, c1, ninv);
  fp2_mul(r.c2, c2, ninv);
}

// ----------------------------------------------------------------- Fp12

__device__ __forceinline__ void fp12_one(Fp12& r) {
  fp2_one(r.c0.c0);
  fp2_zero(r.c0.c1);
  fp2_zero(r.c0.c2);
  fp2_zero(r.c1.c0);
  fp2_zero(r.c1.c1);
  fp2_zero(r.c1.c2);
}

__device__ __forceinline__ bool fp12_is_one(const Fp12& a) {
  Fp one;
  fp_one(one);
  return fp_eq(a.c0.c0.c0, one) && fp_is_zero(a.c0.c0.c1) &&
         fp2_is_zero(a.c0.c1) && fp2_is_zero(a.c0.c2) &&
         fp2_is_zero(a.c1.c0) && fp2_is_zero(a.c1.c1) && fp2_is_zero(a.c1.c2);
}

// slot s of 12 in a (12, 12, B) operand: [c0.c0, c0.c1, c0.c2, c1.c0, ...]
// as (re, im) pairs
__device__ __forceinline__ Fp2& fp12_coeff(Fp12& a, int i) {
  Fp2* c[6] = {&a.c0.c0, &a.c0.c1, &a.c0.c2, &a.c1.c0, &a.c1.c1, &a.c1.c2};
  return *c[i];
}

__device__ __forceinline__ void fp12_load(Fp12& r, const int32_t* base, int lane,
                                          int B) {
#pragma unroll
  for (int i = 0; i < 6; i++)
    fp2_load(fp12_coeff(r, i), base + (size_t)2 * i * NW * B, lane, B);
}

__device__ __forceinline__ void fp12_store(int32_t* base, int lane, int B,
                                           Fp12& a) {
#pragma unroll
  for (int i = 0; i < 6; i++)
    fp2_store(base + (size_t)2 * i * NW * B, lane, B, fp12_coeff(a, i));
}

__device__ __forceinline__ void fp12_conj(Fp12& r, const Fp12& a) {
  r.c0 = a.c0;
  fp6_neg(r.c1, a.c1);
}

// Karatsuba over the Fp6 pair: (a0 b0 + v a1 b1) + ((a0+a1)(b0+b1) - a0 b0 - a1 b1) w
__device__ __noinline__ void fp12_mul(Fp12& r, const Fp12& a, const Fp12& b) {
  Fp6 t0, t1, sa, sb, x;
  fp6_mul(t0, a.c0, b.c0);
  fp6_mul(t1, a.c1, b.c1);
  fp6_add(sa, a.c0, a.c1);
  fp6_add(sb, b.c0, b.c1);
  fp6_mul(x, sa, sb);
  fp6_sub(x, x, t0);
  fp6_sub(r.c1, x, t1);
  fp6_mul_by_v(x, t1);
  fp6_add(r.c0, t0, x);
}

__device__ __forceinline__ void fp12_sqr(Fp12& r, const Fp12& a) {
  fp12_mul(r, a, a);
}

// 1/(b0 + b1 w) = (b0 - b1 w) / (b0^2 - v b1^2)
__device__ __noinline__ void fp12_inv(Fp12& r, const Fp12& a) {
  Fp6 s0, s1, vs1, n, ninv;
  fp6_mul(s0, a.c0, a.c0);
  fp6_mul(s1, a.c1, a.c1);
  fp6_mul_by_v(vs1, s1);
  fp6_sub(n, s0, vs1);
  fp6_inv(ninv, n);
  fp6_mul(r.c0, a.c0, ninv);
  fp6_mul(s1, a.c1, ninv);
  fp6_neg(r.c1, s1);
}

// a^p: conjugate every Fp2 coefficient, scale by its gamma
__device__ __noinline__ void fp12_frobenius(Fp12& r, const Fp12& a) {
  Fp12 out = a;
#pragma unroll
  for (int i = 0; i < 6; i++) {
    Fp2 c, g;
    fp2_conj(c, fp12_coeff(out, i));
    fp_from_const(g.c0, GAMMA_W[i][0]);
    fp_from_const(g.c1, GAMMA_W[i][1]);
    fp2_mul(fp12_coeff(out, i), c, g);
  }
  r = out;
}

// a^(p^2): scale every Fp2 coefficient by its Fp norm
__device__ __noinline__ void fp12_frobenius2(Fp12& r, const Fp12& a) {
  Fp12 out = a;
#pragma unroll
  for (int i = 0; i < 6; i++) {
    Fp n;
    fp_from_const(n, NORM_W[i]);
    Fp2& c = fp12_coeff(out, i);
    fp2_mul_fp(c, c, n);
  }
  r = out;
}

// ------------------------------------------------- complete projective G1/G2

template <class F>
struct Proj {
  F X, Y, Z;
};

__device__ __forceinline__ void f_add(Fp& r, const Fp& a, const Fp& b) { fp_add(r, a, b); }
__device__ __forceinline__ void f_add(Fp2& r, const Fp2& a, const Fp2& b) { fp2_add(r, a, b); }
__device__ __forceinline__ void f_sub(Fp& r, const Fp& a, const Fp& b) { fp_sub(r, a, b); }
__device__ __forceinline__ void f_sub(Fp2& r, const Fp2& a, const Fp2& b) { fp2_sub(r, a, b); }
__device__ __forceinline__ void f_mul(Fp& r, const Fp& a, const Fp& b) { fp_mul(r, a, b); }
__device__ __forceinline__ void f_mul(Fp2& r, const Fp2& a, const Fp2& b) { fp2_mul(r, a, b); }
__device__ __forceinline__ void f_neg(Fp& r, const Fp& a) { fp_neg(r, a); }
__device__ __forceinline__ void f_neg(Fp2& r, const Fp2& a) { fp2_neg(r, a); }
__device__ __forceinline__ void f_zero(Fp& r) { fp_zero(r); }
__device__ __forceinline__ void f_zero(Fp2& r) { fp2_zero(r); }
__device__ __forceinline__ void f_one(Fp& r) { fp_one(r); }
__device__ __forceinline__ void f_one(Fp2& r) { fp2_one(r); }
__device__ __forceinline__ bool f_is_zero(const Fp& a) { return fp_is_zero(a); }
__device__ __forceinline__ bool f_is_zero(const Fp2& a) { return fp2_is_zero(a); }
__device__ __forceinline__ void f_load(Fp& r, const int32_t* b, int lane, int B) { fp_load(r, b, lane, B); }
__device__ __forceinline__ void f_load(Fp2& r, const int32_t* b, int lane, int B) { fp2_load(r, b, lane, B); }
__device__ __forceinline__ void f_store(int32_t* b, int lane, int B, const Fp& a) { fp_store(b, lane, B, a); }
__device__ __forceinline__ void f_store(int32_t* b, int lane, int B, const Fp2& a) { fp2_store(b, lane, B, a); }

// small multiples: 2a, 3a, 8a
template <class F>
__device__ __forceinline__ void f_dbl(F& r, const F& a) { f_add(r, a, a); }
template <class F>
__device__ __forceinline__ void f_mul3(F& r, const F& a) {
  F t;
  f_dbl(t, a);
  f_add(r, t, a);
}
template <class F>
__device__ __forceinline__ void f_mul8(F& r, const F& a) {
  F t;
  f_dbl(t, a);
  f_dbl(t, t);
  f_dbl(r, t);
}

// multiplication by 3b: G1 b = 4 -> 12; G2 b = 4 + 4u -> 12 + 12u,
// (a0 + a1 u)(12 + 12u) = 12 (a0 - a1) + 12 (a0 + a1) u
__device__ __forceinline__ void f_mul_b3(Fp& r, const Fp& a) { fp_mul12(r, a); }
__device__ __forceinline__ void f_mul_b3(Fp2& r, const Fp2& a) {
  Fp d, s;
  fp_sub(d, a.c0, a.c1);
  fp_add(s, a.c0, a.c1);
  fp_mul12(r.c0, d);
  fp_mul12(r.c1, s);
}

template <class F>
__device__ __forceinline__ void proj_identity(Proj<F>& r) {
  f_zero(r.X);
  f_one(r.Y);
  f_zero(r.Z);
}

// RCB Algorithm 7 (a = 0): complete addition, the stage structure of
// curve.ProjectiveGroup.add
template <class F>
__device__ __noinline__ void proj_add(Proj<F>& r, const Proj<F>& p, const Proj<F>& q) {
  F m0, m1, m2, m3, m4, m5, sa, sb;
  f_mul(m0, p.X, q.X);
  f_mul(m1, p.Y, q.Y);
  f_mul(m2, p.Z, q.Z);
  f_add(sa, p.X, p.Y);
  f_add(sb, q.X, q.Y);
  f_mul(m3, sa, sb);
  f_add(sa, p.Y, p.Z);
  f_add(sb, q.Y, q.Z);
  f_mul(m4, sa, sb);
  f_add(sa, p.X, p.Z);
  f_add(sb, q.X, q.Z);
  f_mul(m5, sa, sb);
  F t3, t4, t5, T0, b3m2, Z3s, t1m, y3c;
  f_sub(t3, m3, m0);
  f_sub(t3, t3, m1);  // X1 Y2 + X2 Y1
  f_sub(t4, m4, m1);
  f_sub(t4, t4, m2);  // Y1 Z2 + Y2 Z1
  f_sub(t5, m5, m0);
  f_sub(t5, t5, m2);  // X1 Z2 + X2 Z1
  f_mul3(T0, m0);
  f_mul_b3(b3m2, m2);
  f_add(Z3s, m1, b3m2);
  f_sub(t1m, m1, b3m2);
  f_mul_b3(y3c, t5);
  F a, b;
  Proj<F> out;
  // X3 = t3 t1m - t4 y3c
  f_mul(a, t3, t1m);
  f_mul(b, t4, y3c);
  f_sub(out.X, a, b);
  // Y3 = t1m Z3s + y3c T0
  f_mul(a, t1m, Z3s);
  f_mul(b, y3c, T0);
  f_add(out.Y, a, b);
  // Z3 = Z3s t4 + T0 t3
  f_mul(a, Z3s, t4);
  f_mul(b, T0, t3);
  f_add(out.Z, a, b);
  r = out;
}

// RCB Algorithm 9 (a = 0): complete doubling (identity -> identity)
template <class F>
__device__ __noinline__ void proj_dbl(Proj<F>& r, const Proj<F>& p) {
  F m0, m1, m2, m3, z8, t2v, y3s, t0f, a, b;
  f_mul(m0, p.Y, p.Y);
  f_mul(m1, p.Y, p.Z);
  f_mul(m2, p.Z, p.Z);
  f_mul(m3, p.X, p.Y);
  f_mul8(z8, m0);
  f_mul_b3(t2v, m2);
  f_add(y3s, m0, t2v);
  f_mul3(a, t2v);
  f_sub(t0f, m0, a);
  Proj<F> out;
  f_mul(a, t0f, m3);
  f_dbl(out.X, a);  // X3 = 2 t0f m3
  f_mul(a, t2v, z8);
  f_mul(b, t0f, y3s);
  f_add(out.Y, a, b);  // Y3 = t2v z8 + t0f y3s
  f_mul(out.Z, m1, z8);  // Z3 = m1 z8
  r = out;
}

template <class F>
__device__ __forceinline__ void proj_load(Proj<F>& r, const int32_t* X,
                                          const int32_t* Y, const int32_t* Z,
                                          int lane, int B) {
  f_load(r.X, X, lane, B);
  f_load(r.Y, Y, lane, B);
  f_load(r.Z, Z, lane, B);
}

template <class F>
__device__ __forceinline__ void proj_store(int32_t* X, int32_t* Y, int32_t* Z,
                                           int lane, int B, const Proj<F>& p) {
  f_store(X, lane, B, p.X);
  f_store(Y, lane, B, p.Y);
  f_store(Z, lane, B, p.Z);
}

}  // namespace bls
