// BLS12-381 arithmetic for the port's hand-written Hopper kernels.
//
// The header of K1's `chain` and `w2` bodies (csrc/ladder.cu; the other
// kernels run fp_reg.cuh's register arithmetic): the base field Fp as 12
// little-endian 32-bit words in Montgomery form with R = 2^384 (the same R
// as the JAX package's 33 x 12-bit bundles, so a canonical value converts
// by repacking bits alone), Fp2 = Fp[u]/(u^2 + 1), and the
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
// Code size: the Montgomery product and the Fp2 product are __noinline__,
// so a source compiles one copy of each and the build stays at seconds.
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
// ------------------------------------------------------------------- Fp

__device__ __forceinline__ void fp_zero(Fp& r) {
#pragma unroll
  for (int k = 0; k < NW; k++) r.v[k] = 0u;
}

__device__ __forceinline__ void fp_one(Fp& r) {
#pragma unroll
  for (int k = 0; k < NW; k++) r.v[k] = ONE_W[k];
}

__device__ __forceinline__ bool fp_is_zero(const Fp& a) {
  u32 acc = 0u;
#pragma unroll
  for (int k = 0; k < NW; k++) acc |= a.v[k];
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
