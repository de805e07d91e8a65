// K1's G2 product row, shared by csrc/ladder.cu and csrc/subgroup.cu: the
// Fp2 product (a + a2)(b + b2) of values in a slot file (fp_reg.cuh's
// layout), Karatsuba with lazy reduction -- three 24-word products through
// one product site, summed unreduced, then two Montgomery reductions
// instead of three. ops/ladder_rows.py and ops/subgroup_rows.py model it
// (tests/test_torch_ladder_rows.py `test_lazy_karatsuba_model`).
#pragma once

#include "fp_reg.cuh"

namespace fpr {

constexpr u32 NO_TERM = 63;  // an absent second term of an operand

// p^2 and 2 p^2: the offsets that keep T0 and T1 of `fp2_row` non-negative
__constant__ u32 P2_W[2 * NW] = {
    0x1c718e39u, 0x26aa0000u, 0x76382eabu, 0x7ced6b1du, 0x62113cfdu, 0x162c3383u,
    0x3e71b743u, 0x66bf91edu, 0x7091a049u, 0x292e85a8u, 0x86185c7bu, 0x1d68619cu,
    0x0978ef01u, 0xf5314933u, 0x16ddca6eu, 0x50a62cfdu, 0x349e8bd0u, 0x66e59e49u,
    0x0e7046b4u, 0xe2dc90e5u, 0xa22f25e9u, 0x4bd278eau, 0xb8c35fc7u, 0x02a437a4u};
__constant__ u32 P2X2_W[2 * NW] = {
    0x38e31c72u, 0x4d540000u, 0xec705d56u, 0xf9dad63au, 0xc42279fau, 0x2c586706u,
    0x7ce36e86u, 0xcd7f23dau, 0xe1234092u, 0x525d0b50u, 0x0c30b8f6u, 0x3ad0c339u,
    0x12f1de02u, 0xea629266u, 0x2dbb94ddu, 0xa14c59fau, 0x693d17a0u, 0xcdcb3c92u,
    0x1ce08d68u, 0xc5b921cau, 0x445e4bd3u, 0x97a4f1d5u, 0x7186bf8eu, 0x05486f49u};

// T += t, T -= t (neg) or nothing (!keep), over 25 words in two's
// complement: only the final sums, in [0, 6 p^2), are read
__device__ __forceinline__ void wide_acc(u32 T[2 * NW + 1], const u32 t[2 * NW + 1], bool neg,
                                         bool keep) {
  const u32 flip = neg ? 0xffffffffu : 0u, m = keep ? 0xffffffffu : 0u;
  u64 c = neg && keep ? 1u : 0u;  // T + ~t + 1 = T - t
#pragma unroll
  for (int k = 0; k < 2 * NW + 1; k++) {
    c += (u64)T[k] + ((t[k] ^ flip) & m);
    T[k] = (u32)c;
    c >>= 32;
  }
}

// Karatsuba operand i of the value at slot s (plus the value at s2 unless
// NO_TERM): component i, canonical (i < 2), or (i = 2) the sum of both
// components, below 2p and congruent to the canonical components' sum
__device__ __forceinline__ void kara_operand(u32 x[NW], const u32* f, u32 s, u32 s2, int i) {
  u32 u[NW];
  if (i < 2) {
    load_slot(x, f, s + i);
    if (s2 != NO_TERM) {
      load_slot(u, f, s2 + i);
      fp_add(x, x, u);
    }
    return;
  }
  load_slot(x, f, s);
  load_slot(u, f, s + 1);
  add_words(x, x, u);
  if (s2 != NO_TERM) {  // four canonical terms, below 4p: take 2p off once
    load_slot(u, f, s2);
    add_words(x, x, u);
    load_slot(u, f, s2 + 1);
    add_words(x, x, u);
    const u32 p2[NW] = {0xffff5556u, 0x73fdffffu, 0x62a7ffffu, 0x3d57fffdu, 0xed61ec48u,
                        0xce61a541u, 0xe70a257eu, 0xc8ee9709u, 0x869759aeu, 0x96374f6cu,
                        0x72ffcd34u, 0x340223d4u};  // 2p
    u32 d[NW];
    u64 borrow = 0;
#pragma unroll
    for (int k = 0; k < NW; k++) {
      const u64 v = (u64)x[k] - p2[k] - borrow;
      d[k] = (u32)v;
      borrow = v >> 63;
    }
#pragma unroll
    for (int k = 0; k < NW; k++) x[k] = borrow ? x[k] : d[k];
  }
}

// slots dst, dst + 1 <- the Fp2 product of values (a + a2)(b + b2),
// Karatsuba with lazy reduction: the three 24-word products P0 = a0 b0,
// P1 = a1 b1 (canonical operands) and P2 of the operand sums (each below
// 2p) through one product site, summed unreduced into T0 = P0 - P1 + p^2
// in [0, 2 p^2) and T1 = P2 - P0 - P1 + 2 p^2 in [0, 6 p^2), then two
// Montgomery reductions instead of three (6 p^2 < p 2^384 keeps each below
// 2p before its last subtraction)
__device__ __forceinline__ void fp2_row(u32* f, u32 dst, u32 sa, u32 sa2, u32 sb, u32 sb2) {
  u32 T0[2 * NW + 1], T1[2 * NW + 1];
#pragma unroll
  for (int k = 0; k < 2 * NW + 1; k++) {
    T0[k] = k < 2 * NW ? P2_W[k] : 0u;
    T1[k] = k < 2 * NW ? P2X2_W[k] : 0u;
  }
#pragma unroll 1
  for (int i = 0; i < 3; i++) {
    u32 x[NW], y[NW], t[2 * NW + 1];
    kara_operand(x, f, sa, sa2, i);
    kara_operand(y, f, sb, sb2, i);
    fpr::mul_wide(t, x, y);
    wide_acc(T0, t, i == 1, i < 2);
    wide_acc(T1, t, i < 2, true);
  }
#pragma unroll 1
  for (int j = 0; j < 2; j++) {
    u32 t[2 * NW + 1], r[NW];
#pragma unroll
    for (int k = 0; k < 2 * NW + 1; k++) t[k] = j ? T1[k] : T0[k];
    fpr::mont_reduce(r, t);
    store_slot(f, dst + j, r);
  }
}

}  // namespace fpr
