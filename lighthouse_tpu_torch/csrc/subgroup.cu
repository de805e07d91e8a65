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
// What bounds it on the H100. Field products: 254 doublings (7 Fp2
// products each) and 134 additions (16 each) a lane, 11,766 Fp products,
// and no bytes to speak of (48 words in, one out a lane). The additions
// follow r's bits, which are the same for every lane, so a branch on a bit
// is uniform across a warp: the kernel runs the addition on r's 134 set
// bits only and skips the scan's dead last doubling.
//
// Design (the simple one; making it fast is later work). One thread a
// lane. A lane's points and temporaries are a file of 20 Fp2 slots in the
// thread's local memory; the doubling and the addition are programs of
// steps over that file (a product, a sum, a difference or a small
// multiple of a slot), run by one interpreter loop, so the Fp2 product --
// Karatsuba over fp_reg.cuh's register product -- is compiled a few times,
// not once a step. Every value is canonical, so a zero test is a test of
// the words. The exceptional cases are per lane and all handled, as
// JacobianGroup.add does with its selects:
//   * Z1 = 0 (the accumulator at infinity: every lane at r's bit 0): the
//     sum is the addend;
//   * Z2 = 0 (the addend at infinity: only the point at infinity itself):
//     the sum is the accumulator;
//   * H = 0 and R = 0 (acc == addend): the doubling of the accumulator,
//     a branch only adversarial points take (a point of order 13 does);
//   * H = 0 and R != 0 (acc == -addend): the generic formulas give Z3 = 0.
// A masked lane passes without work.

#include <cuda_runtime.h>

#include "fp_reg.cuh"

using namespace fpr;

namespace sg {

constexpr int THREADS = 64;
constexpr int R_BITS = 255;
// r, little-endian 32-bit words
static __device__ const u32 R_W[8] = {0x00000001u, 0xffffffffu, 0xfffe5bfeu, 0x53bda402u,
                                     0x09a1d805u, 0x3339d808u, 0x299d7d48u, 0x73eda753u};

// ------------------------------------------------------ Fp2 values

typedef u32 fp2[2][NW];

// r = a b in Fp2 = Fp[u] / (u^2 + 1), Karatsuba: 3 Fp products
__device__ __forceinline__ void fp2_mul(fp2 r, const fp2 a, const fp2 b) {
  u32 v0[NW], v1[NW], sa[NW], sb[NW];
  fp_mul(v0, a[0], b[0]);
  fp_mul(v1, a[1], b[1]);
  add_words(sa, a[0], a[1]);
  add_words(sb, b[0], b[1]);
  fp_mul(sa, sa, sb);
  fp_sub(r[0], v0, v1);
  fp_sub(sa, sa, v0);
  fp_sub(r[1], sa, v1);
}

__device__ __forceinline__ bool fp2_is_zero(const uint4* s) {
  u32 o = 0u;
#pragma unroll
  for (int q = 0; q < 6; q++) o |= s[q].x | s[q].y | s[q].z | s[q].w;
  return o == 0u;
}

// ------------------------------------------------------ the slot file
//
// Slots: the accumulator (X1, Y1, Z1) = 0..2, the addend (X2, Y2, Z2) =
// 3..5, temporaries T0..T13 = 6..19; a slot is an Fp2 value, 6 x 16 bytes.
constexpr int SLOTS = 20;
enum : unsigned char { X1 = 0, Y1, Z1, X2, Y2, Z2, T0, T1, T2, T3, T4, T5, T6, T7, T8, T9, T10,
                       T11, T12, T13 };

__device__ __forceinline__ void load2(fp2 r, const uint4* s) {
#pragma unroll
  for (int q = 0; q < 6; q++) {
    const uint4 v = s[q];
    u32* w = &r[q / 3][4 * (q % 3)];
    w[0] = v.x;
    w[1] = v.y;
    w[2] = v.z;
    w[3] = v.w;
  }
}

__device__ __forceinline__ void store2(uint4* s, const fp2 r) {
#pragma unroll
  for (int q = 0; q < 6; q++) {
    const u32* w = &r[q / 3][4 * (q % 3)];
    s[q] = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

__device__ __forceinline__ void copy2(uint4* d, const uint4* s) {
#pragma unroll
  for (int q = 0; q < 6; q++) d[q] = s[q];
}

// ------------------------------------------------------ the programs
//
// A step writes slot `d` from slots `a` and `b`: MUL a b, ADD a + b, SUB
// a - b, or SCL b a for a small integer b.
enum : unsigned char { MUL = 0, ADD, SUB, SCL };
struct Step {
  unsigned char op, d, a, b;
};

// dbl-2001-b in place on the point (X, Y, Z), temporaries T0..T8:
// a = X^2, b = Y^2, yz = Y Z, e = 3a, c = b^2, (X + b)^2, f = e^2,
// d = 2 ((X + b)^2 - a - c), X3 = f - 2d, Y3 = e (d - X3) - 8c, Z3 = 2 yz
#define LH_DOUBLE(X, Y, Z)                                                                    \
  {MUL, T0, X, X}, {MUL, T1, Y, Y}, {MUL, T2, Y, Z}, {SCL, T3, T0, 3}, {ADD, T4, X, T1},      \
      {MUL, T5, T1, T1}, {MUL, T4, T4, T4}, {MUL, T6, T3, T3}, {SUB, T4, T4, T0},             \
      {SUB, T4, T4, T5}, {SCL, T4, T4, 2}, {SCL, T7, T4, 2}, {SUB, X, T6, T7},                \
      {SUB, T7, T4, X}, {MUL, T7, T3, T7}, {SCL, T8, T5, 8}, {SUB, Y, T7, T8}, {SCL, Z, T2, 2}
constexpr int DOUBLE_STEPS = 18;
__constant__ Step DOUBLE_ADDEND[DOUBLE_STEPS] = {LH_DOUBLE(X2, Y2, Z2)};
__constant__ Step DOUBLE_ACC[DOUBLE_STEPS] = {LH_DOUBLE(X1, Y1, Z1)};

// JacobianGroup.add's generic formulas, acc + addend -> (T11, T13, T10),
// with H in T6 and R in T7 kept for the exceptional cases:
// U1 = X1 Z2^2, U2 = X2 Z1^2, S1 = Y1 Z2^3, S2 = Y2 Z1^3, H = U2 - U1,
// R = S2 - S1, I = (2H)^2, J = H I, V = U1 I, X3 = (2R)^2 - J - 2V,
// Y3 = 2R (V - X3) - 2 S1 J, Z3 = 2 Z1 Z2 H
constexpr int ADD_STEPS = 27;
__constant__ Step ADD_GENERIC[ADD_STEPS] = {
    {MUL, T0, Z1, Z1},   {MUL, T1, Z2, Z2},   {MUL, T2, X1, T1},   {MUL, T3, X2, T0},
    {MUL, T1, T1, Z2},   {MUL, T0, T0, Z1},   {MUL, T4, Y1, T1},   {MUL, T5, Y2, T0},
    {SUB, T6, T3, T2},   {SUB, T7, T5, T4},   {SCL, T8, T6, 2},    {SCL, T9, T7, 2},
    {MUL, T10, Z1, Z2},  {MUL, T8, T8, T8},   {MUL, T11, T9, T9},  {MUL, T10, T10, T6},
    {SCL, T10, T10, 2},  {MUL, T12, T6, T8},  {MUL, T2, T2, T8},   {SUB, T11, T11, T12},
    {SCL, T13, T2, 2},   {SUB, T11, T11, T13}, {SUB, T13, T2, T11}, {MUL, T13, T9, T13},
    {MUL, T4, T4, T12},  {SCL, T4, T4, 2},    {SUB, T13, T13, T4}};

__device__ __forceinline__ void run(uint4 (*F)[6], const Step* prog, int n) {
  for (int s = 0; s < n; s++) {
    const Step st = prog[s];
    fp2 a, r;
    load2(a, F[st.a]);
    if (st.op == SCL) {
      // r = b a by additions, b <= 8
#pragma unroll
      for (int c = 0; c < 2; c++)
#pragma unroll
        for (int k = 0; k < NW; k++) r[c][k] = a[c][k];
      for (int t = 1; t < st.b; t++) {
        fp_add(r[0], r[0], a[0]);
        fp_add(r[1], r[1], a[1]);
      }
    } else {
      fp2 b;
      load2(b, F[st.b]);
      if (st.op == MUL) {
        fp2_mul(r, a, b);
      } else if (st.op == ADD) {
        fp_add(r[0], a[0], b[0]);
        fp_add(r[1], a[1], b[1]);
      } else {
        fp_sub(r[0], a[0], b[0]);
        fp_sub(r[1], a[1], b[1]);
      }
    }
    store2(F[st.d], r);
  }
}

// acc <- acc + addend with JacobianGroup.add's selects
__device__ __forceinline__ void add_step(uint4 (*F)[6]) {
  if (fp2_is_zero(F[Z1])) {  // acc at infinity: the addend
    copy2(F[X1], F[X2]);
    copy2(F[Y1], F[Y2]);
    copy2(F[Z1], F[Z2]);
    return;
  }
  if (fp2_is_zero(F[Z2])) return;  // addend at infinity: acc
  run(F, ADD_GENERIC, ADD_STEPS);
  if (fp2_is_zero(F[T6]) && fp2_is_zero(F[T7])) {  // acc == addend
    run(F, DOUBLE_ACC, DOUBLE_STEPS);
  } else {
    copy2(F[X1], F[T11]);
    copy2(F[Y1], F[T13]);
    copy2(F[Z1], F[T10]);
  }
}

// out[lane] = 1 iff [r] (x, y) == O or the lane is masked. x, y: (2, 12, B)
// canonical Montgomery words, batch last.
__global__ void __launch_bounds__(THREADS) g2_subgroup_kernel(const int32_t* __restrict__ x,
                                                              const int32_t* __restrict__ y,
                                                              const int32_t* __restrict__ mask,
                                                              int B, int32_t* __restrict__ out) {
  const int lane = blockIdx.x * THREADS + threadIdx.x;
  if (lane >= B) return;
  if (!mask[lane]) {
    out[lane] = 1;
    return;
  }
  uint4 F[SLOTS][6];
  {
    fp2 v, one, zero;
#pragma unroll
    for (int k = 0; k < NW; k++) {
      one[0][k] = ONE_W[k];
      one[1][k] = 0u;
      zero[0][k] = 0u;
      zero[1][k] = 0u;
    }
#pragma unroll
    for (int c = 0; c < 2; c++)
#pragma unroll
      for (int k = 0; k < NW; k++) v[c][k] = (u32)x[(size_t)(c * NW + k) * B + lane];
    store2(F[X2], v);
#pragma unroll
    for (int c = 0; c < 2; c++)
#pragma unroll
      for (int k = 0; k < NW; k++) v[c][k] = (u32)y[(size_t)(c * NW + k) * B + lane];
    store2(F[Y2], v);
    store2(F[Z2], one);
    store2(F[X1], one);  // the point at infinity (1, 1, 0)
    store2(F[Y1], one);
    store2(F[Z1], zero);
  }
  for (int i = 0; i < R_BITS; i++) {
    if ((R_W[i >> 5] >> (i & 31)) & 1u) add_step(F);
    if (i + 1 < R_BITS) run(F, DOUBLE_ADDEND, DOUBLE_STEPS);
  }
  out[lane] = fp2_is_zero(F[Z1]) ? 1 : 0;
}

}  // namespace sg

extern "C" int lh_g2_subgroup(const void* x, const void* y, const void* mask, int B, void* out,
                              void* stream) {
  const int blocks = (B + sg::THREADS - 1) / sg::THREADS;
  sg::g2_subgroup_kernel<<<blocks, sg::THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)x, (const int32_t*)y, (const int32_t*)mask, B, (int32_t*)out);
  return (int)cudaGetLastError();
}
