// K2 -- the batched optimal-ate Miller loop, one pair per thread.
//
// Replaces the TPU kernel lighthouse_tpu/ops/pallas_miller.py `_kernel`
// (reached through `miller_loop_pallas`): 63 iterations over the bits of
// |x| below its top bit, each f <- f^2 * l_{T,T}(P), T <- 2T, and on a set
// bit f <- f * l_{T,Q}(P), T <- T + Q; then the conjugate because x < 0.
// Masked pairs write f = 1, as the JAX wrapper's select does.
//
// What bounds it on the H100: integer multiply-adds in one thread's
// dependent chain. A pair costs ~10k Fp products (Fp12 squaring, the line
// product and the twist steps), and at the main path's 65 pairs the launch
// is under one SM, so latency -- not the card's multiply rate -- sets the
// time; f (144 words) plus T and the step temporaries exceed the 255
// registers a thread may hold, so they spill to local memory.
//
// Design: the exact step formulas and line layout of ops/tpairing.py
// (`_dbl_step`, `_add_step`, `_mul_by_line`), because a different line
// scaling changes f while keeping the pairing. The line (l0, l2, l3) is
// multiplied as the full Fp12 (l0 + l2 v) + (l3 v) w. One thread per pair
// is the simple first design; spreading a pair over a warp is later work.
//
// ptxas -v (nvcc 12.9, sm_90a): 254 registers, 0 bytes of register spills;
// f, T and the step temporaries live in a 3,984-byte per-thread stack
// frame in local memory (the structs the __noinline__ tower functions take
// by reference), which is where the expected spill went.

#include <cuda_runtime.h>

#include "bls12_381.cuh"

using namespace bls;

struct G2Proj {
  Fp2 X, Y, Z;
};

// tangent line at T evaluated at P, and T <- 2T (tpairing._dbl_step)
__device__ __noinline__ void dbl_step(G2Proj& t, Fp12& line, const Fp& px,
                                      const Fp& py) {
  Fp2 a, b, z2, yz, xb, e, c, xb2, f, x3c, x2z2, yz3, s, u;
  fp2_sqr(a, t.X);
  fp2_sqr(b, t.Y);
  fp2_sqr(z2, t.Z);
  fp2_mul(yz, t.Y, t.Z);
  fp2_add(xb, t.X, b);
  fp2_add(e, a, a);
  fp2_add(e, e, a);  // e = 3a
  fp2_sqr(c, b);
  fp2_sqr(xb2, xb);
  fp2_sqr(f, e);
  fp2_mul(x3c, t.X, a);
  fp2_mul(x2z2, a, z2);
  fp2_mul(yz3, yz, z2);
  // d = xb2 - a - c (half of 2((X + b)^2 - a - c))
  Fp2 d, x3, dmx;
  fp2_sub(d, xb2, a);
  fp2_sub(d, d, c);
  // x3 = f - 4 d
  fp2_dbl(s, d);
  fp2_dbl(s, s);
  fp2_sub(x3, f, s);
  // dmx = 2 d - x3 = 6 d - f
  fp2_dbl(s, d);
  fp2_sub(dmx, s, x3);
  // c0 = 3 x3c - 2 b
  Fp2 c0, m3xz, c3p, z3;
  fp2_add(s, x3c, x3c);
  fp2_add(s, s, x3c);
  fp2_dbl(u, b);
  fp2_sub(c0, s, u);
  // m3xz = -3 x2z2
  fp2_add(s, x2z2, x2z2);
  fp2_add(s, s, x2z2);
  fp2_neg(m3xz, s);
  fp2_dbl(c3p, yz3);
  fp2_dbl(z3, yz);
  // y3 = e dmx - 8 c
  Fp2 y3;
  fp2_mul(s, e, dmx);
  fp2_dbl(u, c);
  fp2_dbl(u, u);
  fp2_dbl(u, u);
  fp2_sub(y3, s, u);
  // line = (c0, m3xz * px, c3p * py) at slots (w^0 v^0, w^0 v^1, w^1 v^1)
  fp12_one(line);
  line.c0.c0 = c0;
  fp2_mul_fp(line.c0.c1, m3xz, px);
  fp2_zero(line.c0.c2);
  fp2_zero(line.c1.c0);
  fp2_mul_fp(line.c1.c1, c3p, py);
  fp2_zero(line.c1.c2);
  t.X = x3;
  t.Y = y3;
  t.Z = z3;
}

// chord line through T and Q evaluated at P, and T <- T + Q
// (tpairing._add_step, mixed addition with affine Q)
__device__ __noinline__ void add_step(G2Proj& t, Fp12& line, const Fp2& qx,
                                      const Fp2& qy, const Fp& px,
                                      const Fp& py) {
  Fp2 z1s, u2, z1c, gamma, qyz, hh, z1gam, theta, tt, hhh, v, tqx, qyz3, s;
  fp2_sqr(z1s, t.Z);
  fp2_mul(u2, qx, z1s);
  fp2_mul(z1c, z1s, t.Z);
  fp2_sub(gamma, u2, t.X);
  fp2_mul(qyz, qy, z1c);
  fp2_sqr(hh, gamma);
  fp2_mul(z1gam, t.Z, gamma);
  fp2_sub(theta, qyz, t.Y);
  fp2_sqr(tt, theta);
  fp2_mul(hhh, gamma, hh);
  fp2_mul(v, t.X, hh);
  fp2_mul(tqx, theta, qx);
  fp2_mul(qyz3, qy, z1gam);
  // x3 = tt - hhh - 2 v ; vmx = v - x3
  Fp2 x3, vmx, c0, mtheta, y3, a, b;
  fp2_sub(x3, tt, hhh);
  fp2_dbl(s, v);
  fp2_sub(x3, x3, s);
  fp2_sub(vmx, v, x3);
  fp2_sub(c0, tqx, qyz3);
  fp2_neg(mtheta, theta);
  // y3 = theta vmx - Y1 hhh
  fp2_mul(a, theta, vmx);
  fp2_mul(b, t.Y, hhh);
  fp2_sub(y3, a, b);
  fp12_one(line);
  line.c0.c0 = c0;
  fp2_mul_fp(line.c0.c1, mtheta, px);
  fp2_zero(line.c0.c2);
  fp2_zero(line.c1.c0);
  fp2_mul_fp(line.c1.c1, z1gam, py);
  fp2_zero(line.c1.c2);
  t.X = x3;
  t.Y = y3;
  t.Z = z1gam;
}

__global__ void miller_kernel(const int32_t* __restrict__ px_w,
                              const int32_t* __restrict__ py_w,
                              const int32_t* __restrict__ qx_w,
                              const int32_t* __restrict__ qy_w,
                              const int32_t* __restrict__ mask, int B,
                              int32_t* f_out) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  Fp12 f;
  fp12_one(f);
  if (mask[lane]) {
    Fp px, py;
    Fp2 qx, qy;
    fp_load(px, px_w, lane, B);
    fp_load(py, py_w, lane, B);
    fp2_load(qx, qx_w, lane, B);
    fp2_load(qy, qy_w, lane, B);
    G2Proj t;
    t.X = qx;
    t.Y = qy;
    fp2_one(t.Z);
    Fp12 line;
    for (int i = 62; i >= 0; i--) {
      fp12_sqr(f, f);
      dbl_step(t, line, px, py);
      fp12_mul(f, f, line);
      if ((X_ABS >> i) & 1ull) {
        add_step(t, line, qx, qy, px, py);
        fp12_mul(f, f, line);
      }
    }
    fp12_conj(f, f);  // x < 0
  }
  fp12_store(f_out, lane, B, f);
}

extern "C" int lh_miller(const void* px, const void* py, const void* qx,
                         const void* qy, const void* mask, int B, void* f_out,
                         void* stream) {
  const int threads = 64;
  const int blocks = (B + threads - 1) / threads;
  miller_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)px, (const int32_t*)py, (const int32_t*)qx,
      (const int32_t*)qy, (const int32_t*)mask, B, (int32_t*)f_out);
  return (int)cudaGetLastError();
}
