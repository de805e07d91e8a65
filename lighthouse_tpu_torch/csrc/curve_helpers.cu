// Helper kernels around K1: the projective lane-sum fold, the batched
// projective -> affine conversion, and its Jacobian entry for points as the
// host holds them, for G1 (Fp, W = 1) and G2 (Fp2, W = 2).
//
// On the TPU these steps are XLA, outside any Pallas kernel
// (lighthouse_tpu/ops/curve.py `_tree_fold_sum` and `to_affine` with
// `inv_batched`, ops/tcurve.py `sum_lanes`; the host's Jacobian conversion
// is bls/tpu_backend.py `batch_to_affine_g2` + `_pack_g2_affine`).
//
// What bounds them on the H100. A lane-sum is complete additions, 12 Fp
// products each on G1 and 36 on G2, in log2(seg) dependent levels: its
// first level is throughput, its last levels latency. A to-affine is one
// inversion and ~3 products a lane: latency, since an inversion is a chain.
//
// Design. Values live in registers and shared memory, products are
// fp_reg.cuh's register product, and nothing has a local-memory frame.
//
// * lane-sum (`fold_kernel`): a block folds columns of 2^L lanes held in
//   shared memory, level by level with the halving tree of
//   curve.Projective.sum_lanes (in a column of n, point j takes j + n/2).
//   A launch takes L levels: column c of segment g holds lanes g seg + j +
//   k (seg / 2^L), k < 2^L, j = c mod (seg / 2^L), which is the state of
//   the halving tree after L levels, so passes compose into the whole tree
//   and the projective words equal the plain version's. An addition is RCB
//   Algorithm 7: 6 products, their combination, 6 more, a last sum; each
//   product is split into Fp products (Karatsuba's three on G2) and every
//   thread of the block takes Fp products in turn, so a level costs a few
//   product latencies. The wrapper's plan (ops/curve_kernels.py
//   `fold_plan`) takes up to 7 levels in the last launch, the rest before:
//   two launches up to 2^15 lanes a segment.
// * to-affine (`affine_kernel`): a block converts 256 lanes. Each lane's Z
//   (on G2 its norm Z0^2 + Z1^2) is a leaf of a product tree in shared
//   memory; a zero Z becomes 1 there, so it cannot poison the tree, and its
//   output is masked to (0, 0) with the identity flag. One thread inverts
//   the root (fp_reg.cuh `fp_inv`, binary extended Euclid), and the tree
//   hands each leaf its inverse on the way down, one product a level: 2 x
//   8 product latencies and one inversion for the whole block. The JAC
//   entry takes Jacobian points as plain (not Montgomery) canonical words,
//   enters Montgomery form with one product by R^2 a coordinate, and
//   returns x = X / Z^2, y = Y / Z^3; the projective entry x = X / Z, y =
//   Y / Z of Montgomery words.

#include <cuda_runtime.h>

#include "fp_reg.cuh"

using namespace fpr;

// ------------------------------------------------------ Fp^W values

// r = a b in Fp (W = 1) or Fp2 = Fp[u] / (u^2 + 1) (W = 2, Karatsuba)
template <int W>
__device__ __forceinline__ void fw_mul(u32 r[W][NW], u32 a[W][NW], u32 b[W][NW]) {
  if (W == 1) {
    fp_mul(r[0], a[0], b[0]);
  } else {
    u32 v0[NW], v1[NW], sa[NW], sb[NW];
    fp_mul(v0, a[0], b[0]);
    fp_mul(v1, a[W - 1], b[W - 1]);
    add_words(sa, a[0], a[W - 1]);
    add_words(sb, b[0], b[W - 1]);
    fp_mul(sa, sa, sb);
    fp_sub(r[0], v0, v1);
    fp_sub(sa, sa, v0);
    fp_sub(r[W - 1], sa, v1);
  }
}

template <int W>
__device__ __forceinline__ void load_w(u32 r[W][NW], const int32_t* __restrict__ src, int lane,
                                       int B) {
#pragma unroll
  for (int c = 0; c < W; c++)
#pragma unroll
    for (int k = 0; k < NW; k++) r[c][k] = (u32)src[(size_t)(c * NW + k) * B + lane];
}

template <int W>
__device__ __forceinline__ void store_w(int32_t* dst, int lane, int B, u32 r[W][NW]) {
#pragma unroll
  for (int c = 0; c < W; c++)
#pragma unroll
    for (int k = 0; k < NW; k++) dst[(size_t)(c * NW + k) * B + lane] = (int32_t)r[c][k];
}

// ------------------------------------------------------------- lane-sum

constexpr int SUM_POINTS = 256;  // points a block folds at most: 2^8
constexpr int SUM_THREADS = 384;

// Fp products of one Fp^W product, and Fp slots of a block's file
template <int W>
struct Fold {
  static constexpr int K = W == 1 ? 1 : 3;
  static constexpr int PT = 3 * W;  // slots of a point
  static constexpr int TMP = 6 * K;  // slots of an addition's products
  static constexpr int SLOTS = SUM_POINTS * PT + (SUM_POINTS / 2) * TMP;
  static constexpr int BYTES = SLOTS * NW * 4;
};

template <int W>
__device__ __forceinline__ void load_fw(u32 r[W][NW], const u32* file, int slot) {
#pragma unroll
  for (int c = 0; c < W; c++) load_slot(r[c], file, slot + c);
}

// Karatsuba operand kk of the Fp^W value at slot s, plus the one at slot t
// where t >= 0: component kk (kk < W) or the sum of both components (kk =
// 2, below 2p); the value's components are canonical sums
template <int W>
__device__ __forceinline__ void operand(u32 r[NW], const u32* file, int s, int t, int kk) {
  u32 v[W][NW];
  load_fw<W>(v, file, s);
  if (t >= 0) {
    u32 x[W][NW];
    load_fw<W>(x, file, t);
#pragma unroll
    for (int c = 0; c < W; c++) fp_add(v[c], v[c], x[c]);
  }
  if (W == 1 || kk < 2) {
#pragma unroll
    for (int k = 0; k < NW; k++) r[k] = kk == 0 ? v[0][k] : v[W - 1][k];
  } else {
    add_words(r, v[0], v[W - 1]);
  }
}

// The linear steps of an addition as rows over its Fp products (curve.
// Projective's ADD_C1 with B3_ROW, and ADD_C3, composed with Karatsuba's
// recombination on G2): the stage-1 products' 6 K parts give the
// combinations c0..c5 = t3, t4, y3c, T0, Z3s, t1m (6 W rows), the stage-2
// products' parts give X3, Y3, Z3 (3 W rows). A term T(k, s) is k times
// product part s; a row ends at its first zero. tests/test_torch_affine.py
// derives both tables from curve.py and holds them to these.
constexpr int FOLD_TERMS = 9;
#define T(k, s) ((k) * 256 + (s))
__constant__ short FOLD_ROWS_G1[9][FOLD_TERMS] = {
    {T(-1, 0), T(-1, 1), T(1, 3)},  // t3
    {T(-1, 1), T(-1, 2), T(1, 4)},  // t4
    {T(-12, 0), T(-12, 2), T(12, 5)},  // y3c
    {T(3, 0)},  // T0
    {T(1, 1), T(12, 2)},  // Z3s
    {T(1, 1), T(-12, 2)},  // t1m
    {T(-1, 0), T(1, 1)},  // X3
    {T(1, 2), T(1, 3)},  // Y3
    {T(1, 4), T(1, 5)},  // Z3
};
__constant__ short FOLD_ROWS_G2[18][FOLD_TERMS] = {
    {T(-1, 0), T(1, 1), T(-1, 3), T(1, 4), T(1, 9), T(-1, 10)},  // t3.0
    {T(1, 0), T(1, 1), T(-1, 2), T(1, 3), T(1, 4), T(-1, 5), T(-1, 9), T(-1, 10), T(1, 11)},  // t3.1
    {T(-1, 3), T(1, 4), T(-1, 6), T(1, 7), T(1, 12), T(-1, 13)},  // t4.0
    {T(1, 3), T(1, 4), T(-1, 5), T(1, 6), T(1, 7), T(-1, 8), T(-1, 12), T(-1, 13), T(1, 14)},  // t4.1
    {T(-24, 0), T(12, 2), T(-24, 6), T(12, 8), T(24, 15), T(-12, 17)},  // y3c.0
    {T(24, 1), T(-12, 2), T(24, 7), T(-12, 8), T(-24, 16), T(12, 17)},  // y3c.1
    {T(3, 0), T(-3, 1)},  // T0.0
    {T(-3, 0), T(-3, 1), T(3, 2)},  // T0.1
    {T(1, 3), T(-1, 4), T(24, 6), T(-12, 8)},  // Z3s.0
    {T(-1, 3), T(-1, 4), T(1, 5), T(-24, 7), T(12, 8)},  // Z3s.1
    {T(1, 3), T(-1, 4), T(-24, 6), T(12, 8)},  // t1m.0
    {T(-1, 3), T(-1, 4), T(1, 5), T(24, 7), T(-12, 8)},  // t1m.1
    {T(-1, 0), T(1, 1), T(1, 3), T(-1, 4)},  // X3.0
    {T(1, 0), T(1, 1), T(-1, 2), T(-1, 3), T(-1, 4), T(1, 5)},  // X3.1
    {T(1, 6), T(-1, 7), T(1, 9), T(-1, 10)},  // Y3.0
    {T(-1, 6), T(-1, 7), T(1, 8), T(-1, 9), T(-1, 10), T(1, 11)},  // Y3.1
    {T(1, 12), T(-1, 13), T(1, 15), T(-1, 16)},  // Z3.0
    {T(-1, 12), T(-1, 13), T(1, 14), T(-1, 15), T(-1, 16), T(1, 17)},  // Z3.1
};
#undef T

// x = the row's sum of product parts at slots base + s, canonical: one
// 64-bit accumulation and one reduction (fp_reg.cuh lin_reduce, L1 <= 108)
__device__ __forceinline__ void lin_row(u32 x[NW], const u32* file, int base, const short* row) {
  u64 acc[NW];
#pragma unroll
  for (int j = 0; j < NW; j++) acc[j] = 0ull;
  u32 kneg = 0u;
  for (int e = 0; e < FOLD_TERMS; e++) {
    const int term = row[e];
    const int k = term >> 8;
    if (k == 0) break;
    const u32 m = k < 0 ? 0xffffffffu : 0u;
    const u32 a = (u32)(k < 0 ? -k : k);
    kneg += a & m;
    u32 v[NW];
    load_slot(v, file, base + (term & 255));
#pragma unroll
    for (int j = 0; j < NW; j++) acc[j] += (u64)(v[j] ^ m) * a;
  }
  lin_reduce(x, acc, kneg, true);
}

// stage-2 products (a, b) as indices of the combinations c0..c5: p0 = t4
// y3c, p1 = t3 t1m, p2 = y3c T0, p3 = t1m Z3s, p4 = T0 t3, p5 = Z3s t4
__constant__ int STAGE2_A[6] = {1, 0, 2, 5, 3, 4};
__constant__ int STAGE2_B[6] = {2, 5, 3, 4, 0, 1};

// Fold columns of 2^L points, L levels of the halving tree, per column.
// in: (W, 12, B_in) Montgomery words; out: (W, 12, B_in >> L).
//
// An addition P + Q (P at point slot p, Q at q = p + h points) per level,
// in four phases between barriers:
//  1. stage-1 Fp products (6 K an addition, K = 1, or Karatsuba's 3 on G2)
//     of the operands X, Y, Z, X + Y, Y + Z, X + Z of P and of Q -> tmp;
//  2. the combinations c0..c5, rows of those parts -> the slots of P (c0..c2)
//     and Q (c3..c5), which phase 1 has read;
//  3. stage-2 Fp products c_a c_b -> tmp;
//  4. X3, Y3, Z3, rows of those parts -> P's slots.
// Phases 1 and 3 share one product site, 2 and 4 one row site (the loop
// over the two stages is not unrolled), so the code stays small.
template <int W>
__global__ void __launch_bounds__(SUM_THREADS, 1)
    fold_kernel(const int32_t* __restrict__ X, const int32_t* __restrict__ Y,
                const int32_t* __restrict__ Z, int B_in, int seg, int L, int32_t* oX,
                int32_t* oY, int32_t* oZ) {
  typedef Fold<W> F;
  constexpr int K = F::K, PT = F::PT, TMP = F::TMP;
  extern __shared__ uint4 smem[];
  u32* file = reinterpret_cast<u32*>(smem);
  const int n = 1 << L;
  const int stride = seg >> L;
  const int cols = B_in >> L;
  const int per_block = SUM_POINTS >> L;
  const int col0 = blockIdx.x * per_block;
  const int ncols = min(per_block, cols - col0);
  const int npts = ncols << L;
  const int tid = threadIdx.x;
  __shared__ short rows[9 * W * FOLD_TERMS];
  __shared__ int rows_a[6], rows_b[6];
  for (int e = tid; e < 9 * W * FOLD_TERMS; e += SUM_THREADS)
    rows[e] = W == 1 ? (&FOLD_ROWS_G1[0][0])[e] : (&FOLD_ROWS_G2[0][0])[e];
  if (tid < 6) {
    rows_a[tid] = STAGE2_A[tid];
    rows_b[tid] = STAGE2_B[tid];
  }

  // point q of the block: column col0 + q / n, its k = q mod n
  for (int q = tid; q < npts; q += SUM_THREADS) {
    const int col = col0 + (q >> L);
    const int lane = (col / stride) * seg + col % stride + (q & (n - 1)) * stride;
#pragma unroll
    for (int o = 0; o < 3; o++) {
      u32 v[W][NW];
      load_w<W>(v, o == 0 ? X : (o == 1 ? Y : Z), lane, B_in);
#pragma unroll
      for (int c = 0; c < W; c++) store_slot(file, q * PT + W * o + c, v[c]);
    }
  }
  __syncthreads();

  const int tmp0 = SUM_POINTS * PT;
  for (int h = n >> 1; h >= 1; h >>= 1) {
    const int nadd = ncols * h;
#pragma unroll 1
    for (int stage = 0; stage < 2; stage++) {
      for (int task = tid; task < nadd * TMP; task += SUM_THREADS) {
        const int a = task / TMP, u = task - a * TMP;
        const int i = u / K, kk = u - i * K;
        const int p = ((a / h) * n + a % h) * PT, q = p + h * PT;
        int sa, ta, sb, tb;
        if (stage == 0) {  // operand i of P and of Q: X, Y, Z, X + Y, Y + Z, X + Z
          const int c0 = i < 3 ? i : (i == 5 ? 0 : i - 3);
          const int c1 = i < 3 ? -1 : (i == 3 ? 1 : 2);
          sa = p + W * c0;
          sb = q + W * c0;
          ta = c1 < 0 ? -1 : p + W * c1;
          tb = c1 < 0 ? -1 : q + W * c1;
        } else {  // c_a and c_b, at P's slots (c0..c2) and Q's (c3..c5)
          const int ja = rows_a[i], jb = rows_b[i];
          sa = ja < 3 ? p + W * ja : q + W * (ja - 3);
          sb = jb < 3 ? p + W * jb : q + W * (jb - 3);
          ta = tb = -1;
        }
        u32 x[NW], y[NW];
        operand<W>(x, file, sa, ta, kk);
        operand<W>(y, file, sb, tb, kk);
        fp_mul(x, x, y);
        store_slot(file, tmp0 + task, x);
      }
      __syncthreads();
      const int nrows = stage == 0 ? 6 * W : 3 * W;
      for (int task = tid; task < nadd * nrows; task += SUM_THREADS) {
        const int a = task / nrows, r = task - a * nrows;
        const int p = ((a / h) * n + a % h) * PT, q = p + h * PT;
        const int row = stage == 0 ? r : 6 * W + r;
        u32 x[NW];
        lin_row(x, file, tmp0 + a * TMP, rows + row * FOLD_TERMS);
        store_slot(file, stage == 0 && r >= 3 * W ? q + r - 3 * W : p + r, x);
      }
      __syncthreads();
    }
  }

  for (int q = tid; q < ncols * 3; q += SUM_THREADS) {
    const int cl = q / 3, o = q - cl * 3;
    u32 v[W][NW];
    load_fw<W>(v, file, (cl << L) * PT + W * o);
    store_w<W>(o == 0 ? oX : (o == 1 ? oY : oZ), col0 + cl, cols, v);
  }
}

// ------------------------------------------------------------ to-affine

constexpr int AFF_LANES = 256;  // lanes a block: the leaves of its tree

// a coordinate of `lane` in Montgomery form: as it is, or (JAC) the plain
// words times R^2
template <int W, bool JAC>
__device__ __forceinline__ void load_mont(u32 r[W][NW], const int32_t* __restrict__ src, int lane,
                                          int B) {
  load_w<W>(r, src, lane, B);
  if (JAC) {
#pragma unroll
    for (int c = 0; c < W; c++) fp_mul(r[c], r[c], R2_W);
  }
}

// (x, y, is_identity) per lane: x = X / Z, y = Y / Z (projective), or
// x = X / Z^2, y = Y / Z^3 (JAC); Z = 0 -> (0, 0), flag set
template <int W, bool JAC>
__global__ void __launch_bounds__(AFF_LANES, 1)
    affine_kernel(const int32_t* __restrict__ X, const int32_t* __restrict__ Y,
                  const int32_t* __restrict__ Z, int B, int32_t* ox, int32_t* oy,
                  int32_t* inf) {
  __shared__ uint4 smem[2 * AFF_LANES * 3];  // heap: node i at slot i, leaves 256..511
  u32* tree = reinterpret_cast<u32*>(smem);
  const int t = threadIdx.x;
  const int lane = blockIdx.x * AFF_LANES + t;
  const bool live = lane < B;

  bool zero = true;
  u32 nz[NW];
  {
    u32 z[W][NW];
#pragma unroll
    for (int c = 0; c < W; c++)
#pragma unroll
      for (int k = 0; k < NW; k++) z[c][k] = 0u;
    if (live) {
      load_mont<W, JAC>(z, Z, lane, B);
#pragma unroll
      for (int c = 0; c < W; c++) zero &= is_zero_words(z[c]);
    }
    if (W == 1) {
#pragma unroll
      for (int k = 0; k < NW; k++) nz[k] = z[0][k];
    } else if (!zero) {  // the norm z0^2 + z1^2 is 0 only for z = 0
      u32 s1[NW];
      fp_mul(nz, z[0], z[0]);
      fp_mul(s1, z[W - 1], z[W - 1]);
      fp_add(nz, nz, s1);
    }
  }
  if (zero) {
#pragma unroll
    for (int k = 0; k < NW; k++) nz[k] = ONE_W[k];
  }
  store_slot(tree, AFF_LANES + t, nz);
  __syncthreads();
  for (int s = AFF_LANES / 2; s >= 1; s >>= 1) {  // up: node s + t = product of its children
    if (t < s) {
      u32 l[NW], r[NW];
      load_slot(l, tree, 2 * (s + t));
      load_slot(r, tree, 2 * (s + t) + 1);
      fp_mul(l, l, r);
      store_slot(tree, s + t, l);
    }
    __syncthreads();
  }
  if (t == 0) {
    u32 root[NW];
    load_slot(root, tree, 1);
    fp_inv(root, root);
    store_slot(tree, 1, root);
  }
  __syncthreads();
  for (int s = 1; s < AFF_LANES; s <<= 1) {  // down: child = inverse(parent) * sibling
    u32 v[NW];
    const int child = 2 * s + t;
    if (t < 2 * s) {
      u32 sib[NW];
      load_slot(v, tree, child >> 1);
      load_slot(sib, tree, child ^ 1);
      fp_mul(v, v, sib);
    }
    __syncthreads();
    if (t < 2 * s) store_slot(tree, child, v);
    __syncthreads();
  }
  if (!live) return;

  // 1 / Z: the leaf's inverse (G2: conj(Z) / norm), masked for Z = 0; Z is
  // read again rather than kept live across the tree
  u32 zi[W][NW];
  load_slot(nz, tree, AFF_LANES + t);
  if (zero) {
#pragma unroll
    for (int k = 0; k < NW; k++) nz[k] = 0u;
  }
  if (W == 1) {
#pragma unroll
    for (int k = 0; k < NW; k++) zi[0][k] = nz[k];
  } else {
    u32 z[W][NW], zero_w[NW];
    load_mont<W, JAC>(z, Z, lane, B);
#pragma unroll
    for (int k = 0; k < NW; k++) zero_w[k] = 0u;
    fp_mul(zi[0], z[0], nz);
    fp_mul(zi[W - 1], z[W - 1], nz);
    fp_sub(zi[W - 1], zero_w, zi[W - 1]);
  }
  u32 c[W][NW], out[W][NW];
  if (JAC) {  // x = X zi^2, y = Y zi^3
    u32 zi2[W][NW];
    fw_mul<W>(zi2, zi, zi);
    load_mont<W, JAC>(c, X, lane, B);
    fw_mul<W>(out, c, zi2);
    store_w<W>(ox, lane, B, out);
    fw_mul<W>(zi, zi2, zi);
  } else {
    load_mont<W, JAC>(c, X, lane, B);
    fw_mul<W>(out, c, zi);
    store_w<W>(ox, lane, B, out);
  }
  load_mont<W, JAC>(c, Y, lane, B);
  fw_mul<W>(out, c, zi);
  store_w<W>(oy, lane, B, out);
  inf[lane] = zero ? 1 : 0;
}

// ------------------------------------------------------------ C entries

template <int W>
static int launch_fold(const void* X, const void* Y, const void* Z, int B_in, int seg, int L,
                       void* oX, void* oY, void* oZ, void* stream) {
  const cudaError_t e = cudaFuncSetAttribute(
      fold_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize, Fold<W>::BYTES);
  if (e != cudaSuccess) return (int)e;
  const int cols = B_in >> L;
  const int per_block = SUM_POINTS >> L;
  const int blocks = (cols + per_block - 1) / per_block;
  fold_kernel<W><<<blocks, SUM_THREADS, Fold<W>::BYTES, (cudaStream_t)stream>>>(
      (const int32_t*)X, (const int32_t*)Y, (const int32_t*)Z, B_in, seg, L, (int32_t*)oX,
      (int32_t*)oY, (int32_t*)oZ);
  return (int)cudaGetLastError();
}

template <int W, bool JAC>
static int launch_affine(const void* X, const void* Y, const void* Z, int B, void* ox, void* oy,
                         void* inf, void* stream) {
  const int blocks = (B + AFF_LANES - 1) / AFF_LANES;
  affine_kernel<W, JAC><<<blocks, AFF_LANES, 0, (cudaStream_t)stream>>>(
      (const int32_t*)X, (const int32_t*)Y, (const int32_t*)Z, B, (int32_t*)ox, (int32_t*)oy,
      (int32_t*)inf);
  return (int)cudaGetLastError();
}

extern "C" int lh_lane_fold_g1(const void* X, const void* Y, const void* Z, int B_in, int seg,
                               int L, void* oX, void* oY, void* oZ, void* stream) {
  return launch_fold<1>(X, Y, Z, B_in, seg, L, oX, oY, oZ, stream);
}

extern "C" int lh_lane_fold_g2(const void* X, const void* Y, const void* Z, int B_in, int seg,
                               int L, void* oX, void* oY, void* oZ, void* stream) {
  return launch_fold<2>(X, Y, Z, B_in, seg, L, oX, oY, oZ, stream);
}

extern "C" int lh_to_affine_g1(const void* X, const void* Y, const void* Z, int B, void* ox,
                               void* oy, void* inf, void* stream) {
  return launch_affine<1, false>(X, Y, Z, B, ox, oy, inf, stream);
}

extern "C" int lh_to_affine_g2(const void* X, const void* Y, const void* Z, int B, void* ox,
                               void* oy, void* inf, void* stream) {
  return launch_affine<2, false>(X, Y, Z, B, ox, oy, inf, stream);
}

extern "C" int lh_jacobian_to_affine_g1(const void* X, const void* Y, const void* Z, int B,
                                        void* ox, void* oy, void* inf, void* stream) {
  return launch_affine<1, true>(X, Y, Z, B, ox, oy, inf, stream);
}

extern "C" int lh_jacobian_to_affine_g2(const void* X, const void* Y, const void* Z, int B,
                                        void* ox, void* oy, void* inf, void* stream) {
  return launch_affine<2, true>(X, Y, Z, B, ox, oy, inf, stream);
}
