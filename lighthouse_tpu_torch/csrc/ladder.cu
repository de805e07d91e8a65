// K1 -- the per-lane RLC scalar ladders, [k_i] P_i per lane, for G1 and G2,
// in three forms: the signed-digit window (the verify path's default), the
// per-bit double-add chain and the 2-bit unsigned window.
//
// Replaces the TPU kernels of lighthouse_tpu/ops/pallas_ladder.py, all
// reached through `ladder_pallas(kind=...)`:
//   window -- `_ladder_kernel_w4`: signed digits, c = 4, MSB first; per
//             window four complete doublings and one complete addition of
//             +-table[|d|], with the table [0..8] P built in the kernel;
//   chain  -- `_ladder_kernel`: LSB first over the bits, per bit
//             acc += addend when the bit is set, addend doubles
//             (tcurve.ladder_step);
//   w2     -- `_ladder_kernel_w2`: MSB-first 2-bit digits, per window two
//             doublings and one complete addition of table[d] from
//             {O, P, 2P, 3P} (tcurve.window2_table / window2_step).
//
// What bounds them on the H100: integer multiply-adds. A lane's products
// grow with the scalar's width (ops/ladder_rows.py `lane_products`). Per
// 64-bit RLC scalar a G1 lane runs 816 Fp products in the window form (17
// windows x (4 doublings + 1 addition) plus the table's 4 doublings and 3
// additions), 916 in w2 (32 x (2 + 1) plus 1 + 1) and 1,272 in the chain
// (63 doublings, and an addition on every bit, since a warp runs in
// lockstep; 888 if it added on set bits only). Per 255-bit KZG scalar (the
// window form alone, 64 windows) a G1 lane runs 2,884. A G2 lane runs 2.5
// times as many products' multiply-adds (an Fp2 product by Karatsuba with
// the lazy reduction below). Each product is 288 32x32->64 multiply-adds;
// the bytes (one read of the point and the digits or bits, one write of
// the result) are ~1% of that.
//
// Design, one body for the three forms: two threads a lane on G1 and G2
// alike, the lane's values in a file of Fp slots in shared memory, its
// products register-resident and inlined (fp_reg.cuh), so nothing of the
// field arithmetic is in local memory. Each doubling and addition is two
// rounds of a MUL phase (the stage's independent products, half on each
// thread) and a LIN phase (the stage's linear recombination, one canonical
// Fp sum `lin_sum` a row, rows alternating between the threads), a warp
// barrier after each; an addition first loads sign * entry into V3..V5.
// The rows and the slot map are generated (ladder_rows.cuh from
// ops/ladder_rows.py, which also runs them and the forms' steps on Python
// integers for the CPU tests). A G1 row is one Fp product; a G2 row is one
// Fp2 product by Karatsuba with lazy reduction: three 24-word products,
// two Montgomery reductions. The kernel has one site each for the product,
// the reduction and `lin_sum`, because the card slows when the loop's code
// outgrows its instruction cache (PERF.md).
//
// A form is a schedule of steps (`Windowed`, `Chain`): a step loads the
// point V0..V2 from a scratch entry or not, runs one doubling or one
// addition of sign * entry, and stores V0..V2 to an entry or not. The
// entries live outside the thread, in a scratch tensor that the wrapper
// allocates, [lane][entry][coordinate][word], 144 w bytes an entry read as
// 16-byte words, each copy split over the lane's threads; the kernel
// allocates nothing. window and w2 keep the table [0, E) P there (E = 9, 4;
// even entries by doubling, odd ones by adding P); window's digits arrive
// pre-recoded, signed window-major (W, B), a magnitude clamped to 0..8 and
// the sign negating Y of the entry; w2's are MSB-first (W, B) digits masked
// & 3, whose 0 adds the identity entry with no branch. The chain keeps its
// accumulator and addend there (E = 2) and adds the accumulator to the
// addend in V0..V2: RCB's complete addition is symmetric in its inputs, so
// the words are those of acc + addend. Its lanes add on every bit, in
// lockstep with the warp's other lanes, and keep the sum where the bit is 1,
// as the JAX select does: the warp barriers need every lane of the warp in
// every phase. Every value stays canonical, so X:Y:Z equal the plain
// version's word for word. One design serves the slot (32,768 lanes: the
// card full of lanes, 12 warps an SM on G2, where shared memory is the
// limit) and the flat batch (1,024 lanes: a lane's chain of dependent
// products, halved by the two threads). ptxas -v (nvcc 12.9, sm_90a): no
// stack frame and no spills in any of the six; chip_smoke.py prints their
// registers (the `k1_ptxas` line) and fails on a frame or a spill.

#include <cuda_runtime.h>

#include "fp2_row.cuh"
#include "fp_reg.cuh"
#include "ladder_rows.cuh"

// ------------------------------------------------------------------ body

namespace k1 {

using fpr::add_words;
using fpr::fp2_row;
using fpr::fp_add;
using fpr::fp_mul;
using fpr::fp_sub;
using fpr::lin_sum;
using fpr::load_slot;
using fpr::NW;
using fpr::ONE_W;
using fpr::store_slot;
using fpr::u32;
using fpr::u64;
using k1rows::BLOCK;
using k1rows::T;
static_assert(k1rows::NONE == fpr::NO_TERM, "an absent operand term");

template <int W>
struct Width;
template <>
struct Width<1> {
  static constexpr int SLOTS = k1rows::SLOTS_G1, WORDS = k1rows::WORDS_G1;
  static __device__ __forceinline__ const u32* table() { return k1rows::TABLE_G1; }
};
template <>
struct Width<2> {
  static constexpr int SLOTS = k1rows::SLOTS_G2, WORDS = k1rows::WORDS_G2;
  static __device__ __forceinline__ const u32* table() { return k1rows::TABLE_G2; }
};

// MUL: this thread's rows of phase p (D1, D3, A1, A3), each (a + a2)(b +
// b2) over values, a2 or b2 NONE where absent
template <int W>
__device__ __forceinline__ void mul_rows(u32* f, const u32* tab, int p, int tid) {
  const u32 idx = tab[k1rows::MUL_INDEX + p * T + tid];
  const int r0 = idx & 0xffffu, n = idx >> 16;
#pragma unroll 1
  for (int k = 0; k < n; k++) {
    const u32 r = tab[r0 + k];
    const u32 sa = (r >> 6) & 63u, sa2 = (r >> 12) & 63u, sb = (r >> 18) & 63u,
              sb2 = (r >> 24) & 63u;
    if constexpr (W == 1) {
      u32 a[NW], b[NW], u[NW];
      load_slot(a, f, sa);
      if (sa2 != k1rows::NONE) {
        load_slot(u, f, sa2);
        add_words(a, a, u);  // below 2p, as fp_mul takes it
      }
      load_slot(b, f, sb);
      if (sb2 != k1rows::NONE) {
        load_slot(u, f, sb2);
        add_words(b, b, u);
      }
      fp_mul(a, a, b);
      store_slot(f, r & 63u, a);
    } else {
      fp2_row(f, r & 63u, sa, sa2, sb, sb2);
    }
  }
}

// LIN: this thread's rows of phase p (DBL_MID, DBL_OUT, ADD_MID, ADD_OUT),
// each one canonical Fp sum sum_t c_t slot_t
__device__ __forceinline__ void lin_rows(u32* f, const u32* tab, int p, int tid) {
  const u32 idx = tab[k1rows::LIN_INDEX + p * T + tid];
  const int r0 = idx & 0xffffu, n = idx >> 16;
#pragma unroll 1
  for (int k = 0; k < n; k++) {
    const u32 r = tab[r0 + k];
    u32 x[NW];
    lin_sum(x, tab + (r >> 16), (r >> 8) & 255u, f, 0u, true);
    store_slot(f, r & 255u, x);
  }
}

// ADD_IN: the addend V3..V5 <- sign * entry (its Y negated for a negative
// digit), slot k of the entry on thread k mod T
template <int W>
__device__ __forceinline__ void add_in(u32* f, const u32* entry, bool neg, int tid) {
  for (int k = tid; k < 3 * W; k += T) {
    u32 x[NW], z[NW], n[NW];
    load_slot(x, entry, k);
#pragma unroll
    for (int j = 0; j < NW; j++) z[j] = 0u;
    fp_sub(n, z, x);
    const bool flip = neg && k >= W && k < 2 * W;
#pragma unroll
    for (int j = 0; j < NW; j++) x[j] = flip ? n[j] : x[j];
    store_slot(f, 3 * W + k, x);
  }
}

// n words between a group's file and the scratch (16-byte aligned both),
// this thread's share: word quads tid, tid + T, ...
__device__ __forceinline__ void copy_words(u32* dst, const u32* src, int n, int tid) {
  for (int q = tid; q < n / 4; q += T)
    reinterpret_cast<uint4*>(dst)[q] = reinterpret_cast<const uint4*>(src)[q];
}

// ------------------------------------------------------------ schedules

// One step of a lane: V0..V2 <- entry `load` first (-1: none), then a
// doubling (add < 0) or an addition of sign * entry `add`, then entry
// `store` <- V0..V2 (-1: none). Whether a step adds is the same for every
// lane of a step; `store` may differ.
struct Step {
  int load, add, store;
  bool neg;
};

// window (E = 9, C = 4, signed digits: magnitudes d0 and signs d1,
// LSB-first window-major) and w2 (E = 4, C = 2, MSB-first digits d0
// masked & 3): the table's entries 2..E-1 (even ones by doubling entry
// d / 2, odd ones by adding P to the last), then MSB first per window C
// doublings, the first from the identity (entry 0), and one addition of
// sign * table[digit]. The result is V0..V2, or the identity with no
// windows.
template <int E, int C, bool SIGNED>
struct Windowed {
  static_assert(SIGNED || (E & (E - 1)) == 0, "an unsigned digit is masked & (E - 1)");
  static constexpr int ENTRIES = E;
  static __device__ __forceinline__ int steps(int n) { return E - 2 + (C + 1) * n; }
  static __device__ __forceinline__ int result(int n) { return n ? -1 : 0; }
  static __device__ __forceinline__ Step step(int s, int n, const int32_t* d0,
                                              const int32_t* d1, int B, int lane) {
    if (s < E - 2) {
      const int d = s + 2;
      return d & 1 ? Step{-1, 1, d, false} : Step{d / 2, -1, d, false};
    }
    const int k = (s - (E - 2)) % (C + 1), j = (s - (E - 2)) / (C + 1);
    if (k < C) return Step{s == E - 2 ? 0 : -1, -1, -1, false};
    if constexpr (!SIGNED) {
      return Step{-1, d0[(size_t)j * B + lane] & (E - 1), -1, false};
    } else {
      const size_t at = (size_t)(n - 1 - j) * B + lane;
      const int mag = d0[at];  // recode_bits keeps |d| <= 8
      return Step{-1, mag < 0 ? 0 : (mag > E - 1 ? E - 1 : mag), -1, d1[at] != 0};
    }
  }
};

// chain (E = 2): entry 0 the accumulator, from the identity, entry 1 the
// addend, from P. Per bit d0[i], LSB first: the addend (V0..V2) plus the
// accumulator, kept as the accumulator where the bit is 1; between bits
// the addend doubles. The result is the accumulator.
struct Chain {
  static constexpr int ENTRIES = 2;
  static __device__ __forceinline__ int steps(int n) { return 2 * n - 1; }
  static __device__ __forceinline__ int result(int) { return 0; }
  static __device__ __forceinline__ Step step(int s, int, const int32_t* d0, const int32_t*,
                                              int B, int lane) {
    if (s & 1) return Step{1, -1, 1, false};
    return Step{-1, 0, d0[(size_t)(s / 2) * B + lane] == 1 ? 0 : -1, false};
  }
};

using WindowForm = Windowed<k1rows::ENTRIES_WINDOW, k1rows::DOUBLINGS_WINDOW, true>;
using W2Form = Windowed<k1rows::ENTRIES_W2, k1rows::DOUBLINGS_W2, false>;
static_assert(k1rows::ENTRIES_CHAIN == Chain::ENTRIES, "the chain's scratch");

// A lane a group of T threads runs form S's steps. A doubling is MUL D1,
// LIN DBL_MID, MUL D3, LIN DBL_OUT; an addition ADD_IN, MUL A1, LIN
// ADD_MID, MUL A3, LIN ADD_OUT; a warp barrier after each, and after each
// step's loads and stores, which the lane's threads split between them.
template <int W, class S>
__global__ void __launch_bounds__(BLOCK)
    ladder_kernel(const int32_t* __restrict__ X, const int32_t* __restrict__ Y,
                  const int32_t* __restrict__ Z, const int32_t* __restrict__ d0,
                  const int32_t* __restrict__ d1, int n, int B, int32_t* scratch, int32_t* oX,
                  int32_t* oY, int32_t* oZ) {
  constexpr int GROUPS = BLOCK / T, SLOTS = Width<W>::SLOTS, WORDS = Width<W>::WORDS;
  constexpr int ES = 3 * W * NW;  // words of a point, a scratch entry
  __shared__ uint4 smem[(WORDS + GROUPS * SLOTS * NW) / 4];
  u32* tab = reinterpret_cast<u32*>(smem);
  for (int i = threadIdx.x; i < WORDS; i += BLOCK) tab[i] = Width<W>::table()[i];
  __syncthreads();
  const int tid = threadIdx.x % T, g = threadIdx.x / T;
  const int lane = blockIdx.x * GROUPS + g;
  const unsigned mask = __ballot_sync(0xffffffffu, lane < B);
  if (lane >= B) return;
  u32* f = tab + WORDS + g * SLOTS * NW;
  u32* ent = reinterpret_cast<u32*>(scratch) + (size_t)lane * S::ENTRIES * ES;
  // V0..V2 and entry 1 <- P, entry 0 <- the identity (0 : 1 : 0)
  for (int i = tid; i < ES; i += T) {
    const int32_t* src = i < W * NW ? X : (i < 2 * W * NW ? Y : Z);
    f[i] = ent[ES + i] = (u32)src[(size_t)(i % (W * NW)) * B + lane];
    ent[i] = i >= W * NW && i < W * NW + NW ? ONE_W[i - W * NW] : 0u;
  }
  __syncwarp(mask);
  const int n_steps = S::steps(n);
  for (int s = 0; s < n_steps; s++) {
    const Step st = S::step(s, n, d0, d1, B, lane);
    if (st.load >= 0) copy_words(f, ent + st.load * ES, ES, tid);
    __syncwarp(mask);
    const bool is_add = st.add >= 0;
    if (is_add) {
      add_in<W>(f, ent + st.add * ES, st.neg, tid);
      __syncwarp(mask);
    }
#pragma unroll 1
    for (int ph = 0; ph < 2; ph++) {
      const int p = 2 * is_add + ph;
      mul_rows<W>(f, tab, p, tid);
      __syncwarp(mask);
      lin_rows(f, tab, p, tid);
      __syncwarp(mask);
    }
    if (st.store >= 0) copy_words(ent + st.store * ES, f, ES, tid);
    __syncwarp(mask);  // V0..V2 read by the stores before the next step writes it
  }
  const int r = S::result(n);
  const u32* res = r < 0 ? f : ent + r * ES;
  for (int i = tid; i < W * NW; i += T) {
    oX[(size_t)i * B + lane] = (int32_t)res[i];
    oY[(size_t)i * B + lane] = (int32_t)res[W * NW + i];
    oZ[(size_t)i * B + lane] = (int32_t)res[2 * W * NW + i];
  }
}

}  // namespace k1

// d0, d1: window's magnitudes and signs; the chain's bits or w2's digits
// and no d1
template <int W, class S>
static int launch(const void* X, const void* Y, const void* Z, const void* d0, const void* d1,
                  int n, int B, void* scratch, void* oX, void* oY, void* oZ, void* stream) {
  constexpr int groups = k1rows::BLOCK / k1rows::T;
  const int blocks = (B + groups - 1) / groups;
  k1::ladder_kernel<W, S><<<blocks, k1rows::BLOCK, 0, (cudaStream_t)stream>>>(
      (const int32_t*)X, (const int32_t*)Y, (const int32_t*)Z, (const int32_t*)d0,
      (const int32_t*)d1, n, B, (int32_t*)scratch, (int32_t*)oX, (int32_t*)oY, (int32_t*)oZ);
  return (int)cudaGetLastError();
}

extern "C" int lh_ladder_g1(const void* X, const void* Y, const void* Z, const void* mags,
                            const void* negs, int n_windows, int B, void* scratch, void* oX,
                            void* oY, void* oZ, void* stream) {
  return launch<1, k1::WindowForm>(X, Y, Z, mags, negs, n_windows, B, scratch, oX, oY, oZ, stream);
}

extern "C" int lh_ladder_g2(const void* X, const void* Y, const void* Z, const void* mags,
                            const void* negs, int n_windows, int B, void* scratch, void* oX,
                            void* oY, void* oZ, void* stream) {
  return launch<2, k1::WindowForm>(X, Y, Z, mags, negs, n_windows, B, scratch, oX, oY, oZ, stream);
}

extern "C" int lh_ladder_g1_chain(const void* X, const void* Y, const void* Z, const void* bits,
                                  int n_bits, int B, void* scratch, void* oX, void* oY, void* oZ,
                                  void* stream) {
  return launch<1, k1::Chain>(X, Y, Z, bits, nullptr, n_bits, B, scratch, oX, oY, oZ, stream);
}

extern "C" int lh_ladder_g2_chain(const void* X, const void* Y, const void* Z, const void* bits,
                                  int n_bits, int B, void* scratch, void* oX, void* oY, void* oZ,
                                  void* stream) {
  return launch<2, k1::Chain>(X, Y, Z, bits, nullptr, n_bits, B, scratch, oX, oY, oZ, stream);
}

extern "C" int lh_ladder_g1_w2(const void* X, const void* Y, const void* Z, const void* digits,
                               int n_windows, int B, void* scratch, void* oX, void* oY, void* oZ,
                               void* stream) {
  return launch<1, k1::W2Form>(X, Y, Z, digits, nullptr, n_windows, B, scratch, oX, oY, oZ,
                               stream);
}

extern "C" int lh_ladder_g2_w2(const void* X, const void* Y, const void* Z, const void* digits,
                               int n_windows, int B, void* scratch, void* oX, void* oY, void* oZ,
                               void* stream) {
  return launch<2, k1::W2Form>(X, Y, Z, digits, nullptr, n_windows, B, scratch, oX, oY, oZ,
                               stream);
}
