// The altair epoch pass: inactivity-score updates, then the rewards and
// penalties of the three participation flags and the inactivity penalty,
// over the (V,) validator arrays.
//
// Replaces lighthouse_tpu/state_processing/epoch_kernel.py `_kernel` (:37),
// which is XLA on the TPU, no Pallas kernel: one jitted elementwise pass
// whose three per-flag participating balances are sums over (V,). The
// plain version is lighthouse_tpu_torch/state_processing/epoch_kernel.py
// `rewards_plain`; the host side (extraction, the int64 envelope, the
// scalars, the divisors' magic numbers) is that module's `rewards` and
// `run_inactivity_and_rewards`, and its `floordiv_magic` models the
// division below.
//
// What it computes, for every validator i (int64, floor division, two's
// complement wrap as in torch and jnp):
//   unslashed = active_prev & !slashed; base = (eff / inc) * base_per_inc
//   target    = unslashed & flag 1 of prev_part
//   score'    = eligible ? (target ? s - min(1, s) : s + bias) then, out of
//               a leak, minus min(recovery, that) : s
//   reward    = sum over flags f of eligible & part_f & !leak ?
//               base w_f inc_f / (active_increments 64) : 0,
//               inc_f = max(inc, sum of eff over part_f) / inc
//   penalty   = sum over flags f != head of eligible & !part_f ? base w_f / 64
//               + eligible & !target ? eff score' / denominator : 0
//   balance'  = max(0, balance + reward - penalty)
// The inactivity penalty reads the UPDATED score, as the spec orders
// process_inactivity_updates before process_rewards_and_penalties.
//
// What bounds it on the H100: bytes. A validator is 3 int64 words, its
// uint8 flags and 3 bool bytes read, 2 int64 words written, against a few
// dozen integer operations; the sums need eff, the flags and two masks
// once more.
//
// Design: two launches from one C entry on one stream, no host round trip
// and no memset.
// * No 64-bit division by a runtime divisor: the card has no such
//   instruction, and its software routine was a call with a stack frame.
//   Each of the epoch's divisors (the increment, the reward denominator
//   active_increments 64 formed with int64 wrap, the inactivity
//   denominator) comes with a magic number from the host (Granlund and
//   Montgomery's round-up method for unsigned 64-bit dividends, Hacker's
//   Delight 10-8): q = (t + ((u - t) >> sh1)) >> sh2 with t = mulhi(m, u)
//   is u / v exactly for u = |a| < 2^64 and v = |d|, and the floor
//   correction -q - (u != q v) where a and d differ in sign makes it
//   floor(a / d) for every int64 a, INT64_MIN included (no divisor is -1:
//   the reward denominator is a multiple of 64, the others positive).
//   Division by 64 is an arithmetic shift right by 6.
// * The sums pass: a grid-stride loop unrolled twice, 4 validators a
//   thread (int64 rows as two 16-byte loads, bytes as one 4-byte load),
//   warp shuffles, one 64-bit atomicAdd a block and flag into a workspace
//   that the wrapper keeps zeroed; then a done-counter: the last block to
//   finish (its ticket after a __threadfence) takes the three sums with
//   atomicExch, leaving them 0 for the next call, and computes the epoch's
//   scalars once: w_f inc_f = w_f max(inc, sum_f) / inc for each flag, and
//   the table of each flag's reward for k = eff / inc below 64 (every
//   effective balance under 64 increments), so that a validator's rewards
//   are three table reads and no division.
// * The elementwise pass: one validator a thread, each array read as the
//   warp's coalesced run (256 bytes of int64, 32 of bytes); on this card
//   that ran faster than 2 or 4 validators a thread, whose registers cut
//   the warps an SM (probes/epoch_passes.py). It is a programmatic
//   dependent launch: its blocks start while the sums pass runs, load
//   their validators, and wait for the sums pass (griddepcontrol.wait)
//   only before they read the scalars.
// Where eff or a byte array is not aligned to its vector the sums pass
// runs one validator a thread instead.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace ep {

constexpr int THREADS = 256;
constexpr int FLAGS = 3;
constexpr int HEAD_FLAG = 2;
constexpr int TARGET_FLAG = 1;
constexpr int WEIGHT_SHIFT = 6;  // WEIGHT_DENOMINATOR = 64 = 2^6
constexpr int MAX_DEVICES = 64;

// the rewards a flag tabled by k = eff / inc, for k below TABLE (a
// validator's effective balance under 64 increments)
constexpr int TABLE = 64;
// the workspace's int64 words: the sums, the done-counter, w_f inc_f for
// each flag, one spare, the table [flag][k]
constexpr int WS_SUMS = 0, WS_DONE = 3, WS_WPI = 4, WS_TABLE = 8,
              WS_WORDS = WS_TABLE + FLAGS * TABLE;

__device__ __forceinline__ int64_t weight(int f) { return f == 0 ? 14 : f == 1 ? 26 : 14; }

// a divisor d: its magic number m, v = |d|, the two shifts, d < 0
struct Magic {
  uint64_t m, v;
  int sh1, sh2, neg;
};

struct Params {
  int64_t base_per_inc, increment, leak, bias, recovery;
  Magic inc, reward, inactivity;
};

// two's complement wrap, as int64 tensors do
__device__ __forceinline__ int64_t wmul(int64_t a, int64_t b) {
  return (int64_t)((uint64_t)a * (uint64_t)b);
}
__device__ __forceinline__ int64_t wadd(int64_t a, int64_t b) {
  return (int64_t)((uint64_t)a + (uint64_t)b);
}
__device__ __forceinline__ int64_t wsub(int64_t a, int64_t b) {
  return (int64_t)((uint64_t)a - (uint64_t)b);
}

// Python's and torch's `//` by the divisor of `d`: rounds toward minus
// infinity
__device__ __forceinline__ int64_t floordiv(int64_t a, const Magic& d) {
  const bool neg_a = a < 0;
  const uint64_t u = neg_a ? 0ull - (uint64_t)a : (uint64_t)a;
  const uint64_t t = __umul64hi(d.m, u);
  const uint64_t q = (t + ((u - t) >> d.sh1)) >> d.sh2;
  if (neg_a != (d.neg != 0)) return (int64_t)(0ull - q - (uint64_t)(u != q * d.v));
  return (int64_t)q;
}

// VEC consecutive entries from entry g VEC on, zero past n: for a whole
// group of 4, two 16-byte loads (int64) or one 4-byte load (bytes)
template <int VEC>
__device__ __forceinline__ void load64(int64_t (&x)[VEC], const int64_t* __restrict__ p, int g,
                                       int n) {
  const int i = g * VEC;
  if constexpr (VEC == 4) {
    if (i + 4 <= n) {
      const longlong2 a = reinterpret_cast<const longlong2*>(p + i)[0];
      const longlong2 b = reinterpret_cast<const longlong2*>(p + i)[1];
      x[0] = a.x; x[1] = a.y; x[2] = b.x; x[3] = b.y;
      return;
    }
  }
#pragma unroll
  for (int k = 0; k < VEC; ++k) x[k] = i + k < n ? p[i + k] : 0;
}

template <int VEC>
__device__ __forceinline__ void load8(uint32_t (&x)[VEC], const uint8_t* __restrict__ p, int g,
                                      int n) {
  const int i = g * VEC;
  if constexpr (VEC == 4) {
    if (i + 4 <= n) {
      const uint32_t w = reinterpret_cast<const uint32_t*>(p + i)[0];
#pragma unroll
      for (int k = 0; k < VEC; ++k) x[k] = (w >> (8 * k)) & 0xffu;
      return;
    }
  }
#pragma unroll
  for (int k = 0; k < VEC; ++k) x[k] = i + k < n ? p[i + k] : 0u;
}

// the reward of flag f for a validator of k = eff / inc base increments:
// (k base_per_inc) w_f inc_f / (active_increments 64)
__device__ __forceinline__ int64_t flag_reward(int64_t k, int64_t wpi, const Params& p) {
  return floordiv(wmul(wmul(k, p.base_per_inc), wpi), p.reward);
}

template <int VEC>
__global__ void __launch_bounds__(THREADS) sums_kernel(
    const int64_t* __restrict__ eff, const uint8_t* __restrict__ part,
    const uint8_t* __restrict__ active, const uint8_t* __restrict__ slashed, int n, Params p,
    unsigned long long* __restrict__ ws) {
  // the elementwise pass may start loading its inputs at once
  asm volatile("griddepcontrol.launch_dependents;");
  unsigned long long acc[FLAGS] = {0, 0, 0};
  const int groups = (n + VEC - 1) / VEC;
#pragma unroll 2
  for (int g = blockIdx.x * THREADS + threadIdx.x; g < groups; g += gridDim.x * THREADS) {
    int64_t e[VEC];
    uint32_t pt[VEC], ac[VEC], sl[VEC];
    load64<VEC>(e, eff, g, n);
    load8<VEC>(pt, part, g, n);
    load8<VEC>(ac, active, g, n);
    load8<VEC>(sl, slashed, g, n);
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const bool unslashed = ac[k] && !sl[k];
#pragma unroll
      for (int f = 0; f < FLAGS; ++f)
        acc[f] += (unslashed && ((pt[k] >> f) & 1u)) ? (unsigned long long)e[k] : 0ull;
    }
  }
  __shared__ unsigned long long warp_sums[FLAGS][THREADS / 32];
  __shared__ int64_t wpi[FLAGS];
  __shared__ bool last;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int f = 0; f < FLAGS; ++f) {
    for (int off = 16; off > 0; off >>= 1) acc[f] += __shfl_down_sync(0xffffffffu, acc[f], off);
    if (lane == 0) warp_sums[f][warp] = acc[f];
  }
  __syncthreads();
  if (threadIdx.x < FLAGS) {
    unsigned long long total = 0;
    for (int w = 0; w < THREADS / 32; ++w) total += warp_sums[threadIdx.x][w];
    atomicAdd(&ws[WS_SUMS + threadIdx.x], total);
    __threadfence();
  }
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(&ws[WS_DONE], 1ull) == (unsigned long long)(gridDim.x - 1);
  __syncthreads();
  if (!last) return;
  // the last block: every block's sums are in. A thread a flag takes its
  // sum, leaving 0 for the next call, and forms w_f inc_f; then the block
  // fills the table of rewards by k = eff / inc below TABLE
  if (threadIdx.x < FLAGS) {
    __threadfence();
    const int f = threadIdx.x;
    const int64_t sum = (int64_t)atomicExch(&ws[WS_SUMS + f], 0ull);
    const int64_t part_increments = floordiv(sum > p.increment ? sum : p.increment, p.inc);
    wpi[f] = wmul(weight(f), part_increments);
    ws[WS_WPI + f] = (unsigned long long)wpi[f];
    if (f == 0) atomicExch(&ws[WS_DONE], 0ull);
  }
  __syncthreads();
  for (int t = threadIdx.x; t < FLAGS * TABLE; t += THREADS)
    ws[WS_TABLE + t] = (unsigned long long)flag_reward(t % TABLE, wpi[t / TABLE], p);
}

// one validator a thread: its rows are read as the warp's coalesced
// 256-byte (int64) and 32-byte (bytes) runs
__global__ void __launch_bounds__(THREADS) rewards_kernel(
    const int64_t* __restrict__ eff, const uint8_t* __restrict__ part,
    const int64_t* __restrict__ scores, const int64_t* __restrict__ balances,
    const uint8_t* __restrict__ active, const uint8_t* __restrict__ slashed,
    const uint8_t* __restrict__ eligible, int n, Params p,
    const unsigned long long* __restrict__ ws, int64_t* __restrict__ out_balances,
    int64_t* __restrict__ out_scores) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  int64_t e = 0, s = 0, bal = 0;
  uint32_t flags = 0, ac = 0, sl = 0, el = 0;
  if (i < n) {
    e = eff[i]; s = scores[i]; bal = balances[i];
    flags = part[i]; ac = active[i]; sl = slashed[i]; el = eligible[i];
  }
  // the inputs are in flight; the scalars need the sums pass done (in a
  // launch in stream order the wait returns at once)
  asm volatile("griddepcontrol.wait;" ::: "memory");
  if (i >= n) return;
  const bool leak = p.leak != 0;
  const bool unslashed = ac && !sl;
  const bool elig = el != 0;
  const int64_t k = floordiv(e, p.inc);
  const int64_t base = wmul(k, p.base_per_inc);

  // process_inactivity_updates, on the old participation
  const bool target = unslashed && ((flags >> TARGET_FLAG) & 1u);
  int64_t ns = target ? wsub(s, s < 1 ? s : 1) : wadd(s, p.bias);
  if (!leak) ns = wsub(ns, p.recovery < ns ? p.recovery : ns);
  if (!elig) ns = s;

  // process_rewards_and_penalties
  int64_t rewards = 0, penalties = 0;
#pragma unroll
  for (int f = 0; f < FLAGS; ++f) {
    const bool in_flag = unslashed && ((flags >> f) & 1u);
    if (elig && in_flag && !leak)
      rewards = wadd(rewards, (uint64_t)k < (uint64_t)TABLE
                                  ? (int64_t)ws[WS_TABLE + f * TABLE + (int)k]
                                  : flag_reward(k, (int64_t)ws[WS_WPI + f], p));
    if (f != HEAD_FLAG && elig && !in_flag)
      penalties = wadd(penalties, wmul(base, weight(f)) >> WEIGHT_SHIFT);
  }
  if (elig && !target) penalties = wadd(penalties, floordiv(wmul(e, ns), p.inactivity));
  const int64_t b = wsub(wadd(bal, rewards), penalties);
  out_balances[i] = b > 0 ? b : 0;
  out_scores[i] = ns;
}

inline Magic magic(const int64_t* h) {
  const uint64_t w = (uint64_t)h[2];
  return {(uint64_t)h[0], (uint64_t)h[1], (int)(w & 0xff), (int)((w >> 8) & 0xff),
          (int)((w >> 16) & 1)};
}

// |d| and the sign agree with the divisor and the shifts are in range
inline bool magic_of(const Magic& m, int64_t d) {
  const uint64_t v = d < 0 ? 0ull - (uint64_t)d : (uint64_t)d;
  return d != 0 && m.v == v && m.neg == (d < 0) && m.sh1 <= 1 && m.sh2 <= 63;
}

// params: a HOST pointer to 16 int64 words (lh_epoch_rewards); false when
// a divisor or its magic words are not the pass's
inline bool params_of(const void* params, Params& p) {
  const int64_t* h = (const int64_t*)params;
  p = {h[0], h[1], h[3], h[4], h[5], magic(h + 7), magic(h + 10), magic(h + 13)};
  const int64_t reward_denominator = (int64_t)((uint64_t)h[2] * 64ull);
  return h[1] > 0 && h[2] > 0 && h[6] > 0 && magic_of(p.inc, h[1]) &&
         magic_of(p.reward, reward_denominator) && magic_of(p.inactivity, h[6]);
}

// the resident blocks an SM of the sums pass (4 validators a thread) and
// of the elementwise pass, and the SMs on the current device, asked once
// a device and published in one atomic word (16 bits each and a ready bit)
inline cudaError_t occupancy(int (&occ)[3]) {
  static std::atomic<unsigned long long> cached[MAX_DEVICES];  // 0 until published
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return rc;
  unsigned long long word = dev < MAX_DEVICES ? cached[dev].load() : 0ull;
  if (word == 0) {
    int sums = 0, rewards = 0, sms = 0;
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&sums, sums_kernel<4>, THREADS, 0);
    if (rc == cudaSuccess)
      rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&rewards, rewards_kernel, THREADS, 0);
    if (rc == cudaSuccess) rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (rc != cudaSuccess) return rc;
    // a kernel that cannot be resident, or a count past 16 bits, takes no grid
    if (sums <= 0 || rewards <= 0 || sms <= 0 || ((sums | rewards | sms) >> 16))
      return cudaErrorInvalidConfiguration;
    word = 1ull << 48 | (unsigned long long)sums | (unsigned long long)rewards << 16 |
           (unsigned long long)sms << 32;
    if (dev < MAX_DEVICES) cached[dev].store(word);
  }
  for (int k = 0; k < 3; ++k) occ[k] = (int)(word >> (16 * k) & 0xffffull);
  return cudaSuccess;
}

// the grids: the elementwise pass a thread a validator; the sums pass
// (VEC validators a thread) at most one full wave, its groups spread
// evenly over the fewest blocks that take them in that many sweeps
template <int VEC>
cudaError_t grids(int n, int& sum_blocks, int& reward_blocks, int (&occ)[3]) {
  const cudaError_t rc = occupancy(occ);
  if (rc != cudaSuccess) return rc;
  reward_blocks = (n + THREADS - 1) / THREADS;
  const int needed = ((n + VEC - 1) / VEC + THREADS - 1) / THREADS;
  const int wave = occ[0] * occ[2];
  const int sweeps = (needed + wave - 1) / wave;
  sum_blocks = (needed + sweeps - 1) / sweeps;
  return cudaSuccess;
}

template <int VEC>
cudaError_t run(const void* eff, const void* part, const void* scores, const void* balances,
                const void* active, const void* slashed, const void* eligible, int n,
                const Params& p, void* ws, void* out_balances, void* out_scores,
                cudaStream_t s) {
  int sum_blocks = 0, reward_blocks = 0, occ[3];
  cudaError_t rc = grids<VEC>(n, sum_blocks, reward_blocks, occ);
  if (rc != cudaSuccess) return rc;
  sums_kernel<VEC><<<sum_blocks, THREADS, 0, s>>>(
      (const int64_t*)eff, (const uint8_t*)part, (const uint8_t*)active, (const uint8_t*)slashed,
      n, p, (unsigned long long*)ws);
  rc = cudaGetLastError();
  if (rc != cudaSuccess) return rc;
  // a programmatic dependent launch: its blocks may start while the sums
  // pass runs and wait for it in griddepcontrol.wait
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.gridDim = dim3(reward_blocks);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  rc = cudaLaunchKernelEx(&cfg, rewards_kernel, (const int64_t*)eff, (const uint8_t*)part,
                          (const int64_t*)scores, (const int64_t*)balances,
                          (const uint8_t*)active, (const uint8_t*)slashed,
                          (const uint8_t*)eligible, n, p, (const unsigned long long*)ws,
                          (int64_t*)out_balances, (int64_t*)out_scores);
  if (rc != cudaSuccess) return rc;
  return cudaGetLastError();
}

}  // namespace ep

// out[6] (host ints) = the plan at n validators with every row aligned:
// the sums pass's validators a thread (4), the resident blocks an SM of
// the sums pass and of the elementwise pass, the SMs, and the two grids'
// blocks
extern "C" int lh_epoch_rewards_plan(int n, void* out, void* stream) {
  (void)stream;
  if (n <= 0) return (int)cudaErrorInvalidValue;
  int sum_blocks = 0, reward_blocks = 0, occ[3];
  const cudaError_t rc = ep::grids<4>(n, sum_blocks, reward_blocks, occ);
  if (rc != cudaSuccess) return (int)rc;
  int* o = (int*)out;
  o[0] = 4; o[1] = occ[0]; o[2] = occ[1]; o[3] = occ[2]; o[4] = sum_blocks; o[5] = reward_blocks;
  return 0;
}

// params: a HOST pointer to 16 int64 words, read before the launches: the
// 7 scalars (base_per_inc, increment, active_increments, leak, bias,
// recovery, denominator), then the magic numbers of the increment, of the
// reward denominator active_increments 64 (int64 wrap) and of the
// inactivity denominator, three words each (m, |d|, sh1 | sh2 << 8 |
// (d < 0) << 16); workspace: a device buffer of WS_WORDS int64 words whose
// sums and counter (words 0-3) are 0 on entry, as every call leaves them.
extern "C" int lh_epoch_rewards(const void* eff, const void* part, const void* scores,
                                const void* balances, const void* active, const void* slashed,
                                const void* eligible, int n, const void* params, void* workspace,
                                void* out_balances, void* out_scores, void* stream) {
  ep::Params p;
  if (n <= 0 || !ep::params_of(params, p)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if ((uintptr_t)eff % 16 == 0 &&
      ((uintptr_t)part | (uintptr_t)active | (uintptr_t)slashed) % 4 == 0)
    return (int)ep::run<4>(eff, part, scores, balances, active, slashed, eligible, n, p, workspace,
                           out_balances, out_scores, s);
  return (int)ep::run<1>(eff, part, scores, balances, active, slashed, eligible, n, p, workspace,
                         out_balances, out_scores, s);
}
