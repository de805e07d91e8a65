// The altair epoch pass: inactivity-score updates, then the rewards and
// penalties of the three participation flags and the inactivity penalty,
// over the (V,) validator arrays.
//
// Replaces lighthouse_tpu/state_processing/epoch_kernel.py `_kernel` (:37),
// which is XLA on the TPU, no Pallas kernel: one jitted elementwise pass
// whose three per-flag participating balances are sums over (V,). The
// plain version is lighthouse_tpu_torch/state_processing/epoch_kernel.py
// `rewards_plain`; the host side (extraction, the int64 envelope, the
// scalars) is that module's `run_inactivity_and_rewards`.
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
// between them. The first is a grid-stride reduction of the three sums
// (warp shuffles, then one 64-bit atomicAdd a block and flag into a
// device buffer that the entry zeroes first); the second is one thread a
// validator and reads the three sums from that buffer.

#include <cuda_runtime.h>
#include <stdint.h>

namespace ep {

constexpr int THREADS = 256;
constexpr int MAX_SUM_BLOCKS = 1056;  // 132 SMs x 8
constexpr int FLAGS = 3;
constexpr int HEAD_FLAG = 2;
constexpr int TARGET_FLAG = 1;
constexpr int64_t WEIGHT_DENOMINATOR = 64;

__device__ __forceinline__ int64_t weight(int f) { return f == 0 ? 14 : f == 1 ? 26 : 14; }

// the scalars, in the order of the host's params array
struct Params {
  int64_t base_per_inc, increment, active_increments, leak, bias, recovery, denominator;
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
// Python's and torch's `//`: rounds toward minus infinity
__device__ __forceinline__ int64_t floordiv(int64_t a, int64_t b) {
  int64_t q = a / b;
  if ((a % b != 0) && ((a < 0) != (b < 0))) --q;
  return q;
}

__global__ void __launch_bounds__(THREADS) sums_kernel(
    const int64_t* __restrict__ eff, const uint8_t* __restrict__ part,
    const uint8_t* __restrict__ active, const uint8_t* __restrict__ slashed, int n,
    unsigned long long* __restrict__ sums) {
  unsigned long long acc[FLAGS] = {0, 0, 0};
  for (int i = blockIdx.x * THREADS + threadIdx.x; i < n; i += gridDim.x * THREADS) {
    if (active[i] && !slashed[i]) {
      const int p = part[i];
      const unsigned long long e = (unsigned long long)eff[i];
#pragma unroll
      for (int f = 0; f < FLAGS; ++f)
        if ((p >> f) & 1) acc[f] += e;
    }
  }
  __shared__ unsigned long long warp_sums[FLAGS][THREADS / 32];
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
    atomicAdd(&sums[threadIdx.x], total);
  }
}

__global__ void __launch_bounds__(THREADS) rewards_kernel(
    const int64_t* __restrict__ eff, const uint8_t* __restrict__ part,
    const int64_t* __restrict__ scores, const int64_t* __restrict__ balances,
    const uint8_t* __restrict__ active, const uint8_t* __restrict__ slashed,
    const uint8_t* __restrict__ eligible, int n, Params p,
    const unsigned long long* __restrict__ sums, int64_t* __restrict__ out_balances,
    int64_t* __restrict__ out_scores) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  int64_t part_increments[FLAGS];
#pragma unroll
  for (int f = 0; f < FLAGS; ++f) {
    const int64_t sum = (int64_t)sums[f];
    part_increments[f] = floordiv(sum > p.increment ? sum : p.increment, p.increment);
  }
  const bool leak = p.leak != 0;
  const bool unslashed = active[i] && !slashed[i];
  const bool elig = eligible[i] != 0;
  const int64_t e = eff[i], s = scores[i];
  const int flags = part[i];
  const int64_t base = wmul(floordiv(e, p.increment), p.base_per_inc);

  // process_inactivity_updates, on the old participation
  const bool target = unslashed && ((flags >> TARGET_FLAG) & 1);
  int64_t ns = target ? wsub(s, s < 1 ? s : 1) : wadd(s, p.bias);
  if (!leak) ns = wsub(ns, p.recovery < ns ? p.recovery : ns);
  if (!elig) ns = s;

  // process_rewards_and_penalties
  int64_t rewards = 0, penalties = 0;
  const int64_t reward_denominator = wmul(p.active_increments, WEIGHT_DENOMINATOR);
#pragma unroll
  for (int f = 0; f < FLAGS; ++f) {
    const bool in_flag = unslashed && ((flags >> f) & 1);
    const int64_t bw = wmul(base, weight(f));
    if (elig && in_flag && !leak)
      rewards = wadd(rewards, floordiv(wmul(bw, part_increments[f]), reward_denominator));
    if (f != HEAD_FLAG && elig && !in_flag)
      penalties = wadd(penalties, floordiv(bw, WEIGHT_DENOMINATOR));
  }
  if (elig && !target) penalties = wadd(penalties, floordiv(wmul(e, ns), p.denominator));
  const int64_t b = wsub(wadd(balances[i], rewards), penalties);
  out_balances[i] = b > 0 ? b : 0;
  out_scores[i] = ns;
}

}  // namespace ep

// params: a HOST pointer to the 7 int64 scalars (base_per_inc, increment,
// active_increments, leak, bias, recovery, denominator), read before the
// launches; sums: a device buffer of 3 uint64 that the entry zeroes.
extern "C" int lh_epoch_rewards(const void* eff, const void* part, const void* scores,
                                const void* balances, const void* active, const void* slashed,
                                const void* eligible, int n, const void* params, void* sums,
                                void* out_balances, void* out_scores, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const int64_t* h = (const int64_t*)params;
  const ep::Params p = {h[0], h[1], h[2], h[3], h[4], h[5], h[6]};
  if (p.increment == 0 || p.active_increments == 0 || p.denominator == 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t rc = cudaMemsetAsync(sums, 0, ep::FLAGS * sizeof(unsigned long long), s);
  if (rc != cudaSuccess) return (int)rc;
  const int blocks = (n + ep::THREADS - 1) / ep::THREADS;
  ep::sums_kernel<<<blocks < ep::MAX_SUM_BLOCKS ? blocks : ep::MAX_SUM_BLOCKS, ep::THREADS, 0, s>>>(
      (const int64_t*)eff, (const uint8_t*)part, (const uint8_t*)active, (const uint8_t*)slashed,
      n, (unsigned long long*)sums);
  rc = cudaGetLastError();
  if (rc != cudaSuccess) return (int)rc;
  ep::rewards_kernel<<<blocks, ep::THREADS, 0, s>>>(
      (const int64_t*)eff, (const uint8_t*)part, (const int64_t*)scores, (const int64_t*)balances,
      (const uint8_t*)active, (const uint8_t*)slashed, (const uint8_t*)eligible, n, p,
      (const unsigned long long*)sums, (int64_t*)out_balances, (int64_t*)out_scores);
  return (int)cudaGetLastError();
}
