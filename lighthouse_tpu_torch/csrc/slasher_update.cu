// The slasher's min/max-target update and surround checks, one block a
// touched validator row, the (V, H) arrays updated in place.
//
// Replaces lighthouse_tpu/slasher/device.py `batch_update` (:39) and
// `_gather_checks` (:25), which are XLA on the TPU, no Pallas kernel: a
// scatter-max / scatter-min of the batch's targets at their source column
// into (V, H) arrays of sentinels, a running max along the epoch axis and
// a reversed running min, the pointwise merge with the old arrays, and two
// gathers a lane. The plain version is
// lighthouse_tpu_torch/slasher/device.py `batch_update_plain`.
//
// What it computes, for every row v that a valid lane touches:
//   max'[v][e] = max(max[v][e], max t over the row's lanes with s <= e)
//   min'[v][e] = min(min[v][e], min t over the row's lanes with s >= e)
// and for every valid lane (v, s, t):
//   surrounded = s > 0 && max'[v][s-1] > t
//   surrounds  = s + 1 < H && min'[v][s+1] < t.
// The merge with a row of sentinels leaves an entry as it is (any max
// entry >= NO_TARGET_MAX, as in every array built from sentinels by
// updates), so rows that no valid lane touches are never read, nor are a
// touched row's max columns below its smallest source or its min columns
// above its largest.
//
// What bounds it on the H100: bytes. A touched row with sources in
// [lo, hi] reads and writes the max columns [lo, H) and the min columns
// [0, hi] once each; the scans and the lanes' work are a few operations
// an element.
//
// Design: the host's glue (torch.sort of the lanes by row, invalid lanes
// last, and each sorted position's segment end) gives the lanes of a row
// as one segment. The grid has one block a sorted position; the block at
// a segment's first position owns the row, every other block returns at
// once. The block builds the row's scatter in shared memory (2 x H int32,
// shared atomics) with its smallest and largest source, runs a forward
// max-scan and a backward min-scan with each warp scanning its own
// stretch 32 elements at a time (shuffles, no bank conflicts), then merges
// the scans with the row's needed columns in 16-byte loads and stores
// (the range rounded out to whole groups), each element taking its warp
// stretch's carry-in from the other stretches' totals, keeps the merged
// columns in shared memory and answers the row's lanes from them, or from
// the row where a lane's neighbour column was not merged.

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sl {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int32_t NO_TARGET_MIN = INT32_MAX;
constexpr int32_t NO_TARGET_MAX = -1;
constexpr unsigned FULL = 0xffffffffu;

template <bool MAX>
__device__ __forceinline__ int32_t op(int32_t a, int32_t b) {
  return MAX ? (a > b ? a : b) : (a < b ? a : b);
}

template <bool MAX>
__device__ __forceinline__ int32_t identity() {
  return MAX ? INT32_MIN : INT32_MAX;
}

// A warp's inclusive scan of its stretch [lo, hi) of a, in rising index
// order (MAX) or falling (!MAX); returns the stretch's total to every lane.
template <bool MAX>
__device__ int32_t scan_stretch(int32_t* a, int lo, int hi, int lane) {
  int32_t carry = identity<MAX>();
  const int len = hi - lo;
  for (int base = 0; base < len; base += 32) {
    const int k = base + lane;
    const int idx = MAX ? lo + k : hi - 1 - k;
    int32_t x = k < len ? a[idx] : identity<MAX>();
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int32_t y = __shfl_up_sync(FULL, x, off);
      if (lane >= off) x = op<MAX>(x, y);
    }
    x = op<MAX>(x, carry);
    if (k < len) a[idx] = x;
    carry = __shfl_sync(FULL, x, 31);
  }
  return carry;
}

__global__ void __launch_bounds__(THREADS) row_kernel(
    int32_t* __restrict__ min_arr, int32_t* __restrict__ max_arr, int V, int H,
    const int32_t* __restrict__ keys, const int64_t* __restrict__ order,
    const int32_t* __restrict__ ends, const int32_t* __restrict__ s,
    const int32_t* __restrict__ t, uint8_t* __restrict__ surrounded,
    uint8_t* __restrict__ surrounds) {
  const int p0 = blockIdx.x;
  const int v = keys[p0];
  if (v >= V || (p0 > 0 && keys[p0 - 1] == v)) return;  // not a row's first lane
  const int p1 = ends[p0];
  extern __shared__ int4 shared4[];
  const int Hp = (H + 3) & ~3;
  int32_t* smax = reinterpret_cast<int32_t*>(shared4);
  int32_t* smin = smax + Hp;
  __shared__ int32_t tot_max[WARPS], tot_min[WARPS], pre_max[WARPS], pre_min[WARPS];
  __shared__ int32_t src_lo, src_hi;  // the row's smallest and largest source
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  if (tid == 0) {
    src_lo = H;
    src_hi = -1;
  }
  for (int e = tid; e < H; e += THREADS) {
    smax[e] = NO_TARGET_MAX;
    smin[e] = NO_TARGET_MIN;
  }
  __syncthreads();
  for (int q = p0 + tid; q < p1; q += THREADS) {
    const int64_t l = order[q];
    atomicMax(&smax[s[l]], t[l]);
    atomicMin(&smin[s[l]], t[l]);
    atomicMin(&src_lo, s[l]);
    atomicMax(&src_hi, s[l]);
  }
  __syncthreads();

  // each warp's stretch: a multiple of 4 elements, so a 16-byte group
  // never straddles two stretches
  const int stretch = (((H + WARPS - 1) / WARPS) + 3) & ~3;
  const int lo = warp * stretch < H ? warp * stretch : H;
  const int hi = lo + stretch < H ? lo + stretch : H;
  const int32_t tmax = scan_stretch<true>(smax, lo, hi, lane);
  const int32_t tmin = scan_stretch<false>(smin, lo, hi, lane);
  if (lane == 0) {
    tot_max[warp] = tmax;
    tot_min[warp] = tmin;
  }
  __syncthreads();
  if (tid < WARPS) {  // carry-in: the stretches below (max), above (min)
    int32_t cmax = identity<true>(), cmin = identity<false>();
    for (int w = 0; w < tid; ++w) cmax = op<true>(cmax, tot_max[w]);
    for (int w = tid + 1; w < WARPS; ++w) cmin = op<false>(cmin, tot_min[w]);
    pre_max[tid] = cmax;
    pre_min[tid] = cmin;
  }
  __syncthreads();

  int32_t* gmax = max_arr + (size_t)v * H;
  int32_t* gmin = min_arr + (size_t)v * H;
  // the merged columns: max [max_lo, H), min [0, min_hi)
  const bool vec = (H & 3) == 0;
  const int max_lo = vec ? src_lo & ~3 : src_lo;
  const int min_hi = vec ? (src_hi + 4) & ~3 : src_hi + 1;
  if (vec) {
    int4* gmax4 = reinterpret_cast<int4*>(gmax);
    int4* gmin4 = reinterpret_cast<int4*>(gmin);
    int4* smax4 = reinterpret_cast<int4*>(smax);
    int4* smin4 = reinterpret_cast<int4*>(smin);
    for (int g = (max_lo >> 2) + tid; g < H >> 2; g += THREADS) {
      const int32_t c = pre_max[(4 * g) / stretch];
      int4 a = gmax4[g], r = smax4[g];
      a.x = op<true>(a.x, op<true>(c, r.x));
      a.y = op<true>(a.y, op<true>(c, r.y));
      a.z = op<true>(a.z, op<true>(c, r.z));
      a.w = op<true>(a.w, op<true>(c, r.w));
      gmax4[g] = a;
      smax4[g] = a;
    }
    for (int g = tid; g < min_hi >> 2; g += THREADS) {
      const int32_t c = pre_min[(4 * g) / stretch];
      int4 b = gmin4[g], m = smin4[g];
      b.x = op<false>(b.x, op<false>(c, m.x));
      b.y = op<false>(b.y, op<false>(c, m.y));
      b.z = op<false>(b.z, op<false>(c, m.z));
      b.w = op<false>(b.w, op<false>(c, m.w));
      gmin4[g] = b;
      smin4[g] = b;
    }
  } else {
    for (int e = max_lo + tid; e < H; e += THREADS) {
      const int32_t a = op<true>(gmax[e], op<true>(pre_max[e / stretch], smax[e]));
      gmax[e] = a;
      smax[e] = a;
    }
    for (int e = tid; e < min_hi; e += THREADS) {
      const int32_t b = op<false>(gmin[e], op<false>(pre_min[e / stretch], smin[e]));
      gmin[e] = b;
      smin[e] = b;
    }
  }
  __syncthreads();

  // a neighbour column outside the merged ones is the row's own entry
  for (int q = p0 + tid; q < p1; q += THREADS) {
    const int64_t l = order[q];
    const int32_t sl = s[l], tl = t[l];
    if (sl > 0) surrounded[l] = (sl - 1 >= max_lo ? smax[sl - 1] : gmax[sl - 1]) > tl;
    if (sl + 1 < H) surrounds[l] = (sl + 1 < min_hi ? smin[sl + 1] : gmin[sl + 1]) < tl;
  }
}

}  // namespace sl

// keys (n,): each sorted position's row, V for an invalid lane, rising;
// order (n,) int64: the lane at each sorted position; ends (n,): the
// position after each position's segment. Every valid lane's v and s are
// in range (the wrapper raises otherwise). The verdicts must be zeroed:
// only a valid lane's verdicts with a neighbour column are written.
extern "C" int lh_slasher_update(void* min_arr, void* max_arr, int V, int H, const void* keys,
                                 const void* order, const void* ends, const void* s,
                                 const void* t, int n, void* surrounded, void* surrounds,
                                 void* stream) {
  if (V <= 0 || H <= 0 || n <= 0) return (int)cudaErrorInvalidValue;
  const size_t smem = 2 * (size_t)((H + 3) & ~3) * sizeof(int32_t);
  if (smem > 48 * 1024) {
    cudaError_t rc = cudaFuncSetAttribute(sl::row_kernel,
                                          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (rc != cudaSuccess) return (int)rc;
  }
  sl::row_kernel<<<n, sl::THREADS, smem, (cudaStream_t)stream>>>(
      (int32_t*)min_arr, (int32_t*)max_arr, V, H, (const int32_t*)keys, (const int64_t*)order,
      (const int32_t*)ends, (const int32_t*)s, (const int32_t*)t, (uint8_t*)surrounded,
      (uint8_t*)surrounds);
  return (int)cudaGetLastError();
}
