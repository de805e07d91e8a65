// The Merkle-branch fold: SHA-256 up a branch, one lane a query.
//
// Replaces lighthouse_tpu/ops/merkle_proof.py `_fold_kernel` (:130, with
// `_compress` :71 and `_hash_pair` :107), which is XLA on the TPU: for each
// of `depth` levels the running node is ordered with its sibling by the
// lane's direction bit (1: the node is the right child, the hash is
// sha256(sibling || node)), and the 64-byte message is hashed in two
// compressions, the message block and then the fixed padding block (0x80,
// zeros, the bit length 512), every lane at once, the rounds and the
// schedule as `fori_loop`s. The plain version is
// lighthouse_tpu_torch/ops/merkle_proof.py `fold_branches_plain`.
//
// What bounds it on the H100: 32-bit integer operations. A level is 3,664
// of them as the formulas below are written (merkle_proof.level_ops: the
// message compression's 64 rounds of 24 and 48 schedule extensions of 13,
// the padding compression's 64 rounds of 23 with its schedule folded into
// the constants, two feed-forwards of 8, 16 selects) and 2,304 at Hopper's
// three-input LOP3 and IADD3 (merkle_proof.level_instructions, the count
// behind the bound), against 280 bytes a lane at depth 6 (the leaf, the
// siblings, the bits and the root): at the light-client finality depth the
// operations outweigh the bytes ~10x.
//
// Design: one thread a lane, 32-thread blocks, so that a batch of ~1,000
// queries spreads over as many SMs as it has warps. The 8-word state, the
// working variables and a rolling 16-word schedule stay in registers: the
// rounds are unrolled, so every index is a constant and nothing goes to
// local memory. Rotations are funnel shifts, ch and maj the two- and
// three-operation forms. The padding block's schedule is the same for
// every message, so its 64 words are added to the round constants ahead of
// time (PAD_KW); its compression reads one constant a round and extends no
// schedule. The next level's sibling and direction bit are loaded before
// the current level hashes, so their latency hides behind its 128 rounds.
// A level's rounds are one dependent chain a lane: with a warp or so a
// scheduler the card waits on that chain, and more lanes fill the
// schedulers' other slots.

#include <cuda_runtime.h>
#include <stdint.h>

namespace sha {

constexpr int BLOCK = 32;

// FIPS 180-4 round constants
__constant__ uint32_t K[64] = {
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5,
    0x3956c25b, 0x59f111f1, 0x923f82a4, 0xab1c5ed5,
    0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174,
    0xe49b69c1, 0xefbe4786, 0x0fc19dc6, 0x240ca1cc,
    0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7,
    0xc6e00bf3, 0xd5a79147, 0x06ca6351, 0x14292967,
    0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85,
    0xa2bfe8a1, 0xa81a664b, 0xc24b8b70, 0xc76c51a3,
    0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5,
    0x391c0cb3, 0x4ed8aa4a, 0x5b9cca4f, 0x682e6ff3,
    0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2,
};

// K[i] + W[i] of the padding block (0x80000000, 14 zero words, 512): its
// schedule does not depend on the message (merkle_proof.pad_round_words)
__constant__ uint32_t PAD_KW[64] = {
    0xc28a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5,
    0x3956c25b, 0x59f111f1, 0x923f82a4, 0xab1c5ed5,
    0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf374,
    0x649b69c1, 0xf0fe4786, 0x0fe1edc6, 0x240cf254,
    0x4fe9346f, 0x6cc984be, 0x61b9411e, 0x16f988fa,
    0xf2c65152, 0xa88e5a6d, 0xb019fc65, 0xb9d99ec7,
    0x9a1231c3, 0xe70eeaa0, 0xfdb1232b, 0xc7353eb0,
    0x3069bad5, 0xcb976d5f, 0x5a0f118f, 0xdc1eeefd,
    0x0a35b689, 0xde0b7a04, 0x58f4ca9d, 0xe15d5b16,
    0x007f3e86, 0x37088980, 0xa507ea32, 0x6fab9537,
    0x17406110, 0x0d8cd6f1, 0xcdaa3b6d, 0xc0bbbe37,
    0x83613bda, 0xdb48a363, 0x0b02e931, 0x6fd15ca7,
    0x521afaca, 0x31338431, 0x6ed41a95, 0x6d437890,
    0xc39c91f2, 0x9eccabbd, 0xb5c9a0e6, 0x532fb63c,
    0xd2c741c6, 0x07237ea3, 0xa4954b68, 0x4c191d76,
};

// the initial state
__constant__ uint32_t IV[8] = {
    0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
    0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19,
};

__device__ __forceinline__ uint32_t rotr(uint32_t x, int n) {
  return __funnelshift_r(x, x, n);
}

// one round on the working variables v (a..h), kw = K[i] + W[i]
__device__ __forceinline__ void round_step(uint32_t (&v)[8], uint32_t kw) {
  const uint32_t a = v[0], b = v[1], c = v[2], e = v[4], f = v[5], g = v[6];
  const uint32_t t1 = v[7] + (rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25)) + (g ^ (e & (f ^ g))) + kw;
  const uint32_t t2 = (rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22)) + ((a & b) | (c & (a | b)));
  v[7] = g;
  v[6] = f;
  v[5] = e;
  v[4] = v[3] + t1;
  v[3] = c;
  v[2] = b;
  v[1] = a;
  v[0] = t1 + t2;
}

// the message block w (16 words, overwritten by the rolling schedule) into
// the state st
__device__ __forceinline__ void compress_message(uint32_t (&st)[8], uint32_t (&w)[16]) {
  uint32_t v[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] = st[j];
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    if (i >= 16) {
      const uint32_t w15 = w[(i - 15) & 15], w2 = w[(i - 2) & 15];
      const uint32_t s0 = rotr(w15, 7) ^ rotr(w15, 18) ^ (w15 >> 3);
      const uint32_t s1 = rotr(w2, 17) ^ rotr(w2, 19) ^ (w2 >> 10);
      w[i & 15] = w[i & 15] + s0 + w[(i - 7) & 15] + s1;
    }
    round_step(v, K[i] + w[i & 15]);
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) st[j] += v[j];
}

// the fixed padding block into the state st
__device__ __forceinline__ void compress_padding(uint32_t (&st)[8]) {
  uint32_t v[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] = st[j];
#pragma unroll
  for (int i = 0; i < 64; ++i) round_step(v, PAD_KW[i]);
#pragma unroll
  for (int j = 0; j < 8; ++j) st[j] += v[j];
}

__device__ __forceinline__ void load8(const uint32_t* p, uint32_t (&x)[8]) {
  const uint4 lo = reinterpret_cast<const uint4*>(p)[0];
  const uint4 hi = reinterpret_cast<const uint4*>(p)[1];
  x[0] = lo.x; x[1] = lo.y; x[2] = lo.z; x[3] = lo.w;
  x[4] = hi.x; x[5] = hi.y; x[6] = hi.z; x[7] = hi.w;
}

// leaves (L, 8), siblings (L, depth, 8) and the roots out (L, 8) as
// big-endian message words; dirbits (L, depth), nonzero where the running
// node is the right child at that level
__global__ void __launch_bounds__(BLOCK) fold_kernel(
    const uint32_t* __restrict__ leaves, const uint32_t* __restrict__ siblings,
    const int32_t* __restrict__ dirbits, int lanes, int depth, uint32_t* __restrict__ out) {
  const int lane = blockIdx.x * BLOCK + threadIdx.x;
  if (lane >= lanes) return;
  const uint32_t* sib_row = siblings + (size_t)lane * depth * 8;
  const int32_t* dir_row = dirbits + (size_t)lane * depth;
  uint32_t node[8], sib[8];
  load8(leaves + (size_t)lane * 8, node);
  load8(sib_row, sib);
  int right = dir_row[0];
  for (int d = 0; d < depth; ++d) {
    uint32_t w[16];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      w[j] = right ? sib[j] : node[j];
      w[j + 8] = right ? node[j] : sib[j];
    }
    if (d + 1 < depth) {  // the next level's operands, ahead of its turn
      load8(sib_row + (size_t)(d + 1) * 8, sib);
      right = dir_row[d + 1];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) node[j] = IV[j];
    compress_message(node, w);
    compress_padding(node);
  }
  uint4* o = reinterpret_cast<uint4*>(out + (size_t)lane * 8);
  o[0] = make_uint4(node[0], node[1], node[2], node[3]);
  o[1] = make_uint4(node[4], node[5], node[6], node[7]);
}

}  // namespace sha

extern "C" int lh_sha256_fold(const void* leaves, const void* siblings, const void* dirbits,
                              int lanes, int depth, void* out, void* stream) {
  if (lanes <= 0 || depth <= 0) return (int)cudaErrorInvalidValue;
  sha::fold_kernel<<<(lanes + sha::BLOCK - 1) / sha::BLOCK, sha::BLOCK, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)leaves, (const uint32_t*)siblings, (const int32_t*)dirbits, lanes, depth,
      (uint32_t*)out);
  return (int)cudaGetLastError();
}
