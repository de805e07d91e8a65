"""The Merkle-proof plane: lane-parallel SHA-256 branch folds on the card.

The port of `lighthouse_tpu/ops/merkle_proof.py`. A query is (leaf, branch,
gindex): a 32-byte leaf, its siblings from the leaf up, and the generalized
index whose bits, LSB first, say at each level whether the running node is
the right child. Folding a query hashes it up to the root; a verdict is
that root against an expected one. Many queries fold in one launch of the
SHA-256 kernel (`csrc/sha256_fold.cu`, which replaces the reference's XLA
`_fold_kernel`), one lane a query, each level two compressions: the 64-byte
message block, then the fixed padding block.

Discipline, as in the reference:

  * SHA-256 runs in exact 32-bit words, so a root is BYTE-IDENTICAL to the
    hashlib oracle `fold_branches_host` (the committed vectors under
    tests/vectors/merkle_proof hold both);
  * queries are grouped by branch depth; depth 0 is answered on the host
    (the root is the leaf); each depth group crosses
    `GUARD.dispatch("merkle_proof", f"d{depth}x{bucket}", attempt)` with
    the reference's power-of-two bucket (at least `MIN_LANE_BUCKET`) in
    its label, so the breaker keeps the same per-bucket state, while the
    kernel launches only the live lanes;
  * a fold yields roots, not a verdict: a flip injection leaves them as
    they are (a stall or an error still raises);
  * every group is priced through `device_attribution.note_batch` under
    plane "merkle_proof", consumer checked before the dispatch.

There is no failover tier: a device fault reaches the caller as a
`DeviceFaultError`. `device="cuda"` runs the kernel and raises when there
is no GPU; `device="cpu"` runs the plain PyTorch version (the tests). The
attempt's uploads, launch and read run under the device lock the BLS and
KZG backends take (`ops/device_io.device_lock`).

Words: the kernel and its plain version take int32 tensors holding the
big-endian 32-bit words of each 32-byte chunk (`_words` viewed as int32):
leaves (L, 8), siblings (L, depth, 8), direction bits (L, depth), roots
(L, 8).
"""

import time

import numpy as np
import torch

from lighthouse_tpu_torch.common import device_attribution as attribution
from lighthouse_tpu_torch.common.tracing import span
from lighthouse_tpu_torch.device_plane.executor import GUARD
from lighthouse_tpu_torch.ops import cuda_build
from lighthouse_tpu_torch.ops.device_io import device_lock, resolve_device, to_device

MIN_LANE_BUCKET = 8

# host/device split of the last `batch_merkle_roots` call: queries, depth
# groups, and the ms of packing the operands and of the guarded dispatches
# (uploads, launches, the roots' read), summed over groups, and the call's
# wall
LAST_STATS: dict = {}

# FIPS 180-4 round constants / initial state
_SHA_K = (
    0x428A2F98, 0x71374491, 0xB5C0FBCF, 0xE9B5DBA5,
    0x3956C25B, 0x59F111F1, 0x923F82A4, 0xAB1C5ED5,
    0xD807AA98, 0x12835B01, 0x243185BE, 0x550C7DC3,
    0x72BE5D74, 0x80DEB1FE, 0x9BDC06A7, 0xC19BF174,
    0xE49B69C1, 0xEFBE4786, 0x0FC19DC6, 0x240CA1CC,
    0x2DE92C6F, 0x4A7484AA, 0x5CB0A9DC, 0x76F988DA,
    0x983E5152, 0xA831C66D, 0xB00327C8, 0xBF597FC7,
    0xC6E00BF3, 0xD5A79147, 0x06CA6351, 0x14292967,
    0x27B70A85, 0x2E1B2138, 0x4D2C6DFC, 0x53380D13,
    0x650A7354, 0x766A0ABB, 0x81C2C92E, 0x92722C85,
    0xA2BFE8A1, 0xA81A664B, 0xC24B8B70, 0xC76C51A3,
    0xD192E819, 0xD6990624, 0xF40E3585, 0x106AA070,
    0x19A4C116, 0x1E376C08, 0x2748774C, 0x34B0BCB5,
    0x391C0CB3, 0x4ED8AA4A, 0x5B9CCA4F, 0x682E6FF3,
    0x748F82EE, 0x78A5636F, 0x84C87814, 0x8CC70208,
    0x90BEFFFA, 0xA4506CEB, 0xBEF9A3F7, 0xC67178F2,
)
_SHA_IV = (
    0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
    0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19,
)
# the second block of a 64-byte message: 0x80, zeros, the bit length 512
_PAD_BLOCK = (0x80000000,) + (0,) * 14 + (512,)

_M32 = 0xFFFFFFFF

# 32-bit operations of the kernel's formulas (csrc/sha256_fold.cu): a round
# is S1 (3 rotations, 2 xors), ch = g ^ (e & (f ^ g)) (3), S0 (5), maj =
# (a & b) | (c & (a | b)) (4) and the adds h + S1 + ch + K + W, S0 + maj,
# d + t1, t1 + t2 (7; the padding block's K + W is one constant, 6); a
# schedule word is s0 and s1 (2 rotations, a shift, 2 xors each) and 3
# adds; a compression ends with 8 adds; a level orders node and sibling
# with 16 selects
ROUND_OPS = 24
PAD_ROUND_OPS = 23
SCHEDULE_OPS = 13
FEED_FORWARD_OPS = 8
SELECT_OPS = 16

# the same formulas at Hopper's three-input instructions (LOP3 takes any
# logic function of three words, IADD3 three addends), the fewest 32-bit
# instructions they need: a round is 6 rotations, 2 three-way xors, ch,
# maj, t1 as two IADD3, e = d + t1 and a = t1 + S0 + maj (14, the padding
# block's too: its K + W is one addend); a schedule word 4 rotations, 2
# shifts, 2 three-way xors and 2 IADD3 (10)
ROUND_INSTRUCTIONS = 14
SCHEDULE_INSTRUCTIONS = 10


def level_ops() -> int:
    """32-bit operations a lane spends on one level, as the formulas are
    written: 3,664."""
    message = 64 * ROUND_OPS + 48 * SCHEDULE_OPS + FEED_FORWARD_OPS
    padding = 64 * PAD_ROUND_OPS + FEED_FORWARD_OPS
    return message + padding + SELECT_OPS


def level_instructions() -> int:
    """The fewest 32-bit instructions one level's formulas need on Hopper
    (three-input logic and adds as one): 2,304, the count behind the
    kernel's bound."""
    compressions = 2 * (64 * ROUND_INSTRUCTIONS + FEED_FORWARD_OPS)
    return compressions + 48 * SCHEDULE_INSTRUCTIONS + SELECT_OPS


def fold_ops(lanes: int, depth: int, per_level=level_instructions) -> int:
    """32-bit operations of folding `lanes` queries `depth` levels (the
    instructions by default; `per_level=level_ops` for the formulas)."""
    return lanes * depth * per_level()


def fold_bytes(lanes: int, depth: int) -> int:
    """Bytes the fold must move: each leaf, sibling and direction bit read
    once, each root written once."""
    return lanes * (32 + depth * 32 + depth * 4 + 32)


def _rotr_int(x: int, r: int) -> int:
    return ((x >> r) | (x << (32 - r))) & _M32


def pad_round_words() -> tuple:
    """K[i] + W[i] of the padding block's 64 rounds (the kernel's PAD_KW):
    its schedule does not depend on the message."""
    w = list(_PAD_BLOCK)
    for i in range(16, 64):
        s0 = _rotr_int(w[i - 15], 7) ^ _rotr_int(w[i - 15], 18) ^ (w[i - 15] >> 3)
        s1 = _rotr_int(w[i - 2], 17) ^ _rotr_int(w[i - 2], 19) ^ (w[i - 2] >> 10)
        w.append((w[i - 16] + s0 + w[i - 7] + s1) & _M32)
    return tuple((k + x) & _M32 for k, x in zip(_SHA_K, w))


_PAD_KW = pad_round_words()


# ------------------------------------------------------------- host side


def _words(chunks) -> np.ndarray:
    """list of 32-byte chunks -> (n, 8) uint32 big-endian words."""
    return np.frombuffer(
        b"".join(bytes(c) for c in chunks), dtype=">u4"
    ).reshape(-1, 8).astype(np.uint32)


def _chunks(words: np.ndarray) -> list:
    data = np.asarray(words, dtype=np.uint32).astype(">u4").tobytes()
    return [data[i : i + 32] for i in range(0, len(data), 32)]


def _lane_bucket(n: int) -> int:
    b = MIN_LANE_BUCKET
    while b < n:
        b <<= 1
    return b


def fold_branches_host(queries) -> list:
    """hashlib oracle: [(leaf, branch, gindex)] -> computed roots."""
    import hashlib

    out = []
    for leaf, branch, gindex in queries:
        node = bytes(leaf)
        g = int(gindex)
        for sibling in branch:
            if g & 1:
                node = hashlib.sha256(bytes(sibling) + node).digest()
            else:
                node = hashlib.sha256(node + bytes(sibling)).digest()
            g >>= 1
        out.append(node)
    return out


def pack_queries(queries, depth: int):
    """Queries of one depth -> the kernel's operands as int32 numpy arrays:
    leaves (n, 8), siblings (n, depth, 8), direction bits (n, depth)."""
    n = len(queries)
    leaves = _words([leaf for leaf, _, _ in queries]).view(np.int32)
    siblings = _words([s for _, branch, _ in queries for s in branch]).view(np.int32)
    # Python ints: a generalized index may outgrow 64 bits
    g = np.array([int(gindex) for _, _, gindex in queries] + [None], dtype=object)[:-1]
    dirbits = ((g[:, None] >> np.arange(depth)) & 1).astype(np.int32)
    return leaves, siblings.reshape(n, depth, 8), dirbits


# ---------------------------------------------------- plain version + kernel


def _u32(t: torch.Tensor) -> torch.Tensor:
    """int32 words -> their unsigned values in int64."""
    return t.to(torch.int64) & _M32


def _rotr(x, r: int):
    return ((x >> r) | (x << (32 - r))) & _M32


def _round(v, kw):
    a, b, c, d, e, f, g, h = v
    t1 = h + (_rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)) + (g ^ (e & (f ^ g))) + kw
    t2 = (_rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)) + ((a & b) | (c & (a | b)))
    return [(t1 + t2) & _M32, a, b, c, (d + t1) & _M32, e, f, g]


def _compress_plain(state, w, pad: bool):
    """One compression on lists of 8 state and 16 message words ((L,)
    int64 tensors), the message's schedule rolling in `w`, or the padding
    block's rounds (`_PAD_KW`) when `pad`."""
    v = list(state)
    if pad:
        for kw in _PAD_KW:
            v = _round(v, kw)
    else:
        w = list(w)
        for i in range(64):
            if i >= 16:
                w15, w2 = w[(i - 15) & 15], w[(i - 2) & 15]
                s0 = _rotr(w15, 7) ^ _rotr(w15, 18) ^ (w15 >> 3)
                s1 = _rotr(w2, 17) ^ _rotr(w2, 19) ^ (w2 >> 10)
                w[i & 15] = (w[i & 15] + s0 + w[(i - 7) & 15] + s1) & _M32
            v = _round(v, _SHA_K[i] + w[i & 15])
    return [(s + x) & _M32 for s, x in zip(state, v)]


def fold_branches_plain(leaves, siblings, dirbits):
    """The kernel's function on any device: (L, 8) roots as int32 words.
    The words are computed in int64 masked to 32 bits, so a word with its
    high bit set never meets an arithmetic shift."""
    L, depth = int(siblings.shape[0]), int(siblings.shape[1])
    node = list(_u32(leaves).unbind(-1))
    sibs = _u32(siblings)
    right = dirbits != 0
    for d in range(depth):
        sib = sibs[:, d, :].unbind(-1)
        r = right[:, d]
        w = [torch.where(r, s, n) for s, n in zip(sib, node)]
        w += [torch.where(r, n, s) for s, n in zip(sib, node)]
        iv = [torch.full((L,), x, dtype=torch.int64, device=leaves.device) for x in _SHA_IV]
        node = _compress_plain(_compress_plain(iv, w, pad=False), None, pad=True)
    out = torch.stack(node, dim=-1)
    return torch.where(out >= 2**31, out - 2**32, out).to(torch.int32)


def fold_branches(leaves, siblings, dirbits, require_kernel: bool = False):
    """(L, 8) int32 roots of the branches: CUDA tensors launch the SHA-256
    fold kernel, CPU tensors run `fold_branches_plain`."""
    if not cuda_build.use_kernel(leaves, require_kernel):
        return fold_branches_plain(leaves, siblings, dirbits)
    L, depth = int(siblings.shape[0]), int(siblings.shape[1])
    dev = leaves.device
    cuda_build.check(leaves, "leaves", (L, 8), dev)
    cuda_build.check(siblings, "siblings", (L, depth, 8), dev)
    cuda_build.check(dirbits, "dirbits", (L, depth), dev)
    for name, t in (("leaves", leaves), ("siblings", siblings)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: the kernel reads 16-byte aligned rows")
    out = torch.empty((L, 8), dtype=torch.int32, device=dev)
    if L:
        cuda_build.launch("sha256_fold", "lh_sha256_fold", "sha256_fold",
                          leaves, siblings, dirbits, L, depth, out)
    return out


# -------------------------------------------------------------- the plane


def batch_merkle_roots(queries, consumer=None, device="cuda") -> list:
    """Fold many (leaf, branch, gindex) queries to roots on `device`, one
    guarded launch a depth. Returns the computed roots in query order --
    byte-identical to `fold_branches_host`."""
    t_start = time.perf_counter()
    queries = list(queries)
    if not queries:
        return []
    consumer = attribution.normalize(consumer)
    by_depth: dict = {}
    for pos, (leaf, branch, gindex) in enumerate(queries):
        if len(branch) != int(gindex).bit_length() - 1:
            raise ValueError(
                f"query {pos}: branch length {len(branch)} does not "
                f"match gindex {gindex} depth"
            )
        by_depth.setdefault(len(branch), []).append((pos, (bytes(leaf), branch, int(gindex))))
    out: list = [None] * len(queries)
    dev = None
    pack_s = dispatch_s = 0.0
    for depth, group in sorted(by_depth.items()):
        n = len(group)
        if depth == 0:
            for pos, (leaf, _branch, _g) in group:
                out[pos] = leaf
            continue
        if dev is None:
            dev = resolve_device(device)
        bucket = _lane_bucket(n)
        t0 = time.perf_counter()
        leaves, siblings, dirbits = pack_queries([q for _, q in group], depth)
        pack_s += time.perf_counter() - t0

        # roots, not a verdict: a flip injection leaves them alone
        def attempt(plan):
            with span("merkle/device", lanes=n, depth=depth), device_lock(dev):
                roots = fold_branches(*(to_device(a, dev) for a in (leaves, siblings, dirbits)))
                return _chunks(roots.cpu().numpy().view(np.uint32))

        t0 = time.perf_counter()
        chunks = GUARD.dispatch("merkle_proof", f"d{depth}x{bucket}", attempt)
        wall = time.perf_counter() - t0
        dispatch_s += wall
        attribution.note_batch(consumer, "merkle_proof", lanes=bucket, live=n, duration_s=wall)
        for (pos, _q), root in zip(group, chunks):
            out[pos] = root
    LAST_STATS.clear()
    LAST_STATS.update({
        "queries": len(queries), "groups": len(by_depth), "pack_ms": pack_s * 1e3,
        "dispatch_ms": dispatch_s * 1e3, "wall_ms": (time.perf_counter() - t_start) * 1e3,
    })
    return out


def batch_verify_branches(queries, roots, consumer=None, device="cuda") -> list:
    """Per-query verdicts: computed root == expected root. A corrupted
    sibling, leaf or direction flips the query's verdict alone."""
    computed = batch_merkle_roots(queries, consumer=consumer, device=device)
    return [c == bytes(r) for c, r in zip(computed, roots)]
