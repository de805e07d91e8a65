"""GPU backend of `verify_signature_sets`: host marshalling -> device batch.

The port of `lighthouse_tpu/bls/tpu_backend.py`'s batch path. The host:

  * runs the signature policy (not infinity, in the subgroup -- memoized
    per signature);
  * bins the sets by message when `_group_plan` finds that grouping at
    least halves the pair count (G * 2 <= S: a slot's attestations, ~64
    committees over >= 30k sets), else lays them out flat;
  * pads sets, keys and groups to power-of-two buckets with masked lanes;
  * converts signatures to affine with one simultaneous inversion, hashes
    each distinct message once (memoized), and packs points as canonical
    Montgomery kernel words;
  * ships table row indices instead of points when every pubkey is
    registered in one `DevicePubkeyTable`;
  * samples 64-bit RLC scalars, and dispatches one device batch
    (`ops/batch_verify.py`) on `device`.

`device="cuda"` runs the CUDA kernels and raises when there is no GPU;
`device="cpu"` runs their plain PyTorch versions (the tests).
"""

import secrets
import time

import numpy as np
import torch

from lighthouse_tpu_torch.bls.api import signature_ok
from lighthouse_tpu_torch.bls.hash_to_curve import hash_to_g2
from lighthouse_tpu_torch.crypto.ref_curve import G1 as G1_GROUP
from lighthouse_tpu_torch.crypto.ref_curve import G2 as G2_GROUP
from lighthouse_tpu_torch.ops import batch_verify, field as fd

# host/device split of the last dispatched batch
LAST_HOST_STATS: dict = {}

# device batches dispatched
CALL_COUNTS = {"batch": 0}


def _bucket(n: int, minimum: int) -> int:
    b = minimum
    while b < n:
        b *= 2
    return b


# --------------------------------------------------------- message hashing

_MSG_CACHE: dict = {}
_MSG_CACHE_MAX = 16_384


def _msg_affine(message: bytes):
    """Memoized hash_to_g2 -> affine ints: a slot's attestations share a
    message per committee."""
    message = bytes(message)
    hit = _MSG_CACHE.get(message)
    if hit is None:
        hit = G2_GROUP.to_affine(hash_to_g2(message))
        if len(_MSG_CACHE) >= _MSG_CACHE_MAX:
            _MSG_CACHE.clear()
        _MSG_CACHE[message] = hit
    return hit


# ----------------------------------------------- batched affine conversion

_F2 = G2_GROUP.F


def batch_to_affine_g2(points):
    """Jacobian G2 points -> affine with ONE Fp2 inversion (Montgomery's
    simultaneous inversion); infinity -> None."""
    keep = [i for i, pt in enumerate(points) if not G2_GROUP.is_infinity(pt)]
    out = [None] * len(points)
    if not keep:
        return out
    zs = [points[i][2] for i in keep]
    prefix = [zs[0]]
    for z in zs[1:]:
        prefix.append(_F2.mul(prefix[-1], z))
    acc = _F2.inv(prefix[-1])
    invs = [None] * len(zs)
    for j in range(len(zs) - 1, 0, -1):
        invs[j] = _F2.mul(acc, prefix[j - 1])
        acc = _F2.mul(acc, zs[j])
    invs[0] = acc
    for j, i in enumerate(keep):
        x, y, _ = points[i]
        zi2 = _F2.sqr(invs[j])
        out[i] = (_F2.mul(x, zi2), _F2.mul(y, _F2.mul(zi2, invs[j])))
    return out


def _pack_g1(affs) -> tuple:
    """Affine G1 (None = masked) -> (N, 1, 12) x and y words."""
    xs = fd.mont_words([a[0] if a else 0 for a in affs])[:, None, :]
    ys = fd.mont_words([a[1] if a else 0 for a in affs])[:, None, :]
    return xs, ys


def _pack_g2(affs) -> tuple:
    """Affine G2 (None = masked) -> (N, 2, 12) x and y words."""
    zero = ((0, 0), (0, 0))
    pts = [a or zero for a in affs]
    xs = fd.mont_words([c for a in pts for c in a[0]]).reshape(-1, 2, fd.NW)
    ys = fd.mont_words([c for a in pts for c in a[1]]).reshape(-1, 2, fd.NW)
    return xs, ys


def _rlc_scalars(n: int, seed) -> np.ndarray:
    """n 64-bit RLC scalars in [1, 2^64), seeded (tests) or from the OS."""
    if seed is not None:
        rng = np.random.default_rng(seed)
        return rng.integers(1, np.iinfo(np.uint64).max, size=n, dtype=np.uint64, endpoint=True)
    return np.array([1 + secrets.randbelow((1 << 64) - 1) for _ in range(n)], dtype=np.uint64)


def _scalar_bits(scalars: np.ndarray) -> np.ndarray:
    """(N,) uint64 -> (N, 64) int32 LSB-first bits."""
    shifts = np.arange(batch_verify.RAND_BITS, dtype=np.uint64)
    return ((scalars[:, None] >> shifts) & np.uint64(1)).astype(np.int32)


def _table_for(sets):
    """The one DevicePubkeyTable that every pubkey of every set is
    registered in, else None."""
    table = None
    for s in sets:
        for p in s.pubkeys:
            t = p.table
            if t is None or p.validator_index is None or (table is not None and t is not table):
                return None
            table = t
    return table


# ------------------------------------------------------------- marshalling


class _Marshalled:
    """Static-shaped inputs for one batch of SignatureSets."""

    __slots__ = (
        "grouped", "msgs", "sigs", "pubkeys", "table", "indices",
        "key_mask", "set_mask", "group_mask", "n_groups", "s_bucket",
        "k_bucket", "timings",
    )


def _group_plan(sets):
    """Order-preserving message -> set-index grouping, or None when the
    merge does not pay: it must at least halve the pairs (G * 2 <= S), and
    the padded (G, Sg) grid must stay within twice the flat bucket."""
    by_msg: dict = {}
    for i, s in enumerate(sets):
        by_msg.setdefault(bytes(s.message), []).append(i)
    n_sets = len(sets)
    G = len(by_msg)
    if G * 2 > n_sets:
        return None
    sg_b = _bucket(max(len(ix) for ix in by_msg.values()), 1)
    if _bucket(G, 1) * sg_b > 2 * _bucket(n_sets, 4):
        return None
    return list(by_msg.items())


def _pack_keys(m, sets, order):
    """Key mask plus either table row indices or packed points, for the
    lanes in `order` (set indices, None = padding)."""
    m.key_mask = np.array(
        [
            [False] * m.k_bucket
            if i is None
            else [True] * len(sets[i].pubkeys) + [False] * (m.k_bucket - len(sets[i].pubkeys))
            for i in order
        ],
        dtype=bool,
    )
    m.table = _table_for(sets)
    if m.table is not None:
        indices = np.full((len(order), m.k_bucket), -1, dtype=np.int32)
        for lane, i in enumerate(order):
            if i is not None:
                for k, p in enumerate(sets[i].pubkeys):
                    indices[lane, k] = p.validator_index
        m.indices = m.table.gather_indices(indices)
        m.pubkeys = None
    else:
        flat = []
        for i in order:
            row = [] if i is None else [G1_GROUP.to_affine(p.point) for p in sets[i].pubkeys]
            flat += row + [None] * (m.k_bucket - len(row))
        xs, ys = _pack_g1(flat)
        m.indices = None
        m.pubkeys = (xs.reshape(len(order), m.k_bucket, 1, fd.NW),
                     ys.reshape(len(order), m.k_bucket, 1, fd.NW))


def _marshal(sets) -> _Marshalled:
    plan = _group_plan(sets)
    return _marshal_flat(sets) if plan is None else _marshal_grouped(sets, plan)


def _marshal_grouped(sets, groups) -> _Marshalled:
    """Grid layout: (g_bucket, sg_bucket) lanes, group-major, one message per
    group; padding lanes carry no signature and no keys."""
    t0 = time.perf_counter()
    m = _Marshalled()
    G = len(groups)
    g_b = _bucket(G, 1)
    sg_b = _bucket(max(len(ix) for _, ix in groups), 1)
    m.grouped, m.n_groups = True, G
    m.s_bucket = g_b * sg_b
    m.k_bucket = _bucket(max(len(s.pubkeys) for s in sets), 1)
    group_msgs = [_msg_affine(sets[ix[0]].message) for _, ix in groups] + [None] * (g_b - G)
    order: list = []
    for _, ix in groups:
        order += list(ix) + [None] * (sg_b - len(ix))
    order += [None] * ((g_b - G) * sg_b)
    sig_aff = batch_to_affine_g2([s.signature.point for s in sets])
    sigs = [None if i is None else sig_aff[i] for i in order]
    t1 = time.perf_counter()
    m.group_mask = np.array([True] * G + [False] * (g_b - G), dtype=bool)
    m.set_mask = np.array([i is not None for i in order], dtype=bool).reshape(g_b, sg_b)
    _pack_keys(m, sets, order)
    m.key_mask = m.key_mask.reshape(g_b, sg_b, m.k_bucket)
    if m.indices is not None:
        m.indices = m.indices.reshape(g_b, sg_b, m.k_bucket)
    else:
        m.pubkeys = tuple(c.reshape(g_b, sg_b, m.k_bucket, 1, fd.NW) for c in m.pubkeys)
    m.msgs = _pack_g2(group_msgs)
    m.sigs = tuple(c.reshape(g_b, sg_b, 2, fd.NW) for c in _pack_g2(sigs))
    t2 = time.perf_counter()
    m.timings = {"points_ms": (t1 - t0) * 1e3, "pack_ms": (t2 - t1) * 1e3}
    return m


def _marshal_flat(sets) -> _Marshalled:
    t0 = time.perf_counter()
    n_sets = len(sets)
    m = _Marshalled()
    m.grouped, m.n_groups, m.group_mask = False, None, None
    m.s_bucket = _bucket(n_sets, 4)
    m.k_bucket = _bucket(max(len(s.pubkeys) for s in sets), 1)
    pad = [None] * (m.s_bucket - n_sets)
    msgs = [_msg_affine(s.message) for s in sets] + pad
    sigs = batch_to_affine_g2([s.signature.point for s in sets]) + pad
    t1 = time.perf_counter()
    order = list(range(n_sets)) + pad
    m.set_mask = np.array([i is not None for i in order], dtype=bool)
    _pack_keys(m, sets, order)
    m.msgs = _pack_g2(msgs)
    m.sigs = _pack_g2(sigs)
    t2 = time.perf_counter()
    m.timings = {"points_ms": (t1 - t0) * 1e3, "pack_ms": (t2 - t1) * 1e3}
    return m


# ---------------------------------------------------------------- dispatch


def _dispatch(m, rand_bits, device) -> bool:
    """Run one marshalled batch on `device`; returns the verdict."""
    CALL_COUNTS["batch"] += 1
    if m.table is not None:
        if m.table.device != device:
            raise ValueError(f"pubkey table on {m.table.device}, batch on {device}")
        pubkeys = m.table.gather(m.indices)
    else:
        pubkeys = m.pubkeys
    if m.grouped:
        ok = batch_verify.verify_signature_sets_grouped(
            m.msgs, m.sigs, pubkeys, m.key_mask,
            rand_bits.reshape(m.set_mask.shape + (batch_verify.RAND_BITS,)),
            m.set_mask, m.group_mask, device=device,
        )
    else:
        ok = batch_verify.verify_signature_sets(
            m.msgs, m.sigs, pubkeys, m.key_mask, rand_bits, m.set_mask, device=device
        )
    return bool(ok)


def resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' requested but no CUDA device is available")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def verify_signature_sets_gpu(sets, seed: int | None = None, device="cuda") -> bool:
    dev = resolve_device(device)
    t_start = time.perf_counter()
    if not all(signature_ok(s.signature) for s in sets):
        return False
    t_subgroup = time.perf_counter()
    m = _marshal(sets)
    rand_bits = _scalar_bits(_rlc_scalars(m.s_bucket, seed))
    t_marshal = time.perf_counter()
    result = _dispatch(m, rand_bits, dev)
    t_end = time.perf_counter()
    LAST_HOST_STATS.clear()
    LAST_HOST_STATS.update(
        {
            "n_sets": len(sets),
            "indexed_path": m.table is not None,
            "grouped": bool(m.grouped),
            "n_groups": m.n_groups,
            "subgroup_ms": (t_subgroup - t_start) * 1e3,
            "points_ms": m.timings["points_ms"],
            "pack_ms": m.timings["pack_ms"],
            "host_ms": (t_marshal - t_start) * 1e3,
            "device_ms": (t_end - t_marshal) * 1e3,
        }
    )
    return result
