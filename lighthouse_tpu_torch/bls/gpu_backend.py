"""GPU backend of `verify_signature_sets`: host marshalling -> device batch.

The port of `lighthouse_tpu/bls/tpu_backend.py`'s batch path. The host:

  * runs the signature policy (not infinity, in the subgroup -- memoized
    per signature);
  * bins the sets by message when `_group_plan` finds that grouping at
    least halves the pair count (G * 2 <= S: a slot's attestations, ~64
    committees over >= 30k sets), else lays them out flat;
  * pads sets, keys and groups to power-of-two buckets with masked lanes;
  * hashes each distinct message once (memoized, affine Montgomery kernel
    words), and ships signatures -- and the pubkeys of a batch whose keys
    are not all in one table -- as their Jacobian coordinates in plain
    canonical words (`fd.ints_to_words`, no field arithmetic): the device
    batch converts them to affine Montgomery words with one kernel launch
    (`curve_kernels.jacobian_to_affine`); a padding lane has Z = 0, which
    maps to (0, 0);
  * ships table row indices instead of points when every pubkey is
    registered in one `DevicePubkeyTable`;
  * samples 64-bit RLC scalars, and dispatches one device batch
    (`ops/batch_verify.py`) on `device`, with K1's `ladder` form.

`verify_signature_sets_gpu_individual` is the per-set fallback after a
failed batch (`tpu_backend.verify_signature_sets_tpu_individual`): the
signature policy per set (a bad signature is False for its set and never
reaches the device), then the live sets laid out flat, unpadded, in one
device call.

`verify_signature_set_batches_gpu` streams several batches
(`tpu_backend.verify_signature_set_batches_tpu`): a batch's launch
(`_launch`) returns its verdict as a device tensor that nobody has read,
its copy to the host is queued right behind its kernels (`_read_later`),
and the loop marshals and launches batch N+1 before it waits for batch
N's copy. Nothing between the two waits for the device: the batch's
arrays reach the card through pinned staging buffers, non-blocking (an
upload from pageable memory would wait for the queued kernels), and the
kernels' constants are uploaded once and cached.

`check_signature_subgroups` fills the subgroup memo of a list of
signatures with two launches: the Jacobian entry of the to-affine kernel,
then the subgroup kernel (`ops/subgroup.py`), the device form of
`bench_oppool.py`'s phase 2; it crosses the guard too.

Each batch is attributed to its consumer (`common/device_attribution.py`:
lanes, padding, device seconds) and traced (`common/tracing.py`: the
reference's `verify/*` spans).

Every device verify crosses the guarded executor
(`device_plane.GUARD.dispatch("bls", bucket, attempt)`, as the reference's
`tpu_backend.py` does): the breaker first, then the attempt on a watchdog
thread, with the seeded injection plan. The attempt calls
`plan.raise_if_faulted()` before any launch and routes what the card
computed through `plan.verdict`; the host policy, marshalling and
attribution stay outside it (the streamed path marshals batch N+1 inside
its one attempt, which is what lets it overlap batch N). A fault reaches
the caller as a `DeviceFaultError`; there is no failover.

The attempts may run on several threads at once (the bus flushes on its
submitters' threads, the watchdog runs each attempt on a thread of its
own). The device work of an attempt -- uploads, launches, the verdict's
read, the call counts -- runs under one lock per device
(`ops/device_io.device_lock`),
so concurrent calls launch one after another, each on the current stream
of the thread that holds the lock.

`device="cuda"` runs the CUDA kernels and raises when there is no GPU;
`device="cpu"` runs their plain PyTorch versions (the tests).
"""

import secrets
import threading
import time

import numpy as np
import torch

from lighthouse_tpu_torch.bls.api import signature_ok
from lighthouse_tpu_torch.bls.hash_to_curve import hash_to_g2
from lighthouse_tpu_torch.common import device_attribution as attribution
from lighthouse_tpu_torch.common.tracing import span
from lighthouse_tpu_torch.crypto.ref_curve import G2 as G2_GROUP
from lighthouse_tpu_torch.device_plane.executor import GUARD, pow2_bucket
from lighthouse_tpu_torch.ops import batch_verify, curve_kernels, field as fd, subgroup
from lighthouse_tpu_torch.ops.device_io import device_lock, resolve_device, to_device

# host/device split of the last dispatched batch
LAST_HOST_STATS: dict = {}

# the last verify_signature_set_batches_gpu call: batches, dispatched,
# host_marshal_ms, wall_ms
LAST_STREAM_STATS: dict = {}

# device calls dispatched: RLC batches and per-set fallbacks
CALL_COUNTS = {"batch": 0, "individual": 0}

_stats_lock = threading.Lock()


def _bucket(n: int, minimum: int) -> int:
    b = minimum
    while b < n:
        b *= 2
    return b


# --------------------------------------------------------- message hashing

_MSG_CACHE: dict = {}
_MSG_CACHE_MAX = 16_384


def _msg_entry(message: bytes):
    """Memoized hash_to_g2 -> (affine ints, (2, 12) x and y Montgomery
    words): a slot's attestations share a message per committee, and the
    per-set layout repeats it on every set's lane."""
    message = bytes(message)
    hit = _MSG_CACHE.get(message)
    if hit is None:
        aff = G2_GROUP.to_affine(hash_to_g2(message))
        x, y = _pack_g2([aff])
        hit = (aff, x[0], y[0])
        if len(_MSG_CACHE) >= _MSG_CACHE_MAX:
            _MSG_CACHE.clear()
        _MSG_CACHE[message] = hit
    return hit


def _msg_affine(message: bytes):
    return _msg_entry(message)[0]


def _pack_msgs(entries, n_pad: int) -> tuple:
    """Message entries (`_msg_entry`) and n_pad padding lanes -> (N, 2, 12)
    x and y Montgomery words; padding is zero."""
    zero = np.zeros((2, fd.NW), np.int32)
    return tuple(np.stack([e[j] for e in entries] + [zero] * n_pad) for j in (1, 2))


# --------------------------------------------------------------- packing


def _pack_g2(affs) -> tuple:
    """Affine G2 (None = masked) -> (N, 2, 12) x and y Montgomery words."""
    zero = ((0, 0), (0, 0))
    pts = [a or zero for a in affs]
    xs = fd.mont_words([c for a in pts for c in a[0]]).reshape(-1, 2, fd.NW)
    ys = fd.mont_words([c for a in pts for c in a[1]]).reshape(-1, 2, fd.NW)
    return xs, ys


def _pack_jacobian(points, w: int) -> tuple:
    """Jacobian points, crypto/ref_curve's coordinates (None = padding) ->
    (N, w, 12) plain canonical words of X, Y and Z; padding is all zero, so
    its Z = 0."""
    zero = (0,) * (3 * w)
    flat = []
    for pt in points:
        if pt is None:
            flat += zero
        elif w == 1:
            flat += pt
        else:
            flat += (c for coord in pt for c in coord)
    words = fd.ints_to_words(flat).reshape(-1, 3, w, fd.NW)
    return tuple(words[:, i] for i in range(3))


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
            row = [] if i is None else [p.point for p in sets[i].pubkeys]
            flat += row + [None] * (m.k_bucket - len(row))
        m.indices = None
        m.pubkeys = tuple(c.reshape(len(order), m.k_bucket, 1, fd.NW)
                          for c in _pack_jacobian(flat, 1))


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
    with span("verify/marshal/points"):
        group_msgs = [_msg_entry(sets[ix[0]].message) for _, ix in groups]
        order: list = []
        for _, ix in groups:
            order += list(ix) + [None] * (sg_b - len(ix))
        order += [None] * ((g_b - G) * sg_b)
        sigs = [None if i is None else sets[i].signature.point for i in order]
    t1 = time.perf_counter()
    with span("verify/marshal/pack"):
        m.group_mask = np.array([True] * G + [False] * (g_b - G), dtype=bool)
        m.set_mask = np.array([i is not None for i in order], dtype=bool).reshape(g_b, sg_b)
        _pack_keys(m, sets, order)
        m.key_mask = m.key_mask.reshape(g_b, sg_b, m.k_bucket)
        if m.indices is not None:
            m.indices = m.indices.reshape(g_b, sg_b, m.k_bucket)
        else:
            m.pubkeys = tuple(c.reshape(g_b, sg_b, m.k_bucket, 1, fd.NW) for c in m.pubkeys)
        m.msgs = _pack_msgs(group_msgs, g_b - G)
        m.sigs = tuple(c.reshape(g_b, sg_b, 2, fd.NW) for c in _pack_jacobian(sigs, 2))
    t2 = time.perf_counter()
    m.timings = {"points_ms": (t1 - t0) * 1e3, "pack_ms": (t2 - t1) * 1e3}
    return m


def _marshal_flat(sets, pow2: bool = True) -> _Marshalled:
    """One lane per set; padded to a power of two (at least 4) for the RLC
    lane folds, or left at len(sets) (`pow2=False`, the per-set path)."""
    t0 = time.perf_counter()
    n_sets = len(sets)
    m = _Marshalled()
    m.grouped, m.n_groups, m.group_mask = False, None, None
    m.s_bucket = _bucket(n_sets, 4) if pow2 else n_sets
    m.k_bucket = _bucket(max(len(s.pubkeys) for s in sets), 1)
    pad = [None] * (m.s_bucket - n_sets)
    with span("verify/marshal/points"):
        msgs = [_msg_entry(s.message) for s in sets]
        sigs = [s.signature.point for s in sets] + pad
    t1 = time.perf_counter()
    with span("verify/marshal/pack"):
        order = list(range(n_sets)) + pad
        m.set_mask = np.array([i is not None for i in order], dtype=bool)
        _pack_keys(m, sets, order)
        m.msgs = _pack_msgs(msgs, len(pad))
        m.sigs = _pack_jacobian(sigs, 2)
    t2 = time.perf_counter()
    m.timings = {"points_ms": (t1 - t0) * 1e3, "pack_ms": (t2 - t1) * 1e3}
    return m


# ---------------------------------------------------------------- dispatch


def _pubkeys(m, device):
    """The batch's key words on `device`: affine (x, y) gathered from its
    table, or the Jacobian (X, Y, Z) plain words of the point path."""
    if m.table is None:
        return tuple(to_device(c, device) for c in m.pubkeys)
    if m.table.device != device:
        raise ValueError(f"pubkey table on {m.table.device}, batch on {device}")
    return m.table.gather(to_device(m.indices, device))


def _launch(m, rand_bits, device, ladder="window") -> torch.Tensor:
    """Upload one marshalled batch and launch its kernels on `device`;
    returns the verdict as a 0-d bool tensor on the device, unread: nothing
    here waits for the device."""
    CALL_COUNTS["batch"] += 1
    msgs = tuple(to_device(c, device) for c in m.msgs)
    sigs = tuple(to_device(c, device) for c in m.sigs)
    pubkeys = _pubkeys(m, device)
    key_mask = to_device(m.key_mask, device)
    set_mask = to_device(m.set_mask, device)
    if m.grouped:
        bits = to_device(rand_bits.reshape(m.set_mask.shape + (batch_verify.RAND_BITS,)), device)
        return batch_verify.verify_signature_sets_grouped(
            msgs, sigs, pubkeys, key_mask, bits, set_mask,
            to_device(m.group_mask, device), device=device, ladder=ladder,
        )
    return batch_verify.verify_signature_sets(
        msgs, sigs, pubkeys, key_mask, to_device(rand_bits, device), set_mask,
        device=device, ladder=ladder,
    )


def _force(ok: torch.Tensor) -> bool:
    """Read a launched batch's verdict: waits for its kernels."""
    return bool(ok)


def _read_later(ok: torch.Tensor):
    """Queue the copy of a launched verdict to the host right behind its
    batch's kernels, and return the call that waits for that copy alone.
    Reading the device tensor itself later would queue its copy behind
    every batch launched since, and wait for them too."""
    if ok.device.type != "cuda":
        return lambda: _force(ok)
    host = torch.empty((), dtype=torch.bool, pin_memory=True)
    host.copy_(ok, non_blocking=True)
    copied = torch.cuda.Event()
    copied.record()

    def read() -> bool:
        copied.synchronize()
        return _force(host)

    return read


def _shape_key(m) -> str:
    """The breaker's bucket: the (set, key) bucket class of the marshalled
    batch, `tpu_backend._shape_key`'s string."""
    if m.grouped:
        g_b, sg_b = m.set_mask.shape
        return f"g{g_b}x{sg_b}k{m.k_bucket}"
    return f"s{m.s_bucket}k{m.k_bucket}"


def _record_stats(n_sets, m, t_start, t_subgroup, t_marshal, t_end, individual) -> None:
    with _stats_lock:
        LAST_HOST_STATS.clear()
        LAST_HOST_STATS.update(
            {
                "n_sets": n_sets,
                "individual": individual,
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


def _policy_ok(sets) -> bool:
    with span("verify/subgroup_check", n_sets=len(sets)):
        return all(signature_ok(s.signature) for s in sets)


def _marshal_batch(sets, seed):
    with span("verify/marshal", n_sets=len(sets)):
        m = _marshal(sets)
    with span("verify/rlc_sample"):
        rand_bits = _scalar_bits(_rlc_scalars(m.s_bucket, seed))
    return m, rand_bits


def verify_signature_sets_gpu(
    sets, seed: int | None = None, device="cuda", ladder: str = "window", consumer=None
) -> bool:
    dev = resolve_device(device)
    t_start = time.perf_counter()
    if not _policy_ok(sets):
        return False
    t_subgroup = time.perf_counter()
    m, rand_bits = _marshal_batch(sets, seed)
    t_marshal = time.perf_counter()

    def attempt(plan):
        plan.raise_if_faulted()
        with span("verify/device", s_bucket=m.s_bucket, grouped=bool(m.grouped),
                  indexed=m.table is not None), device_lock(dev):
            return bool(plan.verdict(_force(_launch(m, rand_bits, dev, ladder))))

    result = GUARD.dispatch("bls", _shape_key(m), attempt)
    t_end = time.perf_counter()
    attribution.note_batch(consumer, "bls", lanes=m.s_bucket, live=len(sets),
                           duration_s=t_end - t_marshal)
    _record_stats(len(sets), m, t_start, t_subgroup, t_marshal, t_end, False)
    return result


def verify_signature_sets_gpu_individual(sets, device="cuda", consumer=None) -> list:
    """Per-set verdicts in one device call: False for a set whose signature
    fails the policy (infinity, not in the subgroup) without device work,
    the pairing check of each other set on `device`."""
    dev = resolve_device(device)
    t_start = time.perf_counter()
    with span("verify/subgroup_check", n_sets=len(sets)):
        live = [i for i, s in enumerate(sets) if signature_ok(s.signature)]
    verdicts = [False] * len(sets)
    if not live:
        return verdicts
    t_subgroup = time.perf_counter()
    with span("verify/marshal", n_sets=len(live)):
        m = _marshal_flat([sets[i] for i in live], pow2=False)
    t_marshal = time.perf_counter()

    def attempt(plan):
        plan.raise_if_faulted()
        with span("verify/device", s_bucket=m.s_bucket, individual=True), device_lock(dev):
            CALL_COUNTS["individual"] += 1
            ok = batch_verify.verify_signature_sets_individual(
                tuple(to_device(c, dev) for c in m.msgs),
                tuple(to_device(c, dev) for c in m.sigs),
                _pubkeys(m, dev), to_device(m.key_mask, dev), to_device(m.set_mask, dev),
                device=dev,
            ).tolist()
        return list(plan.verdict([bool(v) for v in ok]))

    ok = GUARD.dispatch("bls", _shape_key(m), attempt)
    t_end = time.perf_counter()
    for j, i in enumerate(live):
        verdicts[i] = bool(ok[j])
    attribution.note_batch(consumer, "bls", lanes=m.s_bucket, live=len(live),
                           duration_s=t_end - t_marshal)
    _record_stats(len(sets), m, t_start, t_subgroup, t_marshal, t_end, True)
    return verdicts


def verify_signature_set_batches_gpu(
    batches, seed: int | None = None, device="cuda", ladder: str = "window", consumer=None
) -> list:
    """One verdict per batch, streamed: batch N+1 is marshalled and
    launched while batch N runs on the card, and N's verdict is read only
    then. Batch bi takes seed `seed + bi`; an empty batch, or one whose
    signatures fail the policy, is False and never launched. On the CPU the
    same loop runs without the overlap.

    The whole stream is ONE guarded crossing (bucket "stream"): a watchdog
    a batch would serialise exactly the overlap the stream exists for.
    Every device-produced verdict goes through the plan."""
    dev = resolve_device(device)
    t_wall0 = time.perf_counter()
    results = [None] * len(batches)
    live = []
    for bi, sets in enumerate(batches):
        if not sets or not _policy_ok(sets):
            results[bi] = False
        else:
            live.append(bi)
    stream = {"host_s": 0.0, "noted": []}

    def attempt(plan):
        plan.raise_if_faulted()
        out = {}
        stream["host_s"] = 0.0
        stream["noted"] = []
        pending = None  # (batch index, the read of its verdict)
        with device_lock(dev):
            for bi in live:
                sets = batches[bi]
                t0 = time.perf_counter()
                m, rand_bits = _marshal_batch(sets, None if seed is None else seed + bi)
                stream["host_s"] += time.perf_counter() - t0
                read = _read_later(_launch(m, rand_bits, dev, ladder))
                stream["noted"].append((m.s_bucket, len(sets)))
                if pending is not None:
                    out[pending[0]] = bool(plan.verdict(pending[1]()))
                pending = (bi, read)
            if pending is not None:
                out[pending[0]] = bool(plan.verdict(pending[1]()))
        return out

    if live:
        for bi, ok in GUARD.dispatch("bls", "stream", attempt).items():
            results[bi] = ok
    # no duration a batch: with the overlap a batch's device time is not
    # seen alone; the whole call's wall is observed once below
    for lanes, n in stream["noted"]:
        attribution.note_batch(consumer, "bls", lanes=lanes, live=n)
    wall_ms = (time.perf_counter() - t_wall0) * 1e3
    if live:
        attribution.observe_seconds(consumer, "bls", wall_ms / 1e3)
    LAST_STREAM_STATS.clear()
    LAST_STREAM_STATS.update(
        {"batches": len(batches), "dispatched": len(live),
         "host_marshal_ms": stream["host_s"] * 1e3, "wall_ms": wall_ms}
    )
    return results


def _subgroup_verdicts(words, dev) -> list:
    """The device half of `check_signature_subgroups`: the packed Jacobian
    words (`_pack_jacobian`) uploaded, the two launches and the verdicts'
    read, under the device lock."""
    with span("verify/subgroup_check", n_sets=words[0].shape[0], device=dev.type), device_lock(dev):
        jac = tuple(batch_verify._lanes(to_device(c, dev), dev) for c in words)
        x, y, inf = curve_kernels.jacobian_to_affine(jac)
        return [bool(v) for v in subgroup.g2_in_subgroup(x, y, ~inf).tolist()]


def check_signature_subgroups(sigs, device="cuda") -> list:
    """[r] P == O for each signature on `device`, in two launches for the
    whole list -- the Jacobian entry of the to-affine kernel, then the
    subgroup kernel -- and each signature's `_subgroup_ok` memo set to its
    own verdict. The point at infinity becomes a masked lane and passes, as
    `ref_curve.G2.in_subgroup` has it. Returns the verdicts.

    The launches cross the guard like every device verify
    (`GUARD.dispatch("bls", "subgroup<n>", attempt)`, n the list's
    power-of-two bucket), the verdicts through `plan.verdict`; the memos are
    set only from the verdicts of a dispatch that returned, so a fault
    leaves every memo as it was."""
    dev = resolve_device(device)
    sigs = list(sigs)
    if not sigs:
        return []
    words = _pack_jacobian([s.point for s in sigs], 2)

    def attempt(plan):
        plan.raise_if_faulted()
        return list(plan.verdict(_subgroup_verdicts(words, dev)))

    ok = GUARD.dispatch("bls", f"subgroup{pow2_bucket(len(sigs))}", attempt)
    for s, v in zip(sigs, ok):
        s._subgroup_ok = v
    return ok
