"""GPU backend of the KZG data plane: host marshalling -> device.

The port of `lighthouse_tpu/kzg/tpu_backend.py`. Two device workloads
share this boundary:

* `verify_blob_kzg_proof_batch_gpu` (consumer side): challenge hashing,
  polynomial evaluation, decompression with the subgroup checks and RLC
  sampling on the host (`api._batch_inputs`); the lane scalar multiples
  -- C_i, W_i, -W_i and the auxiliary G1 lane -- in ONE launch of K1's
  window body at 255 bits, the two pair points in one fold, and the
  two-pair Miller loop and final exponentiation on the device
  (`ops/kzg_verify.py`).

* the commitment and quotient MSMs (producer side):
  `g1_msm_fixed_base_gpu` over the trusted setup's digit-multiple table,
  packed once a (device, bucket) and cached on the setup
  (`ops/msm.pack_fixed_table`, traced as `kzg/msm_table`), and
  `g1_msm_gpu`, the variable-base MSM over arbitrary points. Host work is
  the signed-digit recoding (`window_ladder.signed_digit_arrays` at 255
  bits: 64 windows); a result is read back as one affine point.

Every device call crosses the guarded executor, as the reference's calls
do: `GUARD.dispatch("kzg", pow2_bucket(n), attempt)` for a verify, its
verdict through `plan.verdict`, and `GUARD.dispatch("msm",
pow2_bucket(n), attempt)` for an MSM (a point, so a flip is a no-op
there). There is no failover: a fault reaches the caller as a
`DeviceFaultError`. The host's decoding and policy run before the
crossing, so a malformed commitment raises `KzgError` and never counts
against the card. The device work of an attempt (uploads, launches, the
read) runs under the device lock that the BLS backend's attempts take
too (`ops/device_io.device_lock`).

Lane counts are bucketed to powers of two, at least `MIN_BUCKET`. The
reference's jit caches, compile ledger and kernel-form switches have no
twin: the kernels take any shape once built, and there is one form.

`device="cuda"` runs the CUDA kernels and raises when there is no GPU;
`device="cpu"` runs their plain PyTorch versions (the tests).
"""

import time

import numpy as np
import torch

from lighthouse_tpu_torch.common import device_attribution as attribution
from lighthouse_tpu_torch.common.metrics import REGISTRY
from lighthouse_tpu_torch.common.tracing import span
from lighthouse_tpu_torch.crypto.constants import P, R
from lighthouse_tpu_torch.crypto.ref_curve import G1 as G1_GROUP
from lighthouse_tpu_torch.device_plane.executor import GUARD, pow2_bucket
from lighthouse_tpu_torch.kzg import api as _api
from lighthouse_tpu_torch.ops import curve_kernels, field as fd, kzg_verify, msm
from lighthouse_tpu_torch.ops import window_ladder as wl
from lighthouse_tpu_torch.ops.device_io import device_lock, resolve_device, to_device

_DEVICE_BATCHES = REGISTRY.counter_vec(
    "lighthouse_tpu_kzg_device_batches_total",
    "KZG device batch dispatches by bucketed lane count",
    ("lanes",),
)
_MSM_DEVICE_BATCHES = REGISTRY.counter_vec(
    "lighthouse_tpu_kzg_msm_device_batches_total",
    "KZG device MSM dispatches by kind and bucketed lane count",
    ("kind", "lanes"),
)

MIN_BUCKET = 2

# host/device split of the last verify: proofs, lanes and the ms of the
# challenges, the evaluations, decompression with the subgroup checks,
# packing, and the device call (upload, launches, the verdict's read)
LAST_HOST_STATS: dict = {}

# the last MSM: kind, scalars, lanes and the ms of the digits, the table
# (0 when cached) and the device call
LAST_MSM_STATS: dict = {}


def _bucket(n: int) -> int:
    b = MIN_BUCKET
    while b < n:
        b *= 2
    return b


def _affine_words(affs):
    """Affine G1 int pairs (None = the identity) -> (N, 1, 12) x and y
    Montgomery words and the (N,) validity mask."""
    pts = [a or (0, 0) for a in affs]
    xs = fd.mont_words([a[0] for a in pts]).reshape(-1, 1, fd.NW)
    ys = fd.mont_words([a[1] for a in pts]).reshape(-1, 1, fd.NW)
    return xs, ys, np.array([a is not None for a in affs], dtype=bool)


def _read_point(pt):
    """A projective device point (1, 12, 1) -> the host's Jacobian point:
    one launch of the to-affine kernel and one read."""
    x, y, inf = curve_kernels.to_affine(pt)
    words = torch.cat([x.reshape(-1), y.reshape(-1), inf.to(torch.int32)]).cpu().numpy()
    if words[-1]:
        return G1_GROUP.infinity
    xv, yv = fd.words_from_mont(words[: 2 * fd.NW].reshape(2, fd.NW))
    return G1_GROUP.from_affine((xv, yv))


# ------------------------------------------------------------ verification


def verify_lanes(cs, ws, rs, zs, ys):
    """The lane layout of `ops/kzg_verify.py` on the host: ((4b,) affine
    int pairs or None, (4b,) scalars) for decompressed commitments cs and
    proofs ws (Jacobian), RLC scalars rs, challenges zs and evaluations
    ys; b = _bucket(N + 1)."""
    n = len(cs)
    b = _bucket(n + 1)
    c_affs = [G1_GROUP.to_affine(c) for c in cs]
    w_affs = [G1_GROUP.to_affine(w) for w in ws]
    neg_w = [None if a is None else (a[0], (P - a[1]) % P) for a in w_affs]
    ry_total = sum(r * y for r, y in zip(rs, ys)) % R
    gen = G1_GROUP.to_affine(G1_GROUP.generator)
    pad = [None] * (b - n)
    zero = [0] * (b - n)
    affs = c_affs + [gen] + pad[1:] + w_affs + pad + neg_w + pad + [None] * b
    scalars = (
        list(rs) + [(-ry_total) % R] + zero[1:]
        + [r * z % R for r, z in zip(rs, zs)] + zero
        + list(rs) + zero
        + [0] * b
    )
    return affs, scalars


def verify_blob_kzg_proof_batch_gpu(
    blobs, commitments, proofs, setup=None, seed=None, consumer: str | None = None,
    device="cuda",
) -> bool:
    dev = resolve_device(device)
    t_start = time.perf_counter()
    timings = {}
    s, zs, ys, cs, ws = _api._batch_inputs(blobs, commitments, proofs, setup, timings)
    n = len(blobs)
    rs = _api._rlc_scalars(n, seed)
    t_inputs = time.perf_counter()
    with span("kzg/marshal", n_proofs=n):
        affs, scalars = verify_lanes(cs, ws, rs, zs, ys)
        x, y, mask = _affine_words(affs)
        mags, negs = wl.signed_digit_arrays(scalars, nbits=msm.SCALAR_BITS)
        tau = tuple(fd.mont_words(c) for c in s.tau_g2)
    lanes = len(affs)
    t_marshal = time.perf_counter()

    def attempt(plan):
        plan.raise_if_faulted()
        with span("kzg/device", lanes=lanes), device_lock(dev):
            ok = kzg_verify.verify_kzg_proof_batch(
                *(to_device(a, dev) for a in (x, y, mask, mags, negs)),
                tuple(to_device(c, dev) for c in tau), device=dev,
            )
            return bool(plan.verdict(bool(ok)))

    _DEVICE_BATCHES.labels(str(lanes)).inc()
    result = GUARD.dispatch("kzg", pow2_bucket(n), attempt)
    t_end = time.perf_counter()
    attribution.note_batch(consumer, "kzg", lanes=lanes, live=3 * n + 1,
                           duration_s=t_end - t_marshal)
    LAST_HOST_STATS.clear()
    LAST_HOST_STATS.update({
        "n_proofs": n, "lanes": lanes,
        "challenge_ms": timings["challenge_s"] * 1e3,
        "evaluate_ms": timings["evaluate_s"] * 1e3,
        "decompress_ms": timings["decompress_s"] * 1e3,
        "host_ms": (t_marshal - t_start) * 1e3,
        "pack_ms": (t_marshal - t_inputs) * 1e3,
        "device_ms": (t_end - t_marshal) * 1e3,
    })
    return result


# ------------------------------------------------------------- MSM plane


def _host_table(setup, bucket: int):
    """`msm.pack_fixed_table` of the setup's first min(bucket, size) G1
    powers, padded to `bucket` lanes, cached on the setup beside the host
    table it packs. Keyed on the bucket, not the MSM's length: the
    commitment (n) and the quotient proof (n - 1) share one table."""
    key = ("packed", bucket, msm.WINDOW_BITS)
    hit = setup._window_tables.get(key)
    if hit is None:
        n_points = min(bucket, setup.size)
        with span("kzg/msm_table", n=n_points, bucket=bucket, c=msm.WINDOW_BITS):
            rows = setup.g1_window_table(n_points, msm.WINDOW_BITS)
            hit = setup._window_tables[key] = msm.pack_fixed_table(rows, bucket)
    return hit


def _device_table(setup, bucket: int, packed, dev):
    """The packed table on `dev`, uploaded once and cached on the setup
    per (device, bucket, c)."""
    key = ("device", str(dev), bucket, msm.WINDOW_BITS)
    hit = setup._window_tables.get(key)
    if hit is None:
        hit = setup._window_tables[key] = torch.from_numpy(packed).to(dev)
    return hit


def _dispatch_msm(kind, n, lanes, consumer, t_marshal, stats, run):
    _MSM_DEVICE_BATCHES.labels(kind, str(lanes)).inc()

    def attempt(plan):
        # a point, not a verdict: a flip injection has nothing to flip
        plan.raise_if_faulted()
        with span("kzg/msm_device", kind=kind, lanes=lanes):
            return run()

    point = GUARD.dispatch("msm", pow2_bucket(n), attempt)
    t_end = time.perf_counter()
    attribution.note_batch(consumer, "msm", lanes=lanes, live=n, duration_s=t_end - t_marshal)
    LAST_MSM_STATS.clear()
    LAST_MSM_STATS.update(stats, kind=kind, n=n, lanes=lanes,
                          device_ms=(t_end - t_marshal) * 1e3)
    return point


def g1_msm_fixed_base_gpu(scalars, setup, consumer: str | None = None, device="cuda"):
    """Fixed-base MSM on the device: sum [s_i] setup.g1_powers[i]. Returns
    the host's Jacobian point (the api layer compresses). The packed table
    amortizes over every commitment and proof against the same setup."""
    dev = resolve_device(device)
    scalars = [int(s) % R for s in scalars]
    n = len(scalars)
    if n > setup.size:
        # the table pack clamps to the setup size; without this guard
        # extra scalars would silently fold as identity (the ref
        # backend raises via zip(strict=True) — match it)
        raise ValueError(f"MSM has {n} scalars but the setup has {setup.size} points")
    if n == 0 or not any(scalars):
        return G1_GROUP.infinity
    bucket = _bucket(n)
    t0 = time.perf_counter()
    with span("kzg/msm_marshal", kind="fixed", n=n):
        packed = _host_table(setup, bucket)
        t1 = time.perf_counter()
        mags, negs = wl.signed_digit_arrays(scalars + [0] * (bucket - n),
                                             nbits=msm.SCALAR_BITS)
    t_marshal = time.perf_counter()

    def run():
        with device_lock(dev):
            table = _device_table(setup, bucket, packed, dev)
            return _read_point(msm.msm_fixed_base(table, to_device(mags, dev),
                                                  to_device(negs, dev)))

    stats = {"table_ms": (t1 - t0) * 1e3, "digits_ms": (t_marshal - t1) * 1e3}
    return _dispatch_msm("fixed", n, bucket, consumer, t_marshal, stats, run)


def g1_msm_gpu(points_affine, scalars, consumer: str | None = None, device="cuda"):
    """Variable-base MSM on the device over arbitrary affine int points
    (None = the identity). Returns the host's Jacobian point."""
    dev = resolve_device(device)
    points_affine = list(points_affine)
    scalars = [int(s) % R for s in scalars]
    if len(points_affine) != len(scalars):
        raise ValueError("MSM points and scalars must have equal lengths")
    n = len(scalars)
    if n == 0:
        return G1_GROUP.infinity
    bucket = _bucket(n)
    t0 = time.perf_counter()
    with span("kzg/msm_marshal", kind="variable", n=n):
        pad = bucket - n
        x, y, valid = _affine_words(points_affine + [None] * pad)
        mags, negs = wl.signed_digit_arrays(scalars + [0] * pad, nbits=msm.SCALAR_BITS)
    t_marshal = time.perf_counter()

    def run():
        with device_lock(dev):
            return _read_point(msm.msm_variable(
                *(to_device(a, dev) for a in (x, y, valid, mags, negs)), device=dev))

    stats = {"table_ms": 0.0, "digits_ms": (t_marshal - t0) * 1e3}
    return _dispatch_msm("variable", n, bucket, consumer, t_marshal, stats, run)
