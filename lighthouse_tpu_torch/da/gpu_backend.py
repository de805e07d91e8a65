"""GPU backend of the DA plane: host marshalling -> device.

The port of `lighthouse_tpu/da/tpu_backend.py`. Two device workloads:

* `rs_extend_gpu` -- the Reed-Solomon extension. ONE launch of the Fr
  Horner kernel (`ops/rs_extend.py`, `csrc/rs_extend.cu`) evaluates every
  (point, blob) pair of the live blobs: no chain runs on padding (the
  reference pads the blob lanes to a power-of-two bucket; here the bucket,
  at least `MIN_BUCKET`, is only the dispatch metric's label). The reference
  converts the coefficients into Montgomery form and the evaluations back;
  here the coefficients upload as plain words and the domain's points as
  Montgomery words (computed once a geometry and kept on the device), so
  each Montgomery product of a chain multiplies by the plain point and the
  evaluations come back plain: no coefficient is ever converted, on the
  host or on the card. Output unpacks to plain canonical ints, equal to
  the host oracle.

* `verify_cell_proof_batch_gpu` -- cell multiproof verification. The
  coset fold (`da/cells.py`) has the pairing shape of the blob-proof
  batch, so it runs the KZG device path as it is
  (`ops/kzg_verify.verify_kzg_proof_batch`: K1's window body at 255 bits,
  the lane fold, to-affine, K2 at two pairs and K3's fold entry), with
  [tau^m]G2 (`setup.tau_g2_power(m)`) as the second pair's G2 point. No
  kernel and no pairing of its own. Its lanes are that path's four
  power-of-two segments of b = _bucket(N + 1) lanes, where the reference
  has three segments and an auxiliary lane:

      [0, b)    : C_k with r_k; lane N: the interpolant commitment
                  commit(sum_k r_k I_k) with scalar r - 1
      [b, 2b)   : W_k with r_k c_k mod r
      [2b, 3b)  : -W_k with r_k (negated on the host while packing)
      [3b, 4b)  : the identity

  so the fold leaves sum_k r_k C_k - commit(sum_k r_k I_k) + sum_k
  r_k c_k W_k and -sum_k r_k W_k, the two G1 points of the reference's
  identity. The lanes differ from the reference's; the verdict must not.
  The interpolant commitment is a host MSM over the setup's first m G1
  powers (`kzg.api._g1_lincomb`), as in the reference.

Every call crosses the guarded executor: `GUARD.dispatch("rs_extend",
...)` in `da/erasure.py` for an extension, `GUARD.dispatch("da_cells",
pow2_bucket(n), attempt)` here for a verify, its verdict through
`plan.verdict`. No failover: a fault reaches the caller as a
`DeviceFaultError`. The host's decoding, interpolation and packing run
before the crossing, so a malformed item raises `KzgError` or `DaError`
and never counts against the card. The device work of an attempt runs
under the device lock of the other backends (`ops/device_io.device_lock`).

`device="cuda"` runs the CUDA kernels and raises when there is no GPU;
`device="cpu"` runs their plain PyTorch versions (the tests).
"""

import threading
import time

import numpy as np

from lighthouse_tpu_torch.common import device_attribution as attribution
from lighthouse_tpu_torch.common.metrics import REGISTRY
from lighthouse_tpu_torch.common.tracing import span
from lighthouse_tpu_torch.crypto.constants import P, R
from lighthouse_tpu_torch.crypto.ref_curve import G1 as G1_GROUP
from lighthouse_tpu_torch.da import cells as _cells
from lighthouse_tpu_torch.da.domain import CellGeometry
from lighthouse_tpu_torch.device_plane.executor import GUARD, pow2_bucket
from lighthouse_tpu_torch.kzg import api as _kzg_api
from lighthouse_tpu_torch.kzg import gpu_backend as _kzg_gpu
from lighthouse_tpu_torch.ops import field as fd, kzg_verify, msm
from lighthouse_tpu_torch.ops import rfield as rf
from lighthouse_tpu_torch.ops import rs_extend
from lighthouse_tpu_torch.ops import window_ladder as wl
from lighthouse_tpu_torch.ops.device_io import device_lock, resolve_device, to_device

_EXTEND_BATCHES = REGISTRY.counter_vec(
    "lighthouse_tpu_da_extend_device_batches_total",
    "RS-extension device dispatches by bucketed blob count",
    ("lanes",),
)
_CELL_DEVICE_BATCHES = REGISTRY.counter_vec(
    "lighthouse_tpu_da_cell_device_batches_total",
    "DA cell-verify device dispatches by bucketed lane count",
    ("lanes",),
)

MIN_BUCKET = 2

# host/device split of the last extension: blobs, the blob lanes launched
# (the live blobs), the metric's bucket, and the ms of packing the
# coefficients and of the device call (uploads, the launch, the read)
LAST_EXTEND_STATS: dict = {}

# host/device split of the last cell verify: cells, lanes, and the ms of
# decompression with the subgroup checks, the cells' interpolants, the
# interpolant commitment, packing, and the device call
LAST_CELL_STATS: dict = {}

# (blob elements, device) -> the extended domain's points, Montgomery
# words on the device
_POINTS: dict = {}
_points_lock = threading.Lock()


def _bucket(n: int) -> int:
    b = MIN_BUCKET
    while b < n:
        b *= 2
    return b


def domain_points(geo: CellGeometry, dev):
    """The 2n domain points as (2n, 8) Montgomery words on `dev`, made
    once a (geometry, device)."""
    key = (geo.blob_elements, str(dev))
    with _points_lock:
        hit = _POINTS.get(key)
        if hit is None:
            hit = _POINTS[key] = to_device(rf.mont_words(geo.ext_points), dev)
    return hit


def pack_coefficients(polys, n_coeff: int, lanes: int) -> np.ndarray:
    """Coefficient lists -> (n_coeff, lanes, 8) plain words, coefficient
    major (a Horner step reads one leading slice), zero polynomials in any
    lanes past the polynomials."""
    coeffs = np.zeros((n_coeff, lanes, rf.NW), dtype=np.int32)
    if polys:
        words = rf.ints_to_words([v for poly in polys for v in poly])
        coeffs[:, : len(polys)] = words.reshape(len(polys), n_coeff, rf.NW).transpose(1, 0, 2)
    return coeffs


def rs_extend_gpu(polys, geo: CellGeometry, consumer: str | None = None, device="cuda") -> list:
    """Batched device extension: list of coefficient lists -> list of
    2n-long evaluation lists (plain canonical ints)."""
    dev = resolve_device(device)
    n = len(polys)
    bucket = _bucket(n)
    t0 = time.perf_counter()
    with span("da/extend_marshal", n_blobs=n, lanes=n):
        coeffs = pack_coefficients(polys, geo.blob_elements, n)
    t_marshal = time.perf_counter()
    _EXTEND_BATCHES.labels(str(bucket)).inc()
    with span("da/extend_device", lanes=n), device_lock(dev):
        out = rs_extend.eval_poly_batch(to_device(coeffs, dev), domain_points(geo, dev))
        out = out.cpu().numpy()
    t_device = time.perf_counter()
    attribution.note_batch(consumer, "rs_extend", lanes=n, live=n,
                           duration_s=t_device - t_marshal)
    # (PTS, n, 8) point-major plain words -> per-blob int lists
    flat = rf.words_to_ints(out)
    LAST_EXTEND_STATS.clear()
    LAST_EXTEND_STATS.update({
        "blobs": n, "lanes": n, "bucket": bucket, "pack_ms": (t_marshal - t0) * 1e3,
        "device_ms": (t_device - t_marshal) * 1e3,
        "unpack_ms": (time.perf_counter() - t_device) * 1e3,
    })
    return [flat[b::n] for b in range(n)]


# ------------------------------------------------------------ cell verify


def cell_verify_lanes(rs, cs, ws, rzs, interp_commit):
    """The lane layout of the module doc on the host: ((4b,) affine int
    pairs or None, (4b,) scalars) for RLC scalars rs, decompressed
    commitments cs and proofs ws (Jacobian), the scalars r_k c_k (rzs) and
    the interpolant commitment (Jacobian); b = _bucket(N + 1)."""
    n = len(cs)
    b = _bucket(n + 1)
    c_affs = [G1_GROUP.to_affine(c) for c in cs]
    w_affs = [G1_GROUP.to_affine(w) for w in ws]
    neg_w = [None if a is None else (a[0], (P - a[1]) % P) for a in w_affs]
    pad = [None] * (b - n)
    zero = [0] * (b - n)
    affs = (c_affs + [G1_GROUP.to_affine(interp_commit)] + pad[1:]
            + w_affs + pad + neg_w + pad + [None] * b)
    scalars = (list(rs) + [R - 1] + zero[1:] + list(rzs) + zero + list(rs) + zero
               + [0] * b)
    return affs, scalars


def verify_cell_proof_batch_gpu(
    items, geo: CellGeometry, setup=None, seed=None, consumer: str | None = None,
    device="cuda",
) -> bool:
    """The device cell-multiproof fold (see the module doc for the lanes):
    the host half, then ONE guarded dispatch of the KZG device path."""
    dev = resolve_device(device)
    setup = _kzg_api._setup_for(geo.blob_elements, setup)
    t_start = time.perf_counter()
    timings = {}
    rs, cs, ws, rzs, interp_acc = _cells._fold_inputs(items, geo, seed, timings)
    n = len(items)
    m = geo.cell_elements
    t_fold = time.perf_counter()
    with span("da/cell_marshal", n_cells=n):
        interp_commit = _kzg_api._g1_lincomb(setup.g1_powers[:m], interp_acc)
        t_commit = time.perf_counter()
        affs, scalars = cell_verify_lanes(rs, cs, ws, rzs, interp_commit)
        x, y, mask = _kzg_gpu._affine_words(affs)
        mags, negs = wl.signed_digit_arrays(scalars, nbits=msm.SCALAR_BITS)
        tau = tuple(fd.mont_words(c) for c in setup.tau_g2_power(m))
    lanes = len(affs)
    t_marshal = time.perf_counter()

    def attempt(plan):
        with span("da/cell_device", lanes=lanes), device_lock(dev):
            ok = kzg_verify.verify_kzg_proof_batch(
                *(to_device(a, dev) for a in (x, y, mask, mags, negs)),
                tuple(to_device(c, dev) for c in tau), device=dev,
            )
            return bool(plan.verdict(bool(ok)))

    _CELL_DEVICE_BATCHES.labels(str(lanes)).inc()
    result = GUARD.dispatch("da_cells", pow2_bucket(n), attempt)
    t_end = time.perf_counter()
    attribution.note_batch(consumer, "da_cells", lanes=lanes, live=3 * n + 1,
                           duration_s=t_end - t_marshal)
    LAST_CELL_STATS.clear()
    LAST_CELL_STATS.update({
        "n_cells": n, "lanes": lanes,
        "decompress_ms": timings["decompress_s"] * 1e3,
        "interpolate_ms": timings["interpolate_s"] * 1e3,
        "interp_commit_ms": (t_commit - t_fold) * 1e3,
        "pack_ms": (t_marshal - t_commit) * 1e3,
        "host_ms": (t_marshal - t_start) * 1e3,
        "device_ms": (t_end - t_marshal) * 1e3,
    })
    return result
