"""Reed-Solomon blob extension + 50%-reconstruction (host policy).

The port of `lighthouse_tpu/da/erasure.py`. `extend_blobs` evaluates every
blob polynomial of a block over the 2x extended domain in ONE batched
dispatch, with the KZG plane's backend surface: "gpu" (the default) goes
through the guarded executor into the Fr Horner kernel
(`da/gpu_backend.rs_extend_gpu`, `csrc/rs_extend.cu`) on `device`, "ref"
is the host bigint Horner oracle, and both give the same values.

The "fake" backend runs the REF oracle too: erasure coding transports
DATA (the bytes nodes reconstruct blobs from), it does not produce a
crypto verdict -- a structural stand-in would break reconstruction
round-trips. Fake stays what it is elsewhere: cell PROOFS are
structural and cell verification auto-accepts (`da.cells`).

The gpu branch is one `GUARD.dispatch("rs_extend", pow2_bucket(n),
attempt)` with no failover: a stall or an error reaches the caller as a
`DeviceFaultError`. An extension yields data, not a verdict, so a flip
injection leaves it as it is.

`reconstruct_poly` inverts the extension from ANY n of the 2n
evaluations (any 50% of cells) by O(n^2) Lagrange interpolation --
host bigint, backend-independent, byte-exact. Fewer than n points
raises `DaError` loudly (the <50% withholding case must never yield a
silently wrong blob).
"""

import time

from lighthouse_tpu_torch.common import device_attribution as attribution
from lighthouse_tpu_torch.common import slot_budget
from lighthouse_tpu_torch.common.tracing import span
from lighthouse_tpu_torch.crypto.constants import R
from lighthouse_tpu_torch.da.domain import (
    BYTES_PER_FIELD_ELEMENT,
    CellGeometry,
    DaError,
)
from lighthouse_tpu_torch.device_plane.executor import GUARD, pow2_bucket
from lighthouse_tpu_torch.kzg.api import BACKENDS, default_backend
from lighthouse_tpu_torch.ops.device_io import resolve_device


def check_backend(backend) -> str:
    backend = backend or default_backend()
    if backend not in BACKENDS:
        raise DaError(f"unknown DA backend {backend!r}")
    return backend


def blob_to_ints(blob: bytes, geo: CellGeometry) -> list:
    """Blob bytes -> n canonical Fr coefficients (spec validity rule:
    each 32-byte big-endian element must be < r)."""
    blob = bytes(blob)
    if len(blob) != geo.blob_bytes:
        raise DaError(
            f"blob is {len(blob)} bytes, geometry wants {geo.blob_bytes}"
        )
    out = []
    for i in range(0, len(blob), BYTES_PER_FIELD_ELEMENT):
        v = int.from_bytes(blob[i : i + BYTES_PER_FIELD_ELEMENT], "big")
        if v >= R:
            raise DaError("blob element is not a canonical field element")
        out.append(v)
    return out


def ints_to_blob(values, geo: CellGeometry) -> bytes:
    if len(values) != geo.blob_elements:
        raise DaError(
            f"{len(values)} coefficients, geometry wants "
            f"{geo.blob_elements}"
        )
    return b"".join(
        (v % R).to_bytes(BYTES_PER_FIELD_ELEMENT, "big") for v in values
    )


def _extend_ref(polys, geo: CellGeometry) -> list:
    """Host bigint Horner oracle: evaluate each polynomial at every
    extended-domain point. Ground truth for the device kernel."""
    out = []
    for poly in polys:
        evals = []
        for x in geo.ext_points:
            acc = 0
            for c in reversed(poly):
                acc = (acc * x + c) % R
            evals.append(acc)
        out.append(evals)
    return out


def extend_blobs(
    blobs,
    geo: CellGeometry,
    backend: str | None = None,
    consumer: str | None = None,
    device="cuda",
) -> list:
    """Extend a block's blobs: list of blob bytes -> list of 2n-long
    evaluation lists (ints, natural domain order). One batched dispatch
    for the whole block. On "gpu" the kernel runs on `device`, on the live
    blobs alone."""
    backend = check_backend(backend)
    polys = [blob_to_ints(b, geo) for b in blobs]
    if not polys:
        return []
    n = len(polys)
    # the slot-budget dispatch mark on every backend: fake/ref stand in
    # for the device plane (GUARD's nested crossing on the gpu branch is
    # depth-suppressed; this interval owns the round trip)
    _budget_tok = slot_budget.open_dispatch("rs_extend", kind="da")
    t0 = time.perf_counter()
    try:
        with span("da/extend", n_blobs=n, backend=backend):
            if backend in ("ref", "fake"):
                # fake still extends for real: data, not a verdict
                result = _extend_ref(polys, geo)
            else:
                from lighthouse_tpu_torch.da.gpu_backend import rs_extend_gpu

                dev = resolve_device(device)

                def attempt(plan):
                    # data, not a verdict: a flip injection has nothing
                    # to flip; a stall or an error raised before this
                    return rs_extend_gpu(polys, geo, consumer=consumer, device=dev)

                result = GUARD.dispatch("rs_extend", pow2_bucket(n), attempt)
    finally:
        slot_budget.close_dispatch(_budget_tok)
    if backend != "gpu":
        attribution.note_batch(
            consumer, "rs_extend", lanes=None, live=n,
            duration_s=time.perf_counter() - t0,
        )
    return result


def lagrange_coeffs(xs, ys) -> list:
    """Coefficient-form interpolation through (x_i, y_i): O(len^2)
    exact bigint. Build the monic product polynomial over the points,
    peel each (X - x_i) back off by synthetic division, scale by
    y_i / prod'(x_i). Shared by blob reconstruction (n points) and the
    cell-multiproof interpolants (m points, `da.cells`)."""
    n = len(xs)
    # prod(X) = prod_i (X - x_i), degree n, monic
    prod = [1]
    for x in xs:
        nxt = [0] * (len(prod) + 1)
        for d, c in enumerate(prod):
            nxt[d + 1] = (nxt[d + 1] + c) % R
            nxt[d] = (nxt[d] - c * x) % R
        prod = nxt

    coeffs = [0] * n
    for x, y in zip(xs, ys, strict=True):
        # q = prod / (X - x): synthetic division, exact (x is a root)
        q = [0] * n
        carry = 0
        for d in range(n, 0, -1):
            carry = (carry * x + prod[d]) % R
            q[d - 1] = carry
        # denominator q(x) = prod'(x) != 0 (distinct points)
        qx = 0
        for c in reversed(q):
            qx = (qx * x + c) % R
        scale = y * pow(qx, R - 2, R) % R
        for d in range(n):
            coeffs[d] = (coeffs[d] + scale * q[d]) % R
    return coeffs


def reconstruct_poly(evaluations: dict, geo: CellGeometry) -> list:
    """{extended-domain index -> evaluation} (>= n entries) -> the n
    polynomial coefficients, exact.

    Raises DaError when fewer than n evaluations are supplied -- below
    50% availability there is no unique answer and guessing would be a
    consensus fault."""
    n = geo.blob_elements
    if len(evaluations) < n:
        raise DaError(
            f"reconstruction needs {n} evaluations, got "
            f"{len(evaluations)} (< 50% of columns available)"
        )
    idxs = sorted(evaluations)[:n]
    xs = [geo.ext_points[i] for i in idxs]
    ys = [evaluations[i] % R for i in idxs]
    return lagrange_coeffs(xs, ys)


def reconstruct_blob(cells: dict, geo: CellGeometry) -> bytes:
    """{cell index -> cell bytes} (any >= 50% of cells) -> the original
    blob bytes, byte-exact."""
    evaluations = {}
    for k, cell in cells.items():
        cell = bytes(cell)
        if len(cell) != geo.cell_bytes:
            raise DaError(
                f"cell {k} is {len(cell)} bytes, geometry wants "
                f"{geo.cell_bytes}"
            )
        for j, i in enumerate(geo.cell_indices(k)):
            v = int.from_bytes(
                cell[
                    j * BYTES_PER_FIELD_ELEMENT
                    : (j + 1) * BYTES_PER_FIELD_ELEMENT
                ],
                "big",
            )
            evaluations[i] = v
    return ints_to_blob(reconstruct_poly(evaluations, geo), geo)
