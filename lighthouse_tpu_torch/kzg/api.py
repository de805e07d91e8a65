"""KZG polynomial commitments over BLS12-381 (EIP-4844 blob flavor).

The port of `lighthouse_tpu/kzg/api.py`, with the same functions, metric
names, spans, consumer attribution and slot-budget marks. The same
pairing-product data plane as the BLS signature boundary, aimed at a
second workload: a blob sidecar is available iff its KZG proof verifies,
and N proofs fold into ONE two-pair multi-pairing via the
random-linear-combination trick the batch signature verifier already uses
(`ops/batch_verify`):

    e( sum_i r_i (C_i - [y_i]G1 + [z_i]W_i),  G2 )
      * e( -sum_i r_i W_i,  [tau]G2 )  ==  1

Dev simplification vs the consensus spec (documented, deliberate): the
blob is interpreted in COEFFICIENT form, not the spec's
evaluation-on-roots-of-unity form. The commitment MSM, quotient-proof
construction, Fiat-Shamir challenge and the pairing checks — the parts
that touch the accelerator — are structurally identical; only the
basis differs. The trusted setup is an insecure deterministic dev
setup (kzg/trusted_setup.py).

Backends mirror `bls.verify_signature_sets`:

  "gpu"  -- the batch identity and the commitment MSMs on a device
            (`kzg/gpu_backend.py`, `ops/kzg_verify.py`, `ops/msm.py`): the
            hand-written CUDA kernels for `device="cuda"`, their plain
            PyTorch versions for `device="cpu"`; the default;
  "ref"  -- pure host bigint, ground truth;
  "fake" -- always true (commitments and proofs are the identity).

Every "gpu" dispatch crosses the guarded executor inside
`kzg/gpu_backend.py`: `GUARD.dispatch("kzg" | "msm", pow2_bucket(n),
attempt)` with no failover, the host's decoding and policy outside the
attempt, so a malformed input raises `KzgError` and a device fault a
`DeviceFaultError`.
"""

import hashlib
import secrets
import time

import numpy as np

from lighthouse_tpu_torch.bls.point_serde import (
    DecodeError,
    g1_compress,
    g1_decompress,
)
from lighthouse_tpu_torch.common import device_attribution as attribution
from lighthouse_tpu_torch.common import slot_budget
from lighthouse_tpu_torch.common.metrics import REGISTRY
from lighthouse_tpu_torch.common.tracing import span
from lighthouse_tpu_torch.crypto.constants import R
from lighthouse_tpu_torch.crypto.ref_curve import G1 as G1_GROUP
from lighthouse_tpu_torch.crypto.ref_curve import G2 as G2_GROUP
from lighthouse_tpu_torch.crypto.ref_pairing import multi_pairing_is_one
from lighthouse_tpu_torch.kzg.trusted_setup import TrustedSetup, dev_setup

BYTES_PER_FIELD_ELEMENT = 32
RAND_BITS = 64  # RLC scalar width, matching ops/batch_verify
CHALLENGE_DST = b"LIGHTHOUSE_TPU_KZG_CHALLENGE_"

BACKENDS = ("gpu", "ref", "fake")


def default_backend() -> str:
    """The backend a call without `backend=` takes: the card."""
    return "gpu"

_VERIFY_SECONDS = REGISTRY.histogram_vec(
    "lighthouse_tpu_kzg_verify_seconds",
    "KZG batch verification wall time by backend",
    ("backend",),
)
_BATCHES = REGISTRY.counter_vec(
    "lighthouse_tpu_kzg_batches_total",
    "KZG proof batches verified, by backend and outcome",
    ("backend", "result"),
)
_PROOFS = REGISTRY.counter(
    "lighthouse_tpu_kzg_proofs_verified_total",
    "individual KZG proofs folded into verified batches",
)
_BATCH_SIZE = REGISTRY.histogram(
    "lighthouse_tpu_kzg_batch_size",
    "proofs per KZG verification batch",
)
_COMMITMENTS = REGISTRY.counter(
    "lighthouse_tpu_kzg_commitments_computed_total",
    "blob -> commitment MSMs computed",
)
_MSM_SECONDS = REGISTRY.histogram_vec(
    "lighthouse_tpu_kzg_msm_seconds",
    "KZG commitment/proof MSM wall time by backend and op",
    ("backend", "op"),
)


class KzgError(Exception):
    pass


def _check_backend(backend) -> str:
    backend = backend or default_backend()
    if backend not in BACKENDS:
        raise KzgError(f"unknown KZG backend {backend!r}")
    return backend


# -------------------------------------------------------- field / blob ops


def _fr(data: bytes) -> int:
    """32 big-endian bytes -> canonical scalar; rejects >= r (the
    spec's bytes_to_bls_field validity rule)."""
    v = int.from_bytes(data, "big")
    if v >= R:
        raise KzgError("blob element is not a canonical field element")
    return v


def blob_to_polynomial(blob: bytes) -> list:
    blob = bytes(blob)
    if len(blob) == 0 or len(blob) % BYTES_PER_FIELD_ELEMENT:
        raise KzgError(
            f"blob length {len(blob)} is not a multiple of "
            f"{BYTES_PER_FIELD_ELEMENT}"
        )
    return [
        _fr(blob[i : i + BYTES_PER_FIELD_ELEMENT])
        for i in range(0, len(blob), BYTES_PER_FIELD_ELEMENT)
    ]


def evaluate_polynomial(poly: list, z: int) -> int:
    """Horner evaluation of the coefficient-form polynomial at z."""
    acc = 0
    for c in reversed(poly):
        acc = (acc * z + c) % R
    return acc


def _setup_for(poly_len: int, setup: TrustedSetup | None) -> TrustedSetup:
    s = setup or dev_setup(poly_len)
    if s.size < poly_len:
        raise KzgError(
            f"trusted setup has {s.size} powers, blob needs {poly_len}"
        )
    return s


def _g1_lincomb_naive(points_affine, scalars):
    """Pre-Pippenger reference MSM: one full double-add ladder per
    point (~255N doublings + ~128N adds). Kept as the
    oracle-of-the-oracle: tests pin `_g1_lincomb` against it."""
    acc = G1_GROUP.infinity
    for aff, s in zip(points_affine, scalars, strict=True):
        if aff is None or s % R == 0:
            continue
        acc = G1_GROUP.add(
            acc, G1_GROUP.mul_scalar(G1_GROUP.from_affine(aff), s % R)
        )
    return acc


def _pippenger_window_bits(n: int) -> int:
    """Window width minimizing the bucketed work model
    ceil(255/c) * (n point inserts + 2*2^c bucket-aggregation adds)."""
    return min(
        range(2, 16),
        key=lambda c: -(-255 // c) * (n + 2 * (1 << c)),
    )


def _g1_lincomb(points_affine, scalars):
    """Reference MSM: sum [s_i]P_i (host bigint; None = infinity).

    Windowed Pippenger: per c-bit window, each point lands in the
    bucket of its window digit (n adds), buckets aggregate by the
    double running sum (2*(2^c - 1) adds), and windows combine
    MSB-first with c doublings each — ~ceil(255/c)*(n + 2^(c+1)) group
    ops against the naive ladder's ~383n. Stays pure host bigint: this
    is the oracle the device MSMs (ops/msm.py) are verified against."""
    pts, ss = [], []
    for aff, s in zip(points_affine, scalars, strict=True):
        s %= R
        if aff is None or s == 0:
            continue
        pts.append(G1_GROUP.from_affine(aff))
        ss.append(s)
    n = len(pts)
    if n == 0:
        return G1_GROUP.infinity
    c = _pippenger_window_bits(n)
    n_windows = -(-255 // c)
    digit_mask = (1 << c) - 1
    acc = G1_GROUP.infinity
    for w in reversed(range(n_windows)):
        if w != n_windows - 1:
            for _ in range(c):
                acc = G1_GROUP.double(acc)
        buckets = [None] * (1 << c)
        for pt, s in zip(pts, ss):
            d = (s >> (c * w)) & digit_mask
            if d:
                b = buckets[d]
                buckets[d] = pt if b is None else G1_GROUP.add(b, pt)
        # window sum = sum_d d * bucket_d via the double running sum
        running = G1_GROUP.infinity
        window = G1_GROUP.infinity
        started = False
        for d in range(digit_mask, 0, -1):
            b = buckets[d]
            if b is not None:
                running = G1_GROUP.add(running, b)
                started = True
            if started:
                window = G1_GROUP.add(window, running)
        acc = G1_GROUP.add(acc, window)
    return acc


def _msm_backend(
    scalars, setup: TrustedSetup, backend: str,
    consumer: str | None = None, device="cuda",
):
    """Producer-side MSM dispatch over the setup's G1 powers — the same
    gpu|ref|fake selection surface as `verify_blob_kzg_proof_batch`.
    Returns a Jacobian point (compression happens at the caller)."""
    n = len(scalars)
    if backend == "ref":
        t0 = time.perf_counter()
        out = _g1_lincomb(setup.g1_powers[:n], scalars)
        attribution.note_batch(
            consumer, "msm", lanes=None, live=n,
            duration_s=time.perf_counter() - t0,
        )
        return out
    if backend == "gpu":
        from lighthouse_tpu_torch.kzg.gpu_backend import g1_msm_fixed_base_gpu

        # crosses GUARD.dispatch("msm", pow2_bucket(n), ...) itself; an
        # MSM yields a point, not a verdict, so a flip is a no-op there
        return g1_msm_fixed_base_gpu(
            scalars, setup, consumer=consumer, device=device
        )
    if backend == "fake":
        # fake crypto plane: commitments/proofs are structural bytes
        # only (the fake verifier accepts everything), so the identity
        # point — cheap and round-trippable — stands in
        attribution.note_batch(consumer, "msm", lanes=None, live=n)
        return G1_GROUP.infinity
    raise KzgError(f"unknown KZG backend {backend!r}")


# ----------------------------------------------------- commitment / proof


def blob_to_kzg_commitment(
    blob: bytes,
    setup: TrustedSetup | None = None,
    backend: str | None = None,
    consumer: str | None = None,
    device="cuda",
) -> bytes:
    """Commit to the blob: C = sum_i b_i [tau^i]G1, compressed. The MSM
    runs on the selected backend (gpu = fixed-base windowed device MSM on
    `device`, ref = host Pippenger oracle, fake = identity); all real
    backends produce identical bytes."""
    backend = _check_backend(backend)
    poly = blob_to_polynomial(blob)
    s = _setup_for(len(poly), setup)
    _COMMITMENTS.inc()
    with _MSM_SECONDS.labels(backend, "commit").time(), span(
        "kzg/commit_msm", n=len(poly), backend=backend
    ):
        return g1_compress(
            _msm_backend(poly, s, backend, consumer=consumer, device=device)
        )


def compute_kzg_proof(
    blob: bytes,
    z: int,
    setup: TrustedSetup | None = None,
    backend: str | None = None,
    consumer: str | None = None,
    device="cuda",
) -> tuple:
    """KZG opening proof at z: W = commit((p(X) - p(z)) / (X - z)).
    Returns (proof_bytes48, y = p(z)). The quotient MSM runs on the
    selected backend, like `blob_to_kzg_commitment`."""
    backend = _check_backend(backend)
    poly = blob_to_polynomial(blob)
    s = _setup_for(len(poly), setup)
    z %= R
    y = evaluate_polynomial(poly, z)
    # synthetic division of p(X) - y by (X - z), highest degree first
    q = [0] * (len(poly) - 1) if len(poly) > 1 else []
    carry = 0
    for i in range(len(poly) - 1, 0, -1):
        carry = (carry * z + poly[i]) % R
        q[i - 1] = carry
    with _MSM_SECONDS.labels(backend, "proof").time(), span(
        "kzg/proof_msm", n=len(q), backend=backend
    ):
        proof = g1_compress(
            _msm_backend(q, s, backend, consumer=consumer, device=device)
        )
    return proof, y


def compute_challenge(blob: bytes, commitment: bytes) -> int:
    """Fiat-Shamir evaluation point binding blob and commitment (the
    spec's compute_challenge, dev-DST flavor)."""
    h = hashlib.sha256()
    h.update(CHALLENGE_DST)
    h.update(len(bytes(blob)).to_bytes(8, "big"))
    h.update(bytes(blob))
    h.update(bytes(commitment))
    return int.from_bytes(h.digest(), "big") % R


def compute_blob_kzg_proof(
    blob: bytes,
    commitment: bytes,
    setup: TrustedSetup | None = None,
    backend: str | None = None,
    consumer: str | None = None,
    device="cuda",
) -> bytes:
    """Proof for the blob at its own Fiat-Shamir challenge point — the
    sidecar-production path (c-kzg compute_blob_kzg_proof)."""
    proof, _ = compute_kzg_proof(
        blob,
        compute_challenge(blob, commitment),
        setup,
        backend=backend,
        consumer=consumer,
        device=device,
    )
    return proof


# ------------------------------------------------------------ verification


def _decompress_checked(data: bytes, what: str):
    """Compressed G1 -> Jacobian with the full deserialization policy
    (on-curve + subgroup; infinity allowed — the zero polynomial
    commits to it)."""
    try:
        pt = g1_decompress(bytes(data))
    except DecodeError as e:
        raise KzgError(f"bad {what}: {e}") from e
    if not G1_GROUP.in_subgroup(pt):
        raise KzgError(f"{what} not in the G1 subgroup")
    return pt


def verify_kzg_proof(
    commitment: bytes,
    z: int,
    y: int,
    proof: bytes,
    setup: TrustedSetup | None = None,
) -> bool:
    """Reference single-proof check:
    e(C - [y]G1 + [z]W, G2) * e(-W, [tau]G2) == 1."""
    s = setup or dev_setup(1)
    c = _decompress_checked(commitment, "commitment")
    w = _decompress_checked(proof, "proof")
    lhs = G1_GROUP.add(
        c,
        G1_GROUP.add(
            G1_GROUP.mul_scalar(G1_GROUP.generator, (-y) % R),
            G1_GROUP.mul_scalar(w, z % R),
        ),
    )
    pairs = [
        (G1_GROUP.to_affine(lhs), G2_GROUP.to_affine(G2_GROUP.generator)),
        (G1_GROUP.to_affine(G1_GROUP.neg(w)), s.tau_g2),
    ]
    return multi_pairing_is_one(pairs)


def verify_blob_kzg_proof(
    blob: bytes,
    commitment: bytes,
    proof: bytes,
    setup: TrustedSetup | None = None,
) -> bool:
    """Single-sidecar availability check at the Fiat-Shamir point."""
    poly = blob_to_polynomial(blob)
    s = _setup_for(len(poly), setup)
    z = compute_challenge(blob, commitment)
    y = evaluate_polynomial(poly, z)
    return verify_kzg_proof(commitment, z, y, proof, s)


def _rlc_scalars(n: int, seed):
    # n == 1: with r = 1 the fold IS the plain single-proof check —
    # same verdict, none of the RLC ladder overhead. Soundness needs
    # independent scalars only to separate MULTIPLE proofs.
    if n == 1:
        return [1]
    top = 1 << RAND_BITS
    if seed is not None:
        rng = np.random.default_rng(seed)
        return [
            int(rng.integers(1, top, dtype=np.uint64)) for _ in range(n)
        ]
    return [1 + secrets.randbelow(top - 1) for _ in range(n)]


def _batch_inputs(blobs, commitments, proofs, setup, timings=None):
    """Shared host front half of both batch backends: challenges,
    evaluations, and policy-checked decompressed points. `timings`, when
    given, gains the seconds of each part: "challenge_s", "evaluate_s"
    and "decompress_s" (decompression with the subgroup checks)."""
    polys = [blob_to_polynomial(b) for b in blobs]
    s = _setup_for(max(len(p) for p in polys), setup)
    zs, ys, cs, ws = [], [], [], []
    t = {"challenge_s": 0.0, "evaluate_s": 0.0, "decompress_s": 0.0}
    for poly, blob, comm, proof in zip(
        polys, blobs, commitments, proofs, strict=True
    ):
        t0 = time.perf_counter()
        z = compute_challenge(blob, comm)
        t1 = time.perf_counter()
        zs.append(z)
        ys.append(evaluate_polynomial(poly, z))
        t2 = time.perf_counter()
        cs.append(_decompress_checked(comm, "commitment"))
        ws.append(_decompress_checked(proof, "proof"))
        t["challenge_s"] += t1 - t0
        t["evaluate_s"] += t2 - t1
        t["decompress_s"] += time.perf_counter() - t2
    if timings is not None:
        timings.update(t)
    return s, zs, ys, cs, ws


def _verify_batch_ref(blobs, commitments, proofs, setup, seed) -> bool:
    s, zs, ys, cs, ws = _batch_inputs(blobs, commitments, proofs, setup)
    rs = _rlc_scalars(len(blobs), seed)
    with span("kzg/rlc_fold", n=len(blobs)):
        lhs = G1_GROUP.infinity
        w_sum = G1_GROUP.infinity
        ry_total = 0
        for r, z, y, c, w in zip(rs, zs, ys, cs, ws, strict=True):
            lhs = G1_GROUP.add(lhs, G1_GROUP.mul_scalar(c, r))
            lhs = G1_GROUP.add(
                lhs, G1_GROUP.mul_scalar(w, r * z % R)
            )
            w_sum = G1_GROUP.add(w_sum, G1_GROUP.mul_scalar(w, r))
            ry_total = (ry_total + r * y) % R
        lhs = G1_GROUP.add(
            lhs, G1_GROUP.mul_scalar(G1_GROUP.generator, (-ry_total) % R)
        )
    pairs = [
        (G1_GROUP.to_affine(lhs), G2_GROUP.to_affine(G2_GROUP.generator)),
        (G1_GROUP.to_affine(G1_GROUP.neg(w_sum)), s.tau_g2),
    ]
    return multi_pairing_is_one(pairs)


def verify_blob_kzg_proof_batch(
    blobs,
    commitments,
    proofs,
    backend: str | None = None,
    setup: TrustedSetup | None = None,
    seed: int | None = None,
    consumer: str | None = None,
    device="cuda",
) -> bool:
    """Batch availability check: N (blob, commitment, proof) triples in
    ONE pairing-product identity (two Miller pairs total, any N).
    Soundness: each r_i is sampled independently per call, so a single
    bad proof breaks the folded identity except with probability
    ~2^-RAND_BITS. Empty batches verify (a block with no blob
    commitments is trivially available). On "gpu" the device work runs
    on `device`."""
    backend = _check_backend(backend)
    blobs = list(blobs)
    commitments = list(commitments)
    proofs = list(proofs)
    if not len(blobs) == len(commitments) == len(proofs):
        raise KzgError("batch inputs must have equal lengths")
    if not blobs:
        return True
    _BATCH_SIZE.observe(len(blobs))
    t0 = time.perf_counter()
    # slot-budget dispatch mark for EVERY backend: the fake/ref tiers
    # stand in for the device plane exactly as they do for attribution
    # (note_batch below), so the import's causal round-trip structure —
    # how many settles, and the gap to the signature fold — measures
    # the same off hardware. On the gpu branch GUARD's own crossing is
    # the nested open and is depth-suppressed; this interval owns it.
    _budget_tok = slot_budget.open_dispatch("kzg", kind="kzg")
    try:
        result = _verify_blob_batch_inner(
            blobs, commitments, proofs, backend, setup, seed, consumer,
            device,
        )
    finally:
        slot_budget.close_dispatch(_budget_tok)
    if backend != "gpu":
        attribution.note_batch(
            consumer, "kzg", lanes=None, live=len(blobs),
            duration_s=time.perf_counter() - t0,
        )
    _BATCHES.labels(backend, "ok" if result else "fail").inc()
    if result:
        _PROOFS.inc(len(blobs))
    return result


def _verify_blob_batch_inner(
    blobs, commitments, proofs, backend, setup, seed, consumer, device
) -> bool:
    with _VERIFY_SECONDS.labels(backend).time(), span(
        "kzg/verify_batch", n=len(blobs), backend=backend
    ):
        if backend == "fake":
            result = True
        elif backend == "ref":
            result = _verify_batch_ref(
                blobs, commitments, proofs, setup, seed
            )
        else:
            from lighthouse_tpu_torch.kzg.gpu_backend import (
                verify_blob_kzg_proof_batch_gpu,
            )

            # crosses GUARD.dispatch("kzg", pow2_bucket(n), ...) itself,
            # its verdict through plan.verdict; no failover
            result = verify_blob_kzg_proof_batch_gpu(
                blobs, commitments, proofs, setup=setup, seed=seed,
                consumer=consumer, device=device,
            )
    return result
