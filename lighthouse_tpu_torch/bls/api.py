"""Host-side BLS API of the port: keys, signatures, aggregation, signature
sets, and the batch boundary over three backends.

The port of `lighthouse_tpu/bls/api.py`, with the same names, metrics,
spans, consumer attribution and journal events:

  "gpu"  -- one multi-pairing per batch with 64-bit RLC scalars on a device
            (`bls/gpu_backend.py`): the hand-written CUDA kernels for a
            `device="cuda"` batch, their plain PyTorch versions for
            `device="cpu"`; the default (`default_backend()`);
  "ref"  -- an independent pure-Python pairing check per set (ground truth);
  "fake" -- always valid (spec tests).

The single-signature functions (`verify`, `fast_aggregate_verify`,
`eth_fast_aggregate_verify`, `aggregate_verify`) run on the host, as the
reference's do. `verify_signature_sets_individually` gives one verdict per
set, the fallback after a failed batch: one more device call on "gpu".
`verify_signature_set_batches` streams several batches through the card,
marshalling batch N+1 while batch N runs.

Policy kept from the reference client: pubkeys are validated when decoded
(on curve, not infinity, in the subgroup); signatures are subgroup-checked
at verification, once per signature through the `_subgroup_ok` memo (which
`gpu_backend.check_signature_subgroups` fills for a whole list on the
card); an empty batch fails; an infinity or non-subgroup signature fails
the batch.
"""

from __future__ import annotations

import hashlib
import secrets
import time

from lighthouse_tpu_torch.bls import point_serde
from lighthouse_tpu_torch.bls.hash_to_curve import hash_to_g2
from lighthouse_tpu_torch.common import device_attribution as attribution
from lighthouse_tpu_torch.common.metrics import REGISTRY
from lighthouse_tpu_torch.common.tracing import span
from lighthouse_tpu_torch.crypto import ref_pairing
from lighthouse_tpu_torch.crypto.constants import R
from lighthouse_tpu_torch.crypto.ref_curve import G1 as G1_GROUP
from lighthouse_tpu_torch.crypto.ref_curve import G2 as G2_GROUP

_VERIFY_BATCHES = REGISTRY.counter_vec(
    "lighthouse_tpu_verify_batches_total",
    "verify_signature_sets batches by backend and verdict",
    ("backend", "result"),
)
_VERIFY_SETS = REGISTRY.counter(
    "lighthouse_tpu_verify_sets_total",
    "signature sets entering verify_signature_sets",
)
_VERIFY_BATCH_SECONDS = REGISTRY.histogram(
    "lighthouse_tpu_verify_batch_seconds",
    "end-to-end wall time of one verify_signature_sets batch",
)
_VERIFY_BATCH_SIZE = REGISTRY.histogram(
    "lighthouse_tpu_verify_batch_size",
    "signature sets per verify_signature_sets batch",
    buckets=(1, 4, 16, 64, 256, 1024, 4096, 16384, 65536),
)

INFINITY_PUBKEY_BYTES = bytes([0xC0]) + b"\x00" * 47
INFINITY_SIGNATURE_BYTES = bytes([0xC0]) + b"\x00" * 95

BACKENDS = ("gpu", "ref", "fake")


def default_backend() -> str:
    """The backend a call without `backend=` takes: the card."""
    return "gpu"


class BlsError(ValueError):
    pass


# ------------------------------------------------------------------ secrets


class SecretKey:
    __slots__ = ("_sk",)

    def __init__(self, scalar: int):
        if not 1 <= scalar < R:
            raise BlsError("secret key out of range")
        self._sk = scalar

    @classmethod
    def from_bytes(cls, data: bytes) -> "SecretKey":
        if len(data) != 32:
            raise BlsError("secret key: expected 32 bytes")
        return cls(int.from_bytes(data, "big"))

    @classmethod
    def random(cls) -> "SecretKey":
        return cls(1 + secrets.randbelow(R - 1))

    def to_bytes(self) -> bytes:
        return self._sk.to_bytes(32, "big")

    def public_key(self) -> "PublicKey":
        return PublicKey(G1_GROUP.mul_scalar(G1_GROUP.generator, self._sk))

    def sign(self, message: bytes) -> "Signature":
        return Signature(G2_GROUP.mul_scalar(hash_to_g2(message), self._sk))


class Keypair:
    __slots__ = ("sk", "pk")

    def __init__(self, sk: SecretKey):
        self.sk = sk
        self.pk = sk.public_key()


def interop_keypairs(n: int) -> list[Keypair]:
    """Deterministic interop keypairs: sk_i = int(sha256(le32(i + 1))) mod r,
    1 where that is 0."""
    out = []
    for i in range(n):
        digest = hashlib.sha256((i + 1).to_bytes(32, "little")).digest()
        sk = int.from_bytes(digest, "little") % R
        out.append(Keypair(SecretKey(sk if sk else 1)))
    return out


# ------------------------------------------------------------------- points


class PublicKey:
    """Validated G1 point (never infinity, always in the subgroup).

    `validator_index`/`table` are set when the key is registered in a
    `DevicePubkeyTable`, so the gpu backend ships table rows instead of
    points."""

    __slots__ = ("point", "_bytes", "validator_index", "table")

    def __init__(self, point_jacobian, compressed: bytes | None = None):
        self.point = point_jacobian
        self._bytes = compressed
        self.validator_index = None
        self.table = None

    @classmethod
    def from_bytes(cls, data: bytes) -> "PublicKey":
        pt = point_serde.g1_decompress(bytes(data))
        if G1_GROUP.is_infinity(pt):
            raise BlsError("pubkey: point at infinity rejected")
        if not G1_GROUP.in_subgroup(pt):
            raise BlsError("pubkey: not in subgroup")
        return cls(pt, bytes(data))

    def to_bytes(self) -> bytes:
        if self._bytes is None:
            self._bytes = point_serde.g1_compress(self.point)
        return self._bytes

    def __eq__(self, other):
        return isinstance(other, PublicKey) and self.to_bytes() == other.to_bytes()

    def __hash__(self):
        return hash(self.to_bytes())


class Signature:
    """G2 point; subgroup-checked at verification, the result memoized."""

    __slots__ = ("point", "_bytes", "_subgroup_ok")

    def __init__(self, point_jacobian, compressed: bytes | None = None):
        self.point = point_jacobian
        self._bytes = compressed
        self._subgroup_ok = None

    @classmethod
    def from_bytes(cls, data: bytes) -> "Signature":
        return cls(point_serde.g2_decompress(bytes(data)), bytes(data))

    def to_bytes(self) -> bytes:
        if self._bytes is None:
            self._bytes = point_serde.g2_compress(self.point)
        return self._bytes

    def is_infinity(self) -> bool:
        return G2_GROUP.is_infinity(self.point)

    def in_subgroup(self) -> bool:
        if self._subgroup_ok is None:
            self._subgroup_ok = G2_GROUP.in_subgroup(self.point)
        return self._subgroup_ok

    def __eq__(self, other):
        return isinstance(other, Signature) and self.to_bytes() == other.to_bytes()


def aggregate_signatures(sigs) -> Signature:
    sigs = list(sigs)
    if not sigs:
        # the spec's Aggregate() needs n >= 1
        raise BlsError("aggregate of zero signatures")
    acc = G2_GROUP.infinity
    for s in sigs:
        acc = G2_GROUP.add(acc, s.point)
    return Signature(acc)


def aggregate_public_keys(pubkeys) -> PublicKey:
    if not pubkeys:
        raise BlsError("aggregate of zero pubkeys")
    acc = G1_GROUP.infinity
    for p in pubkeys:
        acc = G1_GROUP.add(acc, p.point)
    return PublicKey(acc)


def aggregate_pubkeys_bytes(pubkey_bytes_list) -> bytes:
    """Aggregate compressed pubkeys -> compressed aggregate (the infinity
    encoding if the keys cancel; sync committee aggregates)."""
    acc = G1_GROUP.infinity
    for data in pubkey_bytes_list:
        acc = G1_GROUP.add(acc, point_serde.g1_decompress(bytes(data)))
    return point_serde.g1_compress(acc)


# --------------------------------------------------------------- signature sets


class SignatureSet:
    """A signature over a message by one or more pubkeys (aggregated)."""

    __slots__ = ("signature", "pubkeys", "message")

    def __init__(self, signature: Signature, pubkeys, message: bytes):
        if not pubkeys:
            raise BlsError("signature set with no pubkeys")
        self.signature = signature
        self.pubkeys = list(pubkeys)
        self.message = bytes(message)


def signature_ok(sig: Signature) -> bool:
    """The verification-time signature policy: not infinity, in G2."""
    return not sig.is_infinity() and sig.in_subgroup()


def _verify_one_ref(sset: SignatureSet) -> bool:
    """Single-set ground truth, e(agg_pk, H(m)) * e(-G1, sig) == 1, each
    stage a leaf span (`lighthouse_tpu_verify_stage_seconds{stage=...}`)."""
    with span("verify/subgroup_check"):
        bad = not signature_ok(sset.signature)
    if bad:
        return False
    with span("verify/pubkey_aggregation", n_keys=len(sset.pubkeys)):
        agg_pk = G1_GROUP.infinity
        for p in sset.pubkeys:
            agg_pk = G1_GROUP.add(agg_pk, p.point)
    with span("verify/hash_to_curve"):
        h = hash_to_g2(sset.message)
    with span("verify/to_affine"):
        pairs = [
            (G1_GROUP.to_affine(p), G2_GROUP.to_affine(q))
            for p, q in ((agg_pk, h), (G1_GROUP.neg(G1_GROUP.generator), sset.signature.point))
        ]
    # multi_pairing_is_one carries the verify/miller_loop and
    # verify/final_exp spans itself
    return ref_pairing.multi_pairing_is_one(pairs)


def verify(pk: PublicKey, message: bytes, sig: Signature) -> bool:
    return _verify_one_ref(SignatureSet(sig, [pk], message))


def fast_aggregate_verify(pubkeys, message: bytes, sig: Signature) -> bool:
    if not pubkeys:
        return False
    return _verify_one_ref(SignatureSet(sig, pubkeys, message))


def eth_fast_aggregate_verify(pubkeys, message: bytes, sig: Signature) -> bool:
    """Ethereum's variant: the infinity signature over zero pubkeys is valid
    (empty sync aggregates)."""
    if not pubkeys and sig.to_bytes() == INFINITY_SIGNATURE_BYTES:
        return True
    return fast_aggregate_verify(pubkeys, message, sig)


def aggregate_verify(pubkeys, messages, sig: Signature) -> bool:
    """Distinct-message aggregate verification."""
    if not pubkeys or len(pubkeys) != len(messages):
        return False
    if not signature_ok(sig):
        return False
    g1s = [p.point for p in pubkeys] + [G1_GROUP.neg(G1_GROUP.generator)]
    g2s = [hash_to_g2(m) for m in messages] + [sig.point]
    return ref_pairing.pairing_check_points(g1s, g2s)


# ----------------------------------------------------------- batch dispatch


def _check_backend(backend) -> str:
    backend = backend or default_backend()
    if backend not in BACKENDS:
        raise BlsError(f"unknown BLS backend {backend!r}")
    return backend


def _journal_batch(journal, consumer, ok, n_sets, backend, slot, extra=None, individual=False):
    """One `signature_batch` journal event per dispatched batch, with the
    consumer label and, when the gpu backend marshalled it on this thread,
    the batch's lanes and padding. The thread's pending batch records are
    drained even without a journal, so the window stays one call wide."""
    records = attribution.take_batches()
    if journal is None:
        return
    attrs = {"consumer": consumer, "n_sets": n_sets, "backend": backend}
    if individual:
        attrs["individual"] = True
    if len(records) == 1 and records[0].get("lanes") is not None:
        r = records[0]
        attrs["lanes"] = r["lanes"]
        attrs["waste"] = r.get("waste", 0)
        attrs["amortized_fixed_ms"] = r.get("amortized_fixed_ms")
    if extra:
        attrs.update(extra)
    journal.emit("signature_batch", slot=slot, outcome="ok" if ok else "failed", **attrs)


def verify_signature_sets(
    sets,
    seed: int | None = None,
    device: str = "cuda",
    backend: str | None = None,
    ladder: str = "window",
    consumer: str | None = None,
    journal=None,
    slot: int | None = None,
    journal_attrs: dict | None = None,
) -> bool:
    """Batch-verify signature sets; an empty batch fails. `seed` makes the
    RLC scalars deterministic (tests); production draws them from the OS.
    `ladder` picks K1's body on "gpu" ("window", "chain" or "w2"), which
    leaves the verdict as it is. `consumer` names who pays the batch
    (`device_attribution.CONSUMERS`); `journal` records it as one
    `signature_batch` event, with `slot` and `journal_attrs`."""
    sets = list(sets)
    if not sets:
        return False
    backend = _check_backend(backend)
    consumer = attribution.note_sets(consumer, len(sets))
    _VERIFY_SETS.inc(len(sets))
    _VERIFY_BATCH_SIZE.observe(len(sets))
    attribution.begin_batch_window()
    t0 = time.perf_counter()
    with _VERIFY_BATCH_SECONDS.time(), span("verify", n_sets=len(sets), backend=backend):
        if backend == "fake":
            result = True
        elif backend == "ref":
            result = all(_verify_one_ref(s) for s in sets)
        else:
            from lighthouse_tpu_torch.bls.gpu_backend import verify_signature_sets_gpu

            result = verify_signature_sets_gpu(
                sets, seed=seed, device=device, ladder=ladder, consumer=consumer
            )
    if backend != "gpu":
        # host backends have no lane padding; the batch still counts
        attribution.note_batch(
            consumer, "bls", lanes=None, live=len(sets), duration_s=time.perf_counter() - t0
        )
    _VERIFY_BATCHES.labels(backend, "ok" if result else "fail").inc()
    _journal_batch(journal, consumer, result, len(sets), backend, slot, extra=journal_attrs)
    return result


def verify_signature_sets_shared(
    submissions,
    seed: int | None = None,
    device: str = "cuda",
    backend: str | None = None,
    ladder: str = "window",
    extra_sets=None,
) -> tuple:
    """ONE dispatch spanning several consumers' sets. `submissions` is a
    list of (sets, consumer) pairs; the whole collection is one batch (one
    device multi-pairing on "gpu") while the attribution fans out per
    consumer: `device_sets_total` counts each contributor's own sets, and
    the batch economics (participation, proportional device seconds and
    waste, the shared amortized fixed cost) go through
    `device_attribution.begin_shared_window`.

    `extra_sets` are attribution-free riders: they join the dispatch but
    are counted nowhere (no `note_sets`, no contribution), and a batch that
    is empty apart from riders is empty.

    Returns `(ok, record)`, `record` the batch-economics dict (lanes, waste
    and amortized_fixed_ms when the gpu marshal ran) or None. No journal
    event: the caller emits one per submission."""
    contribs = []
    flat = []
    for sets, consumer in submissions:
        sets = list(sets)
        if not sets:
            continue
        consumer = attribution.note_sets(consumer, len(sets))
        contribs.append((consumer, len(sets)))
        flat.extend(sets)
    if not flat:
        return False, None
    if extra_sets:
        flat = flat + list(extra_sets)
    backend = _check_backend(backend)
    # the largest contributor labels the backend call; the shared window
    # redistributes the accounting over every contributor
    primary = max(contribs, key=lambda cn: cn[1])[0]
    _VERIFY_SETS.inc(len(flat))
    _VERIFY_BATCH_SIZE.observe(len(flat))
    attribution.begin_shared_window(contribs)
    t0 = time.perf_counter()
    try:
        with _VERIFY_BATCH_SECONDS.time(), span(
            "verify", n_sets=len(flat), backend=backend, n_consumers=len(contribs)
        ):
            if backend == "fake":
                result = True
            elif backend == "ref":
                result = all(_verify_one_ref(s) for s in flat)
            else:
                from lighthouse_tpu_torch.bls.gpu_backend import verify_signature_sets_gpu

                result = verify_signature_sets_gpu(
                    flat, seed=seed, device=device, ladder=ladder, consumer=primary
                )
        if backend != "gpu":
            attribution.note_batch(
                primary, "bls", lanes=None, live=len(flat), duration_s=time.perf_counter() - t0
            )
    finally:
        # a raising dispatch must not leave the shared window open on this
        # thread (the next batch would fan out over it)
        records = attribution.take_batches()
    _VERIFY_BATCHES.labels(backend, "ok" if result else "fail").inc()
    record = records[0] if records else None
    if record is not None:
        record.setdefault("duration_s", time.perf_counter() - t0)
    return result, record


def verify_signature_set_batches(
    batches,
    seed: int | None = None,
    device: str = "cuda",
    backend: str | None = None,
    ladder: str = "window",
    consumer: str | None = None,
    journal=None,
    slot: int | None = None,
) -> list:
    """One verdict per batch, empty batches False. On "gpu" the batches
    stream: batch N+1 is marshalled and launched while batch N runs on the
    card, and N's verdict is read only then; batch i takes seed `seed + i`.
    The other backends verify the batches one by one."""
    batches = [list(b) for b in batches]
    backend = _check_backend(backend)
    if backend != "gpu":
        return [
            verify_signature_sets(
                b, seed=seed, backend=backend, consumer=consumer, journal=journal, slot=slot
            )
            if b
            else False
            for b in batches
        ]
    from lighthouse_tpu_torch.bls.gpu_backend import verify_signature_set_batches_gpu

    consumer = attribution.normalize(consumer)
    attribution.begin_batch_window()
    results = verify_signature_set_batches_gpu(
        batches, seed=seed, device=device, ladder=ladder, consumer=consumer
    )
    attribution.take_batches()  # the economics live in the registry
    for b, ok in zip(batches, results):
        if not b:
            continue
        attribution.note_sets(consumer, len(b))
        if journal is not None:
            journal.emit(
                "signature_batch",
                slot=slot,
                outcome="ok" if ok else "failed",
                consumer=consumer,
                n_sets=len(b),
                backend=backend,
                streamed=True,
            )
    return results


def verify_signature_sets_individually(
    sets,
    device: str = "cuda",
    backend: str | None = None,
    consumer: str | None = None,
    journal=None,
    slot: int | None = None,
) -> list:
    """Per-set verdicts, to find the bad sets of a failed batch: on "gpu"
    one device call for the whole list (a failed batch plus this call is two
    calls), on "ref" the per-set host check. Empty input -> []."""
    sets = list(sets)
    if not sets:
        return []
    backend = _check_backend(backend)
    consumer = attribution.note_sets(consumer, len(sets))
    attribution.begin_batch_window()
    t0 = time.perf_counter()
    if backend == "fake":
        out = [True] * len(sets)
    elif backend == "ref":
        out = [_verify_one_ref(s) for s in sets]
    else:
        from lighthouse_tpu_torch.bls.gpu_backend import verify_signature_sets_gpu_individual

        out = verify_signature_sets_gpu_individual(sets, device=device, consumer=consumer)
    if backend != "gpu":
        attribution.note_batch(
            consumer, "bls", lanes=None, live=len(sets), duration_s=time.perf_counter() - t0
        )
    _journal_batch(journal, consumer, all(out), len(sets), backend, slot, individual=True)
    return out
