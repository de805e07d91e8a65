"""Host-side BLS API of the port: keys, signatures, signature sets, and
`verify_signature_sets` over two backends.

The slice of `lighthouse_tpu/bls/api.py` that batch verification needs:

  "gpu" -- one multi-pairing per batch with 64-bit RLC scalars on a device
           (`bls/gpu_backend.py`): the hand-written CUDA kernels for a
           `device="cuda"` batch, their plain PyTorch versions for
           `device="cpu"`;
  "ref" -- an independent pure-Python pairing check per set (ground truth).

Policy kept from the reference client: pubkeys are validated when decoded
(on curve, not infinity, in the subgroup); signatures are subgroup-checked
at verification, once per signature through the `_subgroup_ok` memo; an
empty batch fails; an infinity or non-subgroup signature fails the batch.
"""

from __future__ import annotations

import secrets

from lighthouse_tpu_torch.bls import point_serde
from lighthouse_tpu_torch.bls.hash_to_curve import hash_to_g2
from lighthouse_tpu_torch.crypto import ref_pairing
from lighthouse_tpu_torch.crypto.constants import R
from lighthouse_tpu_torch.crypto.ref_curve import G1 as G1_GROUP
from lighthouse_tpu_torch.crypto.ref_curve import G2 as G2_GROUP


class BlsError(ValueError):
    pass


class SecretKey:
    __slots__ = ("_sk",)

    def __init__(self, scalar: int):
        if not 1 <= scalar < R:
            raise BlsError("secret key out of range")
        self._sk = scalar

    @classmethod
    def random(cls) -> "SecretKey":
        return cls(1 + secrets.randbelow(R - 1))

    def public_key(self) -> "PublicKey":
        return PublicKey(G1_GROUP.mul_scalar(G1_GROUP.generator, self._sk))

    def sign(self, message: bytes) -> "Signature":
        return Signature(G2_GROUP.mul_scalar(hash_to_g2(message), self._sk))


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
    """Single-set ground truth: e(agg_pk, H(m)) * e(-G1, sig) == 1."""
    if not signature_ok(sset.signature):
        return False
    agg_pk = G1_GROUP.infinity
    for p in sset.pubkeys:
        agg_pk = G1_GROUP.add(agg_pk, p.point)
    pairs = [
        (G1_GROUP.to_affine(agg_pk), G2_GROUP.to_affine(hash_to_g2(sset.message))),
        (
            G1_GROUP.to_affine(G1_GROUP.neg(G1_GROUP.generator)),
            G2_GROUP.to_affine(sset.signature.point),
        ),
    ]
    return ref_pairing.multi_pairing_is_one(pairs)


def verify_signature_sets(
    sets, seed: int | None = None, device: str = "cuda", backend: str = "gpu"
) -> bool:
    """Batch-verify signature sets; an empty batch fails. `seed` makes the
    RLC scalars deterministic (tests); production draws them from the OS."""
    sets = list(sets)
    if not sets:
        return False
    if backend == "ref":
        return all(_verify_one_ref(s) for s in sets)
    if backend == "gpu":
        from lighthouse_tpu_torch.bls.gpu_backend import verify_signature_sets_gpu

        return verify_signature_sets_gpu(sets, seed=seed, device=device)
    raise BlsError(f"unknown BLS backend {backend!r}")
