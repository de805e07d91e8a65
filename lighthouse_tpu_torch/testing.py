"""Signature-set generators for the port's tests and its chip smoke run.

Large batches use the chained-addition form of `lighthouse_tpu/testing.py`
(`fast_sequential`): secret keys are small consecutive integers and every
point is the previous one plus a base point, so a batch costs one host
point addition per key or signature instead of a 255-bit scalar
multiplication.
"""

import hashlib

import numpy as np

from lighthouse_tpu_torch.bls.api import PublicKey, Signature, SignatureSet
from lighthouse_tpu_torch.bls.gpu_backend import _msg_affine
from lighthouse_tpu_torch.crypto.ref_curve import G1 as RG1
from lighthouse_tpu_torch.crypto.ref_curve import G2 as RG2


def validator_pubkeys(n: int) -> list:
    """PublicKeys of validators 0..n-1, validator i with secret key i + 1."""
    out, acc = [], RG1.infinity
    for _ in range(n):
        acc = RG1.add(acc, RG1.generator)
        out.append(PublicKey(acc))
    return out


def message(tag: str, i: int, seed: int) -> bytes:
    return hashlib.sha256(f"{tag}/{seed}/{i}".encode()).digest()


def _h(msg: bytes):
    """H(msg) as a Jacobian point (through the backend's message memo)."""
    return RG2.from_affine(_msg_affine(msg))


def committee_sets(pubkeys, n_groups: int, per_group: int, seed: int = 0) -> list:
    """One message per committee g, signed by validators g*per_group ..
    (g+1)*per_group - 1 (secret key = index + 1), one single-key set each:
    the gossip attestation shape."""
    sets = []
    for g in range(n_groups):
        msg = message("committee", g, seed)
        h = _h(msg)
        first = g * per_group
        sig = RG2.mul_scalar(h, first + 1)
        for v in range(first, first + per_group):
            sets.append(SignatureSet(Signature(sig), [pubkeys[v]], msg))
            sig = RG2.add(sig, h)
    return sets


def flat_sets(pubkeys, n_sets: int, max_keys: int = 4, seed: int = 0) -> list:
    """n_sets sets with distinct messages and 1..max_keys keys each, drawn
    from `pubkeys` (untagged copies, so the batch takes the point path)."""
    rng = np.random.default_rng(seed)
    sets = []
    for i in range(n_sets):
        k = int(rng.integers(1, max_keys + 1))
        idx = [int(v) for v in rng.choice(len(pubkeys), size=k, replace=False)]
        msg = message("flat", i, seed)
        sig = RG2.mul_scalar(_h(msg), sum(v + 1 for v in idx))
        keys = [PublicKey(pubkeys[v].point) for v in idx]
        sets.append(SignatureSet(Signature(sig), keys, msg))
    return sets


def forge(sets, i: int) -> list:
    """A copy of `sets` whose set i carries its signature plus H(m): invalid
    for its keys whatever they are."""
    s = sets[i]
    bad = SignatureSet(Signature(RG2.add(s.signature.point, _h(s.message))), s.pubkeys, s.message)
    return sets[:i] + [bad] + sets[i + 1 :]
