"""SHA-256 hashing for Merkleization, with the zero-subtree cache.

Role of the reference's crypto/eth2_hashing (runtime-dispatched SHA-256) and
the ZERO_HASHES cache. Python's hashlib uses OpenSSL's assembly SHA-NI path,
which serves the same purpose; a batched device/C++ path can slot in behind
`hash32_many` later without changing callers.
"""

import hashlib

ZERO_BYTES32 = b"\x00" * 32


def hash32(data: bytes) -> bytes:
    return hashlib.sha256(data).digest()


def hash_concat(a: bytes, b: bytes) -> bytes:
    return hashlib.sha256(a + b).digest()


def hash32_many(pairs):
    """Hash a list of 64-byte inputs -> list of 32-byte digests.

    Routed through the native batch hasher when built
    (lighthouse_tpu_torch/native/hashtree.c), hashlib otherwise.
    """
    from lighthouse_tpu_torch.native.hashtree import hash_pairs

    out = hash_pairs(b"".join(pairs))
    return [out[i : i + 32] for i in range(0, len(out), 32)]


# zero_hash(0) = 32 zero bytes; zero_hash(i) = H(zero_hash(i-1) * 2)
_ZERO_HASHES = [ZERO_BYTES32]


def zero_hash(depth: int) -> bytes:
    while len(_ZERO_HASHES) <= depth:
        prev = _ZERO_HASHES[-1]
        _ZERO_HASHES.append(hash_concat(prev, prev))
    return _ZERO_HASHES[depth]
