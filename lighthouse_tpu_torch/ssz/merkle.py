"""Merkleization: chunk trees, length mix-in, and Merkle branch proofs.

Covers the reference's consensus/tree_hash (merkleize with padding to the
next power of two, zero-subtree shortcuts) and consensus/merkle_proof
(branch verification). The virtual-padding trick — never materializing zero
subtrees — is the same idea as the reference's zero-hash cache.
"""

from lighthouse_tpu_torch.ssz.hashing import hash_concat, zero_hash


def _next_pow2(n: int) -> int:
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


def merkleize_chunks(chunks, limit: int | None = None) -> bytes:
    """Merkle root of 32-byte chunks, virtually padded with zero chunks to
    `limit` (or to the next power of two of len(chunks))."""
    count = len(chunks)
    if limit is None:
        limit = _next_pow2(count)
    else:
        if count > limit:
            raise ValueError(f"{count} chunks exceeds limit {limit}")
        limit = _next_pow2(limit)
    depth = (limit - 1).bit_length() if limit > 1 else 0

    if count == 0:
        return zero_hash(depth)

    from lighthouse_tpu_torch.native.hashtree import hash_pairs

    layer = list(chunks)
    for d in range(depth):
        if len(layer) % 2:
            layer.append(zero_hash(d))
        digests = hash_pairs(b"".join(layer))
        layer = [
            digests[i : i + 32] for i in range(0, len(digests), 32)
        ]
    return layer[0]


def mix_in_length(root: bytes, length: int) -> bytes:
    return hash_concat(root, length.to_bytes(32, "little"))


def mix_in_selector(root: bytes, selector: int) -> bytes:
    return hash_concat(root, selector.to_bytes(32, "little"))


# ------------------------------------------------------------- merkle proofs


def merkle_proof(chunks, index: int, limit: int | None = None):
    """Branch (bottom-up sibling hashes) proving chunks[index] against the
    merkleize_chunks root."""
    count = len(chunks)
    if limit is None:
        limit = _next_pow2(count)
    else:
        limit = _next_pow2(limit)
    depth = (limit - 1).bit_length() if limit > 1 else 0

    proof = []
    layer = list(chunks)
    idx = index
    for d in range(depth):
        sibling = idx ^ 1
        if sibling < len(layer):
            proof.append(layer[sibling])
        else:
            proof.append(zero_hash(d))
        nxt = []
        for i in range(0, len(layer), 2):
            left = layer[i]
            right = layer[i + 1] if i + 1 < len(layer) else zero_hash(d)
            nxt.append(hash_concat(left, right))
        layer = nxt
        idx >>= 1
    return proof


def verify_merkle_proof(
    leaf: bytes, proof, index: int, root: bytes
) -> bool:
    node = leaf
    idx = index
    for sibling in proof:
        if idx & 1:
            node = hash_concat(sibling, node)
        else:
            node = hash_concat(node, sibling)
        idx >>= 1
    return node == root
