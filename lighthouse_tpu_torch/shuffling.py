"""Swap-or-not shuffle (spec `compute_shuffled_index` / whole-list form).

Covers the reference's consensus/swap_or_not_shuffle crate: both the O(n)
single-pass whole-list shuffle (shuffle_list) used to build committee
caches, and the per-index variant used in spec tests. The whole-list form
processes each of the SHUFFLE_ROUND_COUNT rounds with one pivot hash and
ceil(n/256)+1 source hashes, flipping pairs in bulk — here vectorized with
numpy instead of a scalar loop.
"""

import hashlib

import numpy as np


def _hash(data: bytes) -> bytes:
    return hashlib.sha256(data).digest()


def compute_shuffled_index(
    index: int, index_count: int, seed: bytes, rounds: int
) -> int:
    """Spec per-index forward shuffle (one validator's committee position)."""
    assert 0 <= index < index_count
    for rnd in range(rounds):
        pivot = (
            int.from_bytes(_hash(seed + bytes([rnd]))[:8], "little")
            % index_count
        )
        flip = (pivot + index_count - index) % index_count
        position = max(index, flip)
        source = _hash(
            seed + bytes([rnd]) + (position // 256).to_bytes(4, "little")
        )
        bit = (source[(position % 256) // 8] >> (position % 8)) & 1
        index = flip if bit else index
    return index


def shuffle_list(
    values: np.ndarray, seed: bytes, rounds: int, forward: bool = True
) -> np.ndarray:
    """Whole-list swap-or-not shuffle, vectorized.

    `values[new_position] = old_values[old_position]` such that element at
    position i moves to compute_shuffled_index(i). Runs rounds in reverse
    for the inverse permutation (forward=False).
    """
    n = len(values)
    if n <= 1:
        return np.asarray(values).copy()
    out = np.asarray(values).copy()
    positions = np.arange(n, dtype=np.int64)
    round_order = range(rounds) if forward else range(rounds - 1, -1, -1)
    for rnd in round_order:
        pivot = (
            int.from_bytes(_hash(seed + bytes([rnd]))[:8], "little") % n
        )
        flips = (pivot + n - positions) % n
        active = positions < flips  # process each pair once
        targets = np.maximum(positions, flips)
        # gather the per-position decision bits from block hashes
        nblocks = (n + 255) // 256
        prefix = seed + bytes([rnd])
        blocks = b"".join(
            _hash(prefix + blk.to_bytes(4, "little"))
            for blk in range(nblocks)
        )
        bits_all = np.unpackbits(
            np.frombuffer(blocks, dtype=np.uint8), bitorder="little"
        )
        swap_bits = bits_all[targets].astype(bool)
        do_swap = active & swap_bits
        src = positions[do_swap]
        dst = flips[do_swap]
        tmp = out[src].copy()
        out[src] = out[dst]
        out[dst] = tmp
    return out


def shuffled_active_indices(
    active_indices, seed: bytes, rounds: int
) -> np.ndarray:
    """Committee ordering: shuffle the active validator index list.

    Matches the spec's `compute_committee` which indexes
    `shuffled = [indices[compute_shuffled_index(i)] for i]` — i.e. the
    INVERSE whole-list permutation of `shuffle_list`.
    """
    arr = np.asarray(active_indices, dtype=np.int64)
    return shuffle_list(arr, seed, rounds, forward=False)
