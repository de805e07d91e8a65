"""Incremental deposit Merkle tree (depth 32 + length mix-in).

The port of `lighthouse_tpu/eth1/deposit_tree.py`.

Role of the reference's deposit-contract tree handling
(common/deposit_contract + beacon_node/eth1/src/deposit_cache.rs): maintain
the incremental Merkle root exactly like the on-chain deposit contract, and
produce the per-deposit branch proofs that `process_deposit` verifies
against `eth1_data.deposit_root`.
"""

from lighthouse_tpu_torch.ssz.hashing import hash_concat, zero_hash
from lighthouse_tpu_torch.types.spec import DEPOSIT_CONTRACT_TREE_DEPTH


class DepositTree:
    def __init__(self, depth: int = DEPOSIT_CONTRACT_TREE_DEPTH):
        self.depth = depth
        self.leaves: list[bytes] = []

    def push(self, leaf: bytes):
        self.leaves.append(bytes(leaf))

    def __len__(self):
        return len(self.leaves)

    def root(self) -> bytes:
        """Root over the padded depth-32 tree, with deposit count mixed in
        (the deposit contract's get_deposit_root)."""
        node = self._subtree_root(self.leaves, self.depth)
        return hash_concat(node, len(self.leaves).to_bytes(32, "little"))

    def _subtree_root(self, leaves, depth: int) -> bytes:
        if depth == 0:
            return leaves[0] if leaves else zero_hash(0)
        if not leaves:
            return zero_hash(depth)
        half = 1 << (depth - 1)
        left = self._subtree_root(leaves[:half], depth - 1)
        right = self._subtree_root(leaves[half:], depth - 1)
        return hash_concat(left, right)

    def proof(self, index: int) -> list[bytes]:
        """Merkle branch for leaf `index`: depth sibling hashes bottom-up,
        plus the length mix-in node — 33 entries total, matching the
        Deposit.proof vector the state transition verifies."""
        assert index < len(self.leaves)
        leaves = self.leaves
        lo = 0
        path = []
        for d in range(self.depth - 1, -1, -1):
            half = 1 << d
            if index < lo + half:
                path.append((lo + half, lo + 2 * half - 1, d, "right"))
            else:
                path.append((lo, lo + half - 1, d, "left"))
                lo = lo + half
        # recompute siblings bottom-up
        branch = []
        for start, end, d, side in reversed(path):
            sub = leaves[start : end + 1]
            branch.append(self._subtree_root(sub, d))
        branch.append(len(self.leaves).to_bytes(32, "little"))
        return branch
