"""Column custody + subnet assignment.

A copy of `lighthouse_tpu/da/custody.py` (host Python; the port keeps its
own). Columns shard onto DATA_COLUMN_SIDECAR_SUBNET_COUNT gossip subnets
by index modulus. Every node deterministically custodies
CUSTODY_REQUIREMENT subnets derived from its node id -- the hash-chain
construction of the spec's get_custody_groups, minus the uint256 node
ids: samplers can recompute any peer's custody set from its id alone,
nothing is negotiated. The node's wiring (gossip topics, the store, the
health endpoint) is not part of the port yet.
"""

import hashlib


def compute_subnet_for_column(index: int, spec) -> int:
    """Column index -> gossip subnet id."""
    return index % spec.DATA_COLUMN_SIDECAR_SUBNET_COUNT


def custody_subnets(node_id: str, spec) -> tuple:
    """Deterministic CUSTODY_REQUIREMENT distinct subnets for a node:
    walk sha256(node_id || counter) and keep fresh subnet draws until
    enough are collected (terminates: counter is unbounded, draws are
    uniform over a finite set)."""
    want = min(spec.CUSTODY_REQUIREMENT, spec.DATA_COLUMN_SIDECAR_SUBNET_COUNT)
    chosen: list = []
    counter = 0
    while len(chosen) < want:
        digest = hashlib.sha256(
            b"lighthouse-tpu-custody:"
            + str(node_id).encode()
            + counter.to_bytes(8, "little")
        ).digest()
        subnet = int.from_bytes(digest[:8], "little") % (
            spec.DATA_COLUMN_SIDECAR_SUBNET_COUNT
        )
        if subnet not in chosen:
            chosen.append(subnet)
        counter += 1
    return tuple(sorted(chosen))


def custody_columns(node_id: str, spec) -> tuple:
    """All column indices a node custodies: the columns of its custody
    subnets."""
    subnets = set(custody_subnets(node_id, spec))
    return tuple(
        index
        for index in range(spec.NUMBER_OF_COLUMNS)
        if compute_subnet_for_column(index, spec) in subnets
    )
