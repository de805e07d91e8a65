"""Signing-domain helpers (spec `compute_domain` / `compute_signing_root`).

Role of the reference's consensus/types signing machinery (`SignedRoot`
trait, `ChainSpec::get_domain`, chain_spec.rs:596 area): every signature in
the system signs `hash_tree_root(SigningData(object_root, domain))` where
the domain binds the 4-byte domain type, fork version, and genesis
validators root.
"""

from lighthouse_tpu_torch.ssz.hashing import hash_concat


def compute_fork_data_root(
    current_version: bytes, genesis_validators_root: bytes
) -> bytes:
    # ForkData container root: two 32-byte leaves
    leaf0 = current_version.ljust(32, b"\x00")
    return hash_concat(leaf0, genesis_validators_root)


def compute_fork_digest(
    current_version: bytes, genesis_validators_root: bytes
) -> bytes:
    return compute_fork_data_root(current_version, genesis_validators_root)[:4]


def compute_domain(
    domain_type: bytes,
    fork_version: bytes,
    genesis_validators_root: bytes,
) -> bytes:
    fork_data_root = compute_fork_data_root(
        fork_version, genesis_validators_root
    )
    return domain_type + fork_data_root[:28]


def compute_signing_root(object_root: bytes, domain: bytes) -> bytes:
    """hash_tree_root(SigningData): container of two bytes32 leaves."""
    return hash_concat(object_root, domain)


def state_anchor_block_root(state) -> bytes:
    """The block root a state commits to: its latest_block_header with
    the state_root filled in (zero inside a state that is the header's
    own post-state). Shared by the chain's genesis/anchor rooting and
    the checkpoint-sync client's block lookup."""
    from lighthouse_tpu_torch.ssz.cached_hash import cached_state_root
    from lighthouse_tpu_torch.ssz.hashing import ZERO_BYTES32

    header = state.latest_block_header
    if bytes(header.state_root) == ZERO_BYTES32:
        header = header.copy()
        header.state_root = cached_state_root(state)
    return type(header).hash_tree_root(header)
