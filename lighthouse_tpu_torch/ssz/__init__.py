"""SimpleSerialize (SSZ) codec + Merkleization.

Covers the capability surface of the reference's in-house SSZ stack —
consensus/ssz (Encode/Decode), consensus/ssz_types (typed fixed/variable
lists, bitfields), consensus/ssz_derive (derive macros -> here, a Container
base class with declarative field specs), consensus/tree_hash (hash_tree_root
merkleization with zero-subtree cache) — re-designed as Python type
descriptors rather than a trait system.

Wire format per the SSZ spec: little-endian basics, 4-byte offsets for
variable-size parts, bitlists with a delimiting bit, lists merkleized to
their capacity limit with the length mixed in.
"""

from lighthouse_tpu_torch.ssz.codec import (  # noqa: F401
    Bitlist,
    Bitvector,
    Boolean,
    ByteList,
    ByteVector,
    Container,
    List,
    Union,
    Vector,
    boolean,
    byte,
    bytes4,
    bytes20,
    bytes32,
    bytes48,
    bytes96,
    uint8,
    uint16,
    uint32,
    uint64,
    uint128,
    uint256,
)
from lighthouse_tpu_torch.ssz.gindex import (  # noqa: F401
    compute_merkle_proof,
    compute_multiproof,
    concat_gindices,
    floorlog2,
    gindex_for_path,
    get_helper_indices,
    state_field_chunks,
    verify_gindex_branch,
    verify_multiproof,
)
from lighthouse_tpu_torch.ssz.hashing import hash32, zero_hash  # noqa: F401
from lighthouse_tpu_torch.ssz.merkle import (  # noqa: F401
    merkle_proof,
    merkleize_chunks,
    mix_in_length,
    verify_merkle_proof,
)
