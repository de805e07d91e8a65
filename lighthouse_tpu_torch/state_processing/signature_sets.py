"""SignatureSet constructors for every signed consensus object.

The port of `lighthouse_tpu/state_processing/signature_sets.py`, over the
port's `bls`. Role of consensus/state_processing/src/per_block_processing/signature_sets.rs
(block_proposal_signature_set:74, randao_signature_set,
indexed_attestation_signature_set:235, proposer/attester slashing sets,
deposit, exit, sync_aggregate_signature_set:563): each function turns a
consensus object + state context into a `bls.SignatureSet` whose message is
the domain-bound signing root. The batch verifier then feeds all sets to
`bls.verify_signature_sets` in one device call; keys from a `PubkeyCache`
are table rows on the card.

Pubkeys are resolved through a caller-provided `pubkey_for(index)` (the
validator-pubkey-cache analog) so decompression happens once per validator.
"""

from lighthouse_tpu_torch import bls
from lighthouse_tpu_torch.state_processing.helpers import (
    get_domain,
)
from lighthouse_tpu_torch.types.helpers import compute_domain, compute_signing_root
from lighthouse_tpu_torch.types.spec import Spec
from lighthouse_tpu_torch import ssz


class SignatureSetError(ValueError):
    pass


def _signing_root(obj, domain: bytes) -> bytes:
    return compute_signing_root(type(obj).hash_tree_root(obj), domain)


def block_proposal_set(
    state, signed_block, pubkey_for, spec: Spec
) -> bls.SignatureSet:
    block = signed_block.message
    domain = get_domain(
        state,
        spec.DOMAIN_BEACON_PROPOSER,
        spec.slot_to_epoch(block.slot),
        spec,
    )
    return bls.SignatureSet(
        bls.Signature.from_bytes(signed_block.signature),
        [pubkey_for(block.proposer_index)],
        _signing_root(block, domain),
    )


def randao_set(state, block, pubkey_for, spec: Spec) -> bls.SignatureSet:
    epoch = spec.slot_to_epoch(block.slot)
    domain = get_domain(state, spec.DOMAIN_RANDAO, epoch, spec)
    return bls.SignatureSet(
        bls.Signature.from_bytes(block.body.randao_reveal),
        [pubkey_for(block.proposer_index)],
        compute_signing_root(
            ssz.uint64.hash_tree_root(epoch), domain
        ),
    )


def block_header_set(
    state, signed_header, pubkey_for, spec: Spec
) -> bls.SignatureSet:
    header = signed_header.message
    domain = get_domain(
        state,
        spec.DOMAIN_BEACON_PROPOSER,
        spec.slot_to_epoch(header.slot),
        spec,
    )
    return bls.SignatureSet(
        bls.Signature.from_bytes(signed_header.signature),
        [pubkey_for(header.proposer_index)],
        _signing_root(header, domain),
    )


def proposer_slashing_sets(state, slashing, pubkey_for, spec: Spec):
    return [
        block_header_set(state, slashing.signed_header_1, pubkey_for, spec),
        block_header_set(state, slashing.signed_header_2, pubkey_for, spec),
    ]


def indexed_attestation_set(
    state, indexed, pubkey_for, spec: Spec
) -> bls.SignatureSet:
    domain = get_domain(
        state, spec.DOMAIN_BEACON_ATTESTER, indexed.data.target.epoch, spec
    )
    pubkeys = [pubkey_for(i) for i in indexed.attesting_indices]
    if not pubkeys:
        raise SignatureSetError("indexed attestation with no indices")
    return bls.SignatureSet(
        bls.Signature.from_bytes(indexed.signature),
        pubkeys,
        _signing_root(indexed.data, domain),
    )


def attester_slashing_sets(state, slashing, pubkey_for, spec: Spec):
    return [
        indexed_attestation_set(
            state, slashing.attestation_1, pubkey_for, spec
        ),
        indexed_attestation_set(
            state, slashing.attestation_2, pubkey_for, spec
        ),
    ]


def deposit_set(deposit_data, spec: Spec) -> bls.SignatureSet:
    """Deposit signatures bind only the genesis fork version and an empty
    validators root (they predate the chain)."""
    from lighthouse_tpu_torch.types.containers import types_for

    t = types_for(spec)
    msg = t.DepositMessage(
        pubkey=deposit_data.pubkey,
        withdrawal_credentials=deposit_data.withdrawal_credentials,
        amount=deposit_data.amount,
    )
    domain = compute_domain(
        spec.DOMAIN_DEPOSIT, spec.GENESIS_FORK_VERSION, b"\x00" * 32
    )
    return bls.SignatureSet(
        bls.Signature.from_bytes(deposit_data.signature),
        [bls.PublicKey.from_bytes(deposit_data.pubkey)],
        _signing_root(msg, domain),
    )


def voluntary_exit_set(
    state, signed_exit, pubkey_for, spec: Spec
) -> bls.SignatureSet:
    exit_msg = signed_exit.message
    domain = get_domain(
        state, spec.DOMAIN_VOLUNTARY_EXIT, exit_msg.epoch, spec
    )
    return bls.SignatureSet(
        bls.Signature.from_bytes(signed_exit.signature),
        [pubkey_for(exit_msg.validator_index)],
        _signing_root(exit_msg, domain),
    )


def sync_aggregate_set(
    state, sync_aggregate, block_slot, block_root, pubkey_for_bytes, spec: Spec
):
    """Sync-committee aggregate over the previous slot's block root.

    Returns None when no bits are set and the signature is the infinity
    point (valid empty aggregate — eth_fast_aggregate_verify semantics).
    """
    previous_slot = max(block_slot, 1) - 1
    domain = get_domain(
        state,
        spec.DOMAIN_SYNC_COMMITTEE,
        spec.slot_to_epoch(previous_slot),
        spec,
    )
    committee = state.current_sync_committee.pubkeys
    participants = [
        bytes(pk)
        for pk, bit in zip(committee, sync_aggregate.sync_committee_bits)
        if bit
    ]
    sig_bytes = bytes(sync_aggregate.sync_committee_signature)
    if not participants:
        if sig_bytes == bls.INFINITY_SIGNATURE_BYTES:
            return None
        raise SignatureSetError("non-infinity signature with no participants")
    return bls.SignatureSet(
        bls.Signature.from_bytes(sig_bytes),
        [pubkey_for_bytes(pk) for pk in participants],
        compute_signing_root(block_root, domain),
    )


# ---- sync-committee gossip plane ------------------------------------------
# Role of signature_sets.rs:563+ (sync_committee_message_set_from_pubkeys,
# signed_sync_aggregate_selection_proof_signature_set,
# signed_sync_aggregate_signature_set,
# sync_committee_contribution_signature_set_from_pubkeys).


def sync_committee_message_set(
    state, message, pubkey_for, spec: Spec
) -> bls.SignatureSet:
    """A validator's per-slot sync vote: signs the head block root under
    DOMAIN_SYNC_COMMITTEE at the message slot's epoch."""
    domain = get_domain(
        state,
        spec.DOMAIN_SYNC_COMMITTEE,
        spec.slot_to_epoch(message.slot),
        spec,
    )
    return bls.SignatureSet(
        bls.Signature.from_bytes(bytes(message.signature)),
        [pubkey_for(message.validator_index)],
        compute_signing_root(bytes(message.beacon_block_root), domain),
    )


def sync_selection_proof_set(
    state, contribution_and_proof, pubkey_for, spec: Spec, types
) -> bls.SignatureSet:
    """Aggregator's selection proof signs SyncAggregatorSelectionData
    (slot, subcommittee_index)."""
    contribution = contribution_and_proof.contribution
    domain = get_domain(
        state,
        spec.DOMAIN_SYNC_COMMITTEE_SELECTION_PROOF,
        spec.slot_to_epoch(contribution.slot),
        spec,
    )
    selection_data = types.SyncAggregatorSelectionData(
        slot=contribution.slot,
        subcommittee_index=contribution.subcommittee_index,
    )
    return bls.SignatureSet(
        bls.Signature.from_bytes(
            bytes(contribution_and_proof.selection_proof)
        ),
        [pubkey_for(contribution_and_proof.aggregator_index)],
        _signing_root(selection_data, domain),
    )


def signed_contribution_and_proof_set(
    state, signed_cap, pubkey_for, spec: Spec
) -> bls.SignatureSet:
    """Outer signature over the ContributionAndProof container."""
    msg = signed_cap.message
    domain = get_domain(
        state,
        spec.DOMAIN_CONTRIBUTION_AND_PROOF,
        spec.slot_to_epoch(msg.contribution.slot),
        spec,
    )
    return bls.SignatureSet(
        bls.Signature.from_bytes(bytes(signed_cap.signature)),
        [pubkey_for(msg.aggregator_index)],
        _signing_root(msg, domain),
    )


def sync_contribution_set(
    state, contribution, participant_pubkeys, spec: Spec
) -> bls.SignatureSet:
    """Aggregated subcommittee signature over the contribution's block
    root. `participant_pubkeys` are the decompressed pubkeys of the set
    aggregation bits (caller slices the subcommittee)."""
    if not participant_pubkeys:
        raise SignatureSetError("contribution with no participants")
    domain = get_domain(
        state,
        spec.DOMAIN_SYNC_COMMITTEE,
        spec.slot_to_epoch(contribution.slot),
        spec,
    )
    return bls.SignatureSet(
        bls.Signature.from_bytes(bytes(contribution.signature)),
        list(participant_pubkeys),
        compute_signing_root(bytes(contribution.beacon_block_root), domain),
    )
