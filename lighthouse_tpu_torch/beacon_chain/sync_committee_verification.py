"""Gossip verification for sync-committee messages and contributions.

The port of `lighthouse_tpu/beacon_chain/sync_committee_verification.py`.

Role of beacon_node/beacon_chain/src/sync_committee_verification.rs:
structural/gossip checks per item, then batched signature verification
through the same `verify_signature_sets` boundary as attestations — one
set per SyncCommitteeMessage, three per SignedContributionAndProof
(selection proof over SyncAggregatorSelectionData, the outer
contribution-and-proof signature, and the aggregated contribution
signature over the subcommittee participants;
sync_committee_verification.rs:267,422,561-622) — with per-item fallback
on batch failure, mirroring attestation batch.rs semantics.
"""

from dataclasses import dataclass

from lighthouse_tpu_torch.ssz.hashing import hash32
from lighthouse_tpu_torch.state_processing.signature_sets import (
    signed_contribution_and_proof_set,
    sync_committee_message_set,
    sync_contribution_set,
    sync_selection_proof_set,
)


class SyncCommitteeError(Exception):
    pass


@dataclass
class VerifiedSyncMessage:
    message: object
    # subcommittee index -> positions of this validator within it
    subnet_positions: dict


@dataclass
class VerifiedContribution:
    signed_contribution: object
    participant_indices: list


def sync_subcommittee_size(spec) -> int:
    return max(spec.SYNC_COMMITTEE_SIZE // spec.SYNC_COMMITTEE_SUBNET_COUNT, 1)


def committee_positions(
    state, validator_index: int, chain, committee=None
) -> list[int]:
    """All positions of `validator_index` in a sync committee (the
    state's current one unless `committee` is given; a validator can
    appear multiple times — sampling is with replacement)."""
    if committee is None:
        committee = state.current_sync_committee
    positions = []
    for pos, pk in enumerate(committee.pubkeys):
        idx = chain.pubkey_cache.index_of(bytes(pk))
        if idx == validator_index:
            positions.append(pos)
    return positions


def subnet_positions_for(state, validator_index: int, chain, spec) -> dict:
    """subcommittee -> [positions within subcommittee] for a validator
    (SyncSubnetId::compute_subnets_for_sync_committee analog)."""
    size = sync_subcommittee_size(spec)
    out: dict[int, list[int]] = {}
    for pos in committee_positions(state, validator_index, chain):
        out.setdefault(pos // size, []).append(pos % size)
    return out


def is_sync_aggregator(selection_proof: bytes, spec) -> bool:
    """SyncSelectionProof::is_aggregator (sync_selection_proof.rs):
    hash(proof)[:8] as u64 mod (subcommittee_size //
    TARGET_AGGREGATORS_PER_SYNC_SUBCOMMITTEE) == 0."""
    modulo = max(
        1,
        sync_subcommittee_size(spec)
        // spec.TARGET_AGGREGATORS_PER_SYNC_SUBCOMMITTEE,
    )
    return (
        int.from_bytes(hash32(bytes(selection_proof))[:8], "little") % modulo
        == 0
    )


def _check_slot_window(chain, slot: int, what: str):
    """verify_propagation_slot_range (sync_committee_verification.rs:519):
    sync messages are only valid for the current slot, with one slot of
    clock-disparity tolerance on each side (the reference permits
    MAXIMUM_GOSSIP_CLOCK_DISPARITY futureward — a marginally-ahead peer
    at a slot boundary must not be dropped)."""
    current = chain.current_slot()
    if slot > current + 1:
        raise SyncCommitteeError(f"future-slot {what}")
    if slot + 1 < current:
        raise SyncCommitteeError(f"past-slot {what}")


def _structural_checks_message(chain, state, message):
    _check_slot_window(chain, message.slot, "sync message")
    positions = subnet_positions_for(
        state, message.validator_index, chain, chain.spec
    )
    if not positions:
        raise SyncCommitteeError("validator not in current sync committee")
    for subcommittee in positions:
        if chain.observed_sync_contributors.is_known(
            message.slot, subcommittee, message.validator_index
        ):
            raise SyncCommitteeError(
                "prior sync message known for validator/slot"
            )
    return positions


def batch_verify_sync_messages(chain, state, messages):
    """Returns list of VerifiedSyncMessage | SyncCommitteeError per input.

    One signature set per message; single batch verify; per-set fallback
    on batch failure (verify_sync_committee_message + batch semantics)."""
    results: list = [None] * len(messages)
    sets, owners = [], []
    for i, msg in enumerate(messages):
        try:
            positions = _structural_checks_message(chain, state, msg)
            sets.append(
                sync_committee_message_set(
                    state, msg, chain.pubkey_cache.get, chain.spec
                )
            )
            owners.append((i, positions))
        except (SyncCommitteeError, ValueError, IndexError) as e:
            results[i] = (
                e
                if isinstance(e, SyncCommitteeError)
                else SyncCommitteeError(str(e))
            )
    if sets:
        ok = chain.verification_bus.submit(
            sets,
            consumer="gossip_single",
            backend=chain.backend,
            journal=chain.journal,
        )
        # batch failure -> per-set verdicts in one extra device call
        verdicts = (
            [True] * len(sets)
            if ok
            else chain.verification_bus.submit_individual(
                sets,
                consumer="gossip_single",
                backend=chain.backend,
                journal=chain.journal,
            )
        )
        for (i, positions), good in zip(owners, verdicts):
            msg = messages[i]
            if good:
                for subcommittee in positions:
                    chain.observed_sync_contributors.observe(
                        msg.slot, subcommittee, msg.validator_index
                    )
                results[i] = VerifiedSyncMessage(msg, positions)
            else:
                results[i] = SyncCommitteeError("invalid signature")
    return results


def _structural_checks_contribution(chain, state, signed_cap):
    spec = chain.spec
    msg = signed_cap.message
    contribution = msg.contribution
    _check_slot_window(chain, contribution.slot, "contribution")
    if contribution.subcommittee_index >= spec.SYNC_COMMITTEE_SUBNET_COUNT:
        raise SyncCommitteeError("subcommittee index out of range")
    bits = list(contribution.aggregation_bits)
    if not any(bits):
        raise SyncCommitteeError("empty contribution")
    if not is_sync_aggregator(msg.selection_proof, spec):
        raise SyncCommitteeError("selection proof does not elect aggregator")
    agg_positions = subnet_positions_for(
        state, msg.aggregator_index, chain, spec
    )
    if contribution.subcommittee_index not in agg_positions:
        raise SyncCommitteeError("aggregator not in subcommittee")
    root = type(contribution).hash_tree_root(contribution)
    if chain.observed_sync_contributions.observe(contribution.slot, root):
        raise SyncCommitteeError("duplicate contribution")
    if chain.observed_sync_aggregators.is_known(
        contribution.slot,
        contribution.subcommittee_index,
        msg.aggregator_index,
    ):
        raise SyncCommitteeError("aggregator already seen for slot/subnet")
    # participants: subcommittee slice of the current sync committee
    size = sync_subcommittee_size(spec)
    start = contribution.subcommittee_index * size
    committee = state.current_sync_committee.pubkeys
    participant_indices = []
    participant_pubkeys = []
    for offset, bit in enumerate(bits):
        if bit:
            pk_bytes = bytes(committee[start + offset])
            participant_pubkeys.append(
                chain.pubkey_cache.get_by_bytes(pk_bytes)
            )
            participant_indices.append(
                chain.pubkey_cache.index_of(pk_bytes)
            )
    return participant_indices, participant_pubkeys


def batch_verify_contributions(chain, state, signed_contributions):
    """Three sets per contribution, one batch, per-item fallback
    (verify_signed_aggregate_signatures, sync_committee_verification.rs:561)."""
    results: list = [None] * len(signed_contributions)
    triples, owners = [], []
    for i, sc in enumerate(signed_contributions):
        try:
            indices, pubkeys = _structural_checks_contribution(
                chain, state, sc
            )
            triple = [
                sync_selection_proof_set(
                    state, sc.message, chain.pubkey_cache.get, chain.spec,
                    chain.t,
                ),
                signed_contribution_and_proof_set(
                    state, sc, chain.pubkey_cache.get, chain.spec
                ),
                sync_contribution_set(
                    state, sc.message.contribution, pubkeys, chain.spec
                ),
            ]
            triples.append(triple)
            owners.append((i, indices))
        except (SyncCommitteeError, ValueError, IndexError) as e:
            results[i] = (
                e
                if isinstance(e, SyncCommitteeError)
                else SyncCommitteeError(str(e))
            )
    if triples:
        flat = [s for triple in triples for s in triple]
        ok = chain.verification_bus.submit(
            flat,
            consumer="gossip_single",
            backend=chain.backend,
            journal=chain.journal,
        )
        if ok:
            verdicts = [True] * len(triples)
        else:
            per_set = chain.verification_bus.submit_individual(
                flat,
                consumer="gossip_single",
                backend=chain.backend,
                journal=chain.journal,
            )
            verdicts = [
                all(per_set[3 * i : 3 * i + 3])
                for i in range(len(triples))
            ]
        for (i, indices), good in zip(owners, verdicts):
            sc = signed_contributions[i]
            if good:
                chain.observed_sync_aggregators.observe(
                    sc.message.contribution.slot,
                    sc.message.contribution.subcommittee_index,
                    sc.message.aggregator_index,
                )
                results[i] = VerifiedContribution(sc, indices)
            else:
                results[i] = SyncCommitteeError(
                    "invalid contribution signature"
                )
    return results
