"""Gossip attestation verification: unaggregated + aggregated, batched.

The port of `lighthouse_tpu/beacon_chain/attestation_verification.py`.

Role of beacon_node/beacon_chain/src/attestation_verification.rs (+batch.rs):
structural/gossip checks per item, then ONE `verify_signature_sets` call for
the whole batch — one set per unaggregated attestation, three per aggregate
(selection proof, aggregate signature over the AggregateAndProof, and the
indexed attestation; batch.rs:70-108) — with fallback to per-item
verification when the batch fails so exact per-item verdicts are preserved
(batch.rs:115-131).
"""

from dataclasses import dataclass

from lighthouse_tpu_torch import bls, ssz
from lighthouse_tpu_torch.state_processing.helpers import (
    get_attesting_indices,
    get_domain,
)
from lighthouse_tpu_torch.types.helpers import compute_signing_root


class AttestationError(Exception):
    pass


@dataclass
class VerifiedAttestation:
    attestation: object
    indexed_indices: list
    committee_index: int
    slot: int


def _indexed_set(chain, state, attestation, indices):
    domain = get_domain(
        state,
        chain.spec.DOMAIN_BEACON_ATTESTER,
        attestation.data.target.epoch,
        chain.spec,
    )
    root = type(attestation.data).hash_tree_root(attestation.data)
    return bls.SignatureSet(
        bls.Signature.from_bytes(bytes(attestation.signature)),
        [chain.pubkey_cache.get(i) for i in indices],
        compute_signing_root(root, domain),
    )


def _selection_proof_set(chain, state, sap):
    """Aggregator's selection proof signs the attestation slot."""
    msg = sap.message
    domain = get_domain(
        state,
        chain.spec.DOMAIN_SELECTION_PROOF,
        chain.spec.slot_to_epoch(msg.aggregate.data.slot),
        chain.spec,
    )
    return bls.SignatureSet(
        bls.Signature.from_bytes(bytes(msg.selection_proof)),
        [chain.pubkey_cache.get(msg.aggregator_index)],
        compute_signing_root(
            ssz.uint64.hash_tree_root(msg.aggregate.data.slot), domain
        ),
    )


def _aggregate_and_proof_set(chain, state, sap):
    msg = sap.message
    domain = get_domain(
        state,
        chain.spec.DOMAIN_AGGREGATE_AND_PROOF,
        chain.spec.slot_to_epoch(msg.aggregate.data.slot),
        chain.spec,
    )
    return bls.SignatureSet(
        bls.Signature.from_bytes(bytes(sap.signature)),
        [chain.pubkey_cache.get(msg.aggregator_index)],
        compute_signing_root(
            type(msg).hash_tree_root(msg), domain
        ),
    )


def _structural_checks_unaggregated(chain, attestation):
    data = attestation.data
    current_slot = chain.current_slot()
    if not (
        data.slot
        <= current_slot
        <= data.slot + chain.spec.SLOTS_PER_EPOCH
    ):
        raise AttestationError("attestation outside propagation window")
    if sum(bool(b) for b in attestation.aggregation_bits) != 1:
        raise AttestationError("unaggregated must have exactly one bit")
    if bytes(data.beacon_block_root) not in chain.fork_choice.proto.indices:
        raise AttestationError("unknown head block")
    committee = chain.committee_for(data)
    if len(attestation.aggregation_bits) != len(committee):
        raise AttestationError("bits/committee length mismatch")
    indices = get_attesting_indices(committee, attestation.aggregation_bits)
    (validator_index,) = indices
    if chain.observed_attesters.is_known(data.target.epoch, validator_index):
        raise AttestationError("prior attestation known for validator/epoch")
    return indices


def batch_verify_unaggregated(chain, state, attestations):
    """Returns list of VerifiedAttestation | AttestationError per input.

    One signature set per attestation; single batch verify; fallback to
    per-set checks on batch failure.
    """
    results: list = [None] * len(attestations)
    sets, set_owner = [], []
    for i, att in enumerate(attestations):
        try:
            indices = _structural_checks_unaggregated(chain, att)
            sets.append(_indexed_set(chain, state, att, indices))
            set_owner.append((i, indices))
        except (AttestationError, ValueError) as e:
            results[i] = (
                e
                if isinstance(e, AttestationError)
                else AttestationError(str(e))
            )
    if sets:
        # the verification bus coalesces this batch with coterminous
        # consumers' submissions (deadline = the slot clock's 1/3-slot
        # attestation window)
        ok = chain.verification_bus.submit(
            sets,
            consumer="gossip_single",
            backend=chain.backend,
            journal=chain.journal,
        )
        # batch failure -> exact per-set verdicts in ONE extra device
        # call (per-set residues), not a round trip per set
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
        for (i, indices), good in zip(set_owner, verdicts):
            att = attestations[i]
            if good:
                chain.observed_attesters.observe(
                    att.data.target.epoch, indices[0]
                )
                results[i] = VerifiedAttestation(
                    att, indices, att.data.index, att.data.slot
                )
            else:
                results[i] = AttestationError("invalid signature")
    return results


def _structural_checks_aggregate(chain, sap):
    msg = sap.message
    att = msg.aggregate
    data = att.data
    current_slot = chain.current_slot()
    if not (
        data.slot <= current_slot <= data.slot + chain.spec.SLOTS_PER_EPOCH
    ):
        raise AttestationError("aggregate outside propagation window")
    if not any(att.aggregation_bits):
        raise AttestationError("empty aggregate")
    att_root = type(att).hash_tree_root(att)
    if chain.observed_aggregates.observe(data.slot, att_root):
        raise AttestationError("duplicate aggregate")
    if chain.observed_aggregators.is_known(
        data.target.epoch, msg.aggregator_index
    ):
        raise AttestationError("aggregator already seen this epoch")
    if bytes(data.beacon_block_root) not in chain.fork_choice.proto.indices:
        raise AttestationError("unknown head block")
    committee = chain.committee_for(data)
    if len(att.aggregation_bits) != len(committee):
        raise AttestationError("bits/committee length mismatch")
    if msg.aggregator_index not in committee:
        raise AttestationError("aggregator not in committee")
    return get_attesting_indices(committee, att.aggregation_bits)


def batch_verify_aggregates(chain, state, signed_aggregates):
    """Three sets per aggregate, one batch, per-item fallback."""
    results: list = [None] * len(signed_aggregates)
    triples, owners = [], []
    for i, sap in enumerate(signed_aggregates):
        try:
            indices = _structural_checks_aggregate(chain, sap)
            triple = [
                _selection_proof_set(chain, state, sap),
                _aggregate_and_proof_set(chain, state, sap),
                _indexed_set(chain, state, sap.message.aggregate, indices),
            ]
            triples.append(triple)
            owners.append((i, indices))
        except (AttestationError, ValueError) as e:
            results[i] = (
                e
                if isinstance(e, AttestationError)
                else AttestationError(str(e))
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
            sap = signed_aggregates[i]
            if good:
                chain.observed_aggregators.observe(
                    sap.message.aggregate.data.target.epoch,
                    sap.message.aggregator_index,
                )
                results[i] = VerifiedAttestation(
                    sap.message.aggregate,
                    indices,
                    sap.message.aggregate.data.index,
                    sap.message.aggregate.data.slot,
                )
            else:
                results[i] = AttestationError("invalid aggregate signature")
    return results
