"""Consensus containers (phase0 + altair), built per-Spec.

The reference monomorphizes containers over the `EthSpec` trait
(consensus/types/src/beacon_state.rs:295, beacon_block.rs, attestation.rs,
superstruct-versioned for forks). Here `types_for(spec)` builds the same
family of SSZ container classes with the spec's sizes baked into List/Vector
limits, cached per spec name. Fork variants are separate classes
(`BeaconStatePhase0` / `BeaconStateAltair`, same for blocks/bodies) with a
shared field prefix, dispatched by `spec.fork_name_at_epoch`.
"""

from types import SimpleNamespace

from lighthouse_tpu_torch import ssz
from lighthouse_tpu_torch.types.spec import (
    DEPOSIT_CONTRACT_TREE_DEPTH,
    JUSTIFICATION_BITS_LENGTH,
    Spec,
)

Root = ssz.bytes32
Hash32 = ssz.bytes32
Slot = ssz.uint64
Epoch = ssz.uint64
CommitteeIndex = ssz.uint64
ValidatorIndex = ssz.uint64
Gwei = ssz.uint64
Version = ssz.bytes4
DomainType = ssz.bytes4
Domain = ssz.bytes32
BLSPubkey = ssz.bytes48
BLSSignature = ssz.bytes96
ParticipationFlags = ssz.uint8
KZGCommitment = ssz.bytes48
KZGProof = ssz.bytes48

_CACHE: dict[str, SimpleNamespace] = {}


def types_for(spec: Spec) -> SimpleNamespace:
    if spec.name in _CACHE:
        return _CACHE[spec.name]

    # ----------------------------------------------------------- fork-free

    class Fork(ssz.Container):
        previous_version: Version
        current_version: Version
        epoch: Epoch

    class ForkData(ssz.Container):
        current_version: Version
        genesis_validators_root: Root

    class Checkpoint(ssz.Container):
        epoch: Epoch
        root: Root

    class SigningData(ssz.Container):
        object_root: Root
        domain: Domain

    class Validator(ssz.Container):
        pubkey: BLSPubkey
        withdrawal_credentials: ssz.bytes32
        effective_balance: Gwei
        slashed: ssz.boolean
        activation_eligibility_epoch: Epoch
        activation_epoch: Epoch
        exit_epoch: Epoch
        withdrawable_epoch: Epoch

    class AttestationData(ssz.Container):
        slot: Slot
        index: CommitteeIndex
        beacon_block_root: Root
        source: Checkpoint
        target: Checkpoint

    class IndexedAttestation(ssz.Container):
        attesting_indices: ssz.List(
            ssz.uint64, spec.MAX_VALIDATORS_PER_COMMITTEE
        )
        data: AttestationData
        signature: BLSSignature

    class PendingAttestation(ssz.Container):
        aggregation_bits: ssz.Bitlist(spec.MAX_VALIDATORS_PER_COMMITTEE)
        data: AttestationData
        inclusion_delay: Slot
        proposer_index: ValidatorIndex

    class Eth1Data(ssz.Container):
        deposit_root: Root
        deposit_count: ssz.uint64
        block_hash: Hash32

    class HistoricalBatch(ssz.Container):
        block_roots: ssz.Vector(Root, spec.SLOTS_PER_HISTORICAL_ROOT)
        state_roots: ssz.Vector(Root, spec.SLOTS_PER_HISTORICAL_ROOT)

    class DepositMessage(ssz.Container):
        pubkey: BLSPubkey
        withdrawal_credentials: ssz.bytes32
        amount: Gwei

    class DepositData(ssz.Container):
        pubkey: BLSPubkey
        withdrawal_credentials: ssz.bytes32
        amount: Gwei
        signature: BLSSignature

    class BeaconBlockHeader(ssz.Container):
        slot: Slot
        proposer_index: ValidatorIndex
        parent_root: Root
        state_root: Root
        body_root: Root

    class SignedBeaconBlockHeader(ssz.Container):
        message: BeaconBlockHeader
        signature: BLSSignature

    class ProposerSlashing(ssz.Container):
        signed_header_1: SignedBeaconBlockHeader
        signed_header_2: SignedBeaconBlockHeader

    class AttesterSlashing(ssz.Container):
        attestation_1: IndexedAttestation
        attestation_2: IndexedAttestation

    class Attestation(ssz.Container):
        aggregation_bits: ssz.Bitlist(spec.MAX_VALIDATORS_PER_COMMITTEE)
        data: AttestationData
        signature: BLSSignature

    class Deposit(ssz.Container):
        proof: ssz.Vector(ssz.bytes32, DEPOSIT_CONTRACT_TREE_DEPTH + 1)
        data: DepositData

    class VoluntaryExit(ssz.Container):
        epoch: Epoch
        validator_index: ValidatorIndex

    class SignedVoluntaryExit(ssz.Container):
        message: VoluntaryExit
        signature: BLSSignature

    class SyncCommittee(ssz.Container):
        pubkeys: ssz.Vector(BLSPubkey, spec.SYNC_COMMITTEE_SIZE)
        aggregate_pubkey: BLSPubkey

    class SyncAggregate(ssz.Container):
        sync_committee_bits: ssz.Bitvector(spec.SYNC_COMMITTEE_SIZE)
        sync_committee_signature: BLSSignature

    # ------------------------------------------------- bellatrix payloads

    Transaction = ssz.ByteList(spec.MAX_BYTES_PER_TRANSACTION)

    class ExecutionPayload(ssz.Container):
        parent_hash: Hash32
        fee_recipient: ssz.bytes20
        state_root: ssz.bytes32
        receipts_root: ssz.bytes32
        logs_bloom: ssz.ByteVector(spec.BYTES_PER_LOGS_BLOOM)
        prev_randao: ssz.bytes32
        block_number: ssz.uint64
        gas_limit: ssz.uint64
        gas_used: ssz.uint64
        timestamp: ssz.uint64
        extra_data: ssz.ByteList(spec.MAX_EXTRA_DATA_BYTES)
        base_fee_per_gas: ssz.uint256
        block_hash: Hash32
        transactions: ssz.List(
            Transaction, spec.MAX_TRANSACTIONS_PER_PAYLOAD
        )

    class ExecutionPayloadHeader(ssz.Container):
        parent_hash: Hash32
        fee_recipient: ssz.bytes20
        state_root: ssz.bytes32
        receipts_root: ssz.bytes32
        logs_bloom: ssz.ByteVector(spec.BYTES_PER_LOGS_BLOOM)
        prev_randao: ssz.bytes32
        block_number: ssz.uint64
        gas_limit: ssz.uint64
        gas_used: ssz.uint64
        timestamp: ssz.uint64
        extra_data: ssz.ByteList(spec.MAX_EXTRA_DATA_BYTES)
        base_fee_per_gas: ssz.uint256
        block_hash: Hash32
        transactions_root: Root

    # -------------------------------------------------------------- bodies

    class BeaconBlockBodyPhase0(ssz.Container):
        randao_reveal: BLSSignature
        eth1_data: Eth1Data
        graffiti: ssz.bytes32
        proposer_slashings: ssz.List(
            ProposerSlashing, spec.MAX_PROPOSER_SLASHINGS
        )
        attester_slashings: ssz.List(
            AttesterSlashing, spec.MAX_ATTESTER_SLASHINGS
        )
        attestations: ssz.List(Attestation, spec.MAX_ATTESTATIONS)
        deposits: ssz.List(Deposit, spec.MAX_DEPOSITS)
        voluntary_exits: ssz.List(
            SignedVoluntaryExit, spec.MAX_VOLUNTARY_EXITS
        )

    class BeaconBlockBodyAltair(ssz.Container):
        randao_reveal: BLSSignature
        eth1_data: Eth1Data
        graffiti: ssz.bytes32
        proposer_slashings: ssz.List(
            ProposerSlashing, spec.MAX_PROPOSER_SLASHINGS
        )
        attester_slashings: ssz.List(
            AttesterSlashing, spec.MAX_ATTESTER_SLASHINGS
        )
        attestations: ssz.List(Attestation, spec.MAX_ATTESTATIONS)
        deposits: ssz.List(Deposit, spec.MAX_DEPOSITS)
        voluntary_exits: ssz.List(
            SignedVoluntaryExit, spec.MAX_VOLUNTARY_EXITS
        )
        sync_aggregate: SyncAggregate

    class BeaconBlockBodyBellatrix(ssz.Container):
        randao_reveal: BLSSignature
        eth1_data: Eth1Data
        graffiti: ssz.bytes32
        proposer_slashings: ssz.List(
            ProposerSlashing, spec.MAX_PROPOSER_SLASHINGS
        )
        attester_slashings: ssz.List(
            AttesterSlashing, spec.MAX_ATTESTER_SLASHINGS
        )
        attestations: ssz.List(Attestation, spec.MAX_ATTESTATIONS)
        deposits: ssz.List(Deposit, spec.MAX_DEPOSITS)
        voluntary_exits: ssz.List(
            SignedVoluntaryExit, spec.MAX_VOLUNTARY_EXITS
        )
        sync_aggregate: SyncAggregate
        execution_payload: ExecutionPayload
        blob_kzg_commitments: ssz.List(
            KZGCommitment, spec.MAX_BLOB_COMMITMENTS_PER_BLOCK
        )

    class BlindedBeaconBlockBodyBellatrix(ssz.Container):
        """Bellatrix body with the payload replaced by its header — the
        builder flow's block shape (reference BlindedPayload,
        consensus/types/src/payload.rs + builder_client/src/lib.rs)."""

        randao_reveal: BLSSignature
        eth1_data: Eth1Data
        graffiti: ssz.bytes32
        proposer_slashings: ssz.List(
            ProposerSlashing, spec.MAX_PROPOSER_SLASHINGS
        )
        attester_slashings: ssz.List(
            AttesterSlashing, spec.MAX_ATTESTER_SLASHINGS
        )
        attestations: ssz.List(Attestation, spec.MAX_ATTESTATIONS)
        deposits: ssz.List(Deposit, spec.MAX_DEPOSITS)
        voluntary_exits: ssz.List(
            SignedVoluntaryExit, spec.MAX_VOLUNTARY_EXITS
        )
        sync_aggregate: SyncAggregate
        execution_payload_header: ExecutionPayloadHeader
        blob_kzg_commitments: ssz.List(
            KZGCommitment, spec.MAX_BLOB_COMMITMENTS_PER_BLOCK
        )

    # ------------------------------------------------------- builder types

    class BuilderBid(ssz.Container):
        """eth2::types::builder_bid::BuilderBid."""

        header: ExecutionPayloadHeader
        value: ssz.uint256
        pubkey: BLSPubkey

    class SignedBuilderBid(ssz.Container):
        message: BuilderBid
        signature: BLSSignature

    class ValidatorRegistrationData(ssz.Container):
        """SignedValidatorRegistrationData message
        (consensus/types/src/validator_registration_data.rs)."""

        fee_recipient: ssz.bytes20
        gas_limit: ssz.uint64
        timestamp: ssz.uint64
        pubkey: BLSPubkey

    class SignedValidatorRegistrationData(ssz.Container):
        message: ValidatorRegistrationData
        signature: BLSSignature

    def _make_block(body_cls, name):
        cls = type(
            name,
            (ssz.Container,),
            {
                "__annotations__": {
                    "slot": Slot,
                    "proposer_index": ValidatorIndex,
                    "parent_root": Root,
                    "state_root": Root,
                    "body": body_cls,
                }
            },
        )
        return cls

    BeaconBlockPhase0 = _make_block(BeaconBlockBodyPhase0, "BeaconBlockPhase0")
    BeaconBlockAltair = _make_block(BeaconBlockBodyAltair, "BeaconBlockAltair")
    BeaconBlockBellatrix = _make_block(
        BeaconBlockBodyBellatrix, "BeaconBlockBellatrix"
    )

    def _make_signed(block_cls, name):
        return type(
            name,
            (ssz.Container,),
            {
                "__annotations__": {
                    "message": block_cls,
                    "signature": BLSSignature,
                }
            },
        )

    SignedBeaconBlockPhase0 = _make_signed(
        BeaconBlockPhase0, "SignedBeaconBlockPhase0"
    )
    SignedBeaconBlockAltair = _make_signed(
        BeaconBlockAltair, "SignedBeaconBlockAltair"
    )
    SignedBeaconBlockBellatrix = _make_signed(
        BeaconBlockBellatrix, "SignedBeaconBlockBellatrix"
    )
    BlindedBeaconBlockBellatrix = _make_block(
        BlindedBeaconBlockBodyBellatrix, "BlindedBeaconBlockBellatrix"
    )
    SignedBlindedBeaconBlockBellatrix = _make_signed(
        BlindedBeaconBlockBellatrix, "SignedBlindedBeaconBlockBellatrix"
    )

    # --------------------------------------------------------------- state

    _state_prefix = {
        "genesis_time": ssz.uint64,
        "genesis_validators_root": Root,
        "slot": Slot,
        "fork": Fork,
        "latest_block_header": BeaconBlockHeader,
        "block_roots": ssz.Vector(Root, spec.SLOTS_PER_HISTORICAL_ROOT),
        "state_roots": ssz.Vector(Root, spec.SLOTS_PER_HISTORICAL_ROOT),
        "historical_roots": ssz.List(Root, spec.HISTORICAL_ROOTS_LIMIT),
        "eth1_data": Eth1Data,
        "eth1_data_votes": ssz.List(
            Eth1Data,
            spec.EPOCHS_PER_ETH1_VOTING_PERIOD * spec.SLOTS_PER_EPOCH,
        ),
        "eth1_deposit_index": ssz.uint64,
        "validators": ssz.List(Validator, spec.VALIDATOR_REGISTRY_LIMIT),
        "balances": ssz.List(Gwei, spec.VALIDATOR_REGISTRY_LIMIT),
        "randao_mixes": ssz.Vector(
            ssz.bytes32, spec.EPOCHS_PER_HISTORICAL_VECTOR
        ),
        "slashings": ssz.Vector(Gwei, spec.EPOCHS_PER_SLASHINGS_VECTOR),
    }
    _state_suffix = {
        "justification_bits": ssz.Bitvector(JUSTIFICATION_BITS_LENGTH),
        "previous_justified_checkpoint": Checkpoint,
        "current_justified_checkpoint": Checkpoint,
        "finalized_checkpoint": Checkpoint,
    }

    BeaconStatePhase0 = type(
        "BeaconStatePhase0",
        (ssz.Container,),
        {
            "__annotations__": {
                **_state_prefix,
                "previous_epoch_attestations": ssz.List(
                    PendingAttestation,
                    spec.MAX_ATTESTATIONS * spec.SLOTS_PER_EPOCH,
                ),
                "current_epoch_attestations": ssz.List(
                    PendingAttestation,
                    spec.MAX_ATTESTATIONS * spec.SLOTS_PER_EPOCH,
                ),
                **_state_suffix,
            }
        },
    )

    _altair_fields = {
        **_state_prefix,
        "previous_epoch_participation": ssz.List(
            ParticipationFlags, spec.VALIDATOR_REGISTRY_LIMIT
        ),
        "current_epoch_participation": ssz.List(
            ParticipationFlags, spec.VALIDATOR_REGISTRY_LIMIT
        ),
        **_state_suffix,
        "inactivity_scores": ssz.List(
            ssz.uint64, spec.VALIDATOR_REGISTRY_LIMIT
        ),
        "current_sync_committee": SyncCommittee,
        "next_sync_committee": SyncCommittee,
    }

    BeaconStateAltair = type(
        "BeaconStateAltair",
        (ssz.Container,),
        {"__annotations__": dict(_altair_fields)},
    )

    BeaconStateBellatrix = type(
        "BeaconStateBellatrix",
        (ssz.Container,),
        {
            "__annotations__": {
                **_altair_fields,
                "latest_execution_payload_header": ExecutionPayloadHeader,
            }
        },
    )

    # ------------------------------------------------- light-client types

    # Generalized indices computed from the SAME state descriptors the
    # codec merkleizes with (ssz/gindex), so branch depths can never
    # drift from hash_tree_root. On this Altair shape the classic spec
    # constants fall out: finalized root 105 (depth 6), current/next
    # sync committee 54/55 (depth 5) — and the Bellatrix state (25
    # fields, same 32-chunk pad) shares them, asserted below.
    from lighthouse_tpu_torch.ssz.gindex import floorlog2, gindex_for_path

    FINALIZED_ROOT_GINDEX = gindex_for_path(
        BeaconStateAltair, ("finalized_checkpoint", "root")
    )
    CURRENT_SYNC_COMMITTEE_GINDEX = gindex_for_path(
        BeaconStateAltair, ("current_sync_committee",)
    )
    NEXT_SYNC_COMMITTEE_GINDEX = gindex_for_path(
        BeaconStateAltair, ("next_sync_committee",)
    )
    assert FINALIZED_ROOT_GINDEX == gindex_for_path(
        BeaconStateBellatrix, ("finalized_checkpoint", "root")
    ), "fork state shapes disagree on the finalized-root gindex"

    class LightClientHeader(ssz.Container):
        """Altair light-client header (capella adds execution fields —
        the wrapper shape is kept so that extension is additive)."""

        beacon: BeaconBlockHeader

    class LightClientBootstrap(ssz.Container):
        header: LightClientHeader
        current_sync_committee: SyncCommittee
        current_sync_committee_branch: ssz.Vector(
            ssz.bytes32, floorlog2(CURRENT_SYNC_COMMITTEE_GINDEX)
        )

    class LightClientUpdate(ssz.Container):
        attested_header: LightClientHeader
        next_sync_committee: SyncCommittee
        next_sync_committee_branch: ssz.Vector(
            ssz.bytes32, floorlog2(NEXT_SYNC_COMMITTEE_GINDEX)
        )
        finalized_header: LightClientHeader
        finality_branch: ssz.Vector(
            ssz.bytes32, floorlog2(FINALIZED_ROOT_GINDEX)
        )
        sync_aggregate: SyncAggregate
        signature_slot: Slot

    class LightClientFinalityUpdate(ssz.Container):
        attested_header: LightClientHeader
        finalized_header: LightClientHeader
        finality_branch: ssz.Vector(
            ssz.bytes32, floorlog2(FINALIZED_ROOT_GINDEX)
        )
        sync_aggregate: SyncAggregate
        signature_slot: Slot

    class LightClientOptimisticUpdate(ssz.Container):
        attested_header: LightClientHeader
        sync_aggregate: SyncAggregate
        signature_slot: Slot

    # ------------------------------------------------- gossip/VC envelopes

    class AggregateAndProof(ssz.Container):
        aggregator_index: ValidatorIndex
        aggregate: Attestation
        selection_proof: BLSSignature

    class SignedAggregateAndProof(ssz.Container):
        message: AggregateAndProof
        signature: BLSSignature

    class SyncCommitteeMessage(ssz.Container):
        slot: Slot
        beacon_block_root: Root
        validator_index: ValidatorIndex
        signature: BLSSignature

    class SyncCommitteeContribution(ssz.Container):
        slot: Slot
        beacon_block_root: Root
        subcommittee_index: ssz.uint64
        aggregation_bits: ssz.Bitvector(max(spec.SYNC_COMMITTEE_SIZE // 4, 1))
        signature: BLSSignature

    class ContributionAndProof(ssz.Container):
        aggregator_index: ValidatorIndex
        contribution: SyncCommitteeContribution
        selection_proof: BLSSignature

    class SignedContributionAndProof(ssz.Container):
        message: ContributionAndProof
        signature: BLSSignature

    class SyncAggregatorSelectionData(ssz.Container):
        """Signed by a sync-committee aggregator's selection proof
        (consensus/types/src/sync_selection_proof.rs)."""

        slot: Slot
        subcommittee_index: ssz.uint64

    class DepositEvent(ssz.Container):
        """Deposit log entry as cached by the eth1 service
        (reference beacon_node/eth1/src/deposit_cache.rs)."""

        deposit_data: DepositData
        block_number: ssz.uint64
        index: ssz.uint64

    # ------------------------------------------------ blob data availability

    Blob = ssz.ByteVector(
        spec.FIELD_ELEMENTS_PER_BLOB * spec.BYTES_PER_FIELD_ELEMENT
    )

    class BlobSidecar(ssz.Container):
        """Deneb-shaped blob sidecar (consensus/types/src/blob_sidecar.rs):
        one blob + its KZG commitment/proof, bound to a block by the
        signed header. Gossiped on `blob_sidecar_{subnet}` topics and
        gated through the DataAvailabilityChecker before the block it
        belongs to may import."""

        index: ssz.uint64
        blob: Blob
        kzg_commitment: KZGCommitment
        kzg_proof: KZGProof
        signed_block_header: SignedBeaconBlockHeader

    class BlobIdentifier(ssz.Container):
        """(block_root, index) — the by-root RPC request key for a
        sidecar (deneb p2p spec BlobIdentifier)."""

        block_root: Root
        index: ssz.uint64

    # -------------------------------------------- column data availability

    Cell = ssz.ByteVector(
        spec.FIELD_ELEMENTS_PER_CELL * spec.BYTES_PER_FIELD_ELEMENT
    )

    class DataColumnSidecar(ssz.Container):
        """PeerDAS-shaped column sidecar (consensus/types/src/
        data_column_sidecar.rs): one vertical slice of the extended blob
        matrix — cell `index` of EVERY blob the block commits to — plus
        the per-cell KZG proofs and the signed header binding it to the
        block. Gossiped on `data_column_sidecar_{subnet}` topics; any
        50% of a block's columns reconstruct the full matrix
        (da.erasure)."""

        index: ssz.uint64
        column: ssz.List(Cell, spec.MAX_BLOB_COMMITMENTS_PER_BLOCK)
        kzg_commitments: ssz.List(
            KZGCommitment, spec.MAX_BLOB_COMMITMENTS_PER_BLOCK
        )
        kzg_proofs: ssz.List(
            KZGProof, spec.MAX_BLOB_COMMITMENTS_PER_BLOCK
        )
        signed_block_header: SignedBeaconBlockHeader

    class DataColumnIdentifier(ssz.Container):
        """(block_root, index) — the by-root request key for a column
        sidecar (PeerDAS p2p DataColumnIdentifier)."""

        block_root: Root
        index: ssz.uint64

    ns = SimpleNamespace(**{
        k: v
        for k, v in locals().items()
        if isinstance(v, type) and issubclass(v, ssz.Container)
    })
    ns.spec = spec
    ns.Blob = Blob
    ns.Cell = Cell
    # light-client generalized-index constants (state-shape-derived)
    ns.FINALIZED_ROOT_GINDEX = FINALIZED_ROOT_GINDEX
    ns.CURRENT_SYNC_COMMITTEE_GINDEX = CURRENT_SYNC_COMMITTEE_GINDEX
    ns.NEXT_SYNC_COMMITTEE_GINDEX = NEXT_SYNC_COMMITTEE_GINDEX

    # fork dispatch tables
    ns.block_body_classes = {
        "phase0": BeaconBlockBodyPhase0,
        "altair": BeaconBlockBodyAltair,
        "bellatrix": BeaconBlockBodyBellatrix,
    }
    ns.block_classes = {
        "phase0": BeaconBlockPhase0,
        "altair": BeaconBlockAltair,
        "bellatrix": BeaconBlockBellatrix,
    }
    ns.signed_block_classes = {
        "phase0": SignedBeaconBlockPhase0,
        "altair": SignedBeaconBlockAltair,
        "bellatrix": SignedBeaconBlockBellatrix,
    }
    ns.state_classes = {
        "phase0": BeaconStatePhase0,
        "altair": BeaconStateAltair,
        "bellatrix": BeaconStateBellatrix,
    }
    # builder/blinded flow (bellatrix onward)
    ns.blinded_body_classes = {
        "bellatrix": BlindedBeaconBlockBodyBellatrix,
    }
    ns.blinded_block_classes = {
        "bellatrix": BlindedBeaconBlockBellatrix,
    }
    ns.signed_blinded_block_classes = {
        "bellatrix": SignedBlindedBeaconBlockBellatrix,
    }

    _CACHE[spec.name] = ns
    return ns
