"""Full per-block state transition (phase0 + altair + bellatrix payloads).

The port of `lighthouse_tpu/state_processing/per_block.py` (role of
consensus/state_processing/src/per_block_processing.rs, with
process_operations.rs and altair/sync_committee.rs): header, RANDAO, eth1
and execution-payload processing, the five operation types, and the
altair sync aggregate, under the same `BlockSignatureStrategy` surface
(per_block_processing.rs:44): NoVerification / VerifyIndividual /
VerifyBulk. VerifyBulk collects every signature set of the block and
sends ONE `bls.verify_signature_sets` batch, one multi-pairing on the
card on the "gpu" backend: the `BlockSignatureVerifier::verify_entire_block`
analog (block_signature_verifier.rs:120-131).

Every `bls` call takes the caller's `device` ("cuda" unless asked), the
deposit check on the default backend included.

The block's constants -- the active indices, the total active balance,
the base reward per increment and the proposer index -- are computed
once per block (`BlockConstants`), not per attester or per attestation:
nothing a block does changes them within it. Attestations set flags;
deposits add validators that are not yet active and change no effective
balance; slashings and exits set exit epochs beyond the current one; the
slot and the proposer seed are fixed.
"""

from enum import Enum

from lighthouse_tpu_torch import bls
from lighthouse_tpu_torch.ssz.hashing import ZERO_BYTES32, hash32
from lighthouse_tpu_torch.ssz.merkle import verify_merkle_proof
from lighthouse_tpu_torch.state_processing import signature_sets as sigsets
from lighthouse_tpu_torch.state_processing.helpers import (
    CommitteeCache,
    compute_proposer_index,
    decrease_balance,
    get_attesting_indices,
    get_block_root,
    get_block_root_at_slot,
    get_current_epoch,
    get_previous_epoch,
    get_randao_mix,
    get_seed,
    get_total_active_balance,
    get_total_balance,
    increase_balance,
    initiate_validator_exit,
    integer_squareroot,
    is_active_validator,
    is_slashable_attestation_data,
    is_slashable_validator,
    slash_validator,
    uint_to_bytes8,
)
from lighthouse_tpu_torch.types.spec import (
    FAR_FUTURE_EPOCH,
    PARTICIPATION_FLAG_WEIGHTS,
    PROPOSER_WEIGHT,
    SYNC_REWARD_WEIGHT,
    TIMELY_HEAD_FLAG_INDEX,
    TIMELY_SOURCE_FLAG_INDEX,
    TIMELY_TARGET_FLAG_INDEX,
    WEIGHT_DENOMINATOR,
    Spec,
)


class BlockProcessingError(Exception):
    pass


class BlockSignatureStrategy(Enum):
    NO_VERIFICATION = "no_verification"
    VERIFY_INDIVIDUAL = "verify_individual"
    VERIFY_BULK = "verify_bulk"


class SignatureCollector:
    """Accumulates signature sets per the strategy; `finish` runs the batch
    (or nothing). Individual mode verifies eagerly so errors surface at the
    offending operation, exactly like the reference's VerifyIndividual.

    `consumer`/`journal`/`slot` ride into every `bls.verify_signature_sets`
    call this collector makes, so block-processing batches carry
    device-plane attribution and land as `signature_batch` journal
    events (common/device_attribution). `device` is where the "gpu"
    backend runs them. `bus` (a chain's VerificationBus) routes those
    calls through the cross-consumer coalescing boundary instead of
    dispatching alone; the bus runs on its own device."""

    def __init__(
        self, strategy, backend=None, seed=None, consumer=None,
        journal=None, slot=None, bus=None, device="cuda",
    ):
        self.strategy = strategy
        self.backend = backend
        self.seed = seed
        self.consumer = consumer
        self.journal = journal
        self.slot = slot
        self.bus = bus
        self.device = device
        self.sets = []

    def _verify(self, sets) -> bool:
        if self.bus is not None:
            return self.bus.submit(
                sets,
                consumer=self.consumer,
                backend=self.backend,
                journal=self.journal,
                slot=self.slot,
            )
        return bls.verify_signature_sets(
            sets,
            backend=self.backend,
            seed=self.seed,
            device=self.device,
            consumer=self.consumer,
            journal=self.journal,
            slot=self.slot,
        )

    def add(self, make_set):
        """`make_set` is a zero-arg callable returning a SignatureSet (or
        None). Construction -- including signature byte parsing -- is
        skipped entirely under NO_VERIFICATION."""
        if self.strategy == BlockSignatureStrategy.NO_VERIFICATION:
            return
        try:
            sset = make_set()
        except ValueError as e:  # undecodable signature/pubkey bytes
            raise BlockProcessingError(f"malformed signature: {e}") from e
        if sset is None:
            return
        if self.strategy == BlockSignatureStrategy.VERIFY_INDIVIDUAL:
            if not self._verify([sset]):
                raise BlockProcessingError("invalid signature")
        else:
            self.sets.append(sset)

    def add_many(self, make_sets):
        if self.strategy == BlockSignatureStrategy.NO_VERIFICATION:
            return
        for s in make_sets():
            self.add(lambda s=s: s)

    def finish(self):
        if (
            self.strategy == BlockSignatureStrategy.VERIFY_BULK
            and self.sets
        ):
            if not self._verify(self.sets):
                raise BlockProcessingError("bulk signature verification failed")


class BlockConstants:
    """What a block's operations read but never change, each computed once
    on first use: the current epoch's active indices (from the epoch's
    committee cache), the total active balance, the base reward per
    increment, the proposer index (spec `get_beacon_proposer_index` on the
    same indices and seed), and the committee cache of each target epoch
    the block's attestations name."""

    def __init__(self, state, spec: Spec, committee_cache: CommitteeCache):
        self.state = state
        self.spec = spec
        self.active = committee_cache.active
        self._caches = {committee_cache.epoch: committee_cache}
        self._proposer = None
        self._total = None

    def committee_cache(self, epoch: int) -> CommitteeCache:
        if epoch not in self._caches:
            self._caches[epoch] = CommitteeCache(self.state, epoch, self.spec)
        return self._caches[epoch]

    @property
    def proposer_index(self) -> int:
        if self._proposer is None:
            state, spec = self.state, self.spec
            seed = hash32(
                get_seed(state, get_current_epoch(state, spec), spec.DOMAIN_BEACON_PROPOSER, spec)
                + uint_to_bytes8(state.slot)
            )
            self._proposer = compute_proposer_index(state, self.active, seed, spec)
        return self._proposer

    @property
    def total_active_balance(self) -> int:
        if self._total is None:
            self._total = get_total_balance(self.state, self.active, self.spec)
        return self._total

    @property
    def base_reward_per_increment(self) -> int:
        return get_base_reward_per_increment(self.total_active_balance, self.spec)


def per_block_processing(
    state,
    signed_block,
    spec: Spec,
    strategy: BlockSignatureStrategy,
    pubkey_cache,
    verify_proposal: bool = True,
    committee_cache: CommitteeCache | None = None,
    backend: str | None = None,
    seed: int | None = None,
    execution_engine=None,
    collector: SignatureCollector | None = None,
    consumer=None,
    journal=None,
    bus=None,
    device="cuda",
):
    """Apply `signed_block` to `state` (which must already be advanced to
    the block's slot via process_slots). Mutates state in place.

    `collector`: an externally-owned SignatureCollector. When given, every
    set this block produces (proposal, randao, operations, sync aggregate)
    accumulates into it and `finish()` is NOT called here -- the caller
    batches across blocks and verifies once. This is how a chain segment
    verifies EVERY signature of every block in one device batch
    (block_verification.rs:509 signature_verify_chain_segment semantics),
    not just the proposer signatures.

    `consumer`/`journal`/`bus` thread device-plane attribution and the
    verification-bus routing into the internally-built collector's
    verify call (ignored when an external collector is given -- its own
    attribution applies). `device` is where this block's "gpu" batch and
    its deposit checks run."""
    block = signed_block.message
    fork = spec.fork_name_at_epoch(get_current_epoch(state, spec))
    pubkey_cache.import_new(state)
    deferred = collector is not None
    if collector is None:
        collector = SignatureCollector(
            strategy, backend=backend, seed=seed, consumer=consumer,
            journal=journal, slot=int(block.slot), bus=bus, device=device,
        )
    pk = pubkey_cache.get

    if committee_cache is None or committee_cache.epoch != get_current_epoch(
        state, spec
    ):
        committee_cache = CommitteeCache(
            state, get_current_epoch(state, spec), spec
        )
    consts = BlockConstants(state, spec, committee_cache)

    if verify_proposal:
        collector.add(
            lambda: sigsets.block_proposal_set(state, signed_block, pk, spec)
        )

    process_block_header(state, block, spec, consts)
    if fork == "bellatrix" and is_execution_enabled(state, block.body):
        if hasattr(block.body, "execution_payload"):
            process_execution_payload(
                state, block.body.execution_payload, execution_engine, spec
            )
        else:
            # blinded body (builder flow): the payload is known only by
            # its header; same state checks, no engine verdict here (the
            # unblinding importer runs the engine on the full payload)
            process_execution_payload_header(
                state, block.body.execution_payload_header, spec
            )
    process_randao(state, block, pk, spec, collector)
    process_eth1_data(state, block.body, spec)
    process_operations(
        state, block.body, spec, fork, pk, collector, pubkey_cache, consts,
        device,
    )
    if fork != "phase0":
        process_sync_aggregate(
            state, block.body.sync_aggregate, pubkey_cache, spec, collector,
            consts,
        )

    if not deferred:
        collector.finish()
    return state


# --------------------------------------------------- execution (bellatrix)


_EMPTY_HEADER_ENC: dict[type, bytes] = {}


def is_merge_transition_complete(state) -> bool:
    """True once the state has seen a real execution payload (spec:
    latest_execution_payload_header != ExecutionPayloadHeader())."""
    cls = type(state.latest_execution_payload_header)
    empty = _EMPTY_HEADER_ENC.get(cls)
    if empty is None:
        empty = _EMPTY_HEADER_ENC[cls] = cls.encode(cls())
    return cls.encode(state.latest_execution_payload_header) != empty


def _body_block_hash(body) -> bytes:
    """block_hash of the body's payload, full or blinded
    (ExecPayload::block_hash over FullPayload/BlindedPayload)."""
    payload = getattr(body, "execution_payload", None)
    if payload is None:
        payload = body.execution_payload_header
    return payload.block_hash


def is_merge_transition_block(state, body) -> bool:
    return (
        not is_merge_transition_complete(state)
        and _body_block_hash(body) != b"\x00" * 32
    )


def is_execution_enabled(state, body) -> bool:
    if is_merge_transition_complete(state):
        return True
    return _body_block_hash(body) != b"\x00" * 32


def compute_timestamp_at_slot(state, slot: int, spec: Spec) -> int:
    return state.genesis_time + (slot) * spec.SECONDS_PER_SLOT


class AlwaysValidExecutionEngine:
    """Spec-test stand-in: accepts every payload (the reference's
    fake-execution path in the harness)."""

    def notify_new_payload(self, payload) -> bool:
        return True


def _check_payload_against_state(state, payload, spec: Spec):
    if is_merge_transition_complete(state):
        if (
            payload.parent_hash
            != state.latest_execution_payload_header.block_hash
        ):
            raise BlockProcessingError("payload parent mismatch")
    if payload.prev_randao != get_randao_mix(
        state, get_current_epoch(state, spec), spec
    ):
        raise BlockProcessingError("payload prev_randao mismatch")
    if payload.timestamp != compute_timestamp_at_slot(
        state, state.slot, spec
    ):
        raise BlockProcessingError("payload timestamp mismatch")


def process_execution_payload_header(state, header, spec: Spec):
    """Blinded-body variant of process_execution_payload: identical
    consistency checks, then roll the header forward verbatim (spec
    process_execution_payload over a BlindedPayload; the engine verdict
    happens at unblinding time on the full payload)."""
    _check_payload_against_state(state, header, spec)
    state.latest_execution_payload_header = header.copy()


def process_execution_payload(state, payload, execution_engine, spec: Spec):
    """Spec process_execution_payload (bellatrix/block_processing.rs
    analog): consistency checks against the state, then the engine
    verdict, then roll the header forward."""
    from lighthouse_tpu_torch.types.containers import types_for

    _check_payload_against_state(state, payload, spec)
    engine = execution_engine or AlwaysValidExecutionEngine()
    if not engine.notify_new_payload(payload):
        raise BlockProcessingError("execution engine rejected payload")
    state.latest_execution_payload_header = execution_payload_to_header(
        payload, types_for(spec), spec
    )


def execution_payload_to_header(payload, t, spec: Spec):
    """ExecutionPayloadHeader::from(ExecutionPayload): same fields with
    the transactions list replaced by its hash_tree_root -- which is why a
    blinded block's root equals the full block's."""
    from lighthouse_tpu_torch import ssz

    tx_list_type = ssz.List(
        ssz.ByteList(spec.MAX_BYTES_PER_TRANSACTION),
        spec.MAX_TRANSACTIONS_PER_PAYLOAD,
    )
    return t.ExecutionPayloadHeader(
        parent_hash=payload.parent_hash,
        fee_recipient=payload.fee_recipient,
        state_root=payload.state_root,
        receipts_root=payload.receipts_root,
        logs_bloom=payload.logs_bloom,
        prev_randao=payload.prev_randao,
        block_number=payload.block_number,
        gas_limit=payload.gas_limit,
        gas_used=payload.gas_used,
        timestamp=payload.timestamp,
        extra_data=payload.extra_data,
        base_fee_per_gas=payload.base_fee_per_gas,
        block_hash=payload.block_hash,
        transactions_root=tx_list_type.hash_tree_root(
            list(payload.transactions)
        ),
    )


# ----------------------------------------------------------------- header


def process_block_header(state, block, spec: Spec, consts: BlockConstants):
    if block.slot != state.slot:
        raise BlockProcessingError("block slot mismatch")
    if block.slot <= state.latest_block_header.slot:
        raise BlockProcessingError("block older than latest header")
    if block.proposer_index != consts.proposer_index:
        raise BlockProcessingError("wrong proposer index")
    header_cls = type(state.latest_block_header)
    parent_root = header_cls.hash_tree_root(state.latest_block_header)
    if bytes(block.parent_root) != parent_root:
        raise BlockProcessingError("parent root mismatch")
    body_cls = type(block.body)
    state.latest_block_header = header_cls(
        slot=block.slot,
        proposer_index=block.proposer_index,
        parent_root=block.parent_root,
        state_root=ZERO_BYTES32,
        body_root=body_cls.hash_tree_root(block.body),
    )
    proposer = state.validators[block.proposer_index]
    if proposer.slashed:
        raise BlockProcessingError("proposer is slashed")


# ----------------------------------------------------------------- randao


def process_randao(state, block, pubkey_for, spec: Spec, collector):
    epoch = get_current_epoch(state, spec)
    collector.add(lambda: sigsets.randao_set(state, block, pubkey_for, spec))
    mix = bytes(
        a ^ b
        for a, b in zip(
            get_randao_mix(state, epoch, spec),
            hash32(bytes(block.body.randao_reveal)),
        )
    )
    state.randao_mixes[epoch % spec.EPOCHS_PER_HISTORICAL_VECTOR] = mix


# ------------------------------------------------------------------- eth1


def process_eth1_data(state, body, spec: Spec):
    state.eth1_data_votes.append(body.eth1_data)
    period_slots = spec.EPOCHS_PER_ETH1_VOTING_PERIOD * spec.SLOTS_PER_EPOCH
    votes = sum(1 for v in state.eth1_data_votes if v == body.eth1_data)
    if votes * 2 > period_slots:
        state.eth1_data = body.eth1_data


# -------------------------------------------------------------- operations


def process_operations(
    state, body, spec, fork, pubkey_for, collector, pubkey_cache, consts,
    device="cuda",
):
    expected_deposits = min(
        spec.MAX_DEPOSITS,
        state.eth1_data.deposit_count - state.eth1_deposit_index,
    )
    if len(body.deposits) != expected_deposits:
        raise BlockProcessingError("wrong deposit count")

    for ps in body.proposer_slashings:
        process_proposer_slashing(
            state, ps, spec, fork, pubkey_for, collector
        )
    for aslash in body.attester_slashings:
        process_attester_slashing(
            state, aslash, spec, fork, pubkey_for, collector
        )
    for att in body.attestations:
        process_attestation(
            state, att, spec, fork, pubkey_for, collector, consts
        )
    for dep in body.deposits:
        process_deposit(
            state, dep, spec, fork, pubkey_cache, collector=collector,
            device=device,
        )
    for exit_ in body.voluntary_exits:
        process_voluntary_exit(state, exit_, spec, pubkey_for, collector)


def process_proposer_slashing(
    state, slashing, spec, fork, pubkey_for, collector
):
    h1 = slashing.signed_header_1.message
    h2 = slashing.signed_header_2.message
    if h1.slot != h2.slot:
        raise BlockProcessingError("proposer slashing: slot mismatch")
    if h1.proposer_index != h2.proposer_index:
        raise BlockProcessingError("proposer slashing: proposer mismatch")
    if h1 == h2:
        raise BlockProcessingError("proposer slashing: identical headers")
    proposer = state.validators[h1.proposer_index]
    if not is_slashable_validator(proposer, get_current_epoch(state, spec)):
        raise BlockProcessingError("proposer slashing: not slashable")
    collector.add_many(
        lambda: sigsets.proposer_slashing_sets(state, slashing, pubkey_for, spec)
    )
    slash_validator(state, h1.proposer_index, spec, fork)


def _check_indexed_attestation(
    state, indexed, spec, pubkey_for, collector
):
    indices = list(indexed.attesting_indices)
    if not indices:
        raise BlockProcessingError("indexed attestation: empty")
    if indices != sorted(set(indices)):
        raise BlockProcessingError("indexed attestation: not sorted/unique")
    collector.add(
        lambda: sigsets.indexed_attestation_set(state, indexed, pubkey_for, spec)
    )


def process_attester_slashing(
    state, slashing, spec, fork, pubkey_for, collector
):
    a1, a2 = slashing.attestation_1, slashing.attestation_2
    if not is_slashable_attestation_data(a1.data, a2.data):
        raise BlockProcessingError("attester slashing: not slashable data")
    _check_indexed_attestation(state, a1, spec, pubkey_for, collector)
    _check_indexed_attestation(state, a2, spec, pubkey_for, collector)
    slashed_any = False
    current = get_current_epoch(state, spec)
    common = sorted(
        set(a1.attesting_indices) & set(a2.attesting_indices)
    )
    for idx in common:
        if is_slashable_validator(state.validators[idx], current):
            slash_validator(state, idx, spec, fork)
            slashed_any = True
    if not slashed_any:
        raise BlockProcessingError("attester slashing: nobody slashed")


def _validate_attestation_common(state, att, spec, consts):
    data = att.data
    current = get_current_epoch(state, spec)
    previous = get_previous_epoch(state, spec)
    if data.target.epoch not in (previous, current):
        raise BlockProcessingError("attestation: bad target epoch")
    if data.target.epoch != spec.slot_to_epoch(data.slot):
        raise BlockProcessingError("attestation: target/slot mismatch")
    if not (
        data.slot + spec.MIN_ATTESTATION_INCLUSION_DELAY
        <= state.slot
        <= data.slot + spec.SLOTS_PER_EPOCH
    ):
        raise BlockProcessingError("attestation: inclusion window")
    epoch_cache = consts.committee_cache(data.target.epoch)
    if data.index >= epoch_cache.committees_per_slot:
        raise BlockProcessingError("attestation: bad committee index")
    committee = epoch_cache.get_beacon_committee(data.slot, data.index)
    if len(att.aggregation_bits) != len(committee):
        raise BlockProcessingError("attestation: bits length mismatch")
    return committee


def _indexed_from_attestation(state, att, committee, spec):
    from lighthouse_tpu_torch.types.containers import types_for

    t = types_for(spec)
    return t.IndexedAttestation(
        attesting_indices=get_attesting_indices(
            committee, att.aggregation_bits
        ),
        data=att.data,
        signature=att.signature,
    )


def process_attestation(state, att, spec, fork, pubkey_for, collector, consts):
    committee = _validate_attestation_common(state, att, spec, consts)
    indexed = _indexed_from_attestation(state, att, committee, spec)
    _check_indexed_attestation(state, indexed, spec, pubkey_for, collector)

    if fork == "phase0":
        _apply_attestation_phase0(state, att, spec, consts)
    else:
        _apply_attestation_altair(state, att, indexed, spec, consts)


def _apply_attestation_phase0(state, att, spec, consts):
    from lighthouse_tpu_torch.types.containers import types_for

    t = types_for(spec)
    data = att.data
    pending = t.PendingAttestation(
        aggregation_bits=list(att.aggregation_bits),
        data=data,
        inclusion_delay=state.slot - data.slot,
        proposer_index=consts.proposer_index,
    )
    if data.target.epoch == get_current_epoch(state, spec):
        if data.source != state.current_justified_checkpoint:
            raise BlockProcessingError("attestation: wrong source (current)")
        state.current_epoch_attestations.append(pending)
    else:
        if data.source != state.previous_justified_checkpoint:
            raise BlockProcessingError("attestation: wrong source (previous)")
        state.previous_epoch_attestations.append(pending)


def get_attestation_participation_flags(
    state, data, inclusion_delay, spec
):
    """Altair: which timeliness flags does this attestation earn."""
    current = get_current_epoch(state, spec)
    if data.target.epoch == current:
        justified = state.current_justified_checkpoint
    else:
        justified = state.previous_justified_checkpoint
    is_matching_source = data.source == justified
    if not is_matching_source:
        raise BlockProcessingError("attestation: source mismatch")
    is_matching_target = is_matching_source and bytes(
        data.target.root
    ) == bytes(get_block_root(state, data.target.epoch, spec))
    is_matching_head = is_matching_target and bytes(
        data.beacon_block_root
    ) == bytes(get_block_root_at_slot(state, data.slot, spec))

    flags = []
    if is_matching_source and inclusion_delay <= integer_squareroot(
        spec.SLOTS_PER_EPOCH
    ):
        flags.append(TIMELY_SOURCE_FLAG_INDEX)
    if is_matching_target and inclusion_delay <= spec.SLOTS_PER_EPOCH:
        flags.append(TIMELY_TARGET_FLAG_INDEX)
    if (
        is_matching_head
        and inclusion_delay == spec.MIN_ATTESTATION_INCLUSION_DELAY
    ):
        flags.append(TIMELY_HEAD_FLAG_INDEX)
    return flags


def get_base_reward_per_increment(total_active_balance: int, spec) -> int:
    return (
        spec.EFFECTIVE_BALANCE_INCREMENT
        * spec.BASE_REWARD_FACTOR
        // integer_squareroot(total_active_balance)
    )


def get_base_reward_altair(state, index, spec) -> int:
    increments = (
        state.validators[index].effective_balance
        // spec.EFFECTIVE_BALANCE_INCREMENT
    )
    return increments * get_base_reward_per_increment(
        get_total_active_balance(state, spec), spec
    )


def _apply_attestation_altair(state, att, indexed, spec, consts):
    data = att.data
    inclusion_delay = state.slot - data.slot
    flags = get_attestation_participation_flags(
        state, data, inclusion_delay, spec
    )
    if data.target.epoch == get_current_epoch(state, spec):
        participation = state.current_epoch_participation
    else:
        participation = state.previous_epoch_participation

    per_increment = consts.base_reward_per_increment
    inc = spec.EFFECTIVE_BALANCE_INCREMENT
    proposer_reward_numerator = 0
    for idx in indexed.attesting_indices:
        base_reward = None
        for flag_index in flags:
            if not participation[idx] & (1 << flag_index):
                participation[idx] |= 1 << flag_index
                if base_reward is None:  # get_base_reward_altair
                    base_reward = (
                        state.validators[idx].effective_balance // inc * per_increment
                    )
                proposer_reward_numerator += (
                    base_reward * PARTICIPATION_FLAG_WEIGHTS[flag_index]
                )

    proposer_reward_denominator = (
        (WEIGHT_DENOMINATOR - PROPOSER_WEIGHT)
        * WEIGHT_DENOMINATOR
        // PROPOSER_WEIGHT
    )
    proposer_reward = proposer_reward_numerator // proposer_reward_denominator
    increase_balance(state, consts.proposer_index, proposer_reward)


# --------------------------------------------------------------- deposits


def process_deposit(
    state, deposit, spec, fork, pubkey_cache, collector=None, device="cuda",
):
    leaf = type(deposit.data).hash_tree_root(deposit.data)
    if not verify_merkle_proof(
        leaf,
        list(deposit.proof),
        state.eth1_deposit_index,
        bytes(state.eth1_data.deposit_root),
    ):
        raise BlockProcessingError("deposit: bad merkle proof")
    state.eth1_deposit_index += 1
    apply_deposit(
        state, deposit.data, spec, fork, pubkey_cache,
        collector=collector, device=device,
    )


def apply_deposit(
    state, deposit_data, spec, fork, pubkey_cache, collector=None,
    device="cuda",
):
    """A new validator's deposit signature is checked INDIVIDUALLY, and an
    invalid one skips the deposit without failing the block. It verifies
    on the default backend (spec semantics), on `device`; attribution
    rides the enclosing collector's consumer/journal when block processing
    supplies one (genesis passes none)."""
    pubkey_cache.import_new(state)
    pk_bytes = bytes(deposit_data.pubkey)
    existing = pubkey_cache.index_of(pk_bytes)
    if existing is not None:
        increase_balance(state, existing, deposit_data.amount)
        return
    try:
        sset = sigsets.deposit_set(deposit_data, spec)
    except bls.BlsError:
        return
    backend = bls.api.default_backend()
    bus = getattr(collector, "bus", None)
    if bus is not None:
        # deposit checks stay on the default backend even when the
        # routing bus serves a chain on another one
        ok = bus.submit(
            [sset],
            consumer=getattr(collector, "consumer", None),
            journal=getattr(collector, "journal", None),
            slot=getattr(collector, "slot", None),
            backend=backend,
        )
    else:
        ok = bls.verify_signature_sets(
            [sset],
            backend=backend,
            device=device,
            consumer=getattr(collector, "consumer", None),
            journal=getattr(collector, "journal", None),
            slot=getattr(collector, "slot", None),
        )
    if ok:
        _add_validator(state, deposit_data, spec, fork)


def _add_validator(state, deposit_data, spec, fork):
    from lighthouse_tpu_torch.types.containers import types_for

    t = types_for(spec)
    amount = deposit_data.amount
    effective = min(
        amount - amount % spec.EFFECTIVE_BALANCE_INCREMENT,
        spec.MAX_EFFECTIVE_BALANCE,
    )
    state.validators.append(
        t.Validator(
            pubkey=deposit_data.pubkey,
            withdrawal_credentials=deposit_data.withdrawal_credentials,
            effective_balance=effective,
            slashed=False,
            activation_eligibility_epoch=FAR_FUTURE_EPOCH,
            activation_epoch=FAR_FUTURE_EPOCH,
            exit_epoch=FAR_FUTURE_EPOCH,
            withdrawable_epoch=FAR_FUTURE_EPOCH,
        )
    )
    state.balances.append(amount)
    if fork != "phase0":
        state.previous_epoch_participation.append(0)
        state.current_epoch_participation.append(0)
        state.inactivity_scores.append(0)


# ------------------------------------------------------------------ exits


def process_voluntary_exit(state, signed_exit, spec, pubkey_for, collector):
    exit_msg = signed_exit.message
    v = state.validators[exit_msg.validator_index]
    current = get_current_epoch(state, spec)
    if not is_active_validator(v, current):
        raise BlockProcessingError("exit: validator not active")
    if v.exit_epoch != FAR_FUTURE_EPOCH:
        raise BlockProcessingError("exit: already exiting")
    if current < exit_msg.epoch:
        raise BlockProcessingError("exit: epoch in the future")
    if current < v.activation_epoch + spec.SHARD_COMMITTEE_PERIOD:
        raise BlockProcessingError("exit: too early in validator lifetime")
    collector.add(
        lambda: sigsets.voluntary_exit_set(state, signed_exit, pubkey_for, spec)
    )
    initiate_validator_exit(state, exit_msg.validator_index, spec)


# --------------------------------------------------------- sync aggregate


def process_sync_aggregate(
    state, aggregate, pubkey_cache, spec, collector, consts
):
    block_root = bytes(
        get_block_root_at_slot(state, max(state.slot, 1) - 1, spec)
    )
    collector.add(
        lambda: sigsets.sync_aggregate_set(
            state,
            aggregate,
            state.slot,
            block_root,
            pubkey_cache.get_by_bytes,
            spec,
        )
    )

    total_active_increments = (
        consts.total_active_balance // spec.EFFECTIVE_BALANCE_INCREMENT
    )
    total_base_rewards = (
        consts.base_reward_per_increment * total_active_increments
    )
    max_participant_rewards = (
        total_base_rewards
        * SYNC_REWARD_WEIGHT
        // WEIGHT_DENOMINATOR
        // spec.SLOTS_PER_EPOCH
    )
    participant_reward = max_participant_rewards // spec.SYNC_COMMITTEE_SIZE
    proposer_reward = (
        participant_reward
        * PROPOSER_WEIGHT
        // (WEIGHT_DENOMINATOR - PROPOSER_WEIGHT)
    )

    proposer_index = consts.proposer_index
    for pk, bit in zip(
        state.current_sync_committee.pubkeys,
        aggregate.sync_committee_bits,
    ):
        idx = pubkey_cache.index_of(bytes(pk))
        if idx is None:
            raise BlockProcessingError("sync aggregate: unknown pubkey")
        if bit:
            increase_balance(state, idx, participant_reward)
            increase_balance(state, proposer_index, proposer_reward)
        else:
            decrease_balance(state, idx, participant_reward)
