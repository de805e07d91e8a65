"""Genesis state construction (interop path + deposit path scaffolding).

The port of `lighthouse_tpu/state_processing/genesis.py`. The deposit
path checks each new validator's deposit signature on the default
backend, on `device` ("cuda" unless asked).

Role of the reference's genesis bootstrapping: `interop_genesis_state`
(beacon_node/genesis + beacon_chain test_utils.rs:47 deterministic keypair
genesis) — a state built directly from a pubkey list, skipping deposit
proofs, used by the in-process harness and simulators.
"""

from lighthouse_tpu_torch.ssz.hashing import ZERO_BYTES32
from lighthouse_tpu_torch.types.spec import FAR_FUTURE_EPOCH, GENESIS_EPOCH, Spec
from lighthouse_tpu_torch.types.containers import types_for


def genesis_fork(spec: Spec, t):
    """Fork container for the genesis epoch, honoring fork-at-genesis specs
    (e.g. altair-from-genesis test configs)."""
    name = spec.fork_name_at_epoch(GENESIS_EPOCH)
    version = spec.fork_version_at_epoch(GENESIS_EPOCH)
    return t.Fork(
        previous_version=version, current_version=version, epoch=GENESIS_EPOCH
    ), name


def interop_genesis_state(
    pubkeys,
    genesis_time: int,
    spec: Spec,
    eth1_block_hash: bytes = b"\x42" * 32,
):
    """Build a fully-valid genesis BeaconState from interop pubkeys.

    All validators are active from genesis with MAX_EFFECTIVE_BALANCE.
    """
    t = types_for(spec)
    fork, fork_name = genesis_fork(spec, t)
    state_cls = t.state_classes[fork_name]

    validators = []
    for pk in pubkeys:
        validators.append(
            t.Validator(
                pubkey=bytes(pk),
                withdrawal_credentials=b"\x00" * 32,
                effective_balance=spec.MAX_EFFECTIVE_BALANCE,
                slashed=False,
                activation_eligibility_epoch=GENESIS_EPOCH,
                activation_epoch=GENESIS_EPOCH,
                exit_epoch=FAR_FUTURE_EPOCH,
                withdrawable_epoch=FAR_FUTURE_EPOCH,
            )
        )

    body_cls = t.block_body_classes[fork_name]
    header = t.BeaconBlockHeader(
        slot=0,
        proposer_index=0,
        parent_root=ZERO_BYTES32,
        state_root=ZERO_BYTES32,
        body_root=body_cls.hash_tree_root(body_cls()),
    )

    state = state_cls(
        genesis_time=genesis_time,
        slot=0,
        fork=fork,
        latest_block_header=header,
        eth1_data=t.Eth1Data(
            deposit_root=ZERO_BYTES32,
            deposit_count=len(validators),
            block_hash=eth1_block_hash,
        ),
        eth1_deposit_index=len(validators),
        validators=validators,
        balances=[spec.MAX_EFFECTIVE_BALANCE] * len(validators),
        randao_mixes=[eth1_block_hash] * spec.EPOCHS_PER_HISTORICAL_VECTOR,
    )

    from lighthouse_tpu_torch import ssz

    validators_type = ssz.List(t.Validator, spec.VALIDATOR_REGISTRY_LIMIT)
    state.genesis_validators_root = validators_type.hash_tree_root(
        state.validators
    )

    if fork_name == "altair":
        _init_altair_fields(state, spec)
    return state


def _init_altair_fields(state, spec: Spec) -> None:
    """Zeroed participation and scores, and both sync committees."""
    from lighthouse_tpu_torch.state_processing.sync_committees import (
        get_next_sync_committee,
    )

    n = len(state.validators)
    state.previous_epoch_participation = [0] * n
    state.current_epoch_participation = [0] * n
    state.inactivity_scores = [0] * n
    state.current_sync_committee = get_next_sync_committee(state, spec)
    state.next_sync_committee = get_next_sync_committee(state, spec)


def empty_genesis_state(
    eth1_block_hash: bytes, eth1_timestamp: int, deposit_count: int,
    deposit_root: bytes, spec: Spec,
):
    """The pre-deposit scaffold shared by the deposit-contract path."""
    t = types_for(spec)
    fork, fork_name = genesis_fork(spec, t)
    state_cls = t.state_classes[fork_name]
    body_cls = t.block_body_classes[fork_name]
    header = t.BeaconBlockHeader(
        slot=0,
        proposer_index=0,
        parent_root=ZERO_BYTES32,
        state_root=ZERO_BYTES32,
        body_root=body_cls.hash_tree_root(body_cls()),
    )
    return state_cls(
        genesis_time=eth1_timestamp + spec.GENESIS_DELAY,
        slot=0,
        fork=fork,
        latest_block_header=header,
        eth1_data=t.Eth1Data(
            deposit_root=deposit_root,
            deposit_count=deposit_count,
            block_hash=eth1_block_hash,
        ),
        randao_mixes=[eth1_block_hash] * spec.EPOCHS_PER_HISTORICAL_VECTOR,
    ), fork_name


def initialize_beacon_state_from_eth1(
    eth1_block_hash: bytes, eth1_timestamp: int, deposits, spec: Spec,
    device="cuda",
):
    """Genesis from the deposit contract (`ClientGenesis::DepositContract`,
    beacon_node/client/src/config.rs:14-34 + beacon_node/genesis): apply
    every deposit — Merkle proof against the INCREMENTALLY growing
    deposit root, individually-verified deposit signatures (invalid ones
    skipped, not fatal) — then activate validators that reached
    MAX_EFFECTIVE_BALANCE.

    `deposits` are Deposit containers whose proofs were built by
    eth1.DepositTree (deposit_cache.rs's role)."""
    from lighthouse_tpu_torch.eth1.deposit_tree import DepositTree
    from lighthouse_tpu_torch.state_processing.per_block import process_deposit
    from lighthouse_tpu_torch.state_processing.pubkey_cache import PubkeyCache

    t = types_for(spec)
    tree = DepositTree()
    leaves = [type(d.data).hash_tree_root(d.data) for d in deposits]
    state, fork_name = empty_genesis_state(
        eth1_block_hash, eth1_timestamp, len(deposits),
        ZERO_BYTES32, spec,
    )
    cache = PubkeyCache(device=device)
    for deposit, leaf in zip(deposits, leaves):
        # the root grows with each leaf, exactly like the contract the
        # proofs were built against (phase0 spec initialize_* loop)
        tree.push(leaf)
        state.eth1_data.deposit_root = tree.root()
        process_deposit(state, deposit, spec, fork_name, cache, device=device)

    process_activations(state, spec)

    from lighthouse_tpu_torch import ssz

    validators_type = ssz.List(t.Validator, spec.VALIDATOR_REGISTRY_LIMIT)
    state.genesis_validators_root = validators_type.hash_tree_root(
        state.validators
    )
    if fork_name == "altair":
        _init_altair_fields(state, spec)
    return state


def process_activations(state, spec: Spec) -> None:
    """Genesis activation pass (phase0 spec `initialize_beacon_state_
    from_eth1` tail): recompute every validator's effective balance
    from its ACTUAL balance BEFORE the activation check. Deposit
    processing only sets effective_balance at validator creation, so a
    key funded by SPLIT deposits (e.g. two 16-ETH deposits) would
    otherwise sit at the first deposit's effective balance forever and
    never activate — a consensus-divergent genesis."""
    for i, v in enumerate(state.validators):
        balance = state.balances[i]
        v.effective_balance = min(
            balance - balance % spec.EFFECTIVE_BALANCE_INCREMENT,
            spec.MAX_EFFECTIVE_BALANCE,
        )
        if v.effective_balance == spec.MAX_EFFECTIVE_BALANCE:
            v.activation_eligibility_epoch = GENESIS_EPOCH
            v.activation_epoch = GENESIS_EPOCH


def is_valid_genesis_state(state, spec: Spec) -> bool:
    """Genesis trigger condition (phase0 spec is_valid_genesis_state):
    enough time past MIN_GENESIS_TIME and enough ACTIVE validators."""
    if state.genesis_time < spec.MIN_GENESIS_TIME:
        return False
    active = sum(
        1
        for v in state.validators
        if v.activation_epoch <= GENESIS_EPOCH < v.exit_epoch
    )
    return active >= spec.MIN_GENESIS_ACTIVE_VALIDATOR_COUNT


def genesis_deposits(deposit_datas, spec: Spec):
    """DepositData list -> Deposit list with INCREMENTAL Merkle proofs:
    deposit i is proven against the tree holding leaves 0..i, matching
    the growing root initialize_beacon_state_from_eth1 verifies
    (deposit_cache.rs builds proofs the same way)."""
    from lighthouse_tpu_torch.eth1.deposit_tree import DepositTree

    t = types_for(spec)
    tree = DepositTree()
    out = []
    for i, data in enumerate(deposit_datas):
        tree.push(type(data).hash_tree_root(data))
        out.append(t.Deposit(proof=tree.proof(i), data=data))
    return out


def genesis_from_eth1_cache(cache, spec: Spec, device="cuda"):
    """Scan cached eth1 blocks oldest-first for the first whose deposit
    log produces a valid genesis — the eth1-genesis service loop
    (beacon_node/genesis eth1 path driven by the deposit cache).
    Blocks that cannot possibly qualify (too few deposits for
    MIN_GENESIS_ACTIVE_VALIDATOR_COUNT, too early for MIN_GENESIS_TIME
    + GENESIS_DELAY) are skipped without building a state. `cache` is
    any object with `blocks` (each with `hash`, `timestamp` and
    `deposit_count`) and `deposit_data`, as the eth1 service's cache."""
    for block in cache.blocks:
        if block.deposit_count < spec.MIN_GENESIS_ACTIVE_VALIDATOR_COUNT:
            continue
        if block.timestamp + spec.GENESIS_DELAY < spec.MIN_GENESIS_TIME:
            continue
        datas = cache.deposit_data[: block.deposit_count]
        state = initialize_beacon_state_from_eth1(
            block.hash,
            block.timestamp,
            genesis_deposits(datas, spec),
            spec,
            device=device,
        )
        if is_valid_genesis_state(state, spec):
            return state
    return None
