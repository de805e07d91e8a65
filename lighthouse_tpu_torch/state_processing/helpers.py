"""Beacon-state accessors, predicates, and mutators (spec helpers).

Role of the reference's consensus/state_processing/src/common + the
`BeaconState` accessor impl (consensus/types/src/beacon_state.rs): epochs,
seeds, active sets, balances, committee assignment, proposer sampling, and
the exit/slashing mutators. Committee shuffling is delegated to the
vectorized `lighthouse_tpu_torch.shuffling` and memoized in `CommitteeCache`.
"""

import hashlib

import numpy as np

from lighthouse_tpu_torch.shuffling import shuffled_active_indices
from lighthouse_tpu_torch.types.spec import FAR_FUTURE_EPOCH, Spec


def hash32(data: bytes) -> bytes:
    return hashlib.sha256(data).digest()


def integer_squareroot(n: int) -> int:
    x, y = n, (n + 1) // 2
    while y < x:
        x, y = y, (y + n // y) // 2
    return x


def uint_to_bytes8(n: int) -> bytes:
    return n.to_bytes(8, "little")


# ------------------------------------------------------------------- epochs


def get_current_epoch(state, spec: Spec) -> int:
    return spec.slot_to_epoch(state.slot)


def get_previous_epoch(state, spec: Spec) -> int:
    cur = get_current_epoch(state, spec)
    return cur - 1 if cur > 0 else 0


def compute_activation_exit_epoch(epoch: int, spec: Spec) -> int:
    return epoch + 1 + spec.MAX_SEED_LOOKAHEAD


# --------------------------------------------------------------- validators


def is_active_validator(v, epoch: int) -> bool:
    return v.activation_epoch <= epoch < v.exit_epoch


def is_slashable_validator(v, epoch: int) -> bool:
    return (not v.slashed) and (
        v.activation_epoch <= epoch < v.withdrawable_epoch
    )


def get_active_validator_indices(state, epoch: int):
    return [
        i
        for i, v in enumerate(state.validators)
        if is_active_validator(v, epoch)
    ]


def get_validator_churn_limit(state, spec: Spec) -> int:
    active = len(
        get_active_validator_indices(state, get_current_epoch(state, spec))
    )
    return max(
        spec.MIN_PER_EPOCH_CHURN_LIMIT, active // spec.CHURN_LIMIT_QUOTIENT
    )


# ----------------------------------------------------------------- balances


def get_total_balance(state, indices, spec: Spec) -> int:
    return max(
        spec.EFFECTIVE_BALANCE_INCREMENT,
        sum(state.validators[i].effective_balance for i in indices),
    )


def get_total_active_balance(state, spec: Spec) -> int:
    return get_total_balance(
        state,
        get_active_validator_indices(state, get_current_epoch(state, spec)),
        spec,
    )


def increase_balance(state, index: int, delta: int):
    state.balances[index] += delta


def decrease_balance(state, index: int, delta: int):
    state.balances[index] = max(0, state.balances[index] - delta)


# ------------------------------------------------------------ randao / seed


def get_randao_mix(state, epoch: int, spec: Spec) -> bytes:
    return state.randao_mixes[epoch % spec.EPOCHS_PER_HISTORICAL_VECTOR]


def get_seed(state, epoch: int, domain_type: bytes, spec: Spec) -> bytes:
    mix = get_randao_mix(
        state,
        epoch + spec.EPOCHS_PER_HISTORICAL_VECTOR - spec.MIN_SEED_LOOKAHEAD - 1,
        spec,
    )
    return hash32(domain_type + uint_to_bytes8(epoch) + mix)


# ------------------------------------------------------------- block roots


def get_block_root_at_slot(state, slot: int, spec: Spec) -> bytes:
    assert slot < state.slot <= slot + spec.SLOTS_PER_HISTORICAL_ROOT
    return state.block_roots[slot % spec.SLOTS_PER_HISTORICAL_ROOT]


def get_block_root(state, epoch: int, spec: Spec) -> bytes:
    return get_block_root_at_slot(state, spec.epoch_start_slot(epoch), spec)


# -------------------------------------------------------------- committees


def get_committee_count_per_slot(active_count: int, spec: Spec) -> int:
    return max(
        1,
        min(
            spec.MAX_COMMITTEES_PER_SLOT,
            active_count
            // spec.SLOTS_PER_EPOCH
            // spec.TARGET_COMMITTEE_SIZE,
        ),
    )


class CommitteeCache:
    """Per-epoch committee assignment: one shuffle, sliced into
    slots x committees — the analog of the reference's
    consensus/types/src/beacon_state/committee_cache.rs."""

    def __init__(self, state, epoch: int, spec: Spec):
        self.epoch = epoch
        self.spec = spec
        self.active = get_active_validator_indices(state, epoch)
        seed = get_seed(state, epoch, spec.DOMAIN_BEACON_ATTESTER, spec)
        self.seed = seed
        self.shuffled = shuffled_active_indices(
            np.asarray(self.active, dtype=np.int64),
            seed,
            spec.SHUFFLE_ROUND_COUNT,
        )
        self.committees_per_slot = get_committee_count_per_slot(
            len(self.active), spec
        )

    def get_beacon_committee(self, slot: int, index: int):
        spec = self.spec
        assert index < self.committees_per_slot
        committees_at_epoch = self.committees_per_slot * spec.SLOTS_PER_EPOCH
        committee_index = (
            (slot % spec.SLOTS_PER_EPOCH) * self.committees_per_slot + index
        )
        n = len(self.shuffled)
        start = n * committee_index // committees_at_epoch
        end = n * (committee_index + 1) // committees_at_epoch
        return self.shuffled[start:end].tolist()

    def committees_at_slot(self, slot: int):
        return [
            self.get_beacon_committee(slot, i)
            for i in range(self.committees_per_slot)
        ]


def compute_proposer_index(state, indices, seed: bytes, spec: Spec) -> int:
    """Effective-balance-weighted proposer sampling (spec algorithm)."""
    assert indices
    MAX_RANDOM_BYTE = 255
    i = 0
    total = len(indices)
    while True:
        from lighthouse_tpu_torch.shuffling import compute_shuffled_index

        shuffled_i = compute_shuffled_index(
            i % total, total, seed, spec.SHUFFLE_ROUND_COUNT
        )
        candidate = indices[shuffled_i]
        random_byte = hash32(seed + uint_to_bytes8(i // 32))[i % 32]
        eb = state.validators[candidate].effective_balance
        if eb * MAX_RANDOM_BYTE >= spec.MAX_EFFECTIVE_BALANCE * random_byte:
            return candidate
        i += 1


def get_beacon_proposer_index(state, spec: Spec) -> int:
    epoch = get_current_epoch(state, spec)
    seed = hash32(
        get_seed(state, epoch, spec.DOMAIN_BEACON_PROPOSER, spec)
        + uint_to_bytes8(state.slot)
    )
    indices = get_active_validator_indices(state, epoch)
    return compute_proposer_index(state, indices, seed, spec)


# ----------------------------------------------------------------- domains


def get_domain(state, domain_type: bytes, epoch, spec: Spec) -> bytes:
    from lighthouse_tpu_torch.types.helpers import compute_domain

    if epoch is None:
        epoch = get_current_epoch(state, spec)
    fork_version = (
        state.fork.previous_version
        if epoch < state.fork.epoch
        else state.fork.current_version
    )
    return compute_domain(
        domain_type, fork_version, state.genesis_validators_root
    )


# ------------------------------------------------------------ attestations


def get_attesting_indices(committee, aggregation_bits):
    assert len(committee) == len(aggregation_bits)
    return sorted(
        idx for idx, bit in zip(committee, aggregation_bits) if bit
    )


def is_slashable_attestation_data(d1, d2) -> bool:
    return (
        d1 != d2 and d1.target.epoch == d2.target.epoch
    ) or (
        d1.source.epoch < d2.source.epoch
        and d2.target.epoch < d1.target.epoch
    )


# ---------------------------------------------------------------- mutators


def initiate_validator_exit(state, index: int, spec: Spec):
    v = state.validators[index]
    if v.exit_epoch != FAR_FUTURE_EPOCH:
        return
    exit_epochs = [
        w.exit_epoch
        for w in state.validators
        if w.exit_epoch != FAR_FUTURE_EPOCH
    ]
    exit_queue_epoch = max(
        exit_epochs
        + [
            compute_activation_exit_epoch(
                get_current_epoch(state, spec), spec
            )
        ]
    )
    exit_queue_churn = sum(
        1 for w in state.validators if w.exit_epoch == exit_queue_epoch
    )
    if exit_queue_churn >= get_validator_churn_limit(state, spec):
        exit_queue_epoch += 1
    v.exit_epoch = exit_queue_epoch
    v.withdrawable_epoch = (
        exit_queue_epoch + spec.MIN_VALIDATOR_WITHDRAWABILITY_DELAY
    )


def slash_validator(
    state, slashed_index: int, spec: Spec, fork: str, whistleblower_index=None
):
    epoch = get_current_epoch(state, spec)
    initiate_validator_exit(state, slashed_index, spec)
    v = state.validators[slashed_index]
    v.slashed = True
    v.withdrawable_epoch = max(
        v.withdrawable_epoch, epoch + spec.EPOCHS_PER_SLASHINGS_VECTOR
    )
    state.slashings[epoch % spec.EPOCHS_PER_SLASHINGS_VECTOR] += (
        v.effective_balance
    )
    min_quot = spec.min_slashing_penalty_quotient_for(fork)
    decrease_balance(state, slashed_index, v.effective_balance // min_quot)

    proposer_index = get_beacon_proposer_index(state, spec)
    if whistleblower_index is None:
        whistleblower_index = proposer_index
    whistleblower_reward = (
        v.effective_balance // spec.WHISTLEBLOWER_REWARD_QUOTIENT
    )
    if fork == "phase0":
        proposer_reward = whistleblower_reward // spec.PROPOSER_REWARD_QUOTIENT
    else:
        from lighthouse_tpu_torch.types.spec import (
            PROPOSER_WEIGHT,
            WEIGHT_DENOMINATOR,
        )

        proposer_reward = (
            whistleblower_reward * PROPOSER_WEIGHT // WEIGHT_DENOMINATOR
        )
    increase_balance(state, proposer_index, proposer_reward)
    increase_balance(
        state, whistleblower_index, whistleblower_reward - proposer_reward
    )
