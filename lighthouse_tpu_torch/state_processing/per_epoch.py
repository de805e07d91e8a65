"""Epoch transition (phase0 + altair).

Role of consensus/state_processing/src/per_epoch_processing.rs: phase0 uses
the validator-statuses pass over PendingAttestations
(base/validator_statuses.rs, base/rewards_and_penalties.rs); altair uses the
participation-flag form (altair/participation_cache.rs analog — here a
single `_AltairContext` pass). Shared tail: registry updates, slashings,
effective-balance hysteresis, vector resets, historical accumulation,
sync-committee rotation.
"""

from lighthouse_tpu_torch.state_processing.helpers import (
    CommitteeCache,
    compute_activation_exit_epoch,
    decrease_balance,
    get_active_validator_indices,
    get_attesting_indices,
    get_block_root,
    get_block_root_at_slot,
    get_current_epoch,
    get_previous_epoch,
    get_randao_mix,
    get_total_active_balance,
    get_total_balance,
    get_validator_churn_limit,
    increase_balance,
    integer_squareroot,
    is_active_validator,
)
from lighthouse_tpu_torch.types.spec import (
    FAR_FUTURE_EPOCH,
    GENESIS_EPOCH,
    PARTICIPATION_FLAG_WEIGHTS,
    TIMELY_HEAD_FLAG_INDEX,
    TIMELY_SOURCE_FLAG_INDEX,
    TIMELY_TARGET_FLAG_INDEX,
    WEIGHT_DENOMINATOR,
    Spec,
)

BASE_REWARDS_PER_EPOCH = 4


def fork_of(state, spec) -> str:
    return spec.fork_name_at_epoch(get_current_epoch(state, spec))


def process_epoch(state, spec: Spec, device="cuda"):
    """The epoch transition. On altair and later, every epoch after
    genesis runs inactivity updates and rewards as one pass on `device`
    (`epoch_kernel.run_inactivity_and_rewards`: the CUDA kernel on "cuda",
    its plain version on "cpu"); the spec's Python passes run only when
    the state lies outside that pass's int64 envelope."""
    fork = fork_of(state, spec)
    if fork == "phase0":
        ctx = _Phase0Context(state, spec)
        process_justification_and_finalization_phase0(state, spec, ctx)
        process_rewards_and_penalties_phase0(state, spec, ctx)
        process_registry_updates(state, spec)
        process_slashings(state, spec, fork)
        _process_final_updates(state, spec, fork)
    else:
        ctx = _AltairContext(state, spec)
        process_justification_and_finalization_altair(state, spec, ctx)
        if get_current_epoch(state, spec) != GENESIS_EPOCH:
            from lighthouse_tpu_torch.state_processing import epoch_kernel

            if not epoch_kernel.run_inactivity_and_rewards(
                state, spec, ctx, device=device
            ):
                process_inactivity_updates(state, spec, ctx)
                process_rewards_and_penalties_altair(state, spec, ctx)
        process_registry_updates(state, spec)
        process_slashings(state, spec, fork)
        _process_final_updates(state, spec, fork)


# ------------------------------------------------------------ shared bits


def get_eligible_validator_indices(state, spec):
    prev = get_previous_epoch(state, spec)
    return [
        i
        for i, v in enumerate(state.validators)
        if is_active_validator(v, prev)
        or (v.slashed and prev + 1 < v.withdrawable_epoch)
    ]


def is_in_inactivity_leak(state, spec) -> bool:
    return (
        get_previous_epoch(state, spec)
        - state.finalized_checkpoint.epoch
    ) > spec.MIN_EPOCHS_TO_INACTIVITY_PENALTY


def get_base_reward_phase0(state, index, total_balance_sqrt, spec) -> int:
    return (
        state.validators[index].effective_balance
        * spec.BASE_REWARD_FACTOR
        // total_balance_sqrt
        // BASE_REWARDS_PER_EPOCH
    )


def _weigh_justification_and_finalization(
    state, total_balance, prev_target_balance, cur_target_balance, spec
):
    from lighthouse_tpu_torch.types.containers import types_for

    t = types_for(spec)
    current = get_current_epoch(state, spec)
    previous = get_previous_epoch(state, spec)

    old_previous_justified = state.previous_justified_checkpoint
    old_current_justified = state.current_justified_checkpoint

    state.previous_justified_checkpoint = state.current_justified_checkpoint
    bits = list(state.justification_bits)
    bits = [False] + bits[:-1]
    if prev_target_balance * 3 >= total_balance * 2:
        state.current_justified_checkpoint = t.Checkpoint(
            epoch=previous, root=get_block_root(state, previous, spec)
        )
        bits[1] = True
    if cur_target_balance * 3 >= total_balance * 2:
        state.current_justified_checkpoint = t.Checkpoint(
            epoch=current, root=get_block_root(state, current, spec)
        )
        bits[0] = True
    state.justification_bits = bits

    # finalization
    if all(bits[1:4]) and old_previous_justified.epoch + 3 == current:
        state.finalized_checkpoint = old_previous_justified
    if all(bits[1:3]) and old_previous_justified.epoch + 2 == current:
        state.finalized_checkpoint = old_previous_justified
    if all(bits[0:3]) and old_current_justified.epoch + 2 == current:
        state.finalized_checkpoint = old_current_justified
    if all(bits[0:2]) and old_current_justified.epoch + 1 == current:
        state.finalized_checkpoint = old_current_justified


# ---------------------------------------------------------------- phase0


class _Phase0Context:
    """One pass over pending attestations -> per-validator flags + epoch
    balances (the validator_statuses.rs analog)."""

    def __init__(self, state, spec):
        self.spec = spec
        prev_epoch = get_previous_epoch(state, spec)
        cur_epoch = get_current_epoch(state, spec)
        self.prev_cache = CommitteeCache(state, prev_epoch, spec)
        self.cur_cache = CommitteeCache(state, cur_epoch, spec)

        n = len(state.validators)
        self.source_attester = [False] * n
        self.target_attester = [False] * n
        self.head_attester = [False] * n
        self.cur_target_attester = [False] * n
        # (inclusion_delay, proposer) per source attester, minimal delay
        self.inclusion = {}

        try:
            prev_target_root = bytes(get_block_root(state, prev_epoch, spec))
        except AssertionError:
            prev_target_root = None
        try:
            cur_target_root = bytes(get_block_root(state, cur_epoch, spec))
        except AssertionError:
            cur_target_root = None

        for att in state.previous_epoch_attestations:
            cache = self.prev_cache
            committee = cache.get_beacon_committee(
                att.data.slot, att.data.index
            )
            indices = get_attesting_indices(committee, att.aggregation_bits)
            is_target = (
                prev_target_root is not None
                and bytes(att.data.target.root) == prev_target_root
            )
            try:
                head_root = bytes(
                    get_block_root_at_slot(state, att.data.slot, spec)
                )
            except AssertionError:
                head_root = None
            is_head = (
                is_target
                and head_root is not None
                and bytes(att.data.beacon_block_root) == head_root
            )
            for i in indices:
                self.source_attester[i] = True
                prev_best = self.inclusion.get(i)
                entry = (att.inclusion_delay, att.proposer_index)
                if prev_best is None or entry[0] < prev_best[0]:
                    self.inclusion[i] = entry
                if is_target:
                    self.target_attester[i] = True
                if is_head:
                    self.head_attester[i] = True

        for att in state.current_epoch_attestations:
            committee = self.cur_cache.get_beacon_committee(
                att.data.slot, att.data.index
            )
            indices = get_attesting_indices(committee, att.aggregation_bits)
            if (
                cur_target_root is not None
                and bytes(att.data.target.root) == cur_target_root
            ):
                for i in indices:
                    self.cur_target_attester[i] = True

        self.unslashed = [not v.slashed for v in state.validators]

    def attesting_balance(self, state, flag_list):
        return get_total_balance(
            state,
            [
                i
                for i, f in enumerate(flag_list)
                if f and self.unslashed[i]
            ],
            self.spec,
        )


def process_justification_and_finalization_phase0(state, spec, ctx):
    if get_current_epoch(state, spec) <= GENESIS_EPOCH + 1:
        return
    total = get_total_active_balance(state, spec)
    prev_target = ctx.attesting_balance(state, ctx.target_attester)
    cur_target = ctx.attesting_balance(state, ctx.cur_target_attester)
    _weigh_justification_and_finalization(
        state, total, prev_target, cur_target, spec
    )


def process_rewards_and_penalties_phase0(state, spec, ctx):
    if get_current_epoch(state, spec) == GENESIS_EPOCH:
        return
    total = get_total_active_balance(state, spec)
    sqrt_total = integer_squareroot(total)
    increment = spec.EFFECTIVE_BALANCE_INCREMENT
    eligible = get_eligible_validator_indices(state, spec)
    leak = is_in_inactivity_leak(state, spec)
    finality_delay = (
        get_previous_epoch(state, spec) - state.finalized_checkpoint.epoch
    )

    rewards = [0] * len(state.validators)
    penalties = [0] * len(state.validators)

    components = [
        (ctx.source_attester,),
        (ctx.target_attester,),
        (ctx.head_attester,),
    ]
    for (flags,) in components:
        attesting_balance = ctx.attesting_balance(state, flags)
        for i in eligible:
            base = get_base_reward_phase0(state, i, sqrt_total, spec)
            if flags[i] and ctx.unslashed[i]:
                if leak:
                    rewards[i] += base
                else:
                    rewards[i] += (
                        base
                        * (attesting_balance // increment)
                        // (total // increment)
                    )
            else:
                penalties[i] += base

    # inclusion-delay rewards (proposer + attester), leak-independent
    for i in eligible:
        if ctx.source_attester[i] and ctx.unslashed[i] and i in ctx.inclusion:
            delay, proposer = ctx.inclusion[i]
            base = get_base_reward_phase0(state, i, sqrt_total, spec)
            proposer_reward = base // spec.PROPOSER_REWARD_QUOTIENT
            rewards[proposer] += proposer_reward
            max_attester_reward = base - proposer_reward
            rewards[i] += max_attester_reward // delay

    if leak:
        for i in eligible:
            base = get_base_reward_phase0(state, i, sqrt_total, spec)
            proposer_reward = base // spec.PROPOSER_REWARD_QUOTIENT
            penalties[i] += BASE_REWARDS_PER_EPOCH * base - proposer_reward
            if not (ctx.target_attester[i] and ctx.unslashed[i]):
                penalties[i] += (
                    state.validators[i].effective_balance
                    * finality_delay
                    // spec.INACTIVITY_PENALTY_QUOTIENT
                )

    for i in range(len(state.validators)):
        increase_balance(state, i, rewards[i])
        decrease_balance(state, i, penalties[i])


# ---------------------------------------------------------------- altair


class _AltairContext:
    """Participation-flag epoch context (participation_cache.rs analog)."""

    def __init__(self, state, spec):
        self.spec = spec
        self.prev_epoch = get_previous_epoch(state, spec)
        self.cur_epoch = get_current_epoch(state, spec)

    def unslashed_participating_indices(self, state, flag_index, epoch):
        if epoch == self.cur_epoch:
            participation = state.current_epoch_participation
        else:
            participation = state.previous_epoch_participation
        return [
            i
            for i, v in enumerate(state.validators)
            if is_active_validator(v, epoch)
            and not v.slashed
            and participation[i] & (1 << flag_index)
        ]


def process_justification_and_finalization_altair(state, spec, ctx):
    if get_current_epoch(state, spec) <= GENESIS_EPOCH + 1:
        return
    total = get_total_active_balance(state, spec)
    prev_target = get_total_balance(
        state,
        ctx.unslashed_participating_indices(
            state, TIMELY_TARGET_FLAG_INDEX, ctx.prev_epoch
        ),
        spec,
    )
    cur_target = get_total_balance(
        state,
        ctx.unslashed_participating_indices(
            state, TIMELY_TARGET_FLAG_INDEX, ctx.cur_epoch
        ),
        spec,
    )
    _weigh_justification_and_finalization(
        state, total, prev_target, cur_target, spec
    )


def process_inactivity_updates(state, spec, ctx):
    if get_current_epoch(state, spec) == GENESIS_EPOCH:
        return
    target_participants = set(
        ctx.unslashed_participating_indices(
            state, TIMELY_TARGET_FLAG_INDEX, ctx.prev_epoch
        )
    )
    leak = is_in_inactivity_leak(state, spec)
    for i in get_eligible_validator_indices(state, spec):
        score = state.inactivity_scores[i]
        if i in target_participants:
            score -= min(1, score)
        else:
            score += spec.INACTIVITY_SCORE_BIAS
        if not leak:
            score -= min(spec.INACTIVITY_SCORE_RECOVERY_RATE, score)
        state.inactivity_scores[i] = score


def process_rewards_and_penalties_altair(state, spec, ctx):
    if get_current_epoch(state, spec) == GENESIS_EPOCH:
        return
    from lighthouse_tpu_torch.state_processing.per_block import (
        get_base_reward_altair,
    )

    total = get_total_active_balance(state, spec)
    increment = spec.EFFECTIVE_BALANCE_INCREMENT
    active_increments = total // increment
    eligible = get_eligible_validator_indices(state, spec)
    leak = is_in_inactivity_leak(state, spec)

    rewards = [0] * len(state.validators)
    penalties = [0] * len(state.validators)

    for flag_index, weight in enumerate(PARTICIPATION_FLAG_WEIGHTS):
        participating = set(
            ctx.unslashed_participating_indices(
                state, flag_index, ctx.prev_epoch
            )
        )
        participating_balance = get_total_balance(
            state, participating, spec
        )
        participating_increments = participating_balance // increment
        for i in eligible:
            base = get_base_reward_altair(state, i, spec)
            if i in participating:
                if not leak:
                    numerator = base * weight * participating_increments
                    rewards[i] += numerator // (
                        active_increments * WEIGHT_DENOMINATOR
                    )
            elif flag_index != TIMELY_HEAD_FLAG_INDEX:
                penalties[i] += base * weight // WEIGHT_DENOMINATOR

    # inactivity penalties (score-scaled)
    target_participants = set(
        ctx.unslashed_participating_indices(
            state, TIMELY_TARGET_FLAG_INDEX, ctx.prev_epoch
        )
    )
    for i in eligible:
        if i not in target_participants:
            numerator = (
                state.validators[i].effective_balance
                * state.inactivity_scores[i]
            )
            denominator = (
                spec.INACTIVITY_SCORE_BIAS
                * spec.inactivity_penalty_quotient_for(fork_of(state, spec))
            )
            penalties[i] += numerator // denominator

    for i in range(len(state.validators)):
        increase_balance(state, i, rewards[i])
        decrease_balance(state, i, penalties[i])


# ------------------------------------------------------ registry/slashing


def process_registry_updates(state, spec):
    current = get_current_epoch(state, spec)
    for i, v in enumerate(state.validators):
        if (
            v.activation_eligibility_epoch == FAR_FUTURE_EPOCH
            and v.effective_balance == spec.MAX_EFFECTIVE_BALANCE
        ):
            v.activation_eligibility_epoch = current + 1
        if (
            is_active_validator(v, current)
            and v.effective_balance <= spec.EJECTION_BALANCE
        ):
            from lighthouse_tpu_torch.state_processing.helpers import (
                initiate_validator_exit,
            )

            initiate_validator_exit(state, i, spec)

    queue = sorted(
        (
            i
            for i, v in enumerate(state.validators)
            if v.activation_eligibility_epoch <= state.finalized_checkpoint.epoch
            and v.activation_epoch == FAR_FUTURE_EPOCH
        ),
        key=lambda i: (
            state.validators[i].activation_eligibility_epoch,
            i,
        ),
    )
    for i in queue[: get_validator_churn_limit(state, spec)]:
        state.validators[i].activation_epoch = (
            compute_activation_exit_epoch(current, spec)
        )


def process_slashings(state, spec, fork):
    epoch = get_current_epoch(state, spec)
    total = get_total_active_balance(state, spec)
    mult = spec.proportional_slashing_multiplier_for(fork)
    adjusted = min(sum(state.slashings) * mult, total)
    increment = spec.EFFECTIVE_BALANCE_INCREMENT
    for i, v in enumerate(state.validators):
        if (
            v.slashed
            and epoch + spec.EPOCHS_PER_SLASHINGS_VECTOR // 2
            == v.withdrawable_epoch
        ):
            penalty = (
                v.effective_balance
                // increment
                * adjusted
                // total
                * increment
            )
            decrease_balance(state, i, penalty)


# ------------------------------------------------------------ final steps


def _process_final_updates(state, spec, fork):
    current = get_current_epoch(state, spec)
    next_epoch = current + 1

    # eth1 data votes reset
    if next_epoch % spec.EPOCHS_PER_ETH1_VOTING_PERIOD == 0:
        state.eth1_data_votes = []

    # effective balance hysteresis
    hysteresis_increment = (
        spec.EFFECTIVE_BALANCE_INCREMENT // spec.HYSTERESIS_QUOTIENT
    )
    downward = hysteresis_increment * spec.HYSTERESIS_DOWNWARD_MULTIPLIER
    upward = hysteresis_increment * spec.HYSTERESIS_UPWARD_MULTIPLIER
    for i, v in enumerate(state.validators):
        balance = state.balances[i]
        if (
            balance + downward < v.effective_balance
            or v.effective_balance + upward < balance
        ):
            v.effective_balance = min(
                balance - balance % spec.EFFECTIVE_BALANCE_INCREMENT,
                spec.MAX_EFFECTIVE_BALANCE,
            )

    # slashings + randao reset
    state.slashings[
        next_epoch % spec.EPOCHS_PER_SLASHINGS_VECTOR
    ] = 0
    state.randao_mixes[
        next_epoch % spec.EPOCHS_PER_HISTORICAL_VECTOR
    ] = get_randao_mix(state, current, spec)

    # historical accumulation
    epochs_per_historical_root = (
        spec.SLOTS_PER_HISTORICAL_ROOT // spec.SLOTS_PER_EPOCH
    )
    if next_epoch % epochs_per_historical_root == 0:
        from lighthouse_tpu_torch.types.containers import types_for

        t = types_for(spec)
        batch = t.HistoricalBatch(
            block_roots=list(state.block_roots),
            state_roots=list(state.state_roots),
        )
        state.historical_roots.append(
            t.HistoricalBatch.hash_tree_root(batch)
        )

    # participation rotation
    if fork == "phase0":
        state.previous_epoch_attestations = (
            state.current_epoch_attestations
        )
        state.current_epoch_attestations = []
    else:
        state.previous_epoch_participation = (
            state.current_epoch_participation
        )
        state.current_epoch_participation = [0] * len(state.validators)
        # sync committee rotation
        if next_epoch % spec.EPOCHS_PER_SYNC_COMMITTEE_PERIOD == 0:
            from lighthouse_tpu_torch.state_processing.sync_committees import (
                get_next_sync_committee,
            )

            state.current_sync_committee = state.next_sync_committee
            state.next_sync_committee = get_next_sync_committee(state, spec)
