"""Per-slot processing and slot advancement with epoch/fork boundaries.

Role of consensus/state_processing/src/per_slot_processing.rs and the
upgrade functions (upgrade_to_altair): cache state/block roots into the
rolling vectors, run the epoch transition on boundaries, and upgrade the
state representation when crossing a fork epoch.
"""

from lighthouse_tpu_torch.ssz.hashing import ZERO_BYTES32
from lighthouse_tpu_torch.types.containers import types_for
from lighthouse_tpu_torch.types.spec import Spec


def state_root(state) -> bytes:
    """Incremental state root (ssz/cached_hash.py) — the per-slot root in
    process_slot is the hottest hash site in the client; the cache makes
    it O(changes · log n) instead of a full-state rehash
    (consensus/cached_tree_hash/src/cache.rs role)."""
    from lighthouse_tpu_torch.ssz.cached_hash import cached_state_root

    return cached_state_root(state)


def process_slot(state, spec: Spec):
    previous_state_root = state_root(state)
    state.state_roots[
        state.slot % spec.SLOTS_PER_HISTORICAL_ROOT
    ] = previous_state_root
    if state.latest_block_header.state_root == ZERO_BYTES32:
        state.latest_block_header.state_root = previous_state_root
    previous_block_root = type(
        state.latest_block_header
    ).hash_tree_root(state.latest_block_header)
    state.block_roots[
        state.slot % spec.SLOTS_PER_HISTORICAL_ROOT
    ] = previous_block_root


def process_slots(state, slot: int, spec: Spec, device="cuda"):
    """Advance state to `slot` (exclusive of block processing). Returns the
    (possibly fork-upgraded) state — callers must use the return value.
    An epoch boundary's rewards pass runs on `device` (per_epoch.py)."""
    assert state.slot <= slot, "cannot rewind slots"
    while state.slot < slot:
        process_slot(state, spec)
        next_slot = state.slot + 1
        if next_slot % spec.SLOTS_PER_EPOCH == 0:
            from lighthouse_tpu_torch.state_processing.per_epoch import (
                process_epoch,
            )

            process_epoch(state, spec, device=device)
        state.slot = next_slot
        # fork upgrade on the first slot of the fork epoch
        if next_slot % spec.SLOTS_PER_EPOCH == 0:
            epoch = spec.slot_to_epoch(next_slot)
            if epoch == spec.ALTAIR_FORK_EPOCH:
                state = upgrade_to_altair(state, spec)
            if epoch == spec.BELLATRIX_FORK_EPOCH:
                state = upgrade_to_bellatrix(state, spec)
    return state


def per_slot_processing(state, spec: Spec, device="cuda"):
    """Single-slot tick (reference per_slot_processing.rs)."""
    return process_slots(state, state.slot + 1, spec, device=device)


def upgrade_to_altair(state, spec: Spec):
    """Translate a phase0 state into the altair representation at the fork
    boundary (spec upgrade_to_altair; reference
    consensus/state_processing/src/upgrade/altair.rs)."""
    t = types_for(spec)
    n = len(state.validators)
    from lighthouse_tpu_torch.state_processing.sync_committees import (
        get_next_sync_committee,
    )
    from lighthouse_tpu_torch.state_processing.helpers import get_current_epoch

    new_state = t.BeaconStateAltair(
        genesis_time=state.genesis_time,
        genesis_validators_root=state.genesis_validators_root,
        slot=state.slot,
        fork=t.Fork(
            previous_version=state.fork.current_version,
            current_version=spec.ALTAIR_FORK_VERSION,
            epoch=get_current_epoch(state, spec),
        ),
        latest_block_header=state.latest_block_header,
        block_roots=list(state.block_roots),
        state_roots=list(state.state_roots),
        historical_roots=list(state.historical_roots),
        eth1_data=state.eth1_data,
        eth1_data_votes=list(state.eth1_data_votes),
        eth1_deposit_index=state.eth1_deposit_index,
        validators=list(state.validators),
        balances=list(state.balances),
        randao_mixes=list(state.randao_mixes),
        slashings=list(state.slashings),
        previous_epoch_participation=[0] * n,
        current_epoch_participation=[0] * n,
        justification_bits=list(state.justification_bits),
        previous_justified_checkpoint=state.previous_justified_checkpoint,
        current_justified_checkpoint=state.current_justified_checkpoint,
        finalized_checkpoint=state.finalized_checkpoint,
        inactivity_scores=[0] * n,
    )
    sync_committee = get_next_sync_committee(new_state, spec)
    new_state.current_sync_committee = sync_committee
    new_state.next_sync_committee = get_next_sync_committee(new_state, spec)
    return new_state


def upgrade_to_bellatrix(state, spec: Spec):
    """Translate an altair state into the bellatrix representation at the
    fork boundary (spec upgrade_to_bellatrix; reference
    consensus/state_processing/src/upgrade/merge.rs): same fields plus an
    empty latest_execution_payload_header (pre-merge — filled by the first
    post-transition block)."""
    t = types_for(spec)
    from lighthouse_tpu_torch.state_processing.helpers import get_current_epoch

    new_state = t.BeaconStateBellatrix(
        genesis_time=state.genesis_time,
        genesis_validators_root=state.genesis_validators_root,
        slot=state.slot,
        fork=t.Fork(
            previous_version=state.fork.current_version,
            current_version=spec.BELLATRIX_FORK_VERSION,
            epoch=get_current_epoch(state, spec),
        ),
        latest_block_header=state.latest_block_header,
        block_roots=list(state.block_roots),
        state_roots=list(state.state_roots),
        historical_roots=list(state.historical_roots),
        eth1_data=state.eth1_data,
        eth1_data_votes=list(state.eth1_data_votes),
        eth1_deposit_index=state.eth1_deposit_index,
        validators=list(state.validators),
        balances=list(state.balances),
        randao_mixes=list(state.randao_mixes),
        slashings=list(state.slashings),
        previous_epoch_participation=list(
            state.previous_epoch_participation
        ),
        current_epoch_participation=list(state.current_epoch_participation),
        justification_bits=list(state.justification_bits),
        previous_justified_checkpoint=state.previous_justified_checkpoint,
        current_justified_checkpoint=state.current_justified_checkpoint,
        finalized_checkpoint=state.finalized_checkpoint,
        inactivity_scores=list(state.inactivity_scores),
        current_sync_committee=state.current_sync_committee,
        next_sync_committee=state.next_sync_committee,
        latest_execution_payload_header=t.ExecutionPayloadHeader(),
    )
    return new_state
