"""Sync-committee computation (altair spec `get_next_sync_committee`).

Role of the reference's sync-committee machinery in
consensus/types/src/beacon_state.rs (sync committee caches) and
per_epoch_processing sync-committee updates.
"""

from lighthouse_tpu_torch.state_processing.helpers import (
    get_active_validator_indices,
    get_current_epoch,
    get_seed,
    hash32,
    uint_to_bytes8,
)
from lighthouse_tpu_torch.shuffling import compute_shuffled_index
from lighthouse_tpu_torch.types.containers import types_for
from lighthouse_tpu_torch.types.spec import Spec


def get_next_sync_committee_indices(state, spec: Spec):
    """Balance-weighted sampling of SYNC_COMMITTEE_SIZE validators (with
    repetition) for the next sync-committee period."""
    epoch = get_current_epoch(state, spec) + 1
    MAX_RANDOM_BYTE = 255
    active = get_active_validator_indices(state, epoch)
    n = len(active)
    seed = get_seed(state, epoch, spec.DOMAIN_SYNC_COMMITTEE, spec)
    i = 0
    out = []
    while len(out) < spec.SYNC_COMMITTEE_SIZE:
        shuffled_index = compute_shuffled_index(
            i % n, n, seed, spec.SHUFFLE_ROUND_COUNT
        )
        candidate = active[shuffled_index]
        random_byte = hash32(seed + uint_to_bytes8(i // 32))[i % 32]
        eb = state.validators[candidate].effective_balance
        if eb * MAX_RANDOM_BYTE >= spec.MAX_EFFECTIVE_BALANCE * random_byte:
            out.append(candidate)
        i += 1
    return out


def get_next_sync_committee(state, spec: Spec):
    from lighthouse_tpu_torch.bls import aggregate_pubkeys_bytes

    t = types_for(spec)
    indices = get_next_sync_committee_indices(state, spec)
    pubkeys = [bytes(state.validators[i].pubkey) for i in indices]
    return t.SyncCommittee(
        pubkeys=pubkeys,
        aggregate_pubkey=aggregate_pubkeys_bytes(pubkeys),
    )
