"""Operation pool: aggregates, slashings, and exits awaiting block packing.

The port of `lighthouse_tpu/beacon_chain/operation_pool.py`.

Role of beacon_node/operation_pool (lib.rs:176 insert_attestation,
:276 get_attestations with greedy max-coverage packing via the MaxCover
trait, max_cover.rs:11,44; :396 get_slashings_and_exits). The attestation
packer solves weighted maximum coverage greedily: repeatedly take the
aggregate covering the most not-yet-covered attesting validators (weighted
by effective balance increments), re-scoring after each pick.
"""

from lighthouse_tpu_torch.state_processing.helpers import (
    CommitteeCache,
    get_attesting_indices,
    get_current_epoch,
    get_previous_epoch,
)


class OperationPool:
    def __init__(self, spec):
        self.spec = spec
        # data_root -> list[Attestation] (aggregates with distinct bitsets)
        self._attestations: dict[bytes, list] = {}
        self._attestation_data: dict[bytes, object] = {}
        self._proposer_slashings: dict[int, object] = {}
        self._attester_slashings: list = []
        self._voluntary_exits: dict[int, object] = {}

    # ------------------------------------------------------- attestations

    def insert_attestation(self, attestation):
        data = attestation.data
        root = type(data).hash_tree_root(data)
        self._attestation_data[root] = data
        bucket = self._attestations.setdefault(root, [])
        bits = list(attestation.aggregation_bits)
        for existing in bucket:
            eb = list(existing.aggregation_bits)
            if all(b or not n for n, b in zip(bits, eb)):
                return  # subset of an existing aggregate
        bucket.append(attestation.copy())

    def num_attestations(self) -> int:
        return sum(len(v) for v in self._attestations.values())

    def get_attestations(self, state, max_count: int):
        """Greedy weighted max-cover packing of aggregates valid for
        inclusion in a block built on `state`."""
        spec = self.spec
        current = get_current_epoch(state, spec)
        previous = get_previous_epoch(state, spec)
        caches = {}

        candidates = []
        for root, bucket in self._attestations.items():
            data = self._attestation_data[root]
            epoch = data.target.epoch
            if epoch not in (previous, current):
                continue
            if not (
                data.slot + spec.MIN_ATTESTATION_INCLUSION_DELAY
                <= state.slot
                <= data.slot + spec.SLOTS_PER_EPOCH
            ):
                continue
            # source must match the state's justified checkpoint
            justified = (
                state.current_justified_checkpoint
                if epoch == current
                else state.previous_justified_checkpoint
            )
            if data.source != justified:
                continue
            if epoch not in caches:
                caches[epoch] = CommitteeCache(state, epoch, spec)
            cache = caches[epoch]
            if data.index >= cache.committees_per_slot:
                continue
            committee = cache.get_beacon_committee(data.slot, data.index)
            for att in bucket:
                if len(att.aggregation_bits) != len(committee):
                    continue
                attesters = get_attesting_indices(
                    committee, att.aggregation_bits
                )
                candidates.append((att, set(attesters)))

        # greedy max cover, weighted by effective-balance increments
        increment = spec.EFFECTIVE_BALANCE_INCREMENT

        def weight(validators, covered):
            return sum(
                state.validators[v].effective_balance // increment
                for v in validators
                if v not in covered
            )

        chosen = []
        covered: set[int] = set()
        remaining = list(candidates)
        while remaining and len(chosen) < max_count:
            best_idx, best_w = None, 0
            for i, (_, validators) in enumerate(remaining):
                w = weight(validators, covered)
                if w > best_w:
                    best_idx, best_w = i, w
            if best_idx is None:
                break
            att, validators = remaining.pop(best_idx)
            covered |= validators
            chosen.append(att)
        return chosen

    def prune_attestations(self, current_epoch: int):
        stale = [
            root
            for root, data in self._attestation_data.items()
            if data.target.epoch + 1 < current_epoch
        ]
        for root in stale:
            self._attestations.pop(root, None)
            self._attestation_data.pop(root, None)

    # ---------------------------------------------------- slashings/exits

    def insert_proposer_slashing(self, slashing):
        idx = slashing.signed_header_1.message.proposer_index
        self._proposer_slashings.setdefault(idx, slashing)

    def insert_attester_slashing(self, slashing):
        self._attester_slashings.append(slashing)

    def insert_voluntary_exit(self, exit_):
        self._voluntary_exits.setdefault(
            exit_.message.validator_index, exit_
        )

    def get_slashings_and_exits(self, state):
        from lighthouse_tpu_torch.state_processing.helpers import (
            is_slashable_validator,
        )
        from lighthouse_tpu_torch.types.spec import FAR_FUTURE_EPOCH

        spec = self.spec
        epoch = get_current_epoch(state, spec)
        proposer_slashings = [
            s
            for idx, s in self._proposer_slashings.items()
            if is_slashable_validator(state.validators[idx], epoch)
        ][: spec.MAX_PROPOSER_SLASHINGS]
        attester_slashings = self._attester_slashings[
            : spec.MAX_ATTESTER_SLASHINGS
        ]
        exits = [
            e
            for idx, e in self._voluntary_exits.items()
            if state.validators[idx].exit_epoch == FAR_FUTURE_EPOCH
        ][: spec.MAX_VOLUNTARY_EXITS]
        return proposer_slashings, attester_slashings, exits
