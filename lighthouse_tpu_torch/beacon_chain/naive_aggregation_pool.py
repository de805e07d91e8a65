"""Naive aggregation pool: merge own-subnet unaggregated attestations.

The port of `lighthouse_tpu/beacon_chain/naive_aggregation_pool.py`.

Role of beacon_node/beacon_chain/src/naive_aggregation_pool.rs: group
unaggregated attestations by AttestationData root, OR the aggregation bits
and aggregate the signatures; retain a few slots; cap distinct data per
slot (SLOTS_RETAINED / MAX_ATTESTATIONS_PER_SLOT,
naive_aggregation_pool.rs:14-24).
"""

from lighthouse_tpu_torch import bls

SLOTS_RETAINED = 3
MAX_ATTESTATIONS_PER_SLOT = 16_384


class InsertOutcome:
    NEW = "new"
    AGGREGATED = "aggregated"
    ALREADY_KNOWN = "already_known"
    STALE = "stale"
    CAPACITY = "capacity"


class NaiveAggregationPool:
    def __init__(self):
        # slot -> {data_root: Attestation (aggregate under construction)}
        self._by_slot: dict[int, dict[bytes, object]] = {}

    def insert(self, attestation) -> str:
        data = attestation.data
        slot = data.slot
        slots = self._by_slot.setdefault(slot, {})
        data_root = type(data).hash_tree_root(data)
        existing = slots.get(data_root)
        if existing is None:
            if len(slots) >= MAX_ATTESTATIONS_PER_SLOT:
                return InsertOutcome.CAPACITY
            slots[data_root] = attestation.copy()
            return InsertOutcome.NEW
        new_bits = list(attestation.aggregation_bits)
        old_bits = list(existing.aggregation_bits)
        if all(ob or not nb for nb, ob in zip(new_bits, old_bits)):
            return InsertOutcome.ALREADY_KNOWN
        merged = [a or b for a, b in zip(old_bits, new_bits)]
        existing.aggregation_bits = merged
        existing.signature = bls.aggregate_signatures(
            [
                bls.Signature.from_bytes(bytes(existing.signature)),
                bls.Signature.from_bytes(bytes(attestation.signature)),
            ]
        ).to_bytes()
        return InsertOutcome.AGGREGATED

    def get(self, data) -> object | None:
        data_root = type(data).hash_tree_root(data)
        return self._by_slot.get(data.slot, {}).get(data_root)

    def aggregates_at_slot(self, slot: int):
        return list(self._by_slot.get(slot, {}).values())

    def prune(self, current_slot: int):
        cutoff = current_slot - SLOTS_RETAINED + 1
        for slot in [s for s in self._by_slot if s < cutoff]:
            del self._by_slot[slot]


class SyncMessageAggregationPool:
    """Naive aggregation of sync-committee messages into per-subcommittee
    contributions (naive_aggregation_pool.rs `SyncContributionAggregateMap`:
    keyed by SyncContributionData = (slot, block root, subcommittee)).

    Messages are inserted with the validator's positions inside each
    subcommittee (one message can land in several subcommittees)."""

    def __init__(self, spec, types):
        self.spec = spec
        self.t = types
        # (slot, root, subcommittee) -> contribution under construction
        self._contributions: dict[tuple, object] = {}

    def insert(self, verified_msg) -> str:
        msg = verified_msg.message
        size = max(
            self.spec.SYNC_COMMITTEE_SIZE
            // self.spec.SYNC_COMMITTEE_SUBNET_COUNT,
            1,
        )
        outcome = InsertOutcome.ALREADY_KNOWN
        # The signature must be aggregated ONCE PER SET BIT: sync
        # committees sample with replacement, so one validator can hold
        # several positions in a subcommittee, and verification pairs
        # the pubkey once per bit (the reference loops `from_message`
        # per position in add_to_naive_sync_aggregation_pool).
        sig = bls.Signature.from_bytes(bytes(msg.signature))
        for subcommittee, positions in verified_msg.subnet_positions.items():
            key = (msg.slot, bytes(msg.beacon_block_root), subcommittee)
            existing = self._contributions.get(key)
            if existing is None:
                bits = [False] * size
                for p in positions:
                    bits[p] = True
                self._contributions[key] = self.t.SyncCommitteeContribution(
                    slot=msg.slot,
                    beacon_block_root=bytes(msg.beacon_block_root),
                    subcommittee_index=subcommittee,
                    aggregation_bits=bits,
                    signature=bls.aggregate_signatures(
                        [sig] * len(positions)
                    ).to_bytes(),
                )
                outcome = InsertOutcome.NEW
                continue
            old_bits = list(existing.aggregation_bits)
            newly_set = [p for p in positions if not old_bits[p]]
            if not newly_set:
                continue
            for p in newly_set:
                old_bits[p] = True
            existing.aggregation_bits = old_bits
            existing.signature = bls.aggregate_signatures(
                [bls.Signature.from_bytes(bytes(existing.signature))]
                + [sig] * len(newly_set)
            ).to_bytes()
            outcome = InsertOutcome.AGGREGATED
        return outcome

    def get_contribution(
        self, slot: int, beacon_block_root: bytes, subcommittee: int
    ):
        return self._contributions.get(
            (slot, bytes(beacon_block_root), subcommittee)
        )

    def prune(self, current_slot: int):
        cutoff = current_slot - SLOTS_RETAINED + 1
        for k in [k for k in self._contributions if k[0] < cutoff]:
            del self._contributions[k]


class SyncContributionPool:
    """Verified SignedContributionAndProofs awaiting block inclusion;
    keeps the best (most-participants) contribution per (slot, root,
    subcommittee) and assembles the block's SyncAggregate
    (operation_pool sync_aggregate assembly in the reference)."""

    def __init__(self, spec, types):
        self.spec = spec
        self.t = types
        self._best: dict[tuple, object] = {}

    def insert(self, contribution) -> None:
        key = (
            contribution.slot,
            bytes(contribution.beacon_block_root),
            contribution.subcommittee_index,
        )
        existing = self._best.get(key)
        if existing is None or sum(
            map(bool, contribution.aggregation_bits)
        ) > sum(map(bool, existing.aggregation_bits)):
            self._best[key] = contribution.copy()

    def produce_sync_aggregate(self, slot: int, beacon_block_root: bytes):
        """SyncAggregate for a block at `slot`+1 voting on the block root
        at `slot` — OR of the best contribution per subcommittee."""
        spec = self.spec
        size = max(
            spec.SYNC_COMMITTEE_SIZE // spec.SYNC_COMMITTEE_SUBNET_COUNT, 1
        )
        bits = [False] * spec.SYNC_COMMITTEE_SIZE
        sigs = []
        for sub in range(spec.SYNC_COMMITTEE_SUBNET_COUNT):
            c = self._best.get((slot, bytes(beacon_block_root), sub))
            if c is None:
                continue
            for offset, bit in enumerate(c.aggregation_bits):
                if bit:
                    bits[sub * size + offset] = True
            sigs.append(bls.Signature.from_bytes(bytes(c.signature)))
        signature = (
            bls.aggregate_signatures(sigs).to_bytes()
            if sigs
            else bls.INFINITY_SIGNATURE_BYTES
        )
        return self.t.SyncAggregate(
            sync_committee_bits=bits,
            sync_committee_signature=signature,
        )

    def prune(self, current_slot: int):
        cutoff = current_slot - SLOTS_RETAINED + 1
        for k in [k for k in self._best if k[0] < cutoff]:
            del self._best[k]
