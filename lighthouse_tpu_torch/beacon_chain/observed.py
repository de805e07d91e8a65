"""First-seen dedup & equivocation caches backing gossip rules.

The port of `lighthouse_tpu/beacon_chain/observed.py`.

Role of beacon_node/beacon_chain/src/{observed_attesters.rs,
observed_aggregates.rs, observed_block_producers.rs}: per-epoch bitmaps of
which validators/aggregators have already been seen, and per-slot proposer
tracking to catch equivocations. Pruned by finalized/current epoch.
"""


class ObservedAttesters:
    """validator x epoch first-seen filter (unaggregated attestations)."""

    def __init__(self):
        self._seen: dict[int, set[int]] = {}  # epoch -> {validator}

    def observe(self, epoch: int, validator_index: int) -> bool:
        """Returns True if already seen (and records the observation)."""
        bucket = self._seen.setdefault(epoch, set())
        if validator_index in bucket:
            return True
        bucket.add(validator_index)
        return False

    def is_known(self, epoch: int, validator_index: int) -> bool:
        return validator_index in self._seen.get(epoch, ())

    def prune(self, finalized_epoch: int):
        for e in [e for e in self._seen if e < finalized_epoch]:
            del self._seen[e]


class ObservedAggregators(ObservedAttesters):
    """aggregator x epoch first-seen filter (aggregate-and-proof)."""


class ObservedAggregates:
    """Seen aggregate attestation roots per slot (exact-duplicate filter)."""

    def __init__(self):
        self._seen: dict[int, set[bytes]] = {}

    def observe(self, slot: int, att_root: bytes) -> bool:
        bucket = self._seen.setdefault(slot, set())
        if att_root in bucket:
            return True
        bucket.add(att_root)
        return False

    def prune(self, current_slot: int, retained: int = 3):
        for s in [s for s in self._seen if s < current_slot - retained]:
            del self._seen[s]


class ObservedBlockProducers:
    """proposer x slot tracking; flags equivocation (two distinct blocks
    from one proposer at one slot)."""

    def __init__(self):
        self._seen: dict[tuple[int, int], bytes] = {}

    def observe(self, slot: int, proposer: int, block_root: bytes) -> str:
        key = (slot, proposer)
        prev = self._seen.get(key)
        if prev is None:
            self._seen[key] = block_root
            return "new"
        if prev == block_root:
            return "duplicate"
        return "equivocation"

    def forget(self, slot: int, proposer: int, block_root: bytes):
        """Un-record an observation IF it still points at this root —
        the fused import path observes the proposer before the deferred
        DA verdict resolves, and a fused-HELD block must stay
        retriable on release (the serial gate never observes a held
        block). A different recorded root stays: that is real
        equivocation evidence, not this import's bookkeeping."""
        key = (slot, proposer)
        if self._seen.get(key) == block_root:
            del self._seen[key]

    def prune(self, finalized_slot: int):
        for k in [k for k in self._seen if k[0] < finalized_slot]:
            del self._seen[k]


class ObservedSyncContributors:
    """validator x (slot, subcommittee) first-seen filter for sync
    committee messages (observed_attesters.rs SlotSubcommitteeIndex
    variant used by sync_committee_verification.rs)."""

    def __init__(self):
        self._seen: dict[tuple[int, int], set[int]] = {}

    def observe(
        self, slot: int, subcommittee_index: int, validator_index: int
    ) -> bool:
        """Returns True if already seen (and records the observation)."""
        bucket = self._seen.setdefault((slot, subcommittee_index), set())
        if validator_index in bucket:
            return True
        bucket.add(validator_index)
        return False

    def is_known(
        self, slot: int, subcommittee_index: int, validator_index: int
    ) -> bool:
        return validator_index in self._seen.get(
            (slot, subcommittee_index), ()
        )

    def prune(self, current_slot: int, retained: int = 3):
        for k in [k for k in self._seen if k[0] < current_slot - retained]:
            del self._seen[k]


class ObservedSyncAggregators(ObservedSyncContributors):
    """aggregator x (slot, subcommittee) first-seen filter for signed
    contribution-and-proofs."""
