"""Attestation-production caches.

The port of `lighthouse_tpu/beacon_chain/attester_cache.py`.

Roles of three reference caches:

* `AttesterCache` (beacon_chain/src/attester_cache.rs:1-60): serve
  `attestation_data` without touching the head state. The shuffling cache
  cannot carry `state.current_justified_checkpoint` (it is keyed by
  shuffling decision root, and the justified checkpoint only exists after
  the epoch transition), so this cache stores, per (epoch, head block
  root): the justified checkpoint + per-slot committee counts/lengths.
  Primed at head recompute; bounded at MAX_LEN, pruned on finality.

* `EarlyAttesterCache` (early_attester_cache.rs:1-40): a single-item
  cache populated DURING block import, allowing attestations to a block
  that has not reached the database/head yet — the 1/3-slot deadline
  must not wait for the head lock.

* `BeaconProposerCache` (beacon_proposer_cache.rs:1-30): LRU of
  (epoch, decision block root) -> the epoch's proposer indices, serving
  proposer duties and block-proposer checks without a state advance.
"""

from collections import OrderedDict

ATTESTER_CACHE_MAX_LEN = 1_024  # attester_cache.rs:37 MAX_CACHE_LEN
PROPOSER_CACHE_SIZE = 16        # beacon_proposer_cache.rs:23 CACHE_SIZE


class AttesterCacheValue:
    __slots__ = (
        "justified_checkpoint",
        "committees_per_slot",
        "target_root",
    )

    def __init__(
        self, justified_checkpoint, committees_per_slot: int,
        target_root: bytes,
    ):
        self.justified_checkpoint = justified_checkpoint
        self.committees_per_slot = committees_per_slot
        self.target_root = target_root


class AttesterCache:
    def __init__(self):
        self._cache: OrderedDict[tuple, AttesterCacheValue] = OrderedDict()
        self.hits = 0
        self.misses = 0

    def prime(
        self, epoch: int, head_root: bytes, justified, cps: int,
        target_root: bytes,
    ):
        key = (epoch, bytes(head_root))
        self._cache[key] = AttesterCacheValue(justified, cps, target_root)
        self._cache.move_to_end(key)
        while len(self._cache) > ATTESTER_CACHE_MAX_LEN:
            self._cache.popitem(last=False)

    def get(self, epoch: int, head_root: bytes):
        v = self._cache.get((epoch, bytes(head_root)))
        if v is None:
            self.misses += 1
        else:
            self.hits += 1
        return v

    def prune(self, finalized_epoch: int):
        for key in [k for k in self._cache if k[0] < finalized_epoch]:
            del self._cache[key]


class EarlyAttesterCacheItem:
    __slots__ = (
        "epoch",
        "beacon_block_root",
        "source",
        "target",
        "committees_per_slot",
        "block",
    )

    def __init__(
        self, epoch, beacon_block_root, source, target,
        committees_per_slot, block,
    ):
        self.epoch = epoch
        self.beacon_block_root = beacon_block_root
        self.source = source
        self.target = target
        self.committees_per_slot = committees_per_slot
        self.block = block


class EarlyAttesterCache:
    def __init__(self):
        self._item = None
        self.hits = 0

    def add_head_block(self, block_root, signed_block, state, spec):
        """Populate during import, before the head moves (the reference
        calls this between consensus verification and fork choice)."""
        from lighthouse_tpu_torch.state_processing.helpers import (
            get_active_validator_indices,
            get_block_root_at_slot,
            get_committee_count_per_slot,
        )

        epoch = spec.slot_to_epoch(state.slot)
        start_slot = spec.epoch_start_slot(epoch)
        if signed_block.message.slot > start_slot:
            target_root = bytes(
                get_block_root_at_slot(state, start_slot, spec)
            )
        else:
            target_root = bytes(block_root)
        self._item = EarlyAttesterCacheItem(
            epoch=epoch,
            beacon_block_root=bytes(block_root),
            source=state.current_justified_checkpoint.copy(),
            target=(epoch, target_root),
            committees_per_slot=get_committee_count_per_slot(
                len(get_active_validator_indices(state, epoch)), spec
            ),
            block=signed_block,
        )

    def try_attest(self, request_slot: int, spec):
        """AttestationData parts for `request_slot` if the cached item is
        from the same epoch (early_attester_cache.rs try_attest)."""
        item = self._item
        if item is None:
            return None
        if spec.slot_to_epoch(request_slot) != item.epoch:
            return None
        self.hits += 1
        return item

    def get_block(self, block_root: bytes):
        """Serve the just-imported block by root (RPC before DB write)."""
        item = self._item
        if item is not None and item.beacon_block_root == bytes(block_root):
            return item.block
        return None


class BeaconProposerCache:
    def __init__(self):
        self._cache: OrderedDict[tuple, list] = OrderedDict()
        self.hits = 0
        self.misses = 0

    def insert(self, epoch: int, decision_root: bytes, proposers: list):
        key = (epoch, bytes(decision_root))
        self._cache[key] = list(proposers)
        self._cache.move_to_end(key)
        while len(self._cache) > PROPOSER_CACHE_SIZE:
            self._cache.popitem(last=False)

    def get_epoch(self, epoch: int, decision_root: bytes):
        key = (epoch, bytes(decision_root))
        v = self._cache.get(key)
        if v is None:
            self.misses += 1
        else:
            self.hits += 1
            self._cache.move_to_end(key)
        return v

    def get_slot(self, epoch: int, decision_root: bytes, slot: int, spec):
        proposers = self.get_epoch(epoch, decision_root)
        if proposers is None:
            return None
        return proposers[slot - spec.epoch_start_slot(epoch)]


def compute_epoch_proposers(state, epoch: int, spec) -> list:
    """Proposer index for every slot of `epoch` on `state`'s shuffling
    (state must be in `epoch`)."""
    from lighthouse_tpu_torch.state_processing.helpers import (
        compute_proposer_index,
        get_active_validator_indices,
        get_seed,
        hash32,
        uint_to_bytes8,
    )

    indices = get_active_validator_indices(state, epoch)
    out = []
    for slot in range(
        spec.epoch_start_slot(epoch), spec.epoch_start_slot(epoch + 1)
    ):
        seed = hash32(
            get_seed(state, epoch, spec.DOMAIN_BEACON_PROPOSER, spec)
            + uint_to_bytes8(slot)
        )
        out.append(compute_proposer_index(state, indices, seed, spec))
    return out
