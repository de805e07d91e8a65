"""Hot/cold split database for blocks and states.

The port of `lighthouse_tpu/store/hot_cold.py`; its state replay runs the
port's `process_slots` and `per_block_processing` on `device` ("cuda" unless
asked). Role of the reference's `HotColdDB` (beacon_node/store/src/hot_cold_store.rs:
42-60): the hot section holds all blocks plus full state snapshots at epoch
boundaries since the split; the cold (freezer) section holds one full
"restore point" state every `slots_per_restore_point` slots; any other
historical state is reconstructed by loading the nearest earlier snapshot
and replaying blocks (the `BlockReplayer` analog,
consensus/state_processing/src/block_replayer.rs).

Objects are stored as SSZ bytes keyed by root (blocks) or slot (states);
fork-aware decoding consults the Spec for the slot's fork.
"""

import threading

from lighthouse_tpu_torch.state_processing.per_block import (
    BlockSignatureStrategy,
    per_block_processing,
)
from lighthouse_tpu_torch.state_processing.per_slot import process_slots
from lighthouse_tpu_torch.state_processing.pubkey_cache import PubkeyCache
from lighthouse_tpu_torch.types.containers import types_for
from lighthouse_tpu_torch.types.spec import Spec

COL_BLOCK = b"blk"
COL_HOT_STATE = b"hst"
COL_COLD_STATE = b"cst"
COL_BLOCK_ROOTS = b"bri"  # slot -> block root (canonical chain index)
COL_BLOB_SIDECAR = b"bsc"  # block_root + index -> sidecar SSZ
COL_BLOB_INDEX = b"bsi"  # slot + block_root + index -> b"" (prune index)
COL_META = b"meta"

SPLIT_KEY = b"split_slot"
GENESIS_STATE_KEY = b"genesis_state"
BLOB_MIN_SLOT_KEY = b"blob_min_slot"  # watermark: oldest indexed sidecar


def _u64(v: int) -> bytes:
    return int(v).to_bytes(8, "big")  # big-endian for ordered iteration


class StoreError(Exception):
    pass


class HotColdDB:
    def __init__(
        self, kv, spec: Spec, slots_per_restore_point: int | None = None,
        device="cuda",
    ):
        self.kv = kv
        self.spec = spec
        self.device = device
        self.t = types_for(spec)
        self.slots_per_restore_point = (
            slots_per_restore_point or spec.SLOTS_PER_EPOCH * 4
        )
        # serializes kv WRITES between the import path and the threaded
        # background migrator (migrate.py runs migrate_to_cold off the
        # import thread; the kv backends are individually atomic but a
        # hot->cold move is a multi-op sequence that must not interleave
        # with an import-path write of the same column). RLock:
        # migrate_to_cold calls prune_blob_sidecars under its own hold.
        self.lock = threading.RLock()
        self._replay_pubkeys = PubkeyCache(device=device)
        # the owning chain's forensic journal (set by BeaconChain after
        # construction): state replay re-verifies deposit signatures
        # individually, and those device batches must stay journaled so
        # per-consumer attribution cross-checks exactly
        self.journal = None
        # schema versioning: stamp fresh stores, migrate old ones on open
        # (store/src/metadata.rs + schema_change.rs). Every production
        # store is created through here, so a missing version record means
        # a fresh database.
        from lighthouse_tpu_torch.store.schema import migrate_schema

        migrate_schema(kv)

    # ------------------------------------------------------------- codecs

    def _state_cls_at_slot(self, slot: int):
        fork = self.spec.fork_name_at_epoch(self.spec.slot_to_epoch(slot))
        return self.t.state_classes[fork]

    def _block_cls_at_slot(self, slot: int):
        fork = self.spec.fork_name_at_epoch(self.spec.slot_to_epoch(slot))
        return self.t.signed_block_classes[fork]

    # ------------------------------------------------------------- blocks

    def put_block(self, root: bytes, signed_block) -> None:
        data = _u64(signed_block.message.slot) + signed_block.to_bytes()
        with self.lock:
            self.kv.put(COL_BLOCK, root, data)

    def get_block(self, root: bytes):
        data = self.kv.get(COL_BLOCK, root)
        if data is None:
            return None
        slot = int.from_bytes(data[:8], "big")
        return self._block_cls_at_slot(slot).decode(data[8:])

    def set_canonical_block_root(self, slot: int, root: bytes) -> None:
        with self.lock:
            self.kv.put(COL_BLOCK_ROOTS, _u64(slot), root)

    def get_canonical_block_root(self, slot: int):
        return self.kv.get(COL_BLOCK_ROOTS, _u64(slot))

    def clear_canonical_block_root(self, slot: int) -> None:
        with self.lock:
            self.kv.delete(COL_BLOCK_ROOTS, _u64(slot))

    # ------------------------------------------------------ blob sidecars

    def put_blob_sidecar(self, block_root: bytes, sidecar) -> None:
        """Persist one verified sidecar (blob_sidecar.rs storage role)
        plus a slot-keyed index row, so retention pruning walks keys
        only — it never reads a blob."""
        key = bytes(block_root) + _u64(int(sidecar.index))
        slot = int(sidecar.signed_block_header.message.slot)
        with self.lock:
            self.kv.put(COL_BLOB_SIDECAR, key, sidecar.to_bytes())
            self.kv.put(COL_BLOB_INDEX, _u64(slot) + key, b"")
            cur = self.kv.get(COL_META, BLOB_MIN_SLOT_KEY)
            if cur is None or slot < int.from_bytes(cur, "big"):
                self.kv.put(COL_META, BLOB_MIN_SLOT_KEY, _u64(slot))

    def get_blob_sidecars(self, block_root: bytes) -> list:
        """Stored sidecars for a block root, ordered by index — at most
        MAX_BLOBS_PER_BLOCK direct keyed gets, no column scan."""
        root = bytes(block_root)
        out = []
        for i in range(self.spec.MAX_BLOBS_PER_BLOCK):
            data = self.kv.get(COL_BLOB_SIDECAR, root + _u64(i))
            if data is not None:
                out.append(self.t.BlobSidecar.decode(data))
        return out

    def get_blob_sidecars_by_range(
        self, start_slot: int, count: int, limit: int | None = None
    ) -> list:
        """Canonical-chain sidecars for slots [start_slot, start_slot +
        count), ordered by (slot, index) — the serving side of the
        `blob_sidecars_by_range` req/resp method. Walks the canonical
        root index (direct keyed reads, no column scan). `limit` stops
        at a BLOCK boundary: a response never carries a partial sidecar
        set for a block, because a client staging it for its DA gate
        could not tell truncation from data-withholding."""
        out = []
        for slot in range(start_slot, start_slot + count):
            root = self.get_canonical_block_root(slot)
            if root is None:
                continue
            sidecars = self.get_blob_sidecars(root)
            if limit is not None and len(out) + len(sidecars) > limit:
                break
            out.extend(sidecars)
        return out

    def prune_blob_sidecars(self, cutoff_slot: int) -> int:
        """Drop sidecars below `cutoff_slot`; returns the count removed.
        Driven by the finality migration with the
        MIN_EPOCHS_FOR_BLOB_SIDECARS_REQUESTS retention window. Walks
        the slot-keyed index — blob values are never read — and a
        min-slot watermark skips the key scan entirely when nothing can
        be below the cutoff (a range-scan KV extension would make the
        remaining per-epoch scan key-bounded; the interface is get/put/
        delete/keys today)."""
        with self.lock:
            cur = self.kv.get(COL_META, BLOB_MIN_SLOT_KEY)
            if cur is not None and int.from_bytes(
                cur, "big"
            ) >= cutoff_slot:
                return 0
            removed = 0
            remaining_min = None
            for key in list(self.kv.keys(COL_BLOB_INDEX)):
                slot = int.from_bytes(key[:8], "big")
                if slot < cutoff_slot:
                    self.kv.delete(COL_BLOB_SIDECAR, key[8:])
                    self.kv.delete(COL_BLOB_INDEX, key)
                    removed += 1
                elif remaining_min is None or slot < remaining_min:
                    remaining_min = slot
            self.kv.put(
                COL_META,
                BLOB_MIN_SLOT_KEY,
                _u64(
                    remaining_min
                    if remaining_min is not None
                    else cutoff_slot
                ),
            )
            return removed

    # ------------------------------------------------------------- states

    def put_hot_state(self, state) -> None:
        with self.lock:
            self.kv.put(
                COL_HOT_STATE, _u64(state.slot), state.to_bytes()
            )

    def get_hot_state(self, slot: int):
        data = self.kv.get(COL_HOT_STATE, _u64(slot))
        if data is None:
            return None
        return self._state_cls_at_slot(slot).decode(data)

    def put_cold_state(self, state) -> None:
        if state.slot % self.slots_per_restore_point:
            raise StoreError("cold states must land on restore points")
        with self.lock:
            self.kv.put(
                COL_COLD_STATE, _u64(state.slot), state.to_bytes()
            )

    # ------------------------------------------------------ hot/cold split

    @property
    def split_slot(self) -> int:
        raw = self.kv.get(COL_META, SPLIT_KEY)
        return int.from_bytes(raw, "big") if raw else 0

    def migrate_to_cold(self, finalized_slot: int) -> None:
        """Move hot states below the finalized slot into the freezer:
        keep restore points, drop the rest (reference
        beacon_chain/src/migrate.rs background migration)."""
        with self.lock:
            for key in sorted(self.kv.keys(COL_HOT_STATE)):
                slot = int.from_bytes(key, "big")
                if slot >= finalized_slot:
                    continue
                if slot % self.slots_per_restore_point == 0:
                    data = self.kv.get(COL_HOT_STATE, key)
                    self.kv.put(COL_COLD_STATE, key, data)
                self.kv.delete(COL_HOT_STATE, key)
            self.kv.put(COL_META, SPLIT_KEY, _u64(finalized_slot))
            # blob retention window: sidecars are a serving obligation,
            # not history — prune everything older than the window
            # behind finality (MIN_EPOCHS_FOR_BLOB_SIDECARS_REQUESTS).
            # Still under the lock (RLock re-entry): the whole
            # migration is ONE sequence an import write cannot split.
            retention_slots = (
                self.spec.MIN_EPOCHS_FOR_BLOB_SIDECARS_REQUESTS
                * self.spec.SLOTS_PER_EPOCH
            )
            self.prune_blob_sidecars(
                max(0, finalized_slot - retention_slots)
            )

    # -------------------------------------------------- state reconstruction

    def load_cold_state(self, slot: int):
        """Exact state at `slot`: nearest restore point at or below, plus
        replay of canonical blocks (signatures skipped — they were verified
        on import; reference store/src/reconstruct.rs + block_replayer)."""
        base_slot = slot - (slot % self.slots_per_restore_point)
        data = None
        while base_slot >= 0:
            data = self.kv.get(COL_COLD_STATE, _u64(base_slot))
            if data is not None:
                break
            base_slot -= self.slots_per_restore_point
        if data is None:
            return None
        state = self._state_cls_at_slot(base_slot).decode(data)
        return self.replay_blocks(state, slot)

    def replay_blocks(self, state, target_slot: int):
        """Advance `state` to `target_slot` applying canonical blocks."""
        spec = self.spec
        while state.slot < target_slot:
            next_slot = state.slot + 1
            root = self.get_canonical_block_root(next_slot)
            state = process_slots(state, next_slot, spec, device=self.device)
            if root is not None:
                block = self.get_block(root)
                if block is not None and block.message.slot == next_slot:
                    self._replay_pubkeys.import_new(state)
                    # NO_VERIFICATION still verifies deposit signatures
                    # individually (an invalid deposit must be skipped
                    # identically on replay) — attribute the recheck of
                    # stored chain data as segment re-verification
                    per_block_processing(
                        state,
                        block,
                        spec,
                        BlockSignatureStrategy.NO_VERIFICATION,
                        self._replay_pubkeys,
                        consumer="sync_segment",
                        journal=self.journal,
                        device=self.device,
                    )
        return state

    def state_at_slot(self, slot: int):
        """Hot lookup first, then freezer reconstruction."""
        hot = self.get_hot_state(slot)
        if hot is not None:
            return hot
        return self.load_cold_state(slot)
