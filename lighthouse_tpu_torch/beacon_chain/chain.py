"""BeaconChain: the runtime assembling store, fork choice, pools, caches,
and the verification pipelines.

The port of `lighthouse_tpu/beacon_chain/chain.py`. A chain runs on the card
unless asked: `backend="gpu"` and `device="cuda"` by default (the reference
defaults to "ref"), and every signature batch, KZG settle, state transition
and light-client branch fold of the chain runs on `device`. A caller that
already holds the genesis state's keys decoded hands them over as a filled
`pubkey_cache` (at mainnet sizes decompressing every key costs minutes of
host time). Column sampling, the blinded/builder flow and an attached
execution layer are not ported yet: asking for them raises
NotImplementedError naming the ROADMAP item.

Role of beacon_node/beacon_chain/src/beacon_chain.rs (`BeaconChain<T>`):
process_block (:2363), process_chain_segment (:2215), produce_block (:3014),
attestation verification entry points (:1622,:1661), and head recompute
(canonical_head.rs:431) — structured as one Python class over the same
subsystem layout. Signature verification for imported blocks runs the
VERIFY_BULK strategy: every set in the block in one batch call (the
SignatureVerifiedBlock stage of the reference's type-state pipeline,
block_verification.rs:21-44).
"""

import time

from lighthouse_tpu_torch.beacon_chain import attestation_verification as attn
from lighthouse_tpu_torch.beacon_chain import sync_committee_verification as syncv
from lighthouse_tpu_torch.beacon_chain.naive_aggregation_pool import (
    NaiveAggregationPool,
    SyncContributionPool,
    SyncMessageAggregationPool,
)
from lighthouse_tpu_torch.beacon_chain.observed import (
    ObservedAggregates,
    ObservedAggregators,
    ObservedAttesters,
    ObservedBlockProducers,
    ObservedSyncAggregators,
    ObservedSyncContributors,
)
from lighthouse_tpu_torch.beacon_chain.operation_pool import OperationPool
from lighthouse_tpu_torch.common.events_journal import Journal
from lighthouse_tpu_torch.common.logging import get_logger
from lighthouse_tpu_torch.common.metrics import RegistryBackedMetrics
from lighthouse_tpu_torch.common.slot_budget import SlotBudgetRecorder
from lighthouse_tpu_torch.common.slot_budget import stage as budget_stage
from lighthouse_tpu_torch.common.tracing import span
from lighthouse_tpu_torch.fork_choice import ForkChoice
from lighthouse_tpu_torch.ops.device_io import resolve_device
from lighthouse_tpu_torch.ssz.cached_hash import (
    cached_state_root,
    carry_tree_cache,
)
from lighthouse_tpu_torch.ssz.hashing import ZERO_BYTES32
from lighthouse_tpu_torch.state_processing.helpers import (
    CommitteeCache,
    get_current_epoch,
    is_active_validator,
)
from lighthouse_tpu_torch.state_processing.per_block import (
    BlockProcessingError,
    BlockSignatureStrategy,
    per_block_processing,
)
from lighthouse_tpu_torch.state_processing.per_slot import process_slots
from lighthouse_tpu_torch.state_processing.pubkey_cache import PubkeyCache
from lighthouse_tpu_torch.store import HotColdDB, MemoryStore
from lighthouse_tpu_torch.types.containers import types_for
from lighthouse_tpu_torch.types.spec import Spec

_LOG = get_logger("chain")

SNAPSHOT_CACHE_SIZE = 4


class BlockError(Exception):
    pass


# the ROADMAP items that the chain's unported paths wait on
_COLUMN_ITEM = (
    "ROADMAP Queue 1 item 5: beacon_chain/column_checker.py and "
    "Harness.make_data_column_sidecars"
)
_EL_ITEM = "ROADMAP Queue 1 item 8: execution_layer/ (the blinded/builder flow)"


class _EngineAdapter:
    """Per_block_processing's execution-engine hook, recording the verdict
    so the import path can mark the fork-choice node VALID vs OPTIMISTIC
    (block_verification.rs payload verification handle +
    execution_payload.rs notify_new_payload). With no execution layer
    attached (the only mode until `execution_layer/` is ported) every
    payload is trusted valid."""

    def __init__(self):
        self.last_status = None

    def notify_new_payload(self, payload) -> bool:
        self.last_status = "VALID"
        return True


class BeaconChain:
    def __init__(
        self,
        genesis_state,
        spec: Spec,
        kv=None,
        backend: str = "gpu",
        slot_clock=None,
        execution_layer=None,
        column_mode: bool = False,
        slot_fuse: bool = True,
        device="cuda",
        pubkey_cache=None,
    ):
        """`device` is where the chain's "gpu" work runs ("cuda" raises
        without a GPU); `pubkey_cache`, when given, is a cache on `device`
        already holding `genesis_state`'s keys (`import_new` then picks up
        only validators it lacks)."""
        resolve_device(device)
        if column_mode:
            raise NotImplementedError(
                f"column_mode is not ported yet ({_COLUMN_ITEM})"
            )
        if execution_layer is not None:
            raise NotImplementedError(
                f"an attached execution layer is not ported yet ({_EL_ITEM})"
            )
        self.device = device
        self.spec = spec
        self.t = types_for(spec)
        self.backend = backend
        # one-dispatch slot (bn --slot-fuse, default on): blob imports
        # defer the DA checker's KZG settle into the import's chained
        # slot-program so the fold + settle cross the host<->device
        # boundary ONCE (ops/slot_program.py); the fused path engages
        # when the active checker supports deferred settles.
        self.slot_fuse = bool(slot_fuse)
        # per-node lifecycle event journal: every subsystem this chain
        # assembles (DA checker, sync manager, beacon processor, HTTP
        # API) emits into THIS instance, so multi-node simulations keep
        # separate forensic records (common/events_journal.py)
        self.journal = Journal()
        # the ONE device-plane submit boundary for every verification
        # consumer this chain assembles (gossip batches, segment bulks,
        # sidecar headers, op-pool packing, the slasher via the node):
        # deadline-aware cross-consumer batch coalescing that amortizes
        # the fixed device cost (verification_bus/bus.py). On host
        # backends the default hold is zero — an attributed
        # passthrough — so test/sim behavior is latency-identical.
        from lighthouse_tpu_torch.verification_bus import VerificationBus

        self.verification_bus = VerificationBus(
            backend=backend, journal=self.journal, device=device
        )
        # slot-budget profiler: per-import critical-path waterfalls,
        # overlap accounting, and the serial-dispatch/fusable-gap
        # ledger (common/slot_budget.py) — the measurement substrate
        # the one-dispatch executor work consumes. One per chain like
        # the journal it emits into.
        self.slot_budget = SlotBudgetRecorder(journal=self.journal)
        if slot_clock is not None:
            # gossip-class deadlines are the slot clock's 1/3-slot
            # attestation deadline, not a hand-set constant: budget =
            # time remaining to the next 1/3-slot boundary (floored so
            # a submission just past the boundary still gets a usable
            # window into the next slot)
            def _gossip_budget():
                clock = self.slot_clock
                rem = (
                    clock.attestation_deadline(clock.current_slot())
                    - clock.now()
                )
                if rem <= 0:
                    rem += spec.SECONDS_PER_SLOT
                return max(0.25, min(rem, float(spec.SECONDS_PER_SLOT)))

            self.verification_bus.budget_fns["gossip_single"] = (
                _gossip_budget
            )
            self.verification_bus.budget_fns["sidecar_header"] = (
                _gossip_budget
            )
        self.store = HotColdDB(kv or MemoryStore(), spec, device=device)
        # state replay re-verifies deposit signatures; keep those
        # batches on this node's forensic record
        self.store.journal = self.journal
        self.pubkey_cache = (
            pubkey_cache if pubkey_cache is not None
            else PubkeyCache(device=device)
        )
        self.pubkey_cache.import_new(genesis_state)
        self.slot_clock = slot_clock

        genesis_root = self._header_root(genesis_state)
        self.genesis_root = genesis_root
        self.store.put_hot_state(genesis_state)
        self.store.set_canonical_block_root(0, genesis_root)

        cp = (0, genesis_root)
        self.fork_choice = ForkChoice(
            genesis_root, genesis_state.slot, cp, cp, spec
        )
        self.head_root = genesis_root
        self.head_state = genesis_state

        # snapshot cache: block root -> post state (reference snapshot_cache)
        self._snapshots = {genesis_root: genesis_state}
        self._snapshot_order = [genesis_root]
        self._committee_caches = {}

        self.naive_pool = NaiveAggregationPool()
        self.op_pool = OperationPool(spec)
        self.observed_attesters = ObservedAttesters()
        self.observed_aggregators = ObservedAggregators()
        self.observed_aggregates = ObservedAggregates()
        self.observed_block_producers = ObservedBlockProducers()
        # sync-committee message plane (sync_committee_verification.rs)
        self.sync_message_pool = SyncMessageAggregationPool(spec, self.t)
        self.sync_contribution_pool = SyncContributionPool(spec, self.t)
        self.observed_sync_contributors = ObservedSyncContributors()
        self.observed_sync_aggregators = ObservedSyncAggregators()
        self.observed_sync_contributions = ObservedAggregates()

        # blob data-availability plane: blocks committing to blobs wait
        # here until every sidecar's KZG proof verifies
        # (data_availability_checker.rs role; KZG checks share the BLS
        # backend selection so "gpu" rides the device pairing plane)
        from lighthouse_tpu_torch.beacon_chain.data_availability_checker import (
            DataAvailabilityChecker,
        )

        self.da_checker = DataAvailabilityChecker(
            spec,
            backend=backend,
            current_slot_fn=self.current_slot,
            journal=self.journal,
            device=device,
        )
        # a released block that fails import for NON-DA reasons (e.g.
        # unknown parent) is handed here; the node wires in its
        # parent-lookup recovery so the block is not silently lost
        self.da_release_failure_handler = None
        # callables(block_root) run after every successful import
        # (gossip AND sync paths) AND on every head CHANGE in
        # recompute_head (reorgs without an import — invalid-payload
        # verdicts, fork-boundary reverts): the HTTP API registers its
        # hot-read cache invalidation here so a cached head/finalized
        # response can never be served after the head moved
        self.import_hooks: list = []
        # light-client serving plane: the producer rides the import
        # hooks, maintaining best-update-per-period, finality/optimistic
        # updates, and bootstrap documents for recent finalized roots
        # (cheap no-op on pre-altair chains — one store read per hook)
        from lighthouse_tpu_torch.light_client.producer import (
            LightClientUpdateProducer,
        )

        self.light_client_producer = LightClientUpdateProducer(
            self, device=device
        )
        self.import_hooks.append(self.light_client_producer.on_import)
        # (header root, signature) pairs whose proposer signature already
        # verified — gossip redeliveries of a block's sidecars cost one
        # pairing total, not one per sidecar (FIFO-bounded)
        self._verified_sidecar_headers: dict[tuple, None] = {}

        self._justified_balances = [
            v.effective_balance for v in genesis_state.validators
        ]
        # dict-compatible view mirrored onto lighthouse_tpu_chain_*
        # registry gauges: chain internals, /metrics scrapes, and the
        # remote monitoring snapshot all read the same numbers
        self.metrics = RegistryBackedMetrics(
            "lighthouse_tpu_chain_",
            initial={
                "blocks_imported": 0,
                "attestations_processed": 0,
                "pre_advance_hits": 0,
                "head_slot": int(genesis_state.slot),
            },
        )
        # pre-slot state advance result: (head block root, advanced state)
        self._advanced = None

        # attestation-production caches (attester_cache.rs,
        # early_attester_cache.rs, beacon_proposer_cache.rs)
        from lighthouse_tpu_torch.beacon_chain.attester_cache import (
            AttesterCache,
            BeaconProposerCache,
            EarlyAttesterCache,
        )

        self.attester_cache = AttesterCache()
        self.early_attester_cache = EarlyAttesterCache()
        self.proposer_cache = BeaconProposerCache()

        from lighthouse_tpu_torch.beacon_chain.events import EventBus
        from lighthouse_tpu_torch.beacon_chain.validator_monitor import (
            ValidatorMonitor,
        )

        self.events = EventBus()
        self.validator_monitor = ValidatorMonitor(journal=self.journal)

        # finality-driven store lifecycle (migrate.rs:29-35): head
        # recompute notifies the migrator on every finalization advance.
        # Synchronous by default (deterministic for tests); BeaconNode
        # swaps in a threaded one so migration runs off the import path.
        from lighthouse_tpu_torch.store.migrate import BackgroundMigrator

        self.migrator = BackgroundMigrator(self, threaded=False)
        self._migrated_finalized_epoch = 0

    @classmethod
    def from_checkpoint(
        cls,
        anchor_state,
        anchor_block,
        spec: Spec,
        kv=None,
        backend: str = "gpu",
        slot_clock=None,
        device="cuda",
        pubkey_cache=None,
    ):
        """Checkpoint-sync boot (reference `ClientGenesis::WeakSubjSszBytes`,
        client/src/config.rs:31-34): start from a trusted finalized state +
        its block instead of genesis; history is backfilled separately
        (SyncManager.run_backfill)."""
        chain = cls(
            anchor_state,
            spec,
            kv=kv,
            backend=backend,
            slot_clock=slot_clock,
            device=device,
            pubkey_cache=pubkey_cache,
        )
        root = type(anchor_block.message).hash_tree_root(
            anchor_block.message
        )
        chain.store.put_block(root, anchor_block)
        chain.store.set_canonical_block_root(
            anchor_block.message.slot, root
        )
        chain.anchor_slot = anchor_state.slot
        return chain

    # ------------------------------------------------------------ helpers

    @staticmethod
    def _copy_state(state):
        """state.copy() with the incremental tree-hash cache carried, so
        the copy's first root costs O(changes) instead of a full rehash."""
        out = state.copy()
        carry_tree_cache(out, state)
        return out

    def _header_root(self, state) -> bytes:
        from lighthouse_tpu_torch.types.helpers import state_anchor_block_root

        return state_anchor_block_root(state)

    def current_slot(self) -> int:
        if self.slot_clock is not None:
            return self.slot_clock.current_slot()
        return max(self.head_state.slot, self.fork_choice.current_slot)

    def _fc_checkpoint(self, cp) -> tuple:
        """A (epoch, root) checkpoint safe for fork choice. Roots the
        proto array legitimately cannot know clamp to the chain's
        anchor root (the reference initializes its ForkChoiceStore the
        same way: everything starts at the anchor, client/src/config.rs:
        31-34 + fork_choice anchor init). The clamp is SCOPED: only the
        epoch-0 zero-root sentinel and checkpoints at or below the
        anchor/finalized boundary qualify (pre-anchor history on a
        checkpoint-synced chain; pruned-proto roots from a late side
        branch carrying a stale finalized vote). An unknown root ABOVE
        that boundary is evidence of a corrupt state or a broken proto
        array — it raises instead of silently becoming the anchor."""
        root = bytes(cp.root)
        if cp.epoch == 0 and root == ZERO_BYTES32:
            return (0, self.genesis_root)
        if root in self.fork_choice.proto.indices:
            return (cp.epoch, root)
        clamp_slot = max(
            getattr(self, "anchor_slot", 0),
            self.spec.epoch_start_slot(self.finalized_checkpoint.epoch),
        )
        if (
            self.spec.epoch_start_slot(cp.epoch) <= clamp_slot
            or root == self.genesis_root
        ):
            return (cp.epoch, self.genesis_root)
        _LOG.warning(
            "fork-choice checkpoint (epoch %d, 0x%s) above the anchor "
            "boundary (slot %d) is unknown to the proto array",
            int(cp.epoch), root.hex()[:12], clamp_slot,
        )
        raise BlockError(
            f"unknown fork-choice checkpoint root 0x{root.hex()[:12]} "
            f"at epoch {int(cp.epoch)} above anchor boundary"
        )

    def set_slot(self, slot: int):
        self.fork_choice.set_slot(slot)
        # close out completed validator-monitor epochs (summaries into
        # the journal; expected proposals from the proposer cache)
        self.validator_monitor.advance(
            self.spec.slot_to_epoch(slot),
            proposers_fn=self.proposers_for_epoch,
        )
        self.attester_cache.prune(self.finalized_checkpoint.epoch)
        self.naive_pool.prune(slot)
        self.observed_aggregates.prune(slot)
        self.sync_message_pool.prune(slot)
        self.sync_contribution_pool.prune(slot)
        self.observed_sync_contributors.prune(slot)
        self.observed_sync_aggregators.prune(slot)
        self.observed_sync_contributions.prune(slot)

    def _committee_cache_for_epoch(self, epoch: int) -> CommitteeCache:
        """Per-epoch shuffling cache, bounded at 8 epochs (reference
        shuffling_cache) — the ONE fill path for every consumer."""
        cache = self._committee_caches.get(epoch)
        if cache is None:
            base = self.state_for_epoch(epoch)
            cache = CommitteeCache(base, epoch, self.spec)
            self._committee_caches[epoch] = cache
            if len(self._committee_caches) > 8:
                oldest = min(self._committee_caches)
                del self._committee_caches[oldest]
        return cache

    def committee_for(self, data):
        """Committee for an AttestationData via the shuffling cache."""
        cache = self._committee_cache_for_epoch(data.target.epoch)
        if data.index >= cache.committees_per_slot:
            raise attn.AttestationError("committee index out of range")
        return cache.get_beacon_committee(data.slot, data.index)

    def committees_per_slot_at(self, epoch: int) -> int:
        """Committee count per slot for `epoch` via the shuffling cache
        (needed by the committee→subnet mapping, subnet_id.rs)."""
        return self._committee_cache_for_epoch(epoch).committees_per_slot

    def state_for_epoch(self, epoch: int):
        """A state usable to compute epoch `epoch` committees."""
        state = self.head_state
        target_slot = self.spec.epoch_start_slot(epoch)
        if state.slot < target_slot:
            state = process_slots(
                self._copy_state(state), target_slot, self.spec,
                device=self.device,
            )
        return state

    # ----------------------------------------------------- block pipeline

    @staticmethod
    def _import_outcome(msg: str) -> str:
        """BlockError message -> journal outcome vocabulary."""
        if "already" in msg:
            return "duplicate"
        if "data unavailable" in msg:
            return "held"
        return "rejected"

    def _journaled_import(self, signed_block, block_root, inner, **extra):
        """Run one import attempt, landing its terminal — imported,
        held, rejected, duplicate — as ONE `block_import` journal event
        keyed by the block root (shared by the gossip and sync paths so
        the forensic record cannot diverge between them)."""
        slot = int(signed_block.message.slot)
        t0 = time.perf_counter()
        head_before = self.head_root
        # open the slot-budget record alongside the journal timing: the
        # two share one terminal vocabulary, and the budget_complete
        # invariant pairs their events 1:1 by (root, outcome)
        budget_rec = self.slot_budget.begin(
            block_root, slot, path=extra.get("path", "gossip")
        )
        try:
            result = inner()
        except BlockError as e:
            msg = str(e)
            outcome = self._import_outcome(msg)
            self.slot_budget.finish(budget_rec, outcome=outcome)
            self.journal.emit(
                "block_import",
                root=block_root,
                slot=slot,
                outcome=outcome,
                duration_s=time.perf_counter() - t0,
                reason=msg,
                **extra,
            )
            raise
        except BaseException:
            # non-BlockError escape: no block_import event will be
            # emitted, so drop the record unemitted too — the 1:1
            # pairing the budget_complete invariant asserts survives
            self.slot_budget.discard(budget_rec)
            raise
        self.slot_budget.finish(budget_rec, outcome="imported")
        self.journal.emit(
            "block_import",
            root=block_root,
            slot=slot,
            outcome="imported",
            duration_s=time.perf_counter() - t0,
            **extra,
        )
        # fire exactly ONCE per import: if this import moved the head,
        # recompute_head's head-change branch already ran the hooks —
        # this covers the remaining case (side-branch import: new store
        # data, unchanged head)
        if self.head_root == head_before:
            with span("import/hooks"):
                for hook in list(self.import_hooks):
                    try:
                        hook(block_root)
                    except Exception as e:
                        # a broken consumer hook must not fail the import
                        _LOG.warning("import hook failed: %s", e)
        return result

    def process_block(self, signed_block):
        """Full import pipeline: structural gossip checks -> bulk signature
        verification + state transition -> fork choice -> store -> head."""
        block_root = type(signed_block.message).hash_tree_root(
            signed_block.message
        )
        return self._journaled_import(
            signed_block,
            block_root,
            lambda: self._process_block_inner(signed_block, block_root),
        )

    def _fuse_active(self) -> bool:
        """True when this import should use the one-dispatch slot path
        (``bn --slot-fuse``, default on)."""
        return self.slot_fuse and hasattr(
            self.da_checker, "put_block_fused"
        )

    def _fused_held(self, block, block_root, missing):
        """A fused import whose deferred settle left sidecars missing
        lands exactly where the serial DA gate would have put it: held,
        unobserved, retriable on release."""
        # the serial path holds BEFORE the proposer observation; undo
        # ours so the released block can re-enter this pipeline
        self.observed_block_producers.forget(
            block.slot, block.proposer_index, block_root
        )
        self.metrics["da_blocks_held"] = (
            self.metrics.get("da_blocks_held", 0) + 1
        )
        raise BlockError(
            f"data unavailable: missing blob sidecars {sorted(missing)}"
        )

    def _process_block_inner(self, signed_block, block_root):
        spec = self.spec
        block = signed_block.message
        parent_root = bytes(block.parent_root)

        if block_root in self._snapshots:
            raise BlockError("block already known")

        # data-availability gate (BEFORE the equivocation observation so
        # a released block can re-enter this pipeline, and BEFORE any
        # state work — an unavailable block must cost nothing): a block
        # committing to blobs waits in the DA checker until every
        # committed sidecar arrived with a verified KZG proof
        from lighthouse_tpu_torch.beacon_chain.data_availability_checker import (
            DataAvailabilityError,
        )

        fused_work = None
        try:
            with budget_stage("kzg_settle"):
                if self._fuse_active():
                    # one-dispatch slot: partition candidates now,
                    # defer the folded KZG verify onto the import's
                    # single chained dispatch (staged below, ridden by
                    # the signature collector's bus submit)
                    missing, fused_work = self.da_checker.put_block_fused(
                        block_root, signed_block
                    )
                else:
                    missing = self.da_checker.put_block(
                        block_root, signed_block
                    )
        except DataAvailabilityError as e:
            # structurally invalid on the DA axis (e.g. more commitments
            # than MAX_BLOBS_PER_BLOCK) — a hard reject, not a hold
            raise BlockError(str(e)) from e
        if missing:
            self.metrics["da_blocks_held"] = (
                self.metrics.get("da_blocks_held", 0) + 1
            )
            raise BlockError(
                f"data unavailable: missing blob sidecars {sorted(missing)}"
            )
        # only an available block may advance the fork-choice clock —
        # before the DA gate a far-future block would drag the
        # checker's own horizon along with it. On the fused path the
        # verdict is still pending: the advance waits for finalize (the
        # sync path's set_slot-inside-store_write discipline), so a
        # fused-held block leaves the clock untouched like a serial one.
        if fused_work is None:
            if self.fork_choice.current_slot < block.slot:
                self.fork_choice.set_slot(block.slot)

        with budget_stage("structural"):
            parent_state = self._snapshots.get(parent_root)
            if parent_state is None:
                stored = self.store.get_block(parent_root)
                if stored is None:
                    raise BlockError("unknown parent")
                parent_state = self.store.state_at_slot(
                    stored.message.slot
                )
                if parent_state is None:
                    raise BlockError("parent state unavailable")

            # proposer observation AFTER parent resolution (the
            # reference's gossip verification order): an unknown-parent
            # block must stay retriable once the parent-lookup recovery
            # fetches its parent — observing it here would make the
            # retry a false "duplicate"
            outcome = self.observed_block_producers.observe(
                block.slot, block.proposer_index, block_root
            )
            if outcome == "equivocation":
                raise BlockError("proposer equivocation")
            if outcome == "duplicate":
                raise BlockError("block already observed")

        # pre-slot state advance (state_advance_timer.rs:89,321): if the
        # timer already advanced the head state across this slot's (or
        # epoch's) boundary, start from that instead of re-running the
        # epoch transition on the import critical path
        adv = self._advanced
        if (
            adv is not None
            and adv[0] == parent_root
            and adv[1].slot <= block.slot
        ):
            parent_state = adv[1]
            self.metrics["pre_advance_hits"] += 1

        with span("import/state_copy"):
            state = self._copy_state(parent_state)
        t0 = time.perf_counter()
        with span("import/slots", slot=int(block.slot)), budget_stage(
            "slots"
        ):
            state = process_slots(state, block.slot, spec, device=self.device)
        engine = _EngineAdapter()
        if fused_work is not None:
            # the deferred settle rides the SAME dispatch as the
            # block's signature fold: the collector's bus submit below
            # picks it up into one chained slot-program
            self.verification_bus.stage_program_work(fused_work)
        try:
            try:
                with span("import/block_processing"), budget_stage(
                    "block_processing"
                ):
                    per_block_processing(
                        state,
                        signed_block,
                        spec,
                        BlockSignatureStrategy.VERIFY_BULK,
                        self.pubkey_cache,
                        backend=self.backend,
                        execution_engine=engine,
                        consumer="gossip_single",
                        journal=self.journal,
                        bus=self.verification_bus,
                        device=self.device,
                    )
            except BlockProcessingError as e:
                if fused_work is not None:
                    # the serial gate orders DA before signatures:
                    # finalize the deferred settle FIRST so a block
                    # that is both unavailable and unverifiable lands
                    # as HELD, exactly like the serial path
                    with budget_stage("kzg_settle"):
                        fused_missing = fused_work.finalize()
                    if fused_missing:
                        self._fused_held(
                            block, block_root, fused_missing
                        )
                raise BlockError(str(e)) from e
            if fused_work is not None:
                with budget_stage("kzg_settle"):
                    fused_missing = fused_work.finalize()
                if fused_missing:
                    self._fused_held(block, block_root, fused_missing)
                if self.fork_choice.current_slot < block.slot:
                    self.fork_choice.set_slot(block.slot)
        finally:
            if fused_work is not None:
                # un-stage on every exit (a pre-submit failure must not
                # leak this import's settle into the next submit on
                # this thread) and keep the checker sound: a work the
                # program never ran settles serially here
                self.verification_bus.pop_staged_work()
                if not fused_work.finalized:
                    fused_work.finalize()
        with span("import/state_root"), budget_stage("state_root"):
            post_root = cached_state_root(state)
        if bytes(block.state_root) != post_root:
            raise BlockError("state root mismatch")
        self.metrics["block_processing_seconds"] = (
            time.perf_counter() - t0
        )

        # make the block attestable BEFORE the store/head work — the
        # 1/3-slot attestation deadline must not wait for it
        # (early_attester_cache.rs add_head_block)
        self.early_attester_cache.add_head_block(
            block_root, signed_block, state, spec
        )

        # store + fork choice. Checkpoints resolve FIRST: _fc_checkpoint
        # can now raise on a corrupt above-anchor root, and that abort
        # must happen before the first store mutation — a block the
        # canonical index serves while fork choice never saw it would
        # make the detected corruption worse, not better
        with span("import/store_fork_choice"), budget_stage(
            "store_write"
        ):
            justified = self._fc_checkpoint(
                state.current_justified_checkpoint
            )
            finalized = self._fc_checkpoint(state.finalized_checkpoint)
            self.store.put_block(block_root, signed_block)
            # persistence point for blob sidecars: only blocks that
            # actually import get their (verified) sidecars on disk, so
            # unsolicited gossip can never grow the store
            for sc in self.da_checker.verified_sidecars(block_root):
                self.store.put_blob_sidecar(block_root, sc)
            with span("import/hot_state_write"):
                self.store.put_hot_state(state)
            self.store.set_canonical_block_root(block.slot, block_root)
            exec_status, exec_hash = self._execution_verdict(block, engine)
            with span("import/fork_choice_on_block"):
                self.fork_choice.on_block(
                    block.slot,
                    block_root,
                    parent_root,
                    justified,
                    finalized,
                    execution_status=exec_status,
                    execution_block_hash=exec_hash,
                )

        # register the block's attestations with fork choice + monitor
        indexed_atts = []
        for att in block.body.attestations:
            try:
                committee = self.committee_for(att.data)
            except attn.AttestationError:
                continue
            from lighthouse_tpu_torch.state_processing.helpers import (
                get_attesting_indices,
            )

            if len(att.aggregation_bits) != len(committee):
                continue
            indices = get_attesting_indices(
                committee, att.aggregation_bits
            )
            indexed_atts.append(
                self.t.IndexedAttestation(
                    attesting_indices=indices,
                    data=att.data,
                    signature=att.signature,
                )
            )
            try:
                self.fork_choice.on_attestation(
                    indices,
                    bytes(att.data.beacon_block_root),
                    att.data.target.epoch,
                )
            except Exception as e:
                # attestations for blocks fork choice never saw are
                # routine during sync; anything else deserves a trace
                _LOG.debug("on_attestation skipped: %s", e)

        self._cache_snapshot(block_root, state)
        self.metrics["blocks_imported"] += 1
        self.validator_monitor.register_block(
            block, indexed_atts, spec
        )
        old_finalized = self.finalized_checkpoint.epoch
        with span("import/head_update"), budget_stage("head_update"):
            self.recompute_head()
        self.events.publish(
            "block",
            {"slot": int(block.slot), "root": "0x" + block_root.hex()},
        )
        self.events.publish(
            "head",
            {
                "slot": int(self.head_state.slot),
                "root": "0x" + self.head_root.hex(),
            },
        )
        new_fin = self.head_state.finalized_checkpoint
        if new_fin.epoch > old_finalized:
            self.events.publish(
                "finalized_checkpoint",
                {
                    "epoch": int(new_fin.epoch),
                    "root": "0x" + bytes(new_fin.root).hex(),
                },
            )
        return block_root

    def process_chain_segment(self, signed_blocks):
        """Batched segment import (range sync path): one bulk signature
        batch across ALL sets of ALL blocks (block_verification.rs:509),
        then sequential state transitions with signatures skipped.

        Every signature in every block — proposal, randao reveal,
        slashing/exit operations, attestations, sync aggregate — goes
        into the segment batch, evaluated against each block's advancing
        pre-state. A serving peer that tampers with ANY inner signature
        fails the whole segment, exactly like the reference's
        signature_verify_chain_segment → BlockSignatureVerifier chain."""
        from lighthouse_tpu_torch.state_processing.per_block import (
            BlockProcessingError,
            SignatureCollector,
        )

        if not signed_blocks:
            return []
        # one collector spanning the segment: per_block_processing feeds
        # it each block's sets (built eagerly against the in-hand
        # advanced state) and leaves finish() to us
        # consumer/journal/bus ride on the collector so the deposit
        # checks INSIDE per_block_processing (verified individually
        # regardless of strategy) stay attributed, journaled, and
        # bus-routed too
        collector = SignatureCollector(
            BlockSignatureStrategy.VERIFY_BULK,
            backend=self.backend,
            consumer="sync_segment",
            journal=self.journal,
            slot=int(signed_blocks[-1].message.slot),
            bus=self.verification_bus,
            device=self.device,
        )
        roots = []
        state = None
        for sb in signed_blocks:
            block = sb.message
            parent_root = bytes(block.parent_root)
            if state is None:
                parent_state = self._snapshots.get(parent_root)
                if parent_state is None:
                    raise BlockError("segment parent unknown")
                state = parent_state.copy()
            state = process_slots(
                state, block.slot, self.spec, device=self.device
            )
            self.pubkey_cache.import_new(state)
            try:
                per_block_processing(
                    state,
                    sb,
                    self.spec,
                    BlockSignatureStrategy.VERIFY_BULK,
                    self.pubkey_cache,
                    collector=collector,
                    device=self.device,
                )
            except BlockProcessingError as e:
                raise BlockError(f"segment block invalid: {e}") from e
        # signature-batch membership: the bus journals one
        # consumer-attributed event per submission (how many sets from
        # how many blocks shared this bulk verification, plus the
        # shared-batch device lane/waste economics), so a segment
        # failure is attributable to the batch that carried it
        batch_ok = bool(
            collector.sets
        ) and self.verification_bus.submit(
            collector.sets,
            consumer="sync_segment",
            backend=self.backend,
            journal=self.journal,
            slot=int(signed_blocks[-1].message.slot),
            journal_attrs={"n_blocks": len(signed_blocks)},
        )
        if not batch_ok:
            raise BlockError("segment signature batch failed")
        # apply for real through the normal pipeline (signatures already
        # batch-checked; per-block re-verification is skipped)
        for sb in signed_blocks:
            block = sb.message
            root = type(block).hash_tree_root(block)
            if root in self._snapshots:
                continue
            self._import_verified(sb)
            roots.append(root)
        return roots

    def verify_blob_sidecar_header(self, sidecar) -> bool:
        """Proposer-signature check on the sidecar's signed block header
        (gossip rule `blob_sidecar.signed_block_header`; reference
        verify_blob_sidecar_for_gossip). Scope of the guarantee: the
        signature covers the HEADER only, so this stops an attacker
        from inventing sidecars for arbitrary (root, index) space —
        spamming the candidate cache now requires replaying a REAL
        proposer's signed header from an existing block. Targeted
        flooding of one known block's candidate cap by pairing that
        public header with garbage blobs remains possible (the
        reference closes that residual with gossip-time KZG +
        commitment-inclusion proofs; here the first-come-wins cap,
        eviction digest-forgetting, and post-block redelivery bound the
        damage to a delayed import). Verified (header root, signature)
        pairs are cached so the N sidecars of one block — and mesh
        redeliveries — cost one pairing total."""
        from lighthouse_tpu_torch.state_processing import signature_sets as ss

        if self.backend == "fake":
            # fake crypto = always-valid (the set can't even be BUILT
            # from a structurally-invalid placeholder signature)
            return True
        header = sidecar.signed_block_header
        msg = header.message
        key = (
            bytes(type(msg).hash_tree_root(msg)),
            bytes(header.signature),
        )
        if key in self._verified_sidecar_headers:
            return True
        try:
            self.pubkey_cache.get(int(msg.proposer_index))
        except (KeyError, IndexError):
            return False
        try:
            ok = self.verification_bus.submit(
                [
                    ss.block_header_set(
                        self.head_state,
                        header,
                        self.pubkey_cache.get,
                        self.spec,
                    )
                ],
                consumer="sidecar_header",
                backend=self.backend,
                journal=self.journal,
                slot=int(msg.slot),
            )
        except Exception as e:
            # malformed points/unknown proposer index verify to False;
            # the gossip caller treats that as an invalid sidecar
            _LOG.debug("sidecar header verification errored: %s", e)
            return False
        if ok:
            self._verified_sidecar_headers[key] = None
            while len(self._verified_sidecar_headers) > 512:
                self._verified_sidecar_headers.pop(
                    next(iter(self._verified_sidecar_headers))
                )
        return bool(ok)

    def process_blob_sidecar(self, sidecar, verify_header: bool = True):
        """Gossip blob-sidecar entry point: verify + record through the
        DA checker, then import any block the sidecar completed.
        Returns the roots of blocks imported as a result (usually
        empty); raises DataAvailabilityError on invalid/duplicate
        sidecars (the gossip layer maps that onto peer scoring).

        `verify_header=False` is for the req/resp sync path ONLY, where
        the caller has already bound the sidecar structurally to a block
        whose proposal signature is verified in the segment batch (the
        sidecar header carries the identical signature over the
        identical root, so re-pairing it proves nothing new)."""
        from lighthouse_tpu_torch.beacon_chain.data_availability_checker import (
            DataAvailabilityError,
        )

        precomputed = None
        if verify_header:
            # cheap structural rejections FIRST: index/horizon junk and
            # exact redeliveries must never cost a pairing. The returned
            # (root, digest) pair rides into put_sidecar so the gossip
            # hot path hashes the sidecar ONCE, not twice.
            precomputed = self.da_checker.precheck_sidecar(sidecar)
            if not self.verify_blob_sidecar_header(sidecar):
                self.metrics["sidecar_header_sig_failures"] = (
                    self.metrics.get("sidecar_header_sig_failures", 0)
                    + 1
                )
                self.journal.emit(
                    "sidecar",
                    root=precomputed[0],
                    slot=int(sidecar.signed_block_header.message.slot),
                    outcome="header_sig_invalid",
                    index=int(sidecar.index),
                )
                raise DataAvailabilityError(
                    "blob sidecar proposer signature invalid"
                )
        released = self.da_checker.put_sidecar(
            sidecar, precomputed=precomputed
        )
        self.metrics["blob_sidecars_processed"] = (
            self.metrics.get("blob_sidecars_processed", 0) + 1
        )
        imported = []
        for blk in released:
            try:
                imported.append(self.process_block(blk))
            except BlockError as e:
                # the block became importable but failed for its own
                # reasons (the sidecars themselves were valid) — hand
                # it to the recovery hook so e.g. an unknown parent
                # triggers the node's lookup instead of silent loss
                if self.da_release_failure_handler is not None:
                    self.da_release_failure_handler(blk, e)
        return imported

    def process_data_column_sidecar(self, sidecar, verify_header=True):
        """Gossip column-sidecar entry point of column-sampling nodes. A
        chain of the port runs the blob checker only (column mode waits:
        see `_COLUMN_ITEM`), so a column sidecar is refused as the
        reference's blob-mode node refuses it."""
        from lighthouse_tpu_torch.beacon_chain.data_availability_checker import (
            DataAvailabilityError,
        )

        raise DataAvailabilityError("node is not in column-sampling mode")

    def _import_verified(self, signed_block):
        block_root = type(signed_block.message).hash_tree_root(
            signed_block.message
        )
        self._journaled_import(
            signed_block,
            block_root,
            lambda: self._import_verified_inner(signed_block, block_root),
            path="sync",
        )

    def _import_verified_inner(self, signed_block, block_root):
        from lighthouse_tpu_torch.beacon_chain.data_availability_checker import (
            DataAvailabilityError,
        )

        spec = self.spec
        block = signed_block.message
        parent_root = bytes(block.parent_root)
        # the availability invariant holds on the sync path too: a
        # segment block committing to blobs imports only if its
        # sidecars already verified (arrived via gossip, or fetched by
        # SyncManager over blob_sidecars_by_range ahead of this
        # import). A still-incomplete segment is rejected rather than
        # imported unavailable — the sync manager requeues it.
        try:
            with budget_stage("kzg_settle"):
                if self._fuse_active():
                    # the sync path has no co-resident signature fold
                    # (NO_VERIFICATION), but the settle still goes out
                    # as ONE chained program instead of a standalone
                    # KZG dispatch
                    missing, fused_work = self.da_checker.put_block_fused(
                        block_root, signed_block
                    )
                    if fused_work is not None:
                        try:
                            self.verification_bus.submit_program(
                                fused_work,
                                consumer="kzg",
                                journal=self.journal,
                                slot=int(block.slot),
                            )
                        finally:
                            missing = fused_work.finalize()
                else:
                    missing = self.da_checker.put_block(
                        block_root, signed_block
                    )
        except DataAvailabilityError as e:
            raise BlockError(str(e)) from e
        if missing:
            raise BlockError(
                f"segment block data unavailable: missing blob "
                f"sidecars {sorted(missing)}"
            )
        with budget_stage("structural"):
            parent_state = self._snapshots.get(parent_root)
            if parent_state is None:
                raise BlockError("unknown parent")
        with budget_stage("slots"):
            with span("import/state_copy"):
                state = self._copy_state(parent_state)
            state = process_slots(state, block.slot, spec, device=self.device)
        engine = _EngineAdapter()
        # NO_VERIFICATION skips the batch-checked signatures, but
        # deposit signatures still verify individually — keep them
        # attributed and journaled on the sync path
        with budget_stage("block_processing"):
            per_block_processing(
                state,
                signed_block,
                spec,
                BlockSignatureStrategy.NO_VERIFICATION,
                self.pubkey_cache,
                execution_engine=engine,
                consumer="sync_segment",
                journal=self.journal,
                bus=self.verification_bus,
                device=self.device,
            )
        with budget_stage("state_root"):
            post_root = cached_state_root(state)
        if bytes(block.state_root) != post_root:
            raise BlockError("state root mismatch")
        # checkpoints resolve BEFORE the store writes (same atomicity
        # contract as the gossip path: a _fc_checkpoint abort must not
        # leave the canonical index pointing at a block fork choice
        # never saw)
        with budget_stage("store_write"):
            justified = self._fc_checkpoint(
                state.current_justified_checkpoint
            )
            finalized = self._fc_checkpoint(state.finalized_checkpoint)
            self.store.put_block(block_root, signed_block)
            for sc in self.da_checker.verified_sidecars(block_root):
                self.store.put_blob_sidecar(block_root, sc)
            with span("import/hot_state_write"):
                self.store.put_hot_state(state)
            self.store.set_canonical_block_root(block.slot, block_root)
            if self.fork_choice.current_slot < block.slot:
                self.fork_choice.set_slot(block.slot)
            exec_status, exec_hash = self._execution_verdict(
                block, engine
            )
            with span("import/fork_choice_on_block"):
                self.fork_choice.on_block(
                    block.slot,
                    block_root,
                    parent_root,
                    justified,
                    finalized,
                    execution_status=exec_status,
                    execution_block_hash=exec_hash,
                )
        self._cache_snapshot(block_root, state)
        self.metrics["blocks_imported"] += 1
        with budget_stage("head_update"):
            self.recompute_head()

    def _execution_verdict(self, block, engine):
        """Map the engine verdict recorded during block processing onto a
        proto-array execution status (+ payload hash). Blocks without a
        payload are IRRELEVANT."""
        from lighthouse_tpu_torch.fork_choice.proto_array import ExecutionStatus

        body = block.body
        payload = getattr(body, "execution_payload", None)
        if payload is None or engine.last_status is None:
            return ExecutionStatus.IRRELEVANT, None
        exec_hash = bytes(payload.block_hash)
        if engine.last_status == "VALID":
            return ExecutionStatus.VALID, exec_hash
        return ExecutionStatus.OPTIMISTIC, exec_hash

    def is_optimistic_head(self) -> bool:
        """True if the current head's payload chain is engine-unverified
        (the optimistic-sync `execution_optimistic` flag of the REST API)."""
        return self.fork_choice.is_optimistic(self.head_root)

    def on_payload_verdict(self, block_root: bytes, status):
        """Late engine verdict for an optimistically imported block
        (beacon_chain.rs process_invalid_execution_payload analog)."""
        if status.status == "VALID":
            self.fork_choice.on_valid_execution_payload(block_root)
        elif status.status in ("INVALID", "INVALID_BLOCK_HASH"):
            self.fork_choice.on_invalid_execution_payload(
                block_root, status.latest_valid_hash
            )
            self.recompute_head()

    def revert_to_fork_boundary(self, fork_epoch: int) -> bytes:
        """Recover a node that followed the wrong side of a hard fork:
        reset the head to the latest canonical block BEFORE the fork
        boundary and rebuild fork choice anchored there
        (fork_revert.rs:24 revert_to_fork_boundary — the reference also
        re-initializes fork choice from the revert point). Returns the
        revert-point root; post-boundary blocks must be re-synced."""
        spec = self.spec
        boundary_slot = spec.epoch_start_slot(fork_epoch)
        for slot in range(boundary_slot - 1, -1, -1):
            root = self.store.get_canonical_block_root(slot)
            if root is None:
                continue
            state = self.store.state_at_slot(slot)
            if state is None:
                continue
            # wrong-fork blocks: purge store index + import caches so the
            # correct chain can re-import from the boundary
            for s in range(boundary_slot, self.fork_choice.current_slot + 1):
                stale = self.store.get_canonical_block_root(s)
                if stale is not None:
                    self._snapshots.pop(stale, None)
                self.store.clear_canonical_block_root(s)
            # fork choice anchored at the revert point (reference rebuilds
            # from store; wrong-fork nodes must not win the next get_head)
            justified = (spec.slot_to_epoch(slot), root)
            finalized = (spec.slot_to_epoch(slot), root)
            self.fork_choice = type(self.fork_choice)(
                root, slot, justified, finalized, spec
            )
            # observation caches saw the wrong-fork blocks; a reverted
            # node restarts its gossip view (the reference reverts via
            # process restart, which clears them implicitly)
            self.observed_block_producers = type(
                self.observed_block_producers
            )()
            self.head_root = root
            self.head_state = state
            # the head moved without a recompute_head pass — keep the
            # mirrored gauge (and remote telemetry) on the new head
            self.metrics["head_slot"] = int(state.slot)
            self._cache_snapshot(root, state)
            return root
        raise BlockError("no pre-fork block available to revert to")

    def _cache_snapshot(self, root: bytes, state):
        self._snapshots[root] = state
        self._snapshot_order.append(root)
        while len(self._snapshot_order) > SNAPSHOT_CACHE_SIZE:
            old = self._snapshot_order.pop(0)
            if old != self.head_root:
                self._snapshots.pop(old, None)

    # ------------------------------------------------------- attestations

    def process_unaggregated_attestations(self, attestations):
        """Gossip batch: verify (one device batch), apply to fork choice +
        naive aggregation pool."""
        state = self.head_state
        results = attn.batch_verify_unaggregated(self, state, attestations)
        accepted = 0
        for res in results:
            if isinstance(res, attn.VerifiedAttestation):
                self.fork_choice.on_attestation(
                    res.indexed_indices,
                    bytes(res.attestation.data.beacon_block_root),
                    res.attestation.data.target.epoch,
                )
                self.naive_pool.insert(res.attestation)
                self.metrics["attestations_processed"] += 1
                accepted += 1
        if results:
            self.journal.emit(
                "attestation_batch",
                slot=int(attestations[0].data.slot),
                outcome="ok" if accepted == len(results) else "partial",
                n=len(results),
                accepted=accepted,
                aggregated=False,
            )
        return results

    def process_aggregated_attestations(self, signed_aggregates):
        state = self.head_state
        results = attn.batch_verify_aggregates(
            self, state, signed_aggregates
        )
        accepted = 0
        for res in results:
            if isinstance(res, attn.VerifiedAttestation):
                self.fork_choice.on_attestation(
                    res.indexed_indices,
                    bytes(res.attestation.data.beacon_block_root),
                    res.attestation.data.target.epoch,
                )
                self.op_pool.insert_attestation(res.attestation)
                self.metrics["attestations_processed"] += 1
                accepted += 1
        if results:
            self.journal.emit(
                "attestation_batch",
                slot=int(
                    signed_aggregates[0].message.aggregate.data.slot
                ),
                outcome="ok" if accepted == len(results) else "partial",
                n=len(results),
                accepted=accepted,
                aggregated=True,
            )
        return results

    # ----------------------------------------------------- sync committee

    def process_sync_messages(self, messages):
        """Gossip batch of SyncCommitteeMessages: verify (one device
        batch) and merge into the per-subcommittee contribution pool
        (sync_committee_verification.rs:622 + naive aggregation)."""
        state = self.head_state
        results = syncv.batch_verify_sync_messages(self, state, messages)
        for res in results:
            if isinstance(res, syncv.VerifiedSyncMessage):
                self.sync_message_pool.insert(res)
                self.metrics["sync_messages_processed"] = (
                    self.metrics.get("sync_messages_processed", 0) + 1
                )
        return results

    def process_signed_contributions(self, signed_contributions):
        """Gossip batch of SignedContributionAndProofs: verify (3 sets
        each, one device batch) and keep the best per subcommittee for
        block inclusion (sync_committee_verification.rs:422 +
        VerifiedSyncContribution::add_to_pool)."""
        state = self.head_state
        results = syncv.batch_verify_contributions(
            self, state, signed_contributions
        )
        for res in results:
            if isinstance(res, syncv.VerifiedContribution):
                self.sync_contribution_pool.insert(
                    res.signed_contribution.message.contribution
                )
                self.metrics["contributions_processed"] = (
                    self.metrics.get("contributions_processed", 0) + 1
                )
        return results

    def produce_sync_aggregate(self, proposal_slot: int):
        """SyncAggregate for a block proposed at `proposal_slot`: the
        pooled contributions voting on the previous slot's block root."""
        prev_slot = max(proposal_slot, 1) - 1
        prev_root = self.store.get_canonical_block_root(prev_slot)
        if prev_root is None:
            prev_root = self.head_root
        return self.sync_contribution_pool.produce_sync_aggregate(
            prev_slot, prev_root
        )

    # ---------------------------------------------------------- production

    def _attestation_parts_from_state(self, epoch: int):
        """(justified, committees_per_slot, target_root) for the head —
        reuses the just-imported block's early-attester item when it
        matches (block import already paid the O(V) active scan there);
        otherwise reads the head state. Either way primes the attester
        cache."""
        from lighthouse_tpu_torch.state_processing.helpers import (
            get_active_validator_indices,
            get_block_root_at_slot,
            get_committee_count_per_slot,
        )

        spec = self.spec
        early = self.early_attester_cache._item
        if (
            early is not None
            and early.epoch == epoch
            and early.beacon_block_root == self.head_root
        ):
            justified = early.source.copy()
            cps = early.committees_per_slot
            target_root = early.target[1]
            self.attester_cache.prime(
                epoch, self.head_root, justified, cps, target_root
            )
            return justified, cps, target_root
        state = self.head_state
        start_slot = spec.epoch_start_slot(epoch)
        if state.slot > start_slot:
            target_root = bytes(
                get_block_root_at_slot(state, start_slot, spec)
            )
        else:
            target_root = self.head_root
        justified = state.current_justified_checkpoint.copy()
        cps = get_committee_count_per_slot(
            len(get_active_validator_indices(state, epoch)), spec
        )
        self.attester_cache.prime(
            epoch, self.head_root, justified, cps, target_root
        )
        return justified, cps, target_root

    def produce_attestation_data(self, slot: int, committee_index: int):
        """AttestationData for (slot, committee) on the canonical head,
        served WITHOUT touching the head state on the hot path: the
        early-attester cache answers for a just-imported block, the
        attester cache answers per (epoch, head root); only a cache miss
        reads the state (and re-primes). Matches attester_cache.rs +
        early_attester_cache.rs."""
        spec = self.spec
        epoch = spec.slot_to_epoch(slot)

        early = self.early_attester_cache.try_attest(slot, spec)
        if early is not None and early.beacon_block_root == self.head_root:
            if committee_index >= early.committees_per_slot:
                raise attn.AttestationError(
                    "committee index out of range"
                )
            t_epoch, t_root = early.target
            return self.t.AttestationData(
                slot=slot,
                index=committee_index,
                beacon_block_root=early.beacon_block_root,
                source=early.source,
                target=self.t.Checkpoint(epoch=t_epoch, root=t_root),
            )

        cached = self.attester_cache.get(epoch, self.head_root)
        if cached is not None:
            justified, cps, target_root = (
                cached.justified_checkpoint,
                cached.committees_per_slot,
                cached.target_root,
            )
        else:
            justified, cps, target_root = (
                self._attestation_parts_from_state(epoch)
            )
        if committee_index >= cps:
            raise attn.AttestationError("committee index out of range")
        return self.t.AttestationData(
            slot=slot,
            index=committee_index,
            beacon_block_root=self.head_root,
            source=justified,
            target=self.t.Checkpoint(epoch=epoch, root=target_root),
        )

    def proposers_for_epoch(self, epoch: int):
        """Proposer index per slot of `epoch`, via the LRU proposer cache
        (beacon_proposer_cache.rs): keyed by (epoch, decision root); a
        miss computes the whole epoch from one state — never a per-slot
        state advance."""
        from lighthouse_tpu_torch.beacon_chain.attester_cache import (
            compute_epoch_proposers,
        )

        spec = self.spec
        end_prev = spec.epoch_start_slot(epoch) - 1
        decision_root = None
        if end_prev >= 0:
            decision_root = self.store.get_canonical_block_root(end_prev)
        if decision_root is None:
            decision_root = self.head_root
        cached = self.proposer_cache.get_epoch(epoch, decision_root)
        if cached is not None:
            return cached
        state = self.state_for_epoch(epoch)
        proposers = compute_epoch_proposers(state, epoch, spec)
        self.proposer_cache.insert(epoch, decision_root, proposers)
        return proposers

    def _open_production(self, slot: int):
        """Advance a cache-carried head-state copy to `slot` and resolve
        fork/proposer — shared by full and blinded production."""
        from lighthouse_tpu_torch.state_processing.helpers import (
            get_beacon_proposer_index,
        )

        spec = self.spec
        state = self._copy_state(self.head_state)
        if state.slot > slot:
            raise ValueError(f"head already past slot {slot}")
        state = process_slots(state, slot, spec, device=self.device)
        fork_name = spec.fork_name_at_epoch(get_current_epoch(state, spec))
        proposer = get_beacon_proposer_index(state, spec)
        return state, fork_name, proposer

    def _packed_body_fields(
        self, state, slot, fork_name, randao_reveal, graffiti
    ) -> dict:
        """Operation-pool packing shared by full and blinded bodies."""
        spec = self.spec
        attestations = self.op_pool.get_attestations(
            state, spec.MAX_ATTESTATIONS
        )
        proposer_slashings, attester_slashings, exits = (
            self.op_pool.get_slashings_and_exits(state)
        )
        fields = dict(
            randao_reveal=bytes(randao_reveal),
            eth1_data=state.eth1_data,
            graffiti=bytes(graffiti),
            attestations=attestations,
            deposits=[],
            voluntary_exits=exits,
            proposer_slashings=proposer_slashings,
            attester_slashings=attester_slashings,
        )
        if fork_name != "phase0":
            fields["sync_aggregate"] = self.produce_sync_aggregate(slot)
        return fields

    def _seal_block(self, state, block, signed_cls):
        """Trial-run the block (signatures skipped) on a cache-carried
        copy and stamp its post-state root."""
        trial = self._copy_state(state)
        # deposit signatures (packed from the eth1 queue) verify
        # individually even under NO_VERIFICATION — attribute them to
        # the op-packing consumer
        per_block_processing(
            trial,
            signed_cls(message=block, signature=b"\x00" * 96),
            self.spec,
            BlockSignatureStrategy.NO_VERIFICATION,
            self.pubkey_cache,
            consumer="oppool",
            journal=self.journal,
            bus=self.verification_bus,
            device=self.device,
        )
        block.state_root = cached_state_root(trial)
        return block

    def produce_block_unsigned(
        self,
        slot: int,
        randao_reveal: bytes,
        graffiti: bytes = b"\x00" * 32,
        blob_kzg_commitments=(),
    ):
        """Unsigned block for `slot` on the canonical head — the VC-facing
        half of block production (beacon_chain.rs:3014 produce_block /
        :3144 produce_block_on_state, served over GET
        /eth/v2/validator/blocks/{slot}): attestations packed from the
        operation pool by greedy max-cover, slashings/exits from the pool,
        the sync aggregate from pooled contributions, and the post-state
        root computed with signatures skipped. `blob_kzg_commitments`
        (bellatrix-or-later bodies) binds the producer's blobs to the
        block — the per-node production path the network simulator's
        blob slots run on."""
        state, fork_name, proposer = self._open_production(slot)
        body = self.t.block_body_classes[fork_name](
            **self._packed_body_fields(
                state, slot, fork_name, randao_reveal, graffiti
            )
        )
        if blob_kzg_commitments:
            if fork_name != "bellatrix":
                raise BlockError(
                    "blob commitments need a bellatrix-or-later body"
                )
            body.blob_kzg_commitments = [
                bytes(c) for c in blob_kzg_commitments
            ]
        if fork_name == "bellatrix":
            builder = getattr(self, "payload_builder", None)
            if builder is not None:
                body.execution_payload = builder(state)
        block = self.t.block_classes[fork_name](
            slot=slot,
            proposer_index=proposer,
            parent_root=self.head_root,
            state_root=ZERO_BYTES32,
            body=body,
        )
        return self._seal_block(
            state, block, self.t.signed_block_classes[fork_name]
        )

    # ------------------------------------------------- builder / blinded

    def produce_blinded_block_unsigned(
        self, slot: int, randao_reveal: bytes, graffiti: bytes = b"\x00" * 32
    ):
        """The builder flow's blinded block (GET
        /eth/v1/validator/blinded_blocks/{slot}) needs `execution_layer/`,
        which is not ported yet."""
        raise NotImplementedError(
            f"produce_blinded_block_unsigned is not ported yet ({_EL_ITEM})"
        )

    def import_blinded_block(self, signed_blinded):
        """Unblinding (POST /eth/v1/beacon/blinded_blocks) needs
        `execution_layer/`, which is not ported yet."""
        raise NotImplementedError(
            f"import_blinded_block is not ported yet ({_EL_ITEM})"
        )

    # --------------------------------------------------------------- head

    def advance_head_to_slot(self, target_slot: int):
        """Pre-slot state advance (state_advance_timer.rs:89,321): advance
        a COPY of the head state across the upcoming slot — including any
        epoch boundary — BEFORE the slot's block arrives, so the import
        path's process_slots finds the work already done. The result is
        keyed by the head root it was computed from; a reorg before the
        block arrives simply misses the cache."""
        if target_slot <= self.head_state.slot:
            return
        st = self._copy_state(self.head_state)
        st = process_slots(st, target_slot, self.spec, device=self.device)
        self._advanced = (self.head_root, st)

    def recompute_head(self):
        """Fork-choice head + justified-balance refresh
        (canonical_head.rs:431 recompute_head_at_slot)."""
        jc_epoch, jc_root = self.fork_choice.justified_checkpoint
        justified_state = self._snapshots.get(jc_root)
        if justified_state is not None:
            epoch = get_current_epoch(justified_state, self.spec)
            self._justified_balances = [
                v.effective_balance
                if is_active_validator(v, epoch)
                else 0
                for v in justified_state.validators
            ]
        with span("import/fork_choice_get_head"):
            head_root = self.fork_choice.get_head(self._justified_balances)
        if head_root != self.head_root:
            self.head_root = head_root
            snap = self._snapshots.get(head_root)
            if snap is not None:
                self.head_state = snap
            else:
                blk = self.store.get_block(head_root)
                if blk is not None:
                    st = self.store.state_at_slot(blk.message.slot)
                    if st is not None:
                        self.head_state = st
            # prime the attester cache for the new head so the 1/3-slot
            # attestation_data path never reads the state
            # (attester_cache.rs is primed at head recompute)
            self._attestation_parts_from_state(
                self.spec.slot_to_epoch(self.head_state.slot)
            )
            # the head can move WITHOUT an import (invalid-payload
            # verdicts, fork-boundary reverts): consumers caching
            # head-derived responses must hear about every move, so
            # the hooks fire on head CHANGE as well as on import
            with span("import/hooks"):
                for hook in list(self.import_hooks):
                    try:
                        hook(head_root)
                    except Exception as e:
                        _LOG.warning("head-change hook failed: %s", e)
        # finalization advance drives the store lifecycle: hot→cold
        # migration + finality-keyed cache pruning, off the critical
        # path when the migrator is threaded (migrate.rs:29-35)
        fin = self.head_state.finalized_checkpoint
        if fin.epoch > self._migrated_finalized_epoch:
            self._migrated_finalized_epoch = fin.epoch
            self.migrator.notify_finalized(
                self.spec.epoch_start_slot(fin.epoch), fin.epoch
            )
        self.metrics["head_slot"] = int(self.head_state.slot)
        return self.head_root

    @property
    def finalized_checkpoint(self):
        return self.head_state.finalized_checkpoint
