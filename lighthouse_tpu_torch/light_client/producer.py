"""Light-client update production, driven by the chain's import hooks.

The port of `lighthouse_tpu/light_client/producer.py`.

Role of the reference's beacon_chain light_client_server machinery
(light_client_finality_update / optimistic_update production +
best-update-per-period persistence): every imported block B whose body
carries a sync aggregate attests its PARENT P — so on each import hook
the producer reads P's header and post-state (the chain's snapshot
cache; field roots from the incremental tree-hash cache), extracts the
finality and next-sync-committee branches via ssz/gindex, and
maintains:

  * `best_updates[period]` — the best LightClientUpdate per
    sync-committee period (spec-shaped ordering: finality presence,
    then participation; ties keep the incumbent);
  * `finality_update` / `optimistic_update` — the latest documents the
    REST endpoints and the two gossip topics serve;
  * `bootstraps[root]` — LightClientBootstrap for recent finalized
    block roots (bounded), built when finality advances.

Every accepted document emits ONE ``lc_update_produced`` journal event
(deterministic protocol claim — part of the sim's canonical replay
projection) and bumps a generation counter the node's gossip publisher
and the serving caches key off.

Branch self-check: with ``device_check=True`` every freshly extracted
branch is re-folded through the batched device plane
(`ops/merkle_proof.batch_verify_branches`, consumer="light_client", on
`device`: the SHA-256 fold kernel `csrc/sha256_fold.cu` on "cuda", its
plain version on "cpu") and must land on the state root. It is an
argument, off by default, as the reference's environment switch is.
"""

import time

from lighthouse_tpu_torch.common.logging import get_logger
from lighthouse_tpu_torch.common.metrics import REGISTRY
from lighthouse_tpu_torch.ssz.gindex import (
    TreeOracle,
    branch_indices,
    state_field_chunks,
)

_LOG = get_logger("light_client")

_PRODUCED = REGISTRY.counter_vec(
    "lighthouse_tpu_lc_updates_produced_total",
    "light-client documents produced/bettered, by kind "
    "(optimistic|finality|period_best|bootstrap)",
    ("kind",),
)

MAX_BOOTSTRAPS = 8
MAX_CACHED_PERIODS = 64

def _popcount(bits) -> int:
    return sum(1 for b in bits if b)


class LightClientUpdateProducer:
    def __init__(self, chain, device_check: bool = False, device="cuda"):
        self.chain = chain
        self.best_updates: dict = {}  # period -> LightClientUpdate
        self.finality_update = None
        self.optimistic_update = None
        self.bootstraps: dict = {}  # block root bytes -> Bootstrap
        # generation counters: the node's gossip publisher diffs these
        self.finality_seq = 0
        self.optimistic_seq = 0
        self._seen_roots: set = set()
        self._last_bootstrap_epoch = 0
        self.device_check = bool(device_check)
        self.device = device

    # ------------------------------------------------------------ helpers

    def _period_at_slot(self, slot: int) -> int:
        spec = self.chain.spec
        return (
            spec.slot_to_epoch(int(slot))
            // spec.EPOCHS_PER_SYNC_COMMITTEE_PERIOD
        )

    def _header_for(self, block):
        t = self.chain.t
        msg = block.message
        return t.LightClientHeader(
            beacon=t.BeaconBlockHeader(
                slot=msg.slot,
                proposer_index=msg.proposer_index,
                parent_root=bytes(msg.parent_root),
                state_root=bytes(msg.state_root),
                body_root=type(msg.body).hash_tree_root(msg.body),
            )
        )

    def _prove(self, state, oracle, gindex):
        branch = [oracle.node(s) for s in branch_indices(gindex)]
        if self.device_check:
            from lighthouse_tpu_torch.ops import merkle_proof as mp

            ok = mp.batch_verify_branches(
                [(oracle.node(gindex), branch, gindex)],
                [oracle.root()],
                consumer="light_client",
                device=self.device,
            )
            if not ok[0]:  # pragma: no cover - defensive
                raise RuntimeError(
                    "device branch fold disagrees with the host oracle"
                )
        return branch

    @staticmethod
    def _is_better(new, old) -> bool:
        """Spec-shaped is_better_update, reduced to the axes this
        producer generates: finality presence first, then sync-
        aggregate participation; ties keep the incumbent."""
        if old is None:
            return True

        def key(u):
            has_finality = int(u.finalized_header.beacon.slot) > 0
            return (
                has_finality,
                _popcount(u.sync_aggregate.sync_committee_bits),
            )

        return key(new) > key(old)

    def _attested_state_for(self, block):
        """Post-state of `block`: the snapshot cache (keyed by block
        root — correct by construction), else the store. The store
        fallback replays the CANONICAL chain at that slot, which for a
        reorged-off block is a DIFFERENT state — cross-check that the
        fetched state commits to `block` before extracting branches a
        client would verify against block.state_root (a mismatched
        oracle would serve never-verifying updates for a whole
        period)."""
        from lighthouse_tpu_torch.types.helpers import state_anchor_block_root

        chain = self.chain
        root = type(block.message).hash_tree_root(block.message)
        state = chain._snapshots.get(root)
        if state is not None:
            return state
        state = chain.store.state_at_slot(int(block.message.slot))
        if state is None or state_anchor_block_root(state) != root:
            return None
        return state

    # -------------------------------------------------------------- hook

    def on_import(self, block_root=None):
        """Chain import/head-change hook. Cheap on non-altair chains
        (one store read + an attribute check); failures are contained —
        a light-client production problem must never fail an import."""
        if block_root is None:
            return
        try:
            self._on_import_inner(bytes(block_root))
        except Exception as e:
            _LOG.warning("light-client production failed: %s", e)

    def _on_import_inner(self, block_root: bytes):
        if block_root in self._seen_roots:
            self._maybe_build_bootstrap()
            return
        chain = self.chain
        block = chain.store.get_block(block_root)
        if block is None:
            return
        aggregate = getattr(block.message.body, "sync_aggregate", None)
        if aggregate is None:
            return
        self._seen_roots.add(block_root)
        if len(self._seen_roots) > 4096:
            self._seen_roots.clear()
        participation = _popcount(aggregate.sync_committee_bits)
        if participation == 0:
            self._maybe_build_bootstrap()
            return
        attested_block = chain.store.get_block(
            bytes(block.message.parent_root)
        )
        if attested_block is None:
            return
        attested_state = self._attested_state_for(attested_block)
        if attested_state is None or not hasattr(
            attested_state, "current_sync_committee"
        ):
            return
        t = chain.t
        t0 = time.perf_counter()
        attested_header = self._header_for(attested_block)
        signature_slot = int(block.message.slot)

        # ---- optimistic update: newest attested header wins
        if (
            self.optimistic_update is None
            or int(attested_header.beacon.slot)
            >= int(self.optimistic_update.attested_header.beacon.slot)
        ):
            self.optimistic_update = t.LightClientOptimisticUpdate(
                attested_header=attested_header,
                sync_aggregate=aggregate,
                signature_slot=signature_slot,
            )
            self.optimistic_seq += 1
            _PRODUCED.labels("optimistic").inc()

        # ---- proofs out of the attested state (cache-backed chunks)
        oracle = TreeOracle(
            type(attested_state),
            attested_state,
            chunks_override=state_field_chunks(attested_state),
        )
        finalized_header = t.LightClientHeader()
        fin_depth = dict(t.LightClientUpdate._fields)[
            "finality_branch"
        ].length
        finality_branch = [b"\x00" * 32] * fin_depth
        fin = attested_state.finalized_checkpoint
        has_finality = False
        if int(fin.epoch) > 0:
            finalized_block = chain.store.get_block(bytes(fin.root))
            if finalized_block is not None:
                finalized_header = self._header_for(finalized_block)
                finality_branch = self._prove(
                    attested_state, oracle, t.FINALIZED_ROOT_GINDEX
                )
                has_finality = True

        next_branch = self._prove(
            attested_state, oracle, t.NEXT_SYNC_COMMITTEE_GINDEX
        )
        update = t.LightClientUpdate(
            attested_header=attested_header,
            next_sync_committee=attested_state.next_sync_committee,
            next_sync_committee_branch=next_branch,
            finalized_header=finalized_header,
            finality_branch=finality_branch,
            sync_aggregate=aggregate,
            signature_slot=signature_slot,
        )

        period = self._period_at_slot(attested_header.beacon.slot)
        bettered = []
        if self._is_better(update, self.best_updates.get(period)):
            self.best_updates[period] = update
            while len(self.best_updates) > MAX_CACHED_PERIODS:
                del self.best_updates[min(self.best_updates)]
            bettered.append("period_best")
            _PRODUCED.labels("period_best").inc()

        if has_finality and (
            self.finality_update is None
            or int(finalized_header.beacon.slot)
            > int(self.finality_update.finalized_header.beacon.slot)
            or (
                int(finalized_header.beacon.slot)
                == int(
                    self.finality_update.finalized_header.beacon.slot
                )
                and int(attested_header.beacon.slot)
                > int(self.finality_update.attested_header.beacon.slot)
            )
        ):
            self.finality_update = t.LightClientFinalityUpdate(
                attested_header=attested_header,
                finalized_header=finalized_header,
                finality_branch=finality_branch,
                sync_aggregate=aggregate,
                signature_slot=signature_slot,
            )
            self.finality_seq += 1
            bettered.append("finality")
            _PRODUCED.labels("finality").inc()

        chain.journal.emit(
            "lc_update_produced",
            root=block_root,
            slot=signature_slot,
            outcome="bettered" if bettered else "kept",
            duration_s=time.perf_counter() - t0,
            period=period,
            participation=participation,
            attested_slot=int(attested_header.beacon.slot),
            finalized_slot=int(finalized_header.beacon.slot),
        )
        self._maybe_build_bootstrap()

    # ---------------------------------------------------------- bootstrap

    def _maybe_build_bootstrap(self):
        """On finality advance, build the bootstrap document for the new
        finalized block root (header + current sync committee + branch)
        — what a light client starting from that trusted root needs."""
        chain = self.chain
        fin = chain.finalized_checkpoint
        if int(fin.epoch) <= self._last_bootstrap_epoch:
            return
        root = bytes(fin.root)
        block = chain.store.get_block(root)
        if block is None:
            return
        state = self._attested_state_for(block)
        if state is None or not hasattr(state, "current_sync_committee"):
            return
        self._last_bootstrap_epoch = int(fin.epoch)
        t = chain.t
        oracle = TreeOracle(
            type(state), state, chunks_override=state_field_chunks(state)
        )
        branch = self._prove(
            state, oracle, t.CURRENT_SYNC_COMMITTEE_GINDEX
        )
        self.bootstraps[root] = t.LightClientBootstrap(
            header=self._header_for(block),
            current_sync_committee=state.current_sync_committee,
            current_sync_committee_branch=branch,
        )
        while len(self.bootstraps) > MAX_BOOTSTRAPS:
            del self.bootstraps[next(iter(self.bootstraps))]
        _PRODUCED.labels("bootstrap").inc()

    # ------------------------------------------------------------ serving

    def bootstrap_for(self, block_root: bytes):
        return self.bootstraps.get(bytes(block_root))

    def updates_range(self, start_period: int, count: int) -> list:
        return [
            self.best_updates[p]
            for p in range(start_period, start_period + count)
            if p in self.best_updates
        ]

    def stats(self) -> dict:
        return {
            "periods": sorted(self.best_updates),
            "bootstraps": len(self.bootstraps),
            "finality_seq": self.finality_seq,
            "optimistic_seq": self.optimistic_seq,
        }
