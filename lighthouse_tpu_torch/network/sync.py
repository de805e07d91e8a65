"""Fault-tolerant sync manager: range sync, backfill, parent lookups.

The port of `lighthouse_tpu/network/sync.py`.

Role of the reference's `SyncManager` (network/src/sync/manager.rs:1-34)
plus the batch retry discipline of range_sync/batch.rs: peer Status
reveals a distant finalized/head slot; range sync pulls `BlocksByRange`
batches (EPOCHS_PER_BATCH epochs per request) AND their
`BlobSidecarsByRange` companions, feeds sidecars through the DA checker,
and imports blocks through `process_chain_segment` (one bulk signature
batch per segment — the device-friendly path); single-block parent
lookups resolve unknown-parent gossip blocks via `BlocksByRoot` +
`BlobSidecarsByRoot`.

The req/resp plane is treated as adversarial:

  * range requests (range sync, backfill, completion probes) run
    through one retriable helper (`_fetch`) with per-request timeout
    accounting, capped exponential backoff with DETERMINISTIC jitter
    (seeded per (range, attempt) so chaos runs replay), and rotation
    to a DIFFERENT peer on every attempt; parent lookups iterate
    peers directly (success there means "the block imported", not
    "the response validated") but share the same scoring vocabulary;
  * peer Status is cached with a short TTL so a long sync cannot burn
    its own `status` rate-limit budget, and `RateLimitExceeded` means
    "try the next peer", never "dead peer";
  * malformed responses — out-of-range slots, broken hash chains,
    foreign sidecars, lying advertisers — downscore the serving peer
    through the gossip hub and quarantine it for the rest of the run;
  * a failed batch re-queues the range (bounded) instead of aborting
    the sync loop, and an empty usable-peer set forgives the
    quarantine once per run before giving up (graceful degradation).
"""

import random
import time

from lighthouse_tpu_torch.common.events_journal import JOURNAL
from lighthouse_tpu_torch.common.logging import get_logger
from lighthouse_tpu_torch.common.metrics import REGISTRY, RegistryBackedMetrics
from lighthouse_tpu_torch.common.tracing import span
from lighthouse_tpu_torch.device_plane.executor import DeviceFaultError
from lighthouse_tpu_torch.network.gossip import (
    SCORE_INVALID_MESSAGE,
    SCORE_TIMEOUT,
    SCORE_VALID,
)
from lighthouse_tpu_torch.network.rpc import (
    MAX_REQUEST_BLOB_SIDECARS,
    BlobIdentifier,
    BlobSidecarsByRangeRequest,
    BlocksByRangeRequest,
    DataColumnIdentifier,
    RateLimitExceeded,
    RpcError,
)

_LOG = get_logger("sync")

EPOCHS_PER_BATCH = 2
# peer Status cache TTL: well under the 15 s status-bucket window, so a
# sync loop re-checks heads often enough to notice progress but never
# polls one peer more than ~2x per bucket refill
STATUS_TTL_SECONDS = 6.0
MAX_ATTEMPTS_PER_REQUEST = 4  # distinct peers tried per request
MAX_REQUEUES_PER_RANGE = 3  # failed-batch re-queues before giving up
MAX_PARENT_CHAIN_DEPTH = 32  # ancestor-walk bound for parent lookups
MAX_RATE_LIMIT_STRIKES = 3  # consecutive rate-limit answers -> quarantine
BACKOFF_BASE_SECONDS = 0.02
BACKOFF_CAP_SECONDS = 1.0
REQUEST_TIMEOUT_SECONDS = 5.0

# validation verdicts that are SUSPICIOUS but not provably malicious —
# they rotate the peer score-free instead of quarantining it
SOFT_VALIDATION_REASONS = {
    "empty_range_from_advertising_peer",
    "uncovering_sidecar_response",
}
# a cached status may serve as a fallback when a refresh fails, but only
# this long — past it the peer is treated as unreachable, so a crashed
# peer cannot pin its last advertised head in the usable set forever
STATUS_STALE_MAX_SECONDS = 30.0

_BATCHES = REGISTRY.counter_vec(
    "lighthouse_tpu_sync_batches_total",
    "range-sync batches, by outcome (imported|requeued|abandoned|empty)",
    ("outcome",),
)
_RETRIES = REGISTRY.counter(
    "lighthouse_tpu_sync_batch_retries_total",
    "req/resp attempts beyond the first, across all sync request kinds",
)
_REQUEST_ERRORS = REGISTRY.counter_vec(
    "lighthouse_tpu_sync_request_errors_total",
    "req/resp client failures seen by the sync manager "
    "(kind: timeout|rate_limited|error|malformed)",
    ("method", "kind"),
)
_DOWNSCORES = REGISTRY.counter_vec(
    "lighthouse_tpu_sync_peer_downscores_total",
    "peer downscores issued by the sync manager, by reason",
    ("reason",),
)
_BACKOFF_SECONDS = REGISTRY.counter(
    "lighthouse_tpu_sync_backoff_seconds_total",
    "total backoff delay requested between sync retries",
)
_BLOCKS_SYNCED = REGISTRY.counter(
    "lighthouse_tpu_sync_blocks_synced_total",
    "blocks imported via range sync",
)
_SIDECARS_FETCHED = REGISTRY.counter(
    "lighthouse_tpu_sync_sidecars_fetched_total",
    "blob sidecars fetched over req/resp and routed into the DA checker",
)
_QUARANTINED = REGISTRY.gauge(
    "lighthouse_tpu_sync_quarantined_peers",
    "peers currently quarantined by the sync manager",
)
_QUARANTINE_RESETS = REGISTRY.counter(
    "lighthouse_tpu_sync_quarantine_resets_total",
    "times an empty usable-peer set forgave the quarantine to keep "
    "syncing (graceful degradation)",
)


class SyncManager:
    def __init__(
        self,
        chain,
        spec,
        hub=None,
        rng_seed=0,
        sleep=None,
        local_peer_id=None,
    ):
        self.chain = chain
        self.spec = spec
        # gossip hub (or SocketNet) for peer scoring; None = scoreless
        self.hub = hub
        # how this node identifies itself to serving peers — their rate
        # limiter buckets key on it, so it must be per-NODE (two nodes
        # sharing an id would drain each other's budgets)
        self.local_peer_id = local_peer_id
        self.peers: dict[str, object] = {}  # peer_id -> RpcServer handle
        self.quarantined: set[str] = set()
        # the node's lifecycle journal (chain-owned, per node): every
        # request attempt, batch outcome, downscore, and quarantine
        # lands there with peer attribution
        self.journal = getattr(chain, "journal", None) or JOURNAL
        # dict-compatible view mirrored onto lighthouse_tpu_sync_client_*
        # registry gauges:
        # EVERY sync-internal number — progress counters AND the
        # previously hand-rolled peer-view gauges (usable peers,
        # quarantine size, live rate-limit strikes, status-cache
        # occupancy) — rides this one view, so sync internals, /metrics
        # scrapes, and registry snapshots read the same numbers; the
        # sync_* counter families above stay the cross-peer totals
        self.metrics = RegistryBackedMetrics(
            "lighthouse_tpu_sync_client_",
            initial={
                "batches": 0,
                "blocks_synced": 0,
                "retries": 0,
                "requeues": 0,
                "sidecars_fetched": 0,
                "peers": 0,
                "quarantined": 0,
                "rl_strikes_active": 0,
                "status_cache_entries": 0,
            },
        )
        self.request_timeout = REQUEST_TIMEOUT_SECONDS
        self._status_cache: dict[str, tuple] = {}  # pid -> (status, t)
        self._rl_strikes: dict[str, int] = {}
        self._rng_seed = rng_seed
        self._sleep = sleep if sleep is not None else time.sleep
        self._last_sidecar_peer = None

    # -------------------------------------------------------------- peers

    def _refresh_peer_gauges(self):
        """Mirror the peer-view internals onto the registry-backed view
        so /metrics carries them."""
        self.metrics["peers"] = len(self.peers)
        self.metrics["quarantined"] = len(self.quarantined)
        self.metrics["rl_strikes_active"] = len(self._rl_strikes)
        self.metrics["status_cache_entries"] = len(self._status_cache)

    def add_peer(self, peer_id: str, rpc_server):
        self.peers.setdefault(peer_id, rpc_server)
        self.quarantined.discard(peer_id)
        _QUARANTINED.set(len(self.quarantined))
        self._refresh_peer_gauges()

    def remove_peer(self, peer_id: str):
        self.peers.pop(peer_id, None)
        self.quarantined.discard(peer_id)
        self._status_cache.pop(peer_id, None)
        self._rl_strikes.pop(peer_id, None)
        _QUARANTINED.set(len(self.quarantined))
        self._refresh_peer_gauges()

    def disconnect(self, peer_id: str, reason: int = 1):
        """Clean client-side disconnect: send `goodbye`, drop the peer."""
        rpc = self.peers.get(peer_id)
        if rpc is not None:
            try:
                rpc.goodbye(self._caller(), reason)
            except Exception as e:
                # best-effort farewell: the peer is going away anyway
                _LOG.debug("goodbye to %s failed: %s", peer_id, e)
        self.remove_peer(peer_id)

    def _caller(self) -> str:
        if self.local_peer_id is not None:
            return self.local_peer_id
        return self.chain.genesis_root.hex()[:8]

    def _downscore(self, peer_id: str, delta: float, reason: str):
        _DOWNSCORES.labels(reason).inc()
        self.journal.emit(
            "peer_downscore", peer=peer_id, outcome=reason, delta=delta
        )
        if self.hub is not None:
            try:
                self.hub.report(peer_id, delta)
            except Exception as e:
                # the score still counts locally; a hub glitch must not
                # break the sync path — but it must be visible
                _LOG.warning(
                    "hub.report(%s, %s) failed: %s", peer_id, delta, e
                )

    def _quarantine(self, peer_id: str, reason: str):
        self._downscore(peer_id, SCORE_INVALID_MESSAGE, reason)
        self.quarantined.add(peer_id)
        self.journal.emit(
            "peer_quarantine", peer=peer_id, outcome=reason
        )
        _QUARANTINED.set(len(self.quarantined))
        self._refresh_peer_gauges()

    def _peer_status(self, peer_id: str, rpc):
        """Cached Status with a short TTL. RateLimitExceeded falls back
        to the stale cache (our own polling budget, not a dead peer)."""
        now = time.monotonic()
        cached = self._status_cache.get(peer_id)
        if cached is not None and now - cached[1] <= STATUS_TTL_SECONDS:
            return cached[0]
        try:
            st = rpc.status(self._caller())
        except RateLimitExceeded:
            _REQUEST_ERRORS.labels("status", "rate_limited").inc()
            return self._stale_status(peer_id, now)
        except Exception:
            _REQUEST_ERRORS.labels("status", "error").inc()
            return self._stale_status(peer_id, now)
        self._status_cache[peer_id] = (st, now)
        self._refresh_peer_gauges()
        return st

    def _stale_status(self, peer_id: str, now: float):
        """Bounded stale fallback: a failed refresh may reuse the last
        status for STATUS_STALE_MAX_SECONDS; beyond that the entry is
        dropped and the peer reads unreachable."""
        cached = self._status_cache.get(peer_id)
        if cached is not None and now - cached[1] <= (
            STATUS_STALE_MAX_SECONDS
        ):
            return cached[0]
        self._status_cache.pop(peer_id, None)
        self._refresh_peer_gauges()
        return None

    def _usable_peers(self):
        """[(peer_id, rpc, head_slot)] sorted best-head-first, skipping
        quarantined peers and peers with no reachable status."""
        out = []
        for pid, rpc in self.peers.items():
            if pid in self.quarantined:
                continue
            st = self._peer_status(pid, rpc)
            if st is None:
                continue
            out.append((pid, rpc, int(st.head_slot)))
        out.sort(key=lambda x: -x[2])
        return out

    def _best_peer(self):
        peers = self._usable_peers()
        if not peers:
            return None, -1
        pid, rpc, head_slot = peers[0]
        return (pid, rpc), head_slot

    # ----------------------------------------------------- retriable unit

    def _backoff(self, key: str, attempt: int):
        """Capped exponential backoff with deterministic jitter: the
        delay for (seed, key, attempt) is a pure function, so a chaos
        run replays exactly from its seed."""
        rng = random.Random(f"{self._rng_seed}:{key}:{attempt}")
        delay = min(
            BACKOFF_CAP_SECONDS, BACKOFF_BASE_SECONDS * (2**attempt)
        )
        delay *= 0.5 + rng.random()  # jitter in [0.5, 1.5)
        _BACKOFF_SECONDS.inc(delay)
        self._sleep(delay)

    def _fetch(self, method: str, key: str, call, validate=None,
               prefer=None, min_head=None, stats=None):
        """One retriable req/resp unit: try up to
        MAX_ATTEMPTS_PER_REQUEST DISTINCT peers (best cached head first,
        `prefer` before all), backing off between attempts. `min_head`
        excludes peers whose advertised head is below it — an empty
        reply is only authoritative from a peer that claims to HAVE the
        range, so behind-peers must not serve (and thereby end) a range
        request. `call(pid, rpc)` runs the request; `validate(result,
        peer_head)` returns an error reason or None — a malformed
        response downscores AND (unless the reason is soft) quarantines
        the serving peer. Returns (peer_id, result) or (None, None)
        when every attempt failed."""
        tried: set[str] = set()
        for attempt in range(MAX_ATTEMPTS_PER_REQUEST):
            candidates = [
                c
                for c in self._usable_peers()
                if c[0] not in tried
                and (min_head is None or c[2] >= min_head)
            ]
            if prefer is not None:
                candidates.sort(key=lambda c: c[0] != prefer)
            if not candidates:
                break
            pid, rpc, peer_head = candidates[0]
            tried.add(pid)
            if stats is not None:
                stats["attempts"] = stats.get("attempts", 0) + 1
            if attempt:
                _RETRIES.inc()
                self.metrics["retries"] += 1
                self._backoff(key, attempt)
            t0 = time.monotonic()

            def _req_event(outcome, **attrs):
                self.journal.emit(
                    "sync_request",
                    peer=pid,
                    outcome=outcome,
                    duration_s=time.monotonic() - t0,
                    method=method,
                    attempt=attempt,
                    **attrs,
                )

            try:
                with span(f"sync/{method}", peer=pid, attempt=attempt):
                    result = call(pid, rpc)
            except RateLimitExceeded:
                # the peer says WE are over budget — usually our own
                # polling; rotate without penalty, but a peer that
                # answers nothing but rate-limits is starving us.
                # The quarantine here is SCORELESS: being over budget
                # is this client's doing, so the peer must not bleed
                # toward the gossip ban threshold for it
                _REQUEST_ERRORS.labels(method, "rate_limited").inc()
                _req_event("rate_limited")
                strikes = self._rl_strikes.get(pid, 0) + 1
                self._rl_strikes[pid] = strikes
                self._refresh_peer_gauges()
                if strikes >= MAX_RATE_LIMIT_STRIKES:
                    _DOWNSCORES.labels("rate_limit_starvation").inc()
                    self.journal.emit(
                        "peer_quarantine",
                        peer=pid,
                        outcome="rate_limit_starvation",
                    )
                    self.quarantined.add(pid)
                    _QUARANTINED.set(len(self.quarantined))
                continue
            except RpcError as e:
                kind = "timeout" if e.code == 2 else "error"
                _REQUEST_ERRORS.labels(method, kind).inc()
                _req_event(kind)
                self._downscore(pid, SCORE_TIMEOUT, kind)
                continue
            except Exception:
                _REQUEST_ERRORS.labels(method, "error").inc()
                _req_event("error")
                self._downscore(pid, SCORE_TIMEOUT, "error")
                continue
            self._rl_strikes.pop(pid, None)
            if time.monotonic() - t0 > self.request_timeout:
                # late but present: count the stall, keep the data
                _REQUEST_ERRORS.labels(method, "timeout").inc()
                self._downscore(pid, SCORE_TIMEOUT, "slow_response")
            if validate is not None:
                reason = validate(result, peer_head)
                if reason is not None:
                    _REQUEST_ERRORS.labels(method, "malformed").inc()
                    _req_event("malformed", reason=reason)
                    if reason in SOFT_VALIDATION_REASONS:
                        # not provably malicious (an all-skip-slot range
                        # or pruned history also yields an empty answer
                        # from a high-head peer): rotate to cross-check
                        # against other peers, score-free — the caller
                        # reads `stats` to see whether the answer was
                        # UNANIMOUS across peers
                        if stats is not None:
                            stats["soft"] = stats.get("soft", 0) + 1
                    else:
                        self._quarantine(pid, reason)
                    continue
            _req_event("ok")
            return pid, result
        return None, None

    # ----------------------------------------------------------- range sync

    def run_range_sync(
        self, max_batches: int = 64, batch_slots: int | None = None
    ) -> int:
        """Pull batches until caught up with the best peer, fetching
        missing blob sidecars alongside each batch so blob-committing
        segments import through the DA gate. A failed batch re-queues
        the range against rotated peers instead of ending the sync.
        Returns blocks imported."""
        imported = 0
        batch_slots = batch_slots or (
            EPOCHS_PER_BATCH * self.spec.SLOTS_PER_EPOCH
        )
        # a batch must stay inside the server's sidecar window — the
        # blocks bucket could fund a larger request, but its sidecar
        # companion would be clamped server-side and the truncated DA
        # data would read as withholding
        batch_slots = min(
            batch_slots,
            MAX_REQUEST_BLOB_SIDECARS // self.spec.MAX_BLOBS_PER_BLOCK,
        )
        requeues = 0
        forgiven = False
        # the fetch cursor: normally head+1, but it advances PAST a
        # window every usable peer unanimously reports empty (an
        # all-skip-slot stretch would otherwise pin the sync forever —
        # blocks beyond it still chain to our head, so importing them
        # needs no blocks from the empty window)
        cursor = 0
        for _ in range(max_batches):
            peers = self._usable_peers()
            if not peers and self.quarantined and not forgiven:
                # graceful degradation: everyone is quarantined but the
                # range is not done — forgive ONCE per run rather than
                # stalling forever on our own suspicion (rate-limit
                # strikes reset with it: they describe the budget we
                # ourselves exhausted)
                self.quarantined.clear()
                self._rl_strikes.clear()
                _QUARANTINED.set(0)
                self._refresh_peer_gauges()
                _QUARANTINE_RESETS.inc()
                self.journal.emit("peer_quarantine", outcome="forgiven")
                forgiven = True
                peers = self._usable_peers()
            if not peers:
                break
            target = max(head_slot for _, _, head_slot in peers)
            head = self.chain.head_state.slot
            cursor = max(cursor, head + 1)
            # the TTL-cached target can lag a fast-moving peer by
            # several slots, and the scarce status bucket (5/15 s)
            # cannot fund a fresh poll per batch. So completion is
            # confirmed with a PROBE: one more blocks_by_range past the
            # cursor (the 1024-token blocks bucket is plentiful),
            # ignoring the advertised-head filter. Probes that produce
            # blocks keep pulling; an unproductive probe means done.
            probe = target < cursor
            start = cursor
            count = (
                batch_slots
                if probe
                else min(batch_slots, target - start + 1)
            )
            outcome, n = self._sync_one_batch(start, count, probe=probe)
            _BATCHES.labels(outcome).inc()
            self.journal.emit(
                "sync_batch",
                slot=start,
                outcome=outcome,
                n_blocks=n,
                count=count,
                probe=probe,
            )
            imported += n
            if n > 0:
                # progress — imported fully, or a retriable failure
                # after a prefix landed. Either way keep pulling (in
                # probe mode too: a productive probe proves the peers
                # have more) and reset the no-progress budget
                requeues = 0
                cursor = 0  # restart from the (advanced) head
                if outcome == "imported":
                    self.metrics["batches"] += 1
                else:
                    self.metrics["requeues"] += 1
                continue
            if probe:
                break
            if outcome == "window_empty":
                # every usable peer agrees [start, start+count) holds
                # nothing: step the cursor over the skip window
                cursor = start + count
                continue
            if outcome in ("requeued", "abandoned"):
                # "abandoned" = every peer failed THIS request; the
                # loop-top forgiveness may still rescue the next pass,
                # so both count against the same bounded requeue budget
                self.metrics["requeues"] += 1
                requeues += 1
                if requeues > MAX_REQUEUES_PER_RANGE:
                    break
                cursor = 0  # rewind: the window may have been skipped
                # on a lying peer's word
                continue
            break  # empty: the best advertised range holds no data
        return imported

    def _validate_block_range(self, start: int, count: int):
        def validate(blocks, peer_head):
            if not blocks:
                # a peer advertising a head inside (or past) the range
                # yet serving nothing is lying about one or the other
                if peer_head >= start:
                    return "empty_range_from_advertising_peer"
                return None
            prev_slot = -1
            prev_root = None
            for sb in blocks:
                slot = int(sb.message.slot)
                if slot < start or slot >= start + count:
                    return "slot_out_of_range"
                if slot <= prev_slot:
                    return "unordered_slots"
                if prev_root is not None and (
                    bytes(sb.message.parent_root) != prev_root
                ):
                    return "hash_chain_violation"
                prev_slot = slot
                prev_root = type(sb.message).hash_tree_root(sb.message)
            return None

        return validate

    def _sync_one_batch(self, start: int, count: int, probe: bool = False):
        """Returns (outcome, blocks_imported). `probe` disables the
        advertised-head candidate filter — a completion probe must reach
        peers whose TTL-cached status understates their real head."""
        min_head = None if probe else start
        # suspect tracking is per-batch: a DA failure must never be
        # pinned on a peer that served a PREVIOUS batch's sidecars
        self._last_sidecar_peer = None
        stats: dict = {}
        with span("sync/batch", start=start, count=count, probe=probe):
            pid, blocks = self._fetch(
                "blocks_by_range",
                f"range:{start}",
                lambda p, r: r.blocks_by_range(
                    self._caller(),
                    BlocksByRangeRequest(
                        start_slot=start, count=count, step=1
                    ),
                ),
                validate=self._validate_block_range(start, count),
                min_head=min_head,
                stats=stats,
            )
            if pid is None:
                attempts = stats.get("attempts", 0)
                if attempts and stats.get("soft", 0) == attempts:
                    # every peer that answered says the window is empty
                    # — a unanimous verdict is authoritative (all-skip
                    # slots), a single peer's word is not (see _fetch)
                    return "window_empty", 0
                return "abandoned", 0
            if not blocks:
                return "empty", 0
            if not self._fetch_segment_sidecars(
                blocks, start, count, pid, min_head=min_head
            ):
                return "requeued", 0
            try:
                with span("sync/import_segment", blocks=len(blocks)):
                    roots = self.chain.process_chain_segment(blocks)
            except DeviceFaultError:
                # the card failed, not the segment: quarantine no peer
                raise
            except Exception as e:
                msg = str(e)
                if "data unavailable" in msg:
                    # the sidecar response was incomplete or its blobs
                    # failed KZG at settle time — the sidecar server is
                    # the suspect
                    suspect = self._last_sidecar_peer or pid
                    self._quarantine(suspect, "segment_data_unavailable")
                elif (
                    "parent unknown" not in msg
                    and "unknown parent" not in msg
                ):
                    # the block server handed us an unimportable segment
                    # (signature batch failure, invalid block, ...)
                    self._quarantine(pid, "segment_invalid")
                # an unknown parent — either phrasing: "segment parent
                # unknown" from the segment pre-pass or "unknown parent"
                # from _import_verified mid-apply — is not provably the
                # peer's fault (we may be on the wrong side of a fork):
                # requeue penalty-free; the requeue cap bounds the loop.
                # A mid-segment failure still imported its prefix —
                # count what actually landed (the range always starts
                # above the pre-batch head, so nothing pre-existed)
                landed = sum(
                    1
                    for sb in blocks
                    if self.chain.store.get_block(
                        type(sb.message).hash_tree_root(sb.message)
                    )
                    is not None
                )
                _BLOCKS_SYNCED.inc(landed)
                self.metrics["blocks_synced"] += landed
                return "requeued", landed
            if self.hub is not None and roots:
                self.hub.report(pid, SCORE_VALID)
            _BLOCKS_SYNCED.inc(len(roots))
            self.metrics["blocks_synced"] += len(roots)
            return "imported", len(roots)

    def _fetch_segment_sidecars(
        self,
        blocks,
        start: int,
        count: int,
        block_peer: str,
        min_head=None,
    ) -> bool:
        """Fetch the blob sidecars a segment needs and route them into
        the DA checker ahead of import. Returns False when sidecars are
        needed but unfetchable (the batch must requeue)."""
        da = self.chain.da_checker
        needed: dict[bytes, tuple] = {}
        for sb in blocks:
            if not da.block_commitments(sb):
                continue
            root = type(sb.message).hash_tree_root(sb.message)
            missing = da.missing_indices(root, sb)
            if missing:
                needed[root] = (sb, missing)
        if not needed:
            return True
        if getattr(da, "put_column", None) is not None:
            # column mode: blob sidecars don't exist on this node's
            # wire — pull each block's missing columns by root instead
            return self._fetch_segment_columns(needed, block_peer)

        needed_keys = {
            (root, i)
            for root, (_, missing) in needed.items()
            for i in missing
        }

        def validate(sidecars, peer_head):
            seen = set()
            for sc in sidecars:
                hdr = sc.signed_block_header.message
                slot = int(hdr.slot)
                if slot < start or slot >= start + count:
                    return "sidecar_slot_out_of_range"
                key = (type(hdr).hash_tree_root(hdr), int(sc.index))
                if key in seen:
                    return "duplicate_sidecar"
                seen.add(key)
            if not seen & needed_keys:
                # withholding (or honest blob-pruned history): rotate
                # to another sidecar server BEFORE the segment pays its
                # state transitions + signature batch only to fail the
                # DA gate
                return "uncovering_sidecar_response"
            return None

        pid, sidecars = self._fetch(
            "blob_sidecars_by_range",
            f"sidecars:{start}",
            lambda p, r: r.blob_sidecars_by_range(
                self._caller(),
                BlobSidecarsByRangeRequest(start_slot=start, count=count),
            ),
            validate=validate,
            prefer=block_peer,
            min_head=min_head,
        )
        if pid is None:
            return False
        self._last_sidecar_peer = pid
        # foreign roots are NOT penalized here: a by_range response
        # legitimately includes sidecars for in-range blocks we already
        # hold
        self._ingest_bound_sidecars(pid, sidecars, needed)
        return True

    def _ingest_bound_sidecars(
        self, pid, sidecars, wanted, foreign_reason=None
    ) -> int:
        """Route fetched sidecars into the DA checker under the
        structural binding rule shared by range sync and parent lookup:
        the sidecar's header must carry EXACTLY the served block's
        signature, so the block's own (batch- or import-time) proposal
        check covers the sidecar header with no extra pairing (see
        PERF_NOTES). `wanted` maps block root -> (signed block, wanted
        index set); `foreign_reason` set means a sidecar for any OTHER
        root is a scored offense (by-root requests name exact roots).
        Returns the number ingested."""
        fetched = 0
        for sc in sidecars:
            hdr = sc.signed_block_header.message
            root = type(hdr).hash_tree_root(hdr)
            entry = wanted.get(root)
            if entry is None:
                if foreign_reason is not None:
                    self._downscore(
                        pid, SCORE_INVALID_MESSAGE, foreign_reason
                    )
                continue
            sb, indices = entry
            if int(sc.index) not in indices:
                continue
            if bytes(sc.signed_block_header.signature) != bytes(
                sb.signature
            ):
                self._downscore(
                    pid, SCORE_INVALID_MESSAGE, "sidecar_header_mismatch"
                )
                continue
            try:
                self.chain.process_blob_sidecar(sc, verify_header=False)
                fetched += 1
            except Exception as e:
                # duplicates on a re-queued range are expected; real
                # mismatches surface as DA failures at import
                _LOG.debug("sidecar ingest skipped: %s", e)
        _SIDECARS_FETCHED.inc(fetched)
        self.metrics["sidecars_fetched"] += fetched
        return fetched

    # ------------------------------------------------------------ backfill

    def run_backfill(self, batch_slots: int | None = None) -> int:
        """Backfill history behind a checkpoint anchor
        (network/src/sync/backfill_sync/mod.rs): fetch blocks BACKWARDS
        from the anchor, verify the parent-root hash chain plus one bulk
        proposer-signature batch per batch (no state transitions), and
        store them. Failed batches rotate peers like range sync."""
        from lighthouse_tpu_torch.state_processing import signature_sets as ss

        anchor = getattr(self.chain, "anchor_slot", None)
        if not anchor:
            return 0
        batch_slots = batch_slots or (
            EPOCHS_PER_BATCH * self.spec.SLOTS_PER_EPOCH
        )
        stored = 0
        # expected parent of the lowest block we hold
        lowest = self.chain.store.get_canonical_block_root(anchor)
        expected_parent = bytes(
            self.chain.store.get_block(lowest).message.parent_root
        )
        next_end = anchor  # exclusive
        requeues = 0
        while next_end > 1:
            start = max(1, next_end - batch_slots)
            count = next_end - start
            pid, blocks = self._fetch(
                "blocks_by_range",
                f"backfill:{start}",
                lambda p, r: r.blocks_by_range(
                    self._caller(),
                    BlocksByRangeRequest(
                        start_slot=start, count=count, step=1
                    ),
                ),
                validate=self._validate_block_range(start, count),
                min_head=start,
            )
            if pid is None or not blocks:
                break
            state = self.chain.head_state
            self.chain.pubkey_cache.import_new(state)
            sets = [
                ss.block_proposal_set(
                    state, sb, self.chain.pubkey_cache.get, self.spec
                )
                for sb in blocks
            ]
            ok = self.chain.verification_bus.submit(
                sets,
                consumer="sync_segment",
                backend=self.chain.backend,
                journal=self.journal,
                slot=start,
                journal_attrs={
                    "n_blocks": len(blocks),
                    "backfill": True,
                },
            )
            if ok:
                # hash-chain walk backwards against the known child:
                # validate the WHOLE batch before storing any of it, so
                # a mid-batch break leaves the store untouched and the
                # range retries cleanly against another peer
                exp = expected_parent
                checked = []
                for sb in reversed(blocks):
                    root = type(sb.message).hash_tree_root(sb.message)
                    if root != exp:
                        checked = None
                        break
                    checked.append((root, sb))
                    exp = bytes(sb.message.parent_root)
                if checked is not None:
                    for root, sb in checked:
                        self.chain.store.put_block(root, sb)
                        self.chain.store.set_canonical_block_root(
                            sb.message.slot, root
                        )
                        stored += 1
                    expected_parent = exp
                    next_end = start
                    requeues = 0
                    continue
            # the peer served signature-invalid or chain-breaking blocks:
            # quarantine it and retry the SAME range against another peer
            self._quarantine(pid, "backfill_batch_invalid")
            _BATCHES.labels("requeued").inc()
            self.metrics["requeues"] += 1
            requeues += 1
            if requeues > MAX_REQUEUES_PER_RANGE:
                break
        return stored

    # ------------------------------------------------------ parent lookup

    def lookup_parent(
        self, parent_root: bytes, _depth: int = 0, _failed=None
    ) -> bool:
        """Parent-chain lookup for an unknown parent (block_lookups/):
        fetch the parent by root, and when the parent ITSELF has an
        unknown parent, recurse down the ancestor chain (bounded at
        MAX_PARENT_CHAIN_DEPTH — the reference's parent-lookup chains
        do the same walk) before importing back up. This is how a node
        rejoining after a partition/eclipse adopts the other side's
        branch from one gossip block: the whole fork segment imports
        oldest-first through this walk. Each level fetches that block's
        blob sidecars too when its body commits to blobs — a
        blob-committing ancestor imports through the DA gate from
        req/resp alone. A peer whose returned block fails import is
        downscored, not silently tolerated.

        `_failed` memoizes roots that already failed WITHIN one
        top-level walk: without it, every peer at every depth serving
        the (hash-verified, so identical) block would re-trigger the
        full deeper recursion that just failed — O(peers^depth) RPCs
        from a single old orphan."""
        if _depth >= MAX_PARENT_CHAIN_DEPTH:
            return False
        parent_root = bytes(parent_root)
        if _failed is None:
            _failed = set()
        if parent_root in _failed:
            return False
        da = self.chain.da_checker
        # quarantined peers stay excluded here too — a lookup that
        # cannot be served by any trusted peer fails and retries on the
        # next trigger rather than consulting a known-bad server
        candidates = [
            (pid, rpc)
            for pid, rpc in self.peers.items()
            if pid not in self.quarantined
        ]
        for pid, rpc in candidates:
            try:
                with span("sync/blocks_by_root", peer=pid):
                    blocks = rpc.blocks_by_root(
                        self._caller(), [parent_root]
                    )
            except RateLimitExceeded:
                _REQUEST_ERRORS.labels(
                    "blocks_by_root", "rate_limited"
                ).inc()
                continue
            except Exception:
                _REQUEST_ERRORS.labels("blocks_by_root", "error").inc()
                continue
            if not blocks:
                continue
            block = blocks[0]
            root = type(block.message).hash_tree_root(block.message)
            if root != parent_root:
                self._downscore(
                    pid, SCORE_INVALID_MESSAGE, "wrong_block_by_root"
                )
                continue
            if da.block_commitments(block):
                self._fetch_lookup_sidecars(pid, rpc, parent_root, block)
            try:
                self.chain.process_block(block)
                return True
            except Exception as e:
                msg = str(e)
                if "already" in msg:
                    return True
                if "unknown parent" in msg:
                    # walk one level deeper down the ancestor chain,
                    # then retry THIS block on top of it
                    if self.lookup_parent(
                        bytes(block.message.parent_root),
                        _depth=_depth + 1,
                        _failed=_failed,
                    ):
                        try:
                            self.chain.process_block(block)
                            return True
                        except Exception as e2:
                            _LOG.debug(
                                "parent retry after chain walk "
                                "failed: %s", e2,
                            )
                    continue
                if (
                    "data unavailable" in msg
                    or "parent state" in msg
                ):
                    # sidecars unfetchable, or OUR pruned state — not
                    # provably this peer's fault; try another
                    continue
                self._downscore(
                    pid, SCORE_INVALID_MESSAGE, "invalid_parent_block"
                )
                continue
        _failed.add(parent_root)
        return False

    def _fetch_lookup_sidecars(self, pid, rpc, root: bytes, block):
        """Pull the missing sidecars for a by-root block from the same
        peer and stage them in the DA checker; the following
        process_block settles and verifies them."""
        missing = self.chain.da_checker.missing_indices(root, block)
        if not missing:
            return
        if getattr(self.chain.da_checker, "put_column", None) is not None:
            self._fetch_lookup_columns(pid, rpc, root, block)
            return
        idents = [
            BlobIdentifier(block_root=root, index=i)
            for i in sorted(missing)
        ]
        try:
            with span("sync/blob_sidecars_by_root", peer=pid):
                sidecars = rpc.blob_sidecars_by_root(
                    self._caller(), idents
                )
        except RateLimitExceeded:
            _REQUEST_ERRORS.labels(
                "blob_sidecars_by_root", "rate_limited"
            ).inc()
            return
        except Exception:
            _REQUEST_ERRORS.labels("blob_sidecars_by_root", "error").inc()
            return
        # by-root named exact roots, so a foreign sidecar is an offense
        self._ingest_bound_sidecars(
            pid,
            sidecars,
            {root: (block, missing)},
            foreign_reason="foreign_sidecar",
        )

    def _fetch_lookup_columns(self, pid, rpc, root: bytes, block):
        """Column-mode twin of the blob lookup fetch: pull the missing
        column sidecars for a by-root block from the same peer and
        route them through the chain's column entry point. The
        structural binding rule is the blob plane's: a column whose
        header does not carry EXACTLY the served block's signature is
        a scored offense, and the accepted header needs no extra
        pairing because the block's own proposal check covers it.
        Crossing the 50% threshold inside this loop releases (and
        imports) the held block; the caller's process_block then hits
        the known-block gate, which lookup_parent treats as success."""
        da = self.chain.da_checker
        missing = da.missing_indices(root, block)
        if not missing:
            return
        idents = [
            DataColumnIdentifier(block_root=root, index=i)
            for i in sorted(missing)
        ]
        try:
            with span("sync/data_column_sidecars_by_root", peer=pid):
                sidecars = rpc.data_column_sidecars_by_root(
                    self._caller(), idents
                )
        except RateLimitExceeded:
            _REQUEST_ERRORS.labels(
                "data_column_sidecars_by_root", "rate_limited"
            ).inc()
            return
        except Exception:
            _REQUEST_ERRORS.labels(
                "data_column_sidecars_by_root", "error"
            ).inc()
            return
        fetched = 0
        for sc in sidecars:
            hdr = sc.signed_block_header.message
            if type(hdr).hash_tree_root(hdr) != root:
                self._downscore(
                    pid, SCORE_INVALID_MESSAGE, "foreign_sidecar"
                )
                continue
            if int(sc.index) not in missing:
                continue
            if bytes(sc.signed_block_header.signature) != bytes(
                block.signature
            ):
                self._downscore(
                    pid, SCORE_INVALID_MESSAGE, "sidecar_header_mismatch"
                )
                continue
            try:
                self.chain.process_data_column_sidecar(
                    sc, verify_header=False
                )
                fetched += 1
            except Exception as e:
                # duplicates on a retried lookup are expected; real
                # mismatches surface as DA failures at import
                _LOG.debug("column ingest skipped: %s", e)
        if fetched:
            try:
                # a block the checker never registered caches the
                # fetched columns as UNVERIFIED candidates; put_block
                # settles them in one folded cell batch so
                # missing_indices reflects the fetch (no-op when the
                # block was already registered or held)
                da.put_block(root, block)
            except Exception as e:
                _LOG.debug("column settle skipped: %s", e)
        _SIDECARS_FETCHED.inc(fetched)
        self.metrics["sidecars_fetched"] += fetched

    def _fetch_segment_columns(self, needed, block_peer) -> bool:
        """Column-mode twin of `_fetch_segment_sidecars`' fetch half:
        by-range blob requests have no column analog here, so each
        blob-committing block in the segment pulls its missing columns
        by root — from the block's server first, then any other
        trusted peer. Returns False when some block stays below its
        50% threshold (the batch must requeue)."""
        da = self.chain.da_checker
        ordered = [block_peer] + [
            p for p in self.peers if p != block_peer
        ]
        ok = True
        for root, (sb, _missing) in needed.items():
            for pid in ordered:
                rpc = self.peers.get(pid)
                if rpc is None or pid in self.quarantined:
                    continue
                self._fetch_lookup_columns(pid, rpc, root, sb)
                if not da.missing_indices(root, sb):
                    break
            if da.missing_indices(root, sb):
                ok = False
        return ok
