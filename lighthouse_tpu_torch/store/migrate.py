"""Finality-driven store lifecycle: background hot→cold migration + pruning.

The port of `lighthouse_tpu/store/migrate.py`.

Role of the reference's `BackgroundMigrator`
(beacon_node/beacon_chain/src/migrate.rs:21-35): every finalization
advance triggers, OFF the block-import critical path, (1) hot states below
the new finalized slot moving into the freezer (restore points kept,
intermediates dropped), (2) pruning of the in-memory caches that key off
finality (snapshots, op-pool attestations, observed-attester epochs). The
reference runs this on a dedicated thread so a slow LevelDB compaction
cannot stall imports; here a single worker thread drains a
latest-wins queue (re-notifying with a newer finalized slot supersedes an
unprocessed older one — migrating to slot 64 subsumes migrating to 32).

`threaded=False` runs notifications synchronously — the deterministic mode
for tests and the in-process simulator.
"""

import logging
import threading

from lighthouse_tpu_torch.common.logging import get_logger, kv


class BackgroundMigrator:
    def __init__(self, chain, threaded: bool = True):
        self.chain = chain
        self.threaded = threaded
        self.log = get_logger("migrator")
        self.runs = 0  # completed migrations (read by tests/metrics)
        self.failures = 0
        self.last_error: str | None = None
        self._pending = None  # latest unprocessed finalized slot
        self._lock = threading.Lock()
        self._wake = threading.Condition(self._lock)
        self._stop = False
        # the worker spawns LAZILY on the first threaded notification:
        # most chains (tests, short sims) never reach a finalization
        # advance, and an eager thread per BeaconNode accumulates dozens
        # of idle daemon threads across a test session
        self._thread = None

    # ------------------------------------------------------------- driving

    def notify_finalized(self, finalized_slot: int, finalized_epoch: int):
        """Called from head recompute when the finalized checkpoint
        advances. The IN-MEMORY cache pruning runs here, on the caller's
        (import) thread — those structures are touched by the import path
        with no locks, so a worker thread must never rebuild them. Only
        the store I/O (hot→cold migration) goes to the worker in
        threaded mode."""
        self._prune_caches(finalized_slot, finalized_epoch)
        if not self.threaded:
            self._migrate_store(finalized_slot)
            self.runs += 1
            return
        with self._wake:
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._worker,
                    name="store-migrator",
                    daemon=True,
                )
                self._thread.start()
            prev = self._pending
            if prev is None or finalized_slot > prev[0]:
                self._pending = (finalized_slot, finalized_epoch)
            self._wake.notify()

    def flush(self, timeout: float = 30.0):
        """Block until the queue is drained (tests; graceful shutdown)."""
        if not self.threaded:
            return
        import time

        deadline = time.monotonic() + timeout
        with self._wake:
            while self._pending is not None or self._busy:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError("migrator flush timed out")
                self._wake.wait(remaining)

    def stop(self):
        with self._wake:
            self._stop = True
            self._wake.notify()
        if self._thread is not None:
            self._thread.join(timeout=10)

    # -------------------------------------------------------------- worker

    _busy = False

    def _worker(self):
        while True:
            with self._wake:
                while self._pending is None and not self._stop:
                    self._wake.wait()
                if self._stop:
                    return
                slot, _epoch = self._pending
                self._pending = None
                self._busy = True
            try:
                self._migrate_store(slot)
                self.runs += 1
            except Exception as e:
                # a failed migration must not kill the node, but it must
                # be VISIBLE: a persistently failing store would
                # otherwise grow the hot column silently — counted AND
                # logged (ADVICE r5: counting alone buried the error)
                self.failures += 1
                self.last_error = repr(e)
                kv(
                    self.log,
                    logging.ERROR,
                    "store migration failed",
                    finalized_slot=slot,
                    failures=self.failures,
                    error=repr(e),
                )
            with self._wake:
                self._busy = False
                self._wake.notify_all()

    # compact the KV every Nth migration (migrate.rs:21-26 triggers
    # LevelDB compaction periodically after finality migrations — every
    # migration would rewrite the log too often)
    COMPACTION_PERIOD = 4

    def _migrate_store(self, finalized_slot: int):
        """The store I/O half: hot states below finality → freezer,
        plus periodic log compaction on backends that support it (the
        native append-log store). Serialization against import-path
        writes happens inside the store: HotColdDB.migrate_to_cold and
        every kv WRITE share `store.lock`, so this worker's multi-op
        hot→cold move never interleaves with an import."""
        self.chain.store.migrate_to_cold(finalized_slot)
        kv = self.chain.store.kv
        if (
            (self.runs + 1) % self.COMPACTION_PERIOD == 0
            and hasattr(kv, "compact")
        ):
            kv.compact()

    def _prune_caches(self, finalized_slot: int, finalized_epoch: int):
        """The in-memory half, ALWAYS on the notifying thread: finalized
        history can never be a fork-choice head again, so snapshots
        below the finalized slot (head excepted) and finality-keyed
        pool/dedup entries go."""
        chain = self.chain
        stale = {
            root
            for root, st in list(chain._snapshots.items())
            if st.slot < finalized_slot and root != chain.head_root
        }
        for root in stale:
            chain._snapshots.pop(root, None)
        chain._snapshot_order = [
            r for r in chain._snapshot_order if r not in stale
        ]
        chain.op_pool.prune_attestations(finalized_epoch)
        chain.observed_attesters.prune(finalized_epoch)
        chain.da_checker.prune(finalized_slot)
