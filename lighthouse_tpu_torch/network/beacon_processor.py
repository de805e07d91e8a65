"""Beacon processor: bounded priority work queues feeding worker threads.

The port of `lighthouse_tpu/network/beacon_processor.py`.

Role of the reference's `BeaconProcessor`
(beacon_node/network/src/beacon_processor/mod.rs:1-40 design doc,
:85-120 queue bounds): a manager drains per-kind bounded FIFO/LIFO queues
in priority order into a capped worker pool. Two reference behaviors are
preserved because they shape the device data plane:

  * attestation COALESCING — queued gossip attestations are handed to one
    worker as a batch (mod.rs attestation queues), which downstream becomes
    ONE device signature batch;
  * the reprocessing queue — early (future-slot) or unknown-parent work is
    delayed and re-injected (work_reprocessing_queue.rs).
"""

import heapq
import threading

from lighthouse_tpu_torch.common.events_journal import JOURNAL
from lighthouse_tpu_torch.common.locks import TimedLock
from lighthouse_tpu_torch.common.metrics import REGISTRY
from lighthouse_tpu_torch.network.shedding import SheddingPolicy
import time
from dataclasses import dataclass, field

# queue-plane observability (the reference exports the same shape from
# beacon_processor/mod.rs via lighthouse_metrics): depth per kind,
# submit/drop/process events, time-in-queue, and handler wall time
_QUEUE_DEPTH = REGISTRY.gauge_vec(
    "lighthouse_tpu_beacon_processor_queue_depth",
    "queued work items per kind",
    ("kind",),
)
_QUEUE_EVENTS = REGISTRY.counter_vec(
    "lighthouse_tpu_beacon_processor_events_total",
    "beacon processor queue events (submitted/dropped/shed/reprocess_"
    "scheduled/processed/handler_error) per kind",
    ("kind", "event"),
)
_QUEUE_WAIT_SECONDS = REGISTRY.histogram_vec(
    "lighthouse_tpu_beacon_processor_wait_seconds",
    "time a work item spent queued before a worker picked it up",
    ("kind",),
)
_WORK_SECONDS = REGISTRY.histogram_vec(
    "lighthouse_tpu_beacon_processor_work_seconds",
    "handler wall time per drained batch, by kind",
    ("kind",),
)


@dataclass(order=True)
class WorkItem:
    priority: int
    seq: int
    kind: str = field(compare=False)
    payload: object = field(compare=False)
    t_submit: float = field(compare=False, default=0.0)


# priority per work kind (lower = more urgent), mirroring the reference's
# drain order: chain segments/blocks first, then aggregates, attestations,
# then the long tail.
PRIORITIES = {
    "gossip_block": 0,
    # sidecars drain right after blocks: a held block's import latency
    # is bounded by its slowest sidecar (deneb queue ordering)
    "gossip_blob_sidecar": 1,
    # column sidecars share the sidecar tier: a column-mode block's
    # import latency is bounded by its slowest 50%-threshold column
    "gossip_data_column": 1,
    "chain_segment": 1,
    "gossip_aggregate": 2,
    "gossip_attestation": 3,
    "sync_message": 4,
    "rpc_request": 5,
    "gossip_exit": 6,
    "gossip_slashing": 6,
}

DEFAULT_BOUNDS = {
    "gossip_block": 1024,
    "gossip_blob_sidecar": 4096,
    "gossip_data_column": 4096,
    "chain_segment": 64,
    "gossip_aggregate": 4096,
    "gossip_attestation": 16384,
    "sync_message": 4096,
    "rpc_request": 1024,
    "gossip_exit": 512,
    "gossip_slashing": 512,
}

ATTESTATION_BATCH_MAX = 64
AGGREGATE_BATCH_MAX = 64

# journal policy: per-item enqueue events only for the object kinds
# whose lifecycle the journal correlates by root downstream (blocks,
# sidecars, segments) — the 16k-deep attestation queue would otherwise
# flush every block's forensic trail out of the ring. Drops are
# journaled for EVERY kind (a dropped item is exactly the event a
# forensic query needs), and each drained batch lands one
# processor_batch event.
_JOURNALED_ENQUEUE_KINDS = frozenset(
    {
        "gossip_block",
        "gossip_blob_sidecar",
        "gossip_data_column",
        "chain_segment",
    }
)


class BeaconProcessor:
    # one journaled drop event per this many drops of a non-forensic
    # kind (the exact count rides in the event's dropped_total attr)
    DROP_SAMPLE = 256

    def __init__(
        self, handlers, max_workers: int = 2, bounds=None, journal=None
    ):
        """handlers: kind -> callable(payload_or_batch). Attestation and
        aggregate kinds receive LISTS (coalesced batches). `journal` is
        the owning node's event journal (defaults to the process-global
        one)."""
        self.handlers = handlers
        self.journal = journal if journal is not None else JOURNAL
        self.bounds = dict(DEFAULT_BOUNDS)
        if bounds:
            self.bounds.update(bounds)
        # backpressure shedding: queue depths become an admission
        # signal — cheap gossip kinds are rejected at submit while a
        # hysteresis window is open, forensic kinds never are
        self.shedder = SheddingPolicy(self.bounds, journal=self.journal)
        self._queues: dict[str, list] = {k: [] for k in PRIORITIES}
        self._dropped: dict[str, int] = {k: 0 for k in PRIORITIES}
        self._lock = TimedLock("beacon_processor.queues")
        self._work_available = threading.Condition(self._lock)
        self._seq = 0
        self._workers = []
        self._max_workers = max_workers
        self._stop = False
        self._reprocess: list = []  # (ready_time, kind, payload)
        self.metrics = {
            "processed": 0, "reprocessed": 0, "dropped": 0, "shed": 0,
        }

    def queue_depths(self) -> dict:
        """Current depth per work kind (the health-plane read)."""
        with self._lock:
            return {k: len(q) for k, q in self._queues.items()}

    def shed_state(self) -> dict:
        """The overload view for /lighthouse/health: open shed windows,
        exact shed counts, window transitions."""
        return self.shedder.state()

    def pressure_high(self) -> bool:
        """Queue-depth pressure signal for the verification bus's flush
        policy: True while any shed window is open or any queue sits
        at/over its high-water fraction — the node is loaded, so the
        bus should dispatch immediately instead of holding for
        co-riders (big batches form naturally from the backlog)."""
        if self.shedder.any_open():
            return True
        with self._lock:
            for kind, q in self._queues.items():
                bound = self.bounds.get(kind)
                if bound and len(q) / bound >= self.shedder.high_water:
                    return True
        return False

    # -------------------------------------------------------------- submit

    def submit(self, kind: str, payload) -> bool:
        """Enqueue work; returns False when the bounded queue dropped it
        or the backpressure shedding policy rejected it (cheapest-first
        overload degradation; forensic kinds are never shed)."""
        with self._lock:
            q = self._queues[kind]
            if self.shedder.should_shed(kind, len(q)):
                self.metrics["shed"] += 1
                _QUEUE_EVENTS.labels(kind, "shed").inc()
                return False
            if len(q) >= self.bounds[kind]:
                self._dropped[kind] += 1
                self.metrics["dropped"] += 1
                _QUEUE_EVENTS.labels(kind, "dropped").inc()
                # drop journaling is per-item only for the forensic
                # object kinds; a high-volume drop storm (attestation
                # flood) is sampled every DROP_SAMPLE so it cannot
                # flush the ring it is being recorded in (the counter
                # above stays exact)
                if (
                    kind in _JOURNALED_ENQUEUE_KINDS
                    or self._dropped[kind] % self.DROP_SAMPLE == 1
                ):
                    self.journal.emit(
                        "processor_drop",
                        outcome="queue_full",
                        work=kind,
                        depth=len(q),
                        dropped_total=self._dropped[kind],
                    )
                return False
            self._seq += 1
            q.append(
                WorkItem(
                    PRIORITIES[kind], self._seq, kind, payload,
                    time.monotonic(),
                )
            )
            _QUEUE_EVENTS.labels(kind, "submitted").inc()
            _QUEUE_DEPTH.labels(kind).set(len(q))
            if kind in _JOURNALED_ENQUEUE_KINDS:
                self.journal.emit(
                    "processor_enqueue",
                    outcome="submitted",
                    work=kind,
                    depth=len(q),
                )
            self._work_available.notify()
        return True

    def submit_delayed(self, kind: str, payload, delay_s: float):
        """Reprocessing queue: re-inject after `delay_s` (early blocks,
        unknown-parent attestations)."""
        with self._lock:
            heapq.heappush(
                self._reprocess,
                (time.monotonic() + delay_s, self._seq, kind, payload),
            )
            self._seq += 1
            self.metrics["reprocessed"] += 1
            _QUEUE_EVENTS.labels(kind, "reprocess_scheduled").inc()

    # --------------------------------------------------------------- drain

    def _next_batch(self):
        """Pop the highest-priority work; coalesce attestation kinds."""
        now = time.monotonic()
        while self._reprocess and self._reprocess[0][0] <= now:
            _, _, kind, payload = heapq.heappop(self._reprocess)
            self.submit(kind, payload)

        for kind in sorted(PRIORITIES, key=PRIORITIES.get):
            q = self._queues[kind]
            if not q:
                continue
            if kind == "gossip_attestation":
                items = q[:ATTESTATION_BATCH_MAX]
            elif kind == "gossip_aggregate":
                items = q[:AGGREGATE_BATCH_MAX]
            else:
                items = q[:1]
            del q[: len(items)]
            # the drain is allowed to close a shed window: after a
            # flood lifts, submit may never run for this kind again
            self.shedder.observe_depth(kind, len(q))
            wait_hist = _QUEUE_WAIT_SECONDS.labels(kind)
            for w in items:
                if w.t_submit:
                    wait_hist.observe(now - w.t_submit)
            _QUEUE_DEPTH.labels(kind).set(len(q))
            if kind in ("gossip_attestation", "gossip_aggregate"):
                return kind, [w.payload for w in items]
            return kind, items[0].payload
        return None

    def process_pending(self, max_items: int | None = None):
        """Synchronous drain (deterministic testing mode — the manual-clock
        analog of the async worker loop)."""
        n = 0
        while max_items is None or n < max_items:
            with self._lock:
                nxt = self._next_batch()
            if nxt is None:
                return n
            kind, payload = nxt
            self._run_batch(kind, payload)
            n += 1
        return n

    def _run_batch(self, kind: str, payload):
        """Run one drained batch through its handler, timing it into the
        work histogram and journaling the batch. A raising handler is
        counted as handler_error — in BOTH the event counter and the
        journal, so the two stay cross-checkable — never as processed."""
        t0 = time.perf_counter()
        n = len(payload) if isinstance(payload, list) else 1
        try:
            self.handlers[kind](payload)
        except Exception:
            dt = time.perf_counter() - t0
            _WORK_SECONDS.labels(kind).observe(dt)
            _QUEUE_EVENTS.labels(kind, "handler_error").inc()
            self.journal.emit(
                "processor_batch",
                outcome="handler_error",
                duration_s=dt,
                work=kind,
                n=n,
            )
            raise
        dt = time.perf_counter() - t0
        _WORK_SECONDS.labels(kind).observe(dt)
        self.metrics["processed"] += 1
        _QUEUE_EVENTS.labels(kind, "processed").inc()
        self.journal.emit(
            "processor_batch",
            outcome="processed",
            duration_s=dt,
            work=kind,
            n=n,
        )

    # ------------------------------------------------------ threaded mode

    def start(self):
        self._stop = False
        for _ in range(self._max_workers):
            th = threading.Thread(target=self._worker_loop, daemon=True)
            th.start()
            self._workers.append(th)

    def stop(self):
        with self._lock:
            self._stop = True
            self._work_available.notify_all()
        for th in self._workers:
            th.join(timeout=5)
        self._workers = []

    def _worker_loop(self):
        while True:
            with self._lock:
                if self._stop:
                    return
                nxt = self._next_batch()
                if nxt is None:
                    self._work_available.wait(timeout=0.05)
                    continue
            kind, payload = nxt
            try:
                self._run_batch(kind, payload)
            # lint: allow(except-swallow): belt for the pool loop —
            except Exception:  # _run_batch already counted handler_error
                pass
