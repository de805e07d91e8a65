"""Object-lifecycle event journal: a correlation-ID'd forensic record.

The port's copy of `lighthouse_tpu/common/events_journal.py`, with the same
event kinds and metric names: the role of the reference client's
structured `tracing` event stream, shaped as a queryable ring. Every
object entering via gossip or RPC is tracked by a stable correlation id
(the block root for blocks), and every decision point along its lifecycle
emits one typed `Event` -- in the port so far, one `signature_batch`
event per verified signature batch (`bls/api.py`).

Events land in a bounded ring buffer (oldest evicted; evictions
counted), are mirrored into the process registry as
``lighthouse_tpu_journal_events_total{kind,outcome}`` so the /metrics
scrape and the journal can be cross-checked against each other, and are
queried per object (`Journal.query`).

A journal is per node: the caller owns a `Journal` and passes it to the
calls that emit; the module-level `JOURNAL` is the default for code
running outside a node.

Event kinds are a CLOSED vocabulary (`KINDS`): `emit` raises on an
unregistered kind, the same contract metric names live under.

`emit` on a disabled journal is one attribute check and a return; enabled
it is one small allocation, a deque append under the ring lock and one
counter increment.
"""

import json
import threading
import time
from collections import deque

from lighthouse_tpu_torch.common.metrics import REGISTRY

# the closed event-kind vocabulary — extend HERE (and only here); emit()
# rejects kinds outside this set
KINDS = frozenset(
    {
        # queue plane (beacon_processor)
        "processor_enqueue",
        "processor_drop",
        "processor_batch",
        # overload plane (network/shedding): one event when a work
        # kind's shed window opens (queue depth crossed the high-water
        # hysteresis threshold) and one when it closes — the bounded
        # forensic record of an overload episode (per-item sheds ride
        # the processor_shed_total counter, never the ring)
        "shed_window",
        # block lifecycle (chain)
        "block_import",
        "block_release",
        "signature_batch",
        "attestation_batch",
        # data-availability lifecycle (da_checker)
        "sidecar",
        "da_settle",
        # DA sampling plane: column-sidecar lifecycle (gossip arrival,
        # verify, reconstruction) — a protocol claim, canonical — and
        # the bus's coalesced cell-proof batches, which (like
        # signature_batch) depend on batch-formation timing and stay
        # OUT of the canonical replay projection
        "column_sidecar",
        "cell_batch",
        # DAS sampler verdicts (sim/das_sampler): issued/satisfied/
        # withheld_flagged per sampled block — wall-clock poll timing,
        # NOT canonical
        "das_sample",
        # req/resp sync lifecycle (sync manager)
        "sync_request",
        "sync_batch",
        # peer scoring
        "peer_downscore",
        "peer_quarantine",
        # validator monitor
        "validator_summary",
        # light-client serving plane (light_client/producer.py +
        # http_api/server.py): one event per produced/bettered update
        # document (deterministic protocol claim — part of the sim's
        # canonical replay projection) and one per served light-client
        # read (request-timing-attributed, deliberately NOT canonical)
        "lc_update_produced",
        "lc_served",
        # network simulator (sim/orchestrator): fault timeline entries —
        # partitions applied/lifted, eclipses, offline windows, spam
        # floods, kv crashes — landed in every affected node's journal so
        # a chaos run's forensic record is self-describing (invariant
        # checks learn fault windows from the journal, not internals)
        "sim_fault",
        # device-plane fault domain (device_plane/executor): faults
        # observed at the guarded host<->device boundary, breaker
        # transitions, and self-test outcomes.
        # Deliberately NOT part of the sim's canonical replay
        # projection: like signature_batch, its event sequence depends
        # on batch-formation timing, not on protocol state
        "device_fault",
        # slot-budget profiler (common/slot_budget): one event per
        # import attempt carrying the critical-path stage decomposition,
        # overlap accounting, and the serial-dispatch/fusable-gap
        # ledger. Pure timing content — stays OUT of the canonical
        # replay projection like signature_batch; the budget_complete
        # sim invariant reads the raw journal instead
        "slot_budget",
    }
)

DEFAULT_CAPACITY = 4096

_EVENTS_TOTAL = REGISTRY.counter_vec(
    "lighthouse_tpu_journal_events_total",
    "object-lifecycle journal events, by kind and outcome",
    ("kind", "outcome"),
)
_DROPPED_TOTAL = REGISTRY.counter(
    "lighthouse_tpu_journal_dropped_total",
    "journal events evicted from the ring buffer (oldest-first)",
)


class Event:
    __slots__ = (
        "seq", "t", "kind", "slot", "root", "peer", "outcome",
        "duration_s", "attrs",
    )

    def __init__(
        self, seq, kind, slot, root, peer, outcome, duration_s, attrs
    ):
        self.seq = seq
        self.t = time.time()
        self.kind = kind
        self.slot = slot
        self.root = root
        self.peer = peer
        self.outcome = outcome
        self.duration_s = duration_s
        self.attrs = attrs

    def to_dict(self) -> dict:
        out = {"seq": self.seq, "t": self.t, "kind": self.kind}
        if self.slot is not None:
            out["slot"] = int(self.slot)
        if self.root is not None:
            out["root"] = "0x" + self.root.hex()
        if self.peer is not None:
            out["peer"] = self.peer
        if self.outcome is not None:
            out["outcome"] = self.outcome
        if self.duration_s is not None:
            out["duration_s"] = self.duration_s
        if self.attrs:
            out["attrs"] = self.attrs
        return out


class Journal:
    def __init__(
        self, capacity: int = DEFAULT_CAPACITY, enabled: bool = True
    ):
        self.enabled = enabled
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=max(1, capacity))
        self._seq = 0
        self.emitted = 0
        self.dropped = 0

    # ------------------------------------------------------- configuration

    @property
    def capacity(self) -> int:
        return self._ring.maxlen

    def configure(self, enabled=None, capacity=None):
        with self._lock:
            if enabled is not None:
                self.enabled = bool(enabled)
            if capacity is not None:
                self._ring = deque(
                    self._ring, maxlen=max(1, int(capacity))
                )

    def reset(self):
        with self._lock:
            self._ring.clear()
            self._seq = 0
            self.emitted = 0
            self.dropped = 0

    # -------------------------------------------------------------- emit

    def emit(
        self,
        kind: str,
        root: bytes | None = None,
        slot: int | None = None,
        peer: str | None = None,
        outcome: str | None = None,
        duration_s: float | None = None,
        **attrs,
    ):
        """Record one lifecycle event. `root` is the object's correlation
        id (block root; sidecars add an `index` attr). Raises ValueError
        on a kind outside the registered vocabulary."""
        if not self.enabled:
            return None
        if kind not in KINDS:
            raise ValueError(f"unregistered journal event kind {kind!r}")
        if root is not None:
            root = bytes(root)
        with self._lock:
            self._seq += 1
            ev = Event(
                self._seq, kind, slot, root, peer, outcome, duration_s,
                attrs,
            )
            if len(self._ring) == self._ring.maxlen:
                self.dropped += 1
                _DROPPED_TOTAL.inc()
            self._ring.append(ev)
            self.emitted += 1
        _EVENTS_TOTAL.labels(kind, outcome or "none").inc()
        return ev

    # ------------------------------------------------------------- query

    def query(
        self,
        root: bytes | str | None = None,
        slot: int | None = None,
        kind: str | None = None,
        peer: str | None = None,
        outcome: str | None = None,
        limit: int | None = None,
    ) -> list[dict]:
        """Forensic filter over the ring, oldest first; `limit` keeps the
        most recent N matches. `root` accepts bytes or 0x-hex."""
        if isinstance(root, str):
            root = bytes.fromhex(root[2:] if root.startswith("0x") else root)
        with self._lock:
            events = list(self._ring)
        out = []
        for ev in events:
            if root is not None and ev.root != root:
                continue
            if slot is not None and ev.slot != slot:
                continue
            if kind is not None and ev.kind != kind:
                continue
            if peer is not None and ev.peer != peer:
                continue
            if outcome is not None and ev.outcome != outcome:
                continue
            out.append(ev.to_dict())
        if limit is not None and limit >= 0:
            out = out[-limit:] if limit else []
        return out

    def count(self, **filters) -> int:
        return len(self.query(**filters))

    def stats(self) -> dict:
        with self._lock:
            return {
                "enabled": self.enabled,
                "capacity": self._ring.maxlen,
                "size": len(self._ring),
                "emitted": self.emitted,
                "dropped": self.dropped,
            }

    # ------------------------------------------------------------ export

    def to_jsonl(self, limit: int | None = None) -> str:
        docs = self.query(limit=limit)
        if not docs:
            return ""
        return "\n".join(json.dumps(d) for d in docs) + "\n"

    def export_jsonl(self, path, limit: int | None = None) -> int:
        """Write the buffered events to `path`; returns the count."""
        docs = self.query(limit=limit)
        with open(path, "w") as f:
            for d in docs:
                f.write(json.dumps(d) + "\n")
        return len(docs)


JOURNAL = Journal()


def configure(enabled=None, capacity=None):
    JOURNAL.configure(enabled=enabled, capacity=capacity)
