"""Backpressure-driven load shedding for the beacon processor's queues.

The port of `lighthouse_tpu/network/shedding.py`.

The beacon processor's queue depth/wait metrics exist precisely to drive admission
decisions; this module is the consumer. A `SheddingPolicy` watches each
work kind's queue depth (as a fraction of its bound) and flips a
per-kind *shed window* open when the depth crosses a high-water mark,
closed when it drains below a low-water mark — classic hysteresis, so a
queue oscillating around one threshold does not flap the policy on
every submit.

Two hard rules shape the policy:

  * FORENSIC KINDS ARE NEVER SHED. Blocks, blob sidecars, and chain
    segments are the objects whose lifecycle the journal correlates by
    root — shedding them would lose consensus-critical work AND punch
    holes in the forensic record. Overload degrades the cheap,
    re-derivable gossip planes first (attestations, then aggregates,
    sync messages); the import path starves last.
  * SHED EARLY, SHED CHEAP. The decision runs at submit time, before
    the item is queued — a shed item costs one counter increment, not
    a queue slot plus a worker drain plus a handler error.

Shed state is observable three ways: the
``lighthouse_tpu_processor_shed_total{kind}`` counter (exact per-item
count), one ``shed_window`` journal event per open/close transition
(bounded — a flood cannot flush the ring through this kind), and
`SheddingPolicy.state()` surfaced under ``overload`` in
``GET /lighthouse/health``. The HTTP API reads the same policy to
return 429 on REST endpoints that enqueue processor work while the
matching kind's window is open.
"""

import threading

from lighthouse_tpu_torch.common.metrics import REGISTRY

_SHED_TOTAL = REGISTRY.counter_vec(
    "lighthouse_tpu_processor_shed_total",
    "work items rejected at submit time by the backpressure shedding "
    "policy, per kind (forensic kinds are exempt and never count here)",
    ("kind",),
)

# kinds whose loss is unrecoverable for consensus or forensics: the
# import path and its DA inputs. The shedding policy refuses to shed
# these no matter how deep their queues run — the bounded queue's own
# drop (counted + journaled by the processor) is the only backstop.
FORENSIC_KINDS = frozenset(
    {"gossip_block", "gossip_blob_sidecar", "chain_segment"}
)

# default hysteresis thresholds, as fractions of each kind's queue
# bound: open the shed window at high_water, close it at low_water.
HIGH_WATER = 0.75
LOW_WATER = 0.25


class SheddingPolicy:
    """Per-kind hysteresis shed windows over the processor queues.

    `should_shed(kind, depth)` is the submit-time admission decision;
    `observe_depth(kind, depth)` lets the drain path close windows as
    queues empty. Both are cheap (one lock, two compares) — they run on
    the gossip ingest hot path.
    """

    def __init__(
        self,
        bounds: dict,
        journal=None,
        high_water: float = HIGH_WATER,
        low_water: float = LOW_WATER,
    ):
        """`bounds` is held BY REFERENCE (the beacon processor passes
        its own dict), so there is exactly one source of truth — a
        caller adjusting queue bounds adjusts the hysteresis thresholds
        with it. Use `enabled = False` to turn the policy off (the
        bench A/B), never by mutating bounds out from under it."""
        if not 0.0 < low_water < high_water <= 1.0:
            raise ValueError(
                f"shedding thresholds need 0 < low ({low_water}) < "
                f"high ({high_water}) <= 1"
            )
        self.bounds = bounds if bounds is not None else {}
        self.enabled = True
        self.journal = journal
        self.high_water = high_water
        self.low_water = low_water
        self._lock = threading.Lock()
        self._open: dict[str, bool] = {}
        self._shed_counts: dict[str, int] = {}
        self._windows_opened: dict[str, int] = {}

    # ------------------------------------------------------------ decisions

    def _transition(self, kind: str, depth: int) -> bool:
        """Update the kind's window from `depth`; returns whether the
        window is open AFTER the update. Caller holds the lock."""
        bound = self.bounds.get(kind)
        if not bound:
            return False
        frac = depth / bound
        was_open = self._open.get(kind, False)
        if was_open and frac <= self.low_water:
            self._open[kind] = False
            self._emit(kind, "closed")
            return False
        if not was_open and frac >= self.high_water:
            self._open[kind] = True
            self._windows_opened[kind] = (
                self._windows_opened.get(kind, 0) + 1
            )
            self._emit(kind, "opened")
            return True
        return was_open

    def _emit(self, kind: str, outcome: str):
        if self.journal is None:
            return
        self.journal.emit(
            "shed_window",
            outcome=outcome,
            work=kind,
        )

    def should_shed(self, kind: str, depth: int) -> bool:
        """Submit-time admission: True = reject this item now. Forensic
        kinds are never shed; everything else sheds while the kind's
        hysteresis window is open."""
        if not self.enabled or kind in FORENSIC_KINDS:
            return False
        with self._lock:
            open_ = self._transition(kind, depth)
            if open_:
                self._shed_counts[kind] = (
                    self._shed_counts.get(kind, 0) + 1
                )
        if open_:
            _SHED_TOTAL.labels(kind).inc()
        return open_

    def observe_depth(self, kind: str, depth: int):
        """Drain-path observation: closes the window once the queue
        falls below the low-water mark (submit may never run again
        after a flood lifts, so the drain must be able to close it)."""
        if kind in FORENSIC_KINDS:
            return
        with self._lock:
            self._transition(kind, depth)

    # ---------------------------------------------------------------- reads

    def is_shedding(self, kind: str) -> bool:
        with self._lock:
            return self._open.get(kind, False)

    def any_open(self) -> bool:
        """True while ANY kind's shed window is open — the cheap
        whole-node pressure read the verification bus polls."""
        with self._lock:
            return any(self._open.values())

    def state(self) -> dict:
        """The health-plane view: which windows are open right now,
        exact shed counts, and how many windows each kind has opened."""
        with self._lock:
            return {
                "enabled": self.enabled,
                "active": sorted(
                    k for k, open_ in self._open.items() if open_
                ),
                "shed_total": dict(self._shed_counts),
                "windows_opened": dict(self._windows_opened),
                "high_water": self.high_water,
                "low_water": self.low_water,
            }
