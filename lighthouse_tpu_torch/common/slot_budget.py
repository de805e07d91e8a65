"""Slot-budget profiler: per-import critical-path waterfalls.

The port's copy of `lighthouse_tpu/common/slot_budget.py`, whole: host
accounting with no device in it, the same stages and metric names. The
guarded executor (`device_plane/executor.py`) and the verification bus
(`verification_bus/bus.py`) mark their device round trips through
`open_dispatch` / `close_dispatch`.

The ROADMAP's one-dispatch-slot item is blocked on a number nobody
could produce: how the ~200 ms slot budget actually decomposes into
SSZ decode, structural checks, state advance, signature fold, tree
hash, KZG settle, and store writes — and, above all, how much host
time sits BETWEEN consecutive host<->device round trips (the "fusable
gap" a chained slot-program would erase). This module is the
instrument:

  * `SlotBudgetRecorder` (one per chain, `chain.slot_budget`) opens a
    per-import record around every `_journaled_import` attempt; the
    import path marks causal stage intervals with `stage("...")` and
    the cross-cutting planes mark device round trips with
    `open_dispatch`/`close_dispatch` — the verification bus marks the
    caller-side submit-to-verdict interval (split into queue wait vs
    dispatch wall by the bus's own stamps), and the guarded executor
    marks every other outermost device crossing by plane label.
  * `finish` runs the overlap accounting: wall vs sum-of-stages
    (overlap = sum - union; unattributed = wall - union, so
    stages(union) + unattributed == wall EXACTLY by construction),
    counts serial dispatches, and sums the fusable gap — host time
    between consecutive device round trips within one import.
  * Every finished record lands as ONE `slot_budget` journal event
    (deliberately NOT part of the sim's canonical replay projection —
    its content is timing, like `signature_batch`), three metric
    families (`lighthouse_tpu_slot_stage_seconds{stage}`,
    `lighthouse_tpu_slot_fusable_gap_seconds`,
    `lighthouse_tpu_slot_serial_dispatches`), and a bounded ring of
    recent waterfalls served at `GET /lighthouse/slot_budget` and
    rendered by `scripts/obs_report.py --slot-budget`.

Threading: the active record is THREAD-LOCAL (the device_attribution
window discipline): an import runs its inner pipeline on one thread,
and the bus's `submit` blocks that same thread even when the flush
runs on another submitter's thread — so the caller-side interval IS
the import's causal device wait. Records nest as a stack (a release
re-entry importing from inside another import each get their own
record); stage/dispatch marks attach to the innermost record. Nested
device crossings on one record are suppressed: the bus interval owns
any guarded dispatch its own flush runs on the submitting thread —
one interval per causal round trip.

Overhead discipline (the PR 6 journal contract): disabled, `begin`
is one attribute check and a return and every mark is one TLS read of
None; enabled, an import pays a handful of perf_counter reads and
list appends plus one finalize (sorting ~10 intervals, one journal
emit, one metric observe per stage). Measured single-digit to low-tens
of µs per import (the reference's tests/test_slot_budget.py).
"""

import threading
import time
from collections import deque
from contextlib import contextmanager

from lighthouse_tpu_torch.common.metrics import REGISTRY
from lighthouse_tpu_torch.common.tracing import STAGE_BUCKETS

# the full-slot budget every headline compares against (PERF_NOTES:
# a mainnet slot gives ~200 ms to verify everything it carries)
SLOT_BUDGET_MS = 200.0

# closed stage vocabulary for the critical-path (union) axis; the
# derived dispatch axes (bus queue wait, device wall) ride the
# per-import dispatch entries, not this list
STAGES = (
    "decode",            # SSZ bytes -> signed block (same-thread sites)
    "structural",        # duplicate/parent/proposer gossip checks
    "kzg_settle",        # DA gate: commitments vs verified sidecars
    "slots",             # process_slots to the block's slot
    "block_processing",  # per_block_processing incl. signature fold
    "state_root",        # cached tree-hash of the post state
    "store_write",       # store puts + fork-choice on_block
    "head_update",       # recompute_head
)

# how long a stashed pre-stage (decode measured before the import
# record exists) stays adoptable by the next begin() on its thread —
# tight: the decode->import handoff is same-thread and immediate, and
# a stale stash would mis-shift an unrelated import's start
PRE_STAGE_TTL_S = 0.5

_STAGE_SECONDS = REGISTRY.histogram_vec(
    "lighthouse_tpu_slot_stage_seconds",
    "per-import critical-path stage durations from the slot-budget "
    "recorder, by stage",
    ("stage",),
    buckets=STAGE_BUCKETS,
)
_FUSABLE_GAP = REGISTRY.histogram(
    "lighthouse_tpu_slot_fusable_gap_seconds",
    "per-import host time between consecutive device round trips — "
    "the serial-dispatch cost a fused slot-program would erase",
    buckets=STAGE_BUCKETS,
)
_SERIAL_DISPATCHES = REGISTRY.histogram(
    "lighthouse_tpu_slot_serial_dispatches",
    "device round trips paid serially by one block import",
    buckets=(0, 1, 2, 3, 4, 6, 8, 12, 16, 24, 32),
)

_TLS = threading.local()


def _top():
    stack = getattr(_TLS, "stack", None)
    return stack[-1] if stack else None


class _Record:
    __slots__ = (
        "recorder", "root", "slot", "path", "t0", "stages",
        "dispatches", "depth",
    )

    def __init__(self, recorder, root, slot, path):
        self.recorder = recorder
        self.root = root
        self.slot = slot
        self.path = path
        self.t0 = time.perf_counter()
        self.stages = []      # (name, abs_start, abs_end)
        self.dispatches = []  # {label, kind, t0, t1, queue_wait_s}
        self.depth = 0        # open-dispatch nesting on this record


@contextmanager
def stage(name: str):
    """Mark one critical-path interval on the innermost active record
    (no-op — one TLS read — when no import is being profiled). The
    interval lands even when the body raises: a held/rejected import's
    partial waterfall is exactly the forensic record wanted."""
    rec = _top()
    if rec is None:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        rec.stages.append((name, t0, time.perf_counter()))


@contextmanager
def pre_stage(name: str):
    """Measure a stage BEFORE the import record exists (the HTTP block
    publish path decodes SSZ on the thread that then imports): stashed
    thread-locally and adopted — shifting the record's start back so
    wall covers it — by the next `begin` on this thread within
    PRE_STAGE_TTL_S."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        stash = getattr(_TLS, "pre_stages", None)
        if stash is None:
            stash = _TLS.pre_stages = []
        stash.append((name, t0, time.perf_counter()))


def open_dispatch(label: str, kind: str = "device"):
    """Open a device round-trip interval on the innermost active
    record; returns an opaque token for `close_dispatch` (None when
    nothing is being profiled). Nested opens on one record return a
    depth-only token: the outermost interval owns the round trip (the
    bus's caller-side interval already covers any guarded dispatch its
    flush runs on the submitting thread)."""
    rec = _top()
    if rec is None:
        return None
    rec.depth += 1
    if rec.depth > 1:
        return (rec, None)
    entry = {
        "label": label,
        "kind": kind,
        "t0": time.perf_counter(),
        "t1": None,
        "queue_wait_s": 0.0,
    }
    rec.dispatches.append(entry)
    return (rec, entry)


def close_dispatch(token, queue_wait_s=None):
    if token is None:
        return
    rec, entry = token
    rec.depth -= 1
    if entry is not None:
        entry["t1"] = time.perf_counter()
        if queue_wait_s:
            entry["queue_wait_s"] = float(queue_wait_s)


def _union_s(intervals) -> float:
    """Total length of the union of (start, end) intervals."""
    total = 0.0
    hi = None
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if hi is None or s > hi:
            total += e - s
            hi = e
        elif e > hi:
            total += e - hi
            hi = e
    return total


def _quantile(sorted_vals, q: float):
    if not sorted_vals:
        return None
    idx = min(len(sorted_vals) - 1, int(q * len(sorted_vals)))
    return sorted_vals[idx]


class SlotBudgetRecorder:
    """One per chain: owns the journal hookup, the recent-imports ring,
    and the enable switch. The thread-local record stack is module
    state so cross-cutting planes (bus, guarded executor) mark the
    active import without holding a chain reference."""

    def __init__(self, journal=None, enabled: bool = True,
                 ring: int = 128):
        self.journal = journal
        self.enabled = bool(enabled)
        self.ring = deque(maxlen=max(8, int(ring)))
        self._lock = threading.Lock()
        self.recorded = 0

    def configure(self, enabled=None, ring=None):
        if enabled is not None:
            self.enabled = bool(enabled)
        if ring is not None:
            with self._lock:
                self.ring = deque(self.ring, maxlen=max(8, int(ring)))

    # ------------------------------------------------------------ lifecycle

    def begin(self, root: bytes, slot: int, path: str = "gossip"):
        """Open a per-import record on this thread (returns None
        disabled — `finish(None)` is a no-op, so call sites stay
        branch-free). Adopts any fresh pre-stages stashed on this
        thread (decode measured before the record existed)."""
        if not self.enabled:
            return None
        rec = _Record(self, root, slot, path)
        pre = getattr(_TLS, "pre_stages", None)
        if pre:
            for name, t0, t1 in pre:
                if rec.t0 - t1 < PRE_STAGE_TTL_S:
                    rec.stages.append((name, t0, t1))
                    if t0 < rec.t0:
                        rec.t0 = t0
            _TLS.pre_stages = None
        stack = getattr(_TLS, "stack", None)
        if stack is None:
            stack = _TLS.stack = []
        stack.append(rec)
        return rec

    def discard(self, rec):
        """Drop a record without emitting anything (an import that
        escaped with a non-protocol exception emits no block_import
        event either — the 1:1 pairing must hold both ways)."""
        if rec is None:
            return
        stack = getattr(_TLS, "stack", None)
        if stack and rec in stack:
            stack.remove(rec)

    def finish(self, rec, outcome: str = "imported"):
        """Close the record: overlap accounting, dispatch-gap ledger,
        metrics, one `slot_budget` journal event, ring append. Returns
        the ring entry (None for a None record)."""
        if rec is None:
            return None
        stack = getattr(_TLS, "stack", None)
        if stack and stack[-1] is rec:
            stack.pop()
        elif stack and rec in stack:
            stack.remove(rec)
        t_end = time.perf_counter()
        t0 = rec.t0
        wall = t_end - t0

        # ---- stage axis: merge duplicates, union for overlap account
        merged: dict = {}
        intervals = []
        for name, s, e in rec.stages:
            e = min(e, t_end)
            if e <= s:
                continue
            merged[name] = merged.get(name, 0.0) + (e - s)
            intervals.append((s, e))
        sum_stages = sum(merged.values())
        union = _union_s(intervals)
        overlap = max(0.0, sum_stages - union)
        unattributed = max(0.0, wall - union)

        # ---- dispatch axis: serial count + fusable-gap ledger
        disp = []
        for d in rec.dispatches:
            d_t1 = d["t1"] if d["t1"] is not None else t_end
            disp.append((d["t0"], d_t1, d))
        disp.sort(key=lambda x: x[0])
        serial = len(disp)
        fusable_gap = 0.0
        for (s0, e0, _), (s1, _e1, _) in zip(disp, disp[1:]):
            if s1 > e0:
                fusable_gap += s1 - e0
        bus_wait = sum(d["queue_wait_s"] for _, _, d in disp)
        device_wall = sum(
            max(0.0, (e - s) - d["queue_wait_s"]) for s, e, d in disp
        )

        # ---- observe: one stage-family observation per merged stage
        for name, dur in merged.items():
            _STAGE_SECONDS.labels(name).observe(dur)
        _FUSABLE_GAP.observe(fusable_gap)
        _SERIAL_DISPATCHES.observe(serial)

        entry = {
            "root": "0x" + rec.root.hex()
            if isinstance(rec.root, (bytes, bytearray))
            else str(rec.root),
            "slot": int(rec.slot) if rec.slot is not None else None,
            "path": rec.path,
            "outcome": outcome,
            "wall_s": round(wall, 6),
            "stages": [
                [name, round(s - t0, 6), round(min(e, t_end) - t0, 6)]
                for name, s, e in rec.stages
            ],
            "dispatches": [
                {
                    "label": d["label"],
                    "kind": d["kind"],
                    "start_s": round(s - t0, 6),
                    "end_s": round(e - t0, 6),
                    "queue_wait_s": round(d["queue_wait_s"], 6),
                }
                for s, e, d in disp
            ],
            "sum_stages_s": round(sum_stages, 6),
            "union_s": round(union, 6),
            "overlap_s": round(overlap, 6),
            "unattributed_s": round(unattributed, 6),
            "serial_dispatches": serial,
            "fusable_gap_s": round(fusable_gap, 6),
            "bus_wait_s": round(bus_wait, 6),
            "device_s": round(device_wall, 6),
        }
        with self._lock:
            self.ring.append(entry)
            self.recorded += 1
        journal = self.journal
        if journal is not None:
            journal.emit(
                "slot_budget",
                root=rec.root
                if isinstance(rec.root, (bytes, bytearray))
                else None,
                slot=rec.slot,
                outcome=outcome,
                duration_s=wall,
                path=rec.path,
                wall_s=round(wall, 6),
                stages={
                    k: round(v, 6) for k, v in sorted(merged.items())
                },
                n_stages=len(merged),
                sum_stages_s=round(sum_stages, 6),
                union_s=round(union, 6),
                overlap_s=round(overlap, 6),
                unattributed_s=round(unattributed, 6),
                serial_dispatches=serial,
                dispatch_labels=[d["label"] for _, _, d in disp],
                fusable_gap_s=round(fusable_gap, 6),
                bus_wait_s=round(bus_wait, 6),
                device_s=round(device_wall, 6),
            )
        return entry

    # ----------------------------------------------------------------- reads

    def recent(self, limit=None) -> list:
        with self._lock:
            out = list(self.ring)
        if limit is not None:
            out = out[-int(limit):]
        return out

    def summary(self) -> dict:
        """Aggregated view over the ring: per-stage p50/p99 (exact over
        the window), wall/fusable-gap/serial-dispatch quantiles — the
        /lighthouse/slot_budget document's header."""
        recs = self.recent()
        by_stage: dict = {}
        walls, gaps, serials = [], [], []
        fused_imports = serial_imports = 0
        for r in recs:
            walls.append(r["wall_s"])
            gaps.append(r["fusable_gap_s"])
            serials.append(r["serial_dispatches"])
            if any(d["kind"] == "fused" for d in r["dispatches"]):
                fused_imports += 1
            elif r["dispatches"]:
                serial_imports += 1
            seen: dict = {}
            for name, s, e in r["stages"]:
                seen[name] = seen.get(name, 0.0) + (e - s)
            for name, dur in seen.items():
                by_stage.setdefault(name, []).append(dur)
        walls.sort()
        gaps.sort()
        serials.sort()
        stages = {}
        for name, vals in sorted(by_stage.items()):
            vals.sort()
            stages[name] = {
                "count": len(vals),
                "p50_s": round(_quantile(vals, 0.5), 6),
                "p99_s": round(_quantile(vals, 0.99), 6),
            }
        return {
            "imports": len(recs),
            "recorded_total": self.recorded,
            "budget_ms": SLOT_BUDGET_MS,
            "wall_p50_s": round(_quantile(walls, 0.5), 6)
            if walls else None,
            "wall_p99_s": round(_quantile(walls, 0.99), 6)
            if walls else None,
            "fusable_gap_p50_s": round(_quantile(gaps, 0.5), 6)
            if gaps else None,
            "serial_dispatches_p50": _quantile(serials, 0.5),
            "serial_dispatches_max": serials[-1] if serials else None,
            # one-dispatch-slot ledger: imports whose device work rode
            # a chained slot-program (dispatch kind "fused") vs imports
            # that paid separate serial round trips
            "fused_imports": fused_imports,
            "serial_dispatch_imports": serial_imports,
            "stages": stages,
        }

    def headline(self):
        """(wall_p50_ms, top_stage, top_share) over the ring for the
        notifier tick — None before the first finished import."""
        s = self.summary()
        if not s["imports"] or s["wall_p50_s"] is None:
            return None
        stages = s["stages"]
        if not stages:
            return None
        top = max(stages.items(), key=lambda kv: kv[1]["p50_s"])
        wall = s["wall_p50_s"]
        share = top[1]["p50_s"] / wall if wall > 0 else 0.0
        return (
            round(wall * 1000.0, 1),
            top[0],
            round(share, 2),
        )
