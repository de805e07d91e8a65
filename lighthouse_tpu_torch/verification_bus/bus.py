"""Cross-subsystem verification bus: deadline-aware batch coalescing.

The port of `lighthouse_tpu/verification_bus/bus.py`, with its `bls`,
`slot_program` and `da_cells` kinds. Every BLS signature goes through ONE
batch boundary (`verify_signature_sets`), but the consumers (gossip
singles, sync segments, sidecar headers, op-pool packing, the slasher)
would each call the card on their own, so a small batch pays the card's
whole fixed dispatch cost alone (FIXED_DEVICE_COST_MS, 11.4 ms on an
H100). Batch amortization across consumers is the lever, and this module
is it.

Consumers submit `SignatureSet` batches tagged with their consumer label
and a deadline (anything with `.remaining()`, or a float budget; without
one, a per-class budget). The scheduler coalesces pending submissions
across subsystems into shared device batches, flushing when:

  * **deadline** — the earliest queued deadline's slack falls below
    the predicted batch wall (`wall_model.PredictedWallModel`, seeded
    from the card's measured scaling model and LEARNED from every
    dispatch this bus performs);
  * **fill** — pending live sets reach the fill target;
  * **bulk** — a submission is big enough to amortize the fixed cost on
    its own, or is a slot program (an import's critical path), and
    carries every pending single along;
  * **pressure** — the caller's pressure signal says the node is loaded;
  * **hold** — the oldest submission has waited its maximum hold (on
    host backends the default hold is ZERO — there is no fixed device
    cost to amortize, so the bus degrades to an attributed passthrough).

Verdicts fan back per submission. A mixed batch failing falls back to
per-submission sub-batches, so one consumer's invalid signature can
never fail a coterminous consumer's verdict — each caller keeps its
existing error semantics (including exceptions: a submission whose
sets raise re-raises in ITS caller only). Every formed batch keeps
consumer attribution: `bls.verify_signature_sets_shared` counts each
contributor's sets in the registry, and the bus emits one
`signature_batch` journal event per contributing submission with a
shared `bus_batch` id plus the batch's lanes/waste/amortized economics.

The shared dispatch crosses the guarded executor (`device_plane.GUARD`)
with the canary's pair checked first and the valid sentinel riding the
batch; there is no failover tier, so a device fault reaches each
submitter as a `DeviceFaultError`.

A thread that staged an import's deferred KZG settle
(`stage_program_work`) turns its next non-empty `submit` into a
`slot_program` submission: the settle rides the same guarded dispatch as
the signature fold (`ops/slot_program.py`), its verdict delivered through
the staged work, never through `submit`'s return value. `submit_program`
sends a settle alone through that boundary. A flush groups its
submissions by (backend, kind), so a slot program and a plain batch never
share a dispatch.

`submit_cells` sends DA cell-proof items (commitment, cell_index, cell,
proof) through the same queue, deadline and mixed-fail contract: pending
cell submissions coalesce into ONE folded pairing batch
(`da.cells.verify_cell_proof_batch`, plane "da_cells"), journaled as one
`cell_batch` event a submission. Cell batches never share a dispatch with
signature sets or slot programs: the flush groups by (backend, kind).

`device` is where the "gpu" backend runs: the card by default, "cpu" for
the plain versions (the tests).
"""

import threading
import time

from lighthouse_tpu_torch.common import device_attribution as attribution
from lighthouse_tpu_torch.common import slot_budget
from lighthouse_tpu_torch.common.metrics import REGISTRY
from lighthouse_tpu_torch.verification_bus.wall_model import PredictedWallModel

_SUBMITTED = REGISTRY.counter_vec(
    "lighthouse_tpu_bus_submissions_total",
    "signature-set submissions entering the verification bus, by "
    "consumer",
    ("consumer",),
)
_BATCHES_FORMED = REGISTRY.counter_vec(
    "lighthouse_tpu_bus_batches_formed_total",
    "device batches formed by the bus, by flush trigger "
    "(passthrough|hold|deadline|fill|bulk|pressure|fallback)",
    ("trigger",),
)
_BATCH_LIVE = REGISTRY.histogram(
    "lighthouse_tpu_bus_batch_live_sets",
    "live signature sets per bus-formed batch",
    buckets=(1, 2, 4, 8, 16, 32, 64, 256, 1024, 4096, 16384),
)
_BATCH_SUBMISSIONS = REGISTRY.histogram(
    "lighthouse_tpu_bus_batch_submissions",
    "submissions coalesced into one bus-formed batch",
    buckets=(1, 2, 4, 8, 16, 32, 64, 256),
)
_WAIT_SECONDS = REGISTRY.histogram_vec(
    "lighthouse_tpu_bus_wait_seconds",
    "submit-to-verdict wall time per submission, by consumer",
    ("consumer",),
    buckets=(
        0.0005, 0.001, 0.002, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
        0.5, 1.0, 2.5, 10.0,
    ),
)
_DEADLINE_MISSES = REGISTRY.counter_vec(
    "lighthouse_tpu_bus_deadline_misses_total",
    "submissions whose verdict landed after their deadline expired "
    "(each got an immediate small-batch flush, never a silent drop)",
    ("consumer",),
)

# default per-class deadline budgets (seconds) when the caller passes
# no Deadline: gossip classes are tight, sync/op-pool/slasher are
# lenient bulk work
DEFAULT_CLASS_BUDGETS = {
    "gossip_single": 2.0,
    "sidecar_header": 2.0,
    "sync_segment": 10.0,
    "oppool": 10.0,
    "slasher": 30.0,
    "kzg": 5.0,
    "da_cells": 5.0,
    "bench": 10.0,
}
DEFAULT_BUDGET_S = 5.0

# how many pending live sets close a batch
DEFAULT_FILL_TARGET = 64

# a submission at least this large flushes IMMEDIATELY (trigger
# "bulk"): it already amortizes the fixed cost well on its own, so
# holding it only adds latency — and flushing it carries every pending
# single along for free co-amortization
DEFAULT_BULK_FLUSH_LIVE = 8

# default maximum hold on the gpu backend: worth waiting this long for
# co-riders when the dispatch itself has a fixed cost (the reference's
# value; host backends default to zero hold)
DEFAULT_GPU_HOLD_MS = 25.0


class _Submission:
    __slots__ = (
        "sets", "consumer", "journal", "slot", "attrs", "backend",
        "budget_s", "submitted_at", "expires_at", "event", "result",
        "exc", "done", "claimed", "dispatch_t0", "kind", "extra",
    )

    def __init__(
        self, sets, consumer, journal, slot, attrs, backend, budget_s,
        kind="bls", extra=None,
    ):
        self.sets = sets
        self.consumer = consumer
        self.journal = journal
        self.slot = slot
        self.attrs = attrs
        self.backend = backend
        self.budget_s = budget_s
        self.submitted_at = time.monotonic()
        self.expires_at = self.submitted_at + budget_s
        self.event = threading.Event()
        self.result = None
        self.exc = None
        self.done = False
        self.claimed = False
        # monotonic timestamp stamped when a flush claims this
        # submission into a dispatch group — the slot-budget recorder's
        # queue-wait/dispatch split on the submitter side
        self.dispatch_t0 = None
        # the shared-dispatch kind: "bls" (a signature batch),
        # "slot_program" (the fold and a staged settle in one program) or
        # "da_cells" (cell-proof items; `sets` holds them)
        self.kind = kind
        # kind-specific context (slot_program: {"work": the settle};
        # da_cells: {"geometry", "setup"})
        self.extra = extra


class VerificationBus:
    """One per chain: the submit boundary every consumer subsystem
    reaches the BLS device plane through."""

    def __init__(
        self,
        backend: str | None = None,
        journal=None,
        max_hold_ms: float | None = None,
        fill_target: int = DEFAULT_FILL_TARGET,
        seed: int | None = None,
        device: str = "cuda",
    ):
        self.backend = backend
        self.device = device
        self.journal = journal
        # None = backend-derived default (gpu: DEFAULT_GPU_HOLD_MS,
        # host: 0 == attributed passthrough); a float is an explicit
        # override
        self.max_hold_ms = max_hold_ms
        self.fill_target = int(fill_target)
        self.bulk_flush_live = DEFAULT_BULK_FLUSH_LIVE
        self.class_budgets = dict(DEFAULT_CLASS_BUDGETS)
        # zero-arg callable -> bool: the node's queue-depth/shedding
        # pressure signal
        self.pressure_fn = None
        self.seed = seed
        self.wall_model = PredictedWallModel()
        self._lock = threading.Lock()
        # thread-local slot-program staging: an import stages its deferred
        # KZG settle here so that the same thread's next submit carries it
        self._tls = threading.local()
        self._pending: list[_Submission] = []
        self._batch_seq = 0
        # counters (under _lock)
        self._submitted = 0
        self._completed = 0
        self._batches_formed = 0
        self._coalesced_batches = 0
        self._live_dispatched = 0
        self._deadline_misses = 0
        self._fallback_batches = 0
        self._triggers: dict[str, int] = {}

    # ------------------------------------------------------------- submit

    def submit(
        self,
        sets,
        consumer: str,
        deadline=None,
        journal=None,
        slot=None,
        journal_attrs: dict | None = None,
        backend: str | None = None,
    ) -> bool:
        """Verify `sets` as one unit (the `verify_signature_sets`
        contract: True iff every set verifies), possibly coalesced with
        other consumers' concurrent submissions. Blocks until the
        verdict; never drops — a submission whose deadline expires
        while queued gets an immediate small-batch flush.

        An EMPTY submission is vacuously true and returns immediately:
        it never occupies a coalescing slot or joins a device batch.

        `deadline` is anything with `.remaining()` or a float budget in
        seconds; None derives the class budget.

        When this thread staged a settle (`stage_program_work`), the
        submission becomes a `slot_program`: the settle rides the same
        dispatch as the signature fold, its verdict delivered through the
        staged work."""
        sets = list(sets)
        if not sets:
            # still validate the label — a typo'd consumer must fail
            # loudly here like it would on the non-empty path. A staged
            # settle stays staged for the next non-empty submit.
            attribution.normalize(consumer)
            return True
        work = self.pop_staged_work()
        consumer = attribution.normalize(consumer)
        _SUBMITTED.labels(consumer).inc()
        budget_s = self._budget_for(consumer, deadline)
        sub = _Submission(
            sets,
            consumer,
            journal if journal is not None else self.journal,
            slot,
            journal_attrs,
            backend or self.backend,
            budget_s,
            kind="slot_program" if work is not None else "bls",
            extra={"work": work} if work is not None else None,
        )
        return self._submit_and_wait(sub)

    def stage_program_work(self, work):
        """Stage one import's deferred device work (anything with
        `payload() -> (blobs, commitments, proofs, backend)` and
        `deliver(verdict)`) on THIS thread: the next non-empty `submit`
        from the same thread folds it into a slot program."""
        self._tls.staged_work = work

    def pop_staged_work(self):
        """Claim (and clear) this thread's staged program work."""
        work = getattr(self._tls, "staged_work", None)
        if work is not None:
            self._tls.staged_work = None
        return work

    def submit_program(
        self,
        work,
        consumer: str = "kzg",
        deadline=None,
        journal=None,
        slot=None,
        backend: str | None = None,
    ) -> bool:
        """Submit a settle-only slot program (an import with no signature
        fold still wants the guarded one-dispatch boundary for its
        settle). Blocks until the program ran; the settle verdict reaches
        the caller through `work.deliver`, and the returned bool is the
        program's group verdict, True for a healthy settle-only run."""
        consumer = attribution.normalize(consumer)
        _SUBMITTED.labels(consumer).inc()
        budget_s = self._budget_for(consumer, deadline)
        sub = _Submission(
            [],
            consumer,
            journal if journal is not None else self.journal,
            slot,
            None,
            backend or self.backend,
            budget_s,
            kind="slot_program",
            extra={"work": work},
        )
        return self._submit_and_wait(sub)

    def submit_cells(
        self,
        items,
        geometry,
        consumer: str = "da_cells",
        deadline=None,
        journal=None,
        slot=None,
        journal_attrs: dict | None = None,
        backend: str | None = None,
        setup=None,
    ) -> bool:
        """Verify DA cell-proof items (commitment, cell_index, cell, proof)
        as one unit, coalesced with other pending CELL submissions into one
        folded pairing batch (`da.cells.verify_cell_proof_batch`). The
        queue, deadline and mixed-fail contract of `submit`; cell batches
        never merge with signature batches -- the flush groups by
        (backend, kind). Empty submissions verify vacuously, like
        `submit`."""
        items = list(items)
        if not items:
            attribution.normalize(consumer)
            return True
        consumer = attribution.normalize(consumer)
        _SUBMITTED.labels(consumer).inc()
        budget_s = self._budget_for(consumer, deadline)
        sub = _Submission(
            items,
            consumer,
            journal if journal is not None else self.journal,
            slot,
            journal_attrs,
            backend or self.backend,
            budget_s,
            kind="da_cells",
            extra={"geometry": geometry, "setup": setup},
        )
        return self._submit_and_wait(sub)

    def _submit_and_wait(self, sub: _Submission) -> bool:
        hold_s = self._hold_s(sub.backend)
        # the pressure signal only matters when a hold could actually
        # be taken; evaluated OUTSIDE the bus lock
        pressure = hold_s > 0 and self._pressure()
        # caller-side slot-budget interval: the submit-to-verdict span
        # IS the import's causal device round trip (the flush may run
        # on another submitter's thread — this thread still blocks for
        # exactly that long); a slot program marks kind "fused"
        _budget_tok = slot_budget.open_dispatch(
            sub.consumer,
            kind="fused" if sub.kind == "slot_program" else "bus",
        )
        try:
            with self._lock:
                self._pending.append(sub)
                self._submitted += 1
                trigger = self._flush_trigger_locked(pressure)
            if trigger:
                self._flush(trigger)
            while not sub.done:
                if sub.claimed:
                    # another thread's flush took this submission; its
                    # _dispatch_group completes every claimed submission
                    # even on an escaping BaseException (finally), so
                    # this wait always terminates
                    sub.event.wait(1.0)
                    continue
                now = time.monotonic()
                pred = self.wall_model.predict_s(
                    len(sub.sets), cold_risk=self._cold_risk(sub.backend)
                )
                wake = min(
                    sub.submitted_at + hold_s, sub.expires_at - pred
                )
                timeout = wake - now
                if timeout > 0:
                    sub.event.wait(timeout)
                    continue
                reason = (
                    "deadline" if now >= sub.expires_at - pred
                    else "hold"
                )
                self._flush(reason)
        finally:
            slot_budget.close_dispatch(
                _budget_tok,
                queue_wait_s=(
                    max(0.0, sub.dispatch_t0 - sub.submitted_at)
                    if sub.dispatch_t0 is not None
                    else None
                ),
            )
        if sub.exc is not None:
            raise sub.exc
        return bool(sub.result)

    def submit_individual(
        self,
        sets,
        consumer: str,
        journal=None,
        slot=None,
        backend: str | None = None,
    ) -> list:
        """Per-set verdicts — the exact-fallback half of the batch
        semantics consumers run AFTER their batch verdict came back
        False. No coalescing (it is the rare recovery path, and its
        callers need the answer now); attribution and journal emission
        ride the normal api path."""
        from lighthouse_tpu_torch import bls

        return bls.verify_signature_sets_individually(
            list(sets),
            device=self.device,
            backend=backend or self.backend,
            consumer=consumer,
            journal=journal if journal is not None else self.journal,
            slot=slot,
        )

    # ---------------------------------------------------------- scheduling

    def _budget_for(self, consumer: str, deadline) -> float:
        if deadline is not None:
            remaining = getattr(deadline, "remaining", None)
            if callable(remaining):
                return max(0.0, float(remaining()))
            return max(0.0, float(deadline))
        return self.class_budgets.get(consumer, DEFAULT_BUDGET_S)

    def _hold_s(self, backend) -> float:
        if self.max_hold_ms is not None:
            return max(0.0, float(self.max_hold_ms)) / 1e3
        return (DEFAULT_GPU_HOLD_MS / 1e3) if backend == "gpu" else 0.0

    def _cold_risk(self, backend) -> bool:
        """May a dispatch on `backend` wait for the card's first-use
        build? Only the gpu backend on the card."""
        return backend == "gpu" and str(self.device).startswith("cuda")

    def _pressure(self) -> bool:
        if self.pressure_fn is None:
            return False
        try:
            return bool(self.pressure_fn())
        # a broken pressure source must not fail verification — treat as no pressure
        except Exception:
            return False

    def _flush_trigger_locked(self, pressure: bool):
        """The submit-time flush decision (caller holds the lock):
        returns the trigger name or None (keep holding)."""
        pending = [s for s in self._pending if not s.claimed]
        if not pending:
            return None
        if any(s.kind == "slot_program" for s in pending):
            # a slot program is an import's critical path carrying its own
            # settle: holding it for co-riders only delays that import
            return "bulk"
        live = sum(len(s.sets) for s in pending)
        if live >= self.fill_target:
            return "fill"
        if any(
            len(s.sets) >= self.bulk_flush_live for s in pending
        ):
            return "bulk"
        if pressure:
            return "pressure"
        if all(self._hold_s(s.backend) <= 0 for s in pending):
            return "passthrough"
        now = time.monotonic()
        pred = self.wall_model.predict_s(
            live,
            cold_risk=any(self._cold_risk(s.backend) for s in pending),
        )
        if min(s.expires_at for s in pending) - now <= pred:
            return "deadline"
        return None

    # ------------------------------------------------------------ dispatch

    def _flush(self, trigger: str):
        """Form one shared batch a (backend, kind) from everything
        pending and deliver verdicts. Runs on whichever submitter thread hit the trigger;
        the device dispatch happens OUTSIDE the bus lock so new
        submissions keep queueing behind it."""
        with self._lock:
            batch = [s for s in self._pending if not s.claimed]
            self._pending = []
            for s in batch:
                s.claimed = True
        if not batch:
            return
        groups: dict = {}
        for s in batch:
            groups.setdefault((s.backend, s.kind), []).append(s)
        for (backend, _kind), subs in groups.items():
            self._dispatch_group(subs, backend, trigger)

    def _dispatch_group(self, subs, backend, trigger: str):
        """Dispatch one backend group, guaranteeing every claimed
        submission completes: even a BaseException escaping the
        dispatch must not strand the other submitters in their wait
        loops — the finally fails any straggler loudly instead."""
        now = time.monotonic()
        for s in subs:
            s.dispatch_t0 = now
        try:
            self._dispatch_group_inner(subs, backend, trigger)
        finally:
            stragglers = [s for s in subs if not s.done]
            for s in stragglers:
                if s.exc is None:
                    s.exc = RuntimeError(
                        "verification bus flush aborted before this "
                        "submission's verdict"
                    )
                s.done = True
                s.event.set()
            if stragglers:
                with self._lock:
                    self._completed += len(stragglers)

    def _shared_verify(self, subs, backend):
        """Kind dispatch: a group is homogeneous by construction (the
        flush groups by (backend, kind))."""
        if subs[0].kind == "da_cells":
            return self._cells_shared_verify(subs, backend)
        if subs[0].kind == "slot_program":
            return self._program_shared_verify(subs, backend)
        return self._guarded_shared_verify(subs, backend)

    def _program_shared_verify(self, subs, backend):
        """The slot-program dispatch: the group's signature sets and each
        submission's staged settle run as ONE guarded program
        (`ops/slot_program.py`) on the "bls" plane -- the same breaker,
        canary sentinels and injection as the plain path. The returned
        (ok, record) is the signature verdict, the group contract that the
        mixed-batch retry isolates per submission; settle verdicts fan back
        through each work's `deliver`."""
        from lighthouse_tpu_torch import bls
        from lighthouse_tpu_torch.ops.slot_program import SlotProgram

        program = SlotProgram(seed=self.seed)
        for s in subs:
            if s.sets:
                program.add_signatures(s.sets, s.consumer)
            work = (s.extra or {}).get("work")
            if work is not None:
                program.add_settle(work)
        effective = backend or bls.api.default_backend()
        journal = next((s.journal for s in subs if s.journal is not None), None)
        slot = next((s.slot for s in subs if s.slot is not None), None)
        return program.run(
            backend=backend,
            journal=journal,
            slot=slot,
            predicted_s=self.wall_model.predict_s(
                max(1, program.total_live()), cold_risk=self._cold_risk(effective)
            ),
            device=self.device,
        )

    def _cells_shared_verify(self, subs, backend):
        """The shared DA cell-proof dispatch: every submission's items in
        ONE folded pairing batch. `da.cells.verify_cell_proof_batch` owns
        the guarded dispatch (plane "da_cells", no failover), the
        slot-budget mark and the attribution, so the bus adds only
        queueing and coalescing. Returns (ok, None): a cell batch carries
        no lanes/waste record."""
        from lighthouse_tpu_torch.da import cells as da_cells

        items = [it for s in subs for it in s.sets]
        geo = subs[0].extra["geometry"]
        setup = next(
            (s.extra["setup"] for s in subs if s.extra["setup"] is not None), None
        )
        ok = da_cells.verify_cell_proof_batch(
            items, geo, backend=backend, setup=setup, seed=self.seed,
            consumer="da_cells", device=self.device,
        )
        return bool(ok), None

    def _guarded_shared_verify(self, subs, backend):
        """The shared dispatch, routed through the device-plane guard
        (`device_plane.GUARD`): watchdog + circuit breaker around the
        card, deterministic fault injection on EVERY backend, and — when
        the canary is active — the known-answer sentinel contract: the
        valid sentinel rides the batch as an attribution-free extra set,
        and the (valid, invalid) pair is checked per set BEFORE the batch
        verify inside the same guarded attempt, so a lying verdict plane
        is caught before it can mis-verify the batch. No failover: a
        fault raises `DeviceFaultError` to every submitter of the group."""
        from lighthouse_tpu_torch import bls
        from lighthouse_tpu_torch.device_plane import (
            GUARD,
            DeviceFaultError,
            canary,
            pow2_bucket,
        )

        submissions = [(s.sets, s.consumer) for s in subs]
        effective = backend or bls.api.default_backend()
        total_live = sum(len(s.sets) for s in subs)
        journal = next(
            (s.journal for s in subs if s.journal is not None), None
        )
        slot = next((s.slot for s in subs if s.slot is not None), None)
        canary_on = GUARD.canary_active(effective)
        extra = [canary.bls_sentinels()[0]] if canary_on else None

        def attempt(plan):
            if canary_on:
                canary.check_pair(effective, plan, device=self.device)
            ok, record = bls.verify_signature_sets_shared(
                submissions, backend=backend, seed=self.seed,
                extra_sets=extra, device=self.device,
            )
            return plan.verdict(bool(ok)), record

        return GUARD.dispatch(
            "bls",
            pow2_bucket(total_live),
            attempt,
            journal=journal,
            slot=slot,
            predicted_s=self.wall_model.predict_s(
                total_live, cold_risk=self._cold_risk(effective)
            ),
            # host backends cross no device boundary: only the guard's
            # own fault taxonomy (injected faults, canary violations)
            # counts — data-dependent exceptions keep their
            # caller-visible semantics
            fault_types=None if effective == "gpu" else (DeviceFaultError,),
        )

    def _dispatch_group_inner(self, subs, backend, trigger: str):
        with self._lock:
            self._batch_seq += 1
            batch_id = self._batch_seq
            self._batches_formed += 1
            if len(subs) > 1:
                self._coalesced_batches += 1
            self._live_dispatched += sum(len(s.sets) for s in subs)
            self._triggers[trigger] = (
                self._triggers.get(trigger, 0) + 1
            )
        total_live = sum(len(s.sets) for s in subs)
        _BATCHES_FORMED.labels(trigger).inc()
        _BATCH_LIVE.observe(total_live)
        _BATCH_SUBMISSIONS.observe(len(subs))
        t0 = time.perf_counter()
        exc = None
        record = None
        try:
            ok, record = self._shared_verify(subs, backend)
        except Exception as e:
            ok = False
            exc = e
        wall_s = time.perf_counter() - t0
        self.wall_model.observe(total_live, wall_s)
        if ok or len(subs) == 1:
            self._journal_group(
                subs, [ok] * len(subs), batch_id, trigger, backend,
                total_live, wall_s, record, exc=exc,
            )
            self._complete(subs, [ok] * len(subs), exc_all=exc)
            return
        # mixed batch failed (or raised): isolate per submission so one
        # consumer's bad set cannot fail — or crash — a coterminous
        # consumer's verdict. Each sub-batch re-dispatches through the
        # same shared boundary (counted again on BOTH the registry and
        # journal sides, so attribution equality holds).
        self._journal_group(
            subs, [False] * len(subs), batch_id, trigger, backend,
            total_live, wall_s, record, exc=exc, mixed_retry=True,
        )
        verdicts = []
        for s in subs:
            with self._lock:
                self._batch_seq += 1
                sub_id = self._batch_seq
                self._batches_formed += 1
                self._fallback_batches += 1
                self._live_dispatched += len(s.sets)
                self._triggers["fallback"] = (
                    self._triggers.get("fallback", 0) + 1
                )
            _BATCHES_FORMED.labels("fallback").inc()
            _BATCH_LIVE.observe(len(s.sets))
            _BATCH_SUBMISSIONS.observe(1)
            t1 = time.perf_counter()
            sub_exc = None
            sub_record = None
            try:
                ok_i, sub_record = self._shared_verify([s], backend)
            except Exception as e:
                ok_i = False
                sub_exc = e
            sub_wall = time.perf_counter() - t1
            self.wall_model.observe(len(s.sets), sub_wall)
            self._journal_group(
                [s], [ok_i], sub_id, "fallback", backend,
                len(s.sets), sub_wall, sub_record, exc=sub_exc,
            )
            s.exc = sub_exc
            verdicts.append(ok_i)
        self._complete(subs, verdicts)

    def _journal_group(
        self,
        subs,
        verdicts,
        batch_id: int,
        trigger: str,
        backend,
        total_live: int,
        wall_s: float,
        record,
        exc=None,
        mixed_retry: bool = False,
    ):
        """One `signature_batch` event per contributing submission (a
        `cell_batch` one for a cell submission), sharing the batch id and
        economics — the journal side of the attribution equality (the
        registry counted each contributor's sets in
        verify_signature_sets_shared)."""
        now = time.monotonic()
        for s, ok_i in zip(subs, verdicts):
            journal = s.journal
            if journal is None:
                continue
            if s.kind == "slot_program" and not s.sets:
                # a settle-only program counted no signature sets on the
                # registry side, so it emits no signature_batch event
                continue
            attrs = {
                "consumer": s.consumer,
                "n_sets": len(s.sets),
                "backend": backend or "default",
                "bus_batch": batch_id,
                "batch_live": total_live,
                "n_submissions": len(subs),
                "trigger": trigger,
                "wait_s": round(now - s.submitted_at, 6),
                "budget_s": round(s.budget_s, 6),
                "wall_s": round(wall_s, 6),
            }
            if record is not None:
                if record.get("lanes") is not None:
                    attrs["lanes"] = record["lanes"]
                    attrs["waste"] = record.get("waste", 0)
                if record.get("amortized_fixed_ms") is not None:
                    attrs["amortized_fixed_ms"] = record[
                        "amortized_fixed_ms"
                    ]
            if mixed_retry:
                attrs["mixed_retry"] = True
            if s.attrs:
                attrs.update(s.attrs)
            outcome = (
                "error" if exc is not None
                else ("ok" if ok_i else "failed")
            )
            journal.emit(
                "cell_batch" if s.kind == "da_cells" else "signature_batch",
                slot=s.slot,
                outcome=outcome,
                **attrs,
            )

    def _complete(self, subs, verdicts, exc_all=None):
        now = time.monotonic()
        missed = 0
        for s, ok_i in zip(subs, verdicts):
            _WAIT_SECONDS.labels(s.consumer).observe(
                now - s.submitted_at
            )
            if now > s.expires_at:
                _DEADLINE_MISSES.labels(s.consumer).inc()
                missed += 1
            if exc_all is not None:
                s.exc = exc_all
            s.result = ok_i
            s.done = True
            s.event.set()
        with self._lock:
            self._completed += len(subs)
            self._deadline_misses += missed

    # --------------------------------------------------------------- reads

    def stats(self) -> dict:
        """The health-plane / bench view: knobs, queue state, batch
        formation counters, and the learned wall model."""
        with self._lock:
            batches = self._batches_formed
            return {
                "backend": self.backend,
                "max_hold_ms": (
                    self.max_hold_ms
                    if self.max_hold_ms is not None
                    else (
                        DEFAULT_GPU_HOLD_MS
                        if self.backend == "gpu"
                        else 0.0
                    )
                ),
                "fill_target": self.fill_target,
                "bulk_flush_live": self.bulk_flush_live,
                "class_budgets": dict(self.class_budgets),
                "pending": len(self._pending),
                "submitted": self._submitted,
                "completed": self._completed,
                "batches_formed": batches,
                "coalesced_batches": self._coalesced_batches,
                "live_dispatched": self._live_dispatched,
                "mean_live_per_batch": round(
                    self._live_dispatched / batches, 3
                )
                if batches
                else 0.0,
                "deadline_misses": self._deadline_misses,
                "fallback_batches": self._fallback_batches,
                "triggers": dict(self._triggers),
                "wall_model": self.wall_model.stats(),
            }
