"""The slot program: one guarded dispatch for a whole import.

The port of `lighthouse_tpu/ops/slot_program.py`. A blob import would pay
two serial host<->device crossings -- the data-availability checker's KZG
settle, then the bus's signature fold -- each with its own guard, canary
and fixed dispatch cost. A `SlotProgram` collects an import's device work
-- Merkle branch checks, the signature RLC fold and the KZG settle -- and
runs all of it inside ONE `GUARD.dispatch` crossing.

The guard's contract is the bus's shared verify
(`verification_bus/bus.py::_guarded_shared_verify`):

  * the program dispatches on the "bls" plane, so it shares the breaker,
    the canary and the fault injection with the plain signature path;
  * when the canary is active, the sentinel pair is checked FIRST inside
    the attempt and the valid sentinel rides the signature fold as an
    attribution-free extra set;
  * every verdict the program produces -- each settle's, each Merkle
    query's, the fold's -- goes through the attempt's `plan.verdict`, so a
    flip injection flips them all, which is how the canary catches it;
  * the inner `kzg`, `merkle_proof` and `bls` dispatches meet the guard's
    reentrancy check and pass through: one program is one counted
    dispatch.

There is no failover tier: a device fault reaches the caller as a
`DeviceFaultError`, and a fault raised before the segments run (a stall, an
error, an open breaker, a canary violation) delivers no settle verdict --
the caller sees the work undelivered.

Verdict isolation: each settle work keeps its OWN folded KZG batch
(one import's invalid blob never fails another's settle), delivered
through `work.deliver` ("error" when the batch raises `KzgError`). The
signature fold is the unchanged `bls.verify_signature_sets_shared`.

`device` is where every call inside the program runs: the card by default,
"cpu" for the plain versions (the tests).
"""

from lighthouse_tpu_torch.common import slot_budget


def run_slot_program_segments(program, sig_backend, plan, extra_sets, seed, device):
    """Run every segment of `program`: the KZG settle works first (each its
    own folded batch, its verdict delivered to the work), then the Merkle
    checks, then the signature RLC fold over every submission. Returns
    `(ok, record)`: `ok` the signature and Merkle verdict, `record` the
    fold's batch economics (None without signatures).

    Callers reach it only through `SlotProgram.run`'s guarded attempt."""
    from lighthouse_tpu_torch import bls, kzg
    from lighthouse_tpu_torch.ops import merkle_proof

    for work in program.settles:
        blobs, commitments, proofs, work_backend = work.payload()
        try:
            ok = kzg.verify_blob_kzg_proof_batch(
                blobs, commitments, proofs, backend=work_backend, consumer="kzg",
                device=device,
            )
        except kzg.KzgError:
            # a malformed candidate must not sink the rest: the caller
            # settles that work its own way
            work.deliver("error")
        else:
            work.deliver(plan.verdict(bool(ok)))
    program.merkle_results = []
    merkle_ok = True
    for queries, roots, consumer in program.merkle_segments:
        verdicts = [
            plan.verdict(bool(v))
            for v in merkle_proof.batch_verify_branches(
                queries, roots, consumer=consumer, device=device
            )
        ]
        program.merkle_results.append(verdicts)
        merkle_ok = merkle_ok and all(verdicts)
    if not program.signature_submissions:
        # a settle or Merkle program alone: the group verdict is the
        # other segments' conjunction
        return plan.verdict(True) and merkle_ok, None
    ok, record = bls.verify_signature_sets_shared(
        program.signature_submissions, backend=sig_backend, seed=seed,
        extra_sets=extra_sets, device=device,
    )
    return plan.verdict(bool(ok)) and merkle_ok, record


class SlotProgram:
    """One import's chained device program. Compose it with
    `add_settle` (anything with `payload() -> (blobs, commitments, proofs,
    backend)` and `deliver(verdict)`), `add_signatures` and `add_merkle`;
    then one `run()` is one guarded host<->device crossing for
    everything."""

    def __init__(self, seed=None):
        self.seed = seed
        self.settles: list = []
        self.signature_submissions: list = []  # (sets, consumer)
        self.merkle_segments: list = []  # (queries, roots, consumer)
        self.merkle_results: list = []

    def add_settle(self, work):
        self.settles.append(work)
        return self

    def add_signatures(self, sets, consumer: str):
        sets = list(sets)
        if sets:
            self.signature_submissions.append((sets, consumer))
        return self

    def add_merkle(self, queries, roots, consumer: str = "bench"):
        queries = list(queries)
        if queries:
            self.merkle_segments.append((queries, list(roots), consumer))
        return self

    @property
    def empty(self) -> bool:
        return not (self.settles or self.signature_submissions or self.merkle_segments)

    def total_live(self) -> int:
        return (
            sum(len(s) for s, _ in self.signature_submissions)
            + sum(len(w.payload()[0]) for w in self.settles)
            + sum(len(q) for q, _, _ in self.merkle_segments)
        )

    def run(self, backend: str | None = None, journal=None, slot=None, predicted_s=None,
            device="cuda"):
        """One guarded dispatch for the whole program: watchdog, breaker,
        canary and injection around the chained segments. Returns `(ok,
        record)` like the bus's shared verify; settle verdicts fan back
        through each work's `deliver`. On "gpu" with `device="cuda"` and
        no GPU it raises before the guard is crossed."""
        from lighthouse_tpu_torch.bls import api
        from lighthouse_tpu_torch.device_plane import (
            GUARD,
            DeviceFaultError,
            canary,
            pow2_bucket,
        )
        from lighthouse_tpu_torch.ops.device_io import resolve_device

        effective = backend or api.default_backend()
        if effective == "gpu":
            resolve_device(device)
        canary_on = GUARD.canary_active(effective)
        extra = [canary.bls_sentinels()[0]] if canary_on and self.signature_submissions else None

        def attempt(plan):
            if canary_on:
                canary.check_pair(effective, plan, device=device)
            return run_slot_program_segments(self, backend, plan, extra, self.seed, device)

        # the fused dispatch interval belongs to the bus's caller-side
        # "fused" mark (or, driven directly, to this outermost open)
        tok = slot_budget.open_dispatch("slot_program", kind="fused")
        try:
            return GUARD.dispatch(
                "bls",
                pow2_bucket(max(1, self.total_live())),
                attempt,
                journal=journal,
                slot=slot,
                predicted_s=predicted_s,
                # host backends cross no device boundary: only the guard's
                # own faults count, and data-dependent exceptions keep
                # their caller-visible semantics
                fault_types=None if effective == "gpu" else (DeviceFaultError,),
            )
        finally:
            slot_budget.close_dispatch(tok)
