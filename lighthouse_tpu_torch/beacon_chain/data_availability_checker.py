"""Data-availability checker: gate block import on verified blob sidecars.

The port of `lighthouse_tpu/beacon_chain/data_availability_checker.py`.

Role of the reference's `DataAvailabilityChecker`
(beacon_node/beacon_chain/src/data_availability_checker.rs + the
overflow LRU cache): a block whose body commits to blobs may only be
imported once every committed blob has arrived as a sidecar whose KZG
proof verifies. Components arrive in any order inside
`_PendingComponents` keyed by block root.

Verification discipline (the soundness/DoS core):

  * sidecar BEFORE block — cached as an UNVERIFIED candidate, keyed by
    content digest, with NO pairing work: a commitment that no block
    body names must cost nothing, and an attacker racing a
    self-consistent forgery ahead of the honest sidecar cannot poison
    anything (both candidates sit side by side until the block picks
    the one matching its body). Candidates per (root, index) are
    capped; the chain entry point (`chain.process_blob_sidecar`)
    verifies the sidecar's signed block header BEFORE anything may
    enter this cache (`chain.verify_blob_sidecar_header`), so spam
    must replay a real proposer's signed header — inventing arbitrary
    (root, index) space is closed, while targeted flooding of one
    known block's cap with header-replay forgeries remains bounded
    (not eliminated) by first-come-wins + digest-forgetting; the
    reference's full answer is gossip-time KZG + inclusion proofs.
  * block arrival — candidates matching the body's commitments are
    verified in ONE RLC-folded multi-pairing
    (`kzg.verify_blob_kzg_proof_batch`), the fold the PERF_NOTES entry
    measures; non-matching candidates are dropped.
  * sidecar AFTER the block — cross-checked against the body and
    verified immediately (N=1 skips the RLC overhead), so the last
    sidecar releases the held block with no extra latency.

An observed first-seen cache (observed_blob_sidecars.rs role) keyed by
(root, index, content digest) deduplicates exact redeliveries before
any work runs; every eviction (candidate cap, entry overflow, block
arrival, finality prune) forgets the evicted digests so a redelivery
is judged fresh.

The checker holds NO durable state: verified sidecars are persisted by
the import path (`chain.process_block`) only once their block actually
imports, so the store cannot be grown by sidecars of blocks that never
pass consensus validation.
"""

import hashlib
import time

from lighthouse_tpu_torch.common.events_journal import JOURNAL
from lighthouse_tpu_torch.common.metrics import REGISTRY
from lighthouse_tpu_torch.common.tracing import span

_PENDING_BLOCKS = REGISTRY.gauge(
    "lighthouse_tpu_da_pending_blocks",
    "blocks held awaiting blob sidecars",
)
_SIDECARS = REGISTRY.counter_vec(
    "lighthouse_tpu_da_sidecars_total",
    "blob sidecars processed, by outcome",
    ("outcome",),
)
_BLOCKS_RELEASED = REGISTRY.counter(
    "lighthouse_tpu_da_blocks_released_total",
    "held blocks released to import after their sidecars completed",
)
_HOLD_SECONDS = REGISTRY.histogram(
    "lighthouse_tpu_da_block_hold_seconds",
    "wall time a block spent held before its sidecars completed",
)


# the KZG backends a checker takes (kzg.api's)
_BACKENDS = ("gpu", "ref", "fake")


class DataAvailabilityError(Exception):
    pass


class ObservedBlobSidecars:
    """(block_root, index, content digest) first-seen filter for gossip
    dedup (observed_blob_sidecars.rs role), pruned by slot. Keying by
    content digest means only EXACT redeliveries are duplicates — a
    different sidecar for the same (root, index) is new information,
    judged on its own merits."""

    def __init__(self):
        self._seen: dict[int, set] = {}  # slot -> {(root, index, digest)}

    @staticmethod
    def _key(block_root: bytes, index: int, digest: bytes):
        return (bytes(block_root), int(index), digest)

    def is_known(
        self, slot: int, block_root: bytes, index: int, digest: bytes
    ) -> bool:
        return self._key(block_root, index, digest) in self._seen.get(
            slot, ()
        )

    def observe(
        self, slot: int, block_root: bytes, index: int, digest: bytes
    ) -> bool:
        """Returns True if already seen (and records the observation)."""
        bucket = self._seen.setdefault(slot, set())
        key = self._key(block_root, index, digest)
        if key in bucket:
            return True
        bucket.add(key)
        return False

    def forget(
        self, slot: int, block_root: bytes, index: int, digest: bytes
    ):
        """Un-record an observation — called whenever a cached-but-
        unsettled candidate is evicted, so a redelivery of that exact
        sidecar is judged fresh instead of 'duplicate'."""
        self._seen.get(slot, set()).discard(
            self._key(block_root, index, digest)
        )

    def prune(self, finalized_slot: int):
        for s in [s for s in self._seen if s < finalized_slot]:
            del self._seen[s]


class _PendingComponents:
    """One block root's in-flight pieces: the held block (if it arrived
    first), VERIFIED body-matching sidecars by index, and unverified
    pre-block candidates by (index, content digest)."""

    __slots__ = ("block", "sidecars", "candidates", "commitments", "t_held")

    def __init__(self):
        self.block = None  # held SignedBeaconBlock, or None
        self.sidecars: dict[int, object] = {}  # index -> verified sidecar
        self.candidates: dict[int, dict] = {}  # index -> {digest: sidecar}
        self.commitments = None  # list[bytes] once the block is known
        self.t_held = None


class PendingSettle:
    """One block's DEFERRED candidate settle, produced by
    `put_block_fused`: the body-matching candidates are partitioned
    host-side, the folded KZG verify rides the import's chained
    slot-program (`ops/slot_program.py`), and the verdict fans back
    through `deliver` before `finalize` applies it with serial
    byte-identity — a True verdict accepts the fold exactly like the
    serial batch path, a False/"error" verdict falls back to the same
    per-sidecar host recovery, and a never-delivered verdict (the
    program never dispatched) settles fully serially."""

    __slots__ = (
        "checker", "block_root", "signed_block", "entry", "matching",
        "discarded", "verdict", "finalized", "missing",
    )

    def __init__(
        self, checker, block_root, signed_block, entry, matching,
        discarded,
    ):
        self.checker = checker
        self.block_root = block_root
        self.signed_block = signed_block
        self.entry = entry
        self.matching = matching
        self.discarded = discarded
        self.verdict = None  # None | True | False | "error"
        self.finalized = False
        self.missing = None

    def payload(self):
        """The folded batch the chained program verifies: parallel
        (blobs, commitments, proofs) lists plus the checker's backend —
        the exact inputs the serial `_verify_batch` would fold."""
        scs = [sc for _, _, sc in self.matching]
        return (
            [bytes(sc.blob) for sc in scs],
            [bytes(sc.kzg_commitment) for sc in scs],
            [bytes(sc.kzg_proof) for sc in scs],
            self.checker.backend,
        )

    def deliver(self, verdict):
        """Record the chained program's fold verdict (idempotent-last:
        a mixed-batch retry re-delivers, and the retry's verdict is the
        one the batch semantics say counts)."""
        if not self.finalized:
            self.verdict = verdict

    def finalize(self) -> set:
        """Apply the (delivered or serially computed) verdict with the
        serial settle's exact note/journal/forget discipline, then run
        put_block's hold tail. Returns the missing indices; safe to
        call more than once (later calls return the first answer)."""
        if self.finalized:
            return self.missing
        self.finalized = True
        ch = self.checker
        with span("da/settle_candidates", n=len(self.matching)):
            if self.verdict is True:
                accepted = list(self.matching)
            elif self.verdict is None:
                accepted = ch._verify_matching(self.matching)
            else:
                # False or "error": per-sidecar recovery so honest
                # candidates still land — serial fold-failure semantics
                accepted = ch._verify_each(self.matching)
        ch._apply_settle(
            self.block_root, self.entry, self.matching, accepted,
            self.discarded,
        )
        self.missing = ch.missing_indices(
            self.block_root, self.signed_block
        )
        ch._hold_tail(
            self.block_root, self.signed_block, self.entry, self.missing
        )
        return self.missing


class DataAvailabilityChecker:
    # memory bounds against unsolicited gossip: at most this many roots
    # tracked (candidate-only spam entries evicted first, then oldest —
    # the reference's overflow LRU role), a candidate cap per
    # (root, index), and nothing accepted beyond one epoch past the
    # clock (a far-future slot would otherwise dodge finality pruning
    # forever). Every eviction forgets the evictees' observed digests.
    MAX_PENDING_ENTRIES = 512
    MAX_CANDIDATES_PER_INDEX = 4

    def __init__(
        self,
        spec,
        backend: str = "gpu",
        current_slot_fn=None,
        journal=None,
        device="cuda",
    ):
        self.spec = spec
        # the KZG checks share the chain's BLS backend name: "gpu" on
        # `device`, "ref" on the host, "fake" (structural testing, no real
        # pairing plane) always valid. Any other name raises: no backend
        # stands in for another
        if backend not in _BACKENDS:
            raise ValueError(
                f"unknown data-availability backend {backend!r}; "
                f"expected one of {_BACKENDS}"
            )
        self.backend = backend
        self.device = device
        self.current_slot_fn = current_slot_fn
        # per-node lifecycle journal (the chain passes its own); every
        # sidecar outcome counted in the da_sidecars_total family also
        # lands as a root/index-correlated journal event
        self.journal = journal if journal is not None else JOURNAL
        self.observed = ObservedBlobSidecars()
        self._pending: dict[bytes, _PendingComponents] = {}

    def _note_sidecar(
        self, outcome: str, root=None, index=None, slot=None, n: int = 1
    ):
        """One sidecar outcome -> Prometheus counter + journal event."""
        _SIDECARS.labels(outcome).inc(n)
        self.journal.emit(
            "sidecar",
            root=root,
            slot=slot,
            outcome=outcome,
            index=index,
            **({"n": n} if n != 1 else {}),
        )

    def stats(self) -> dict:
        """Occupancy snapshot for the health plane. Reads race import
        threads (the checker carries no lock), so every container is
        snapshotted with an ATOMIC C-level copy (list(dict.values()))
        before iteration — a concurrent put/evict shifts the numbers by
        one but can never raise mid-scrape."""
        entries = list(self._pending.values())
        candidates = 0
        verified = 0
        held = 0
        for e in entries:
            candidates += sum(
                len(c) for c in list(e.candidates.values())
            )
            verified += len(e.sidecars)
            if e.block is not None:
                held += 1
        return {
            "pending_entries": len(entries),
            "held_blocks": held,
            "cached_candidates": candidates,
            "verified_sidecars": verified,
        }

    def _drop_entry(self, block_root: bytes):
        """Evict one root and forget every digest it recorded —
        unsettled candidates AND verified sidecars — so redelivery
        after an eviction is judged fresh, never 'duplicate'."""
        entry = self._pending.pop(block_root, None)
        if entry is None:
            return
        for index, cands in entry.candidates.items():
            for digest, sc in cands.items():
                self.observed.forget(
                    int(sc.signed_block_header.message.slot),
                    block_root,
                    index,
                    digest,
                )
        for index, sc in entry.sidecars.items():
            self.observed.forget(
                int(sc.signed_block_header.message.slot),
                block_root,
                index,
                hashlib.sha256(sc.to_bytes()).digest(),
            )
        _PENDING_BLOCKS.set(len(self.pending_block_roots()))

    def _entry(self, block_root: bytes) -> _PendingComponents:
        e = self._pending.get(block_root)
        if e is None:
            if len(self._pending) >= self.MAX_PENDING_ENTRIES:
                # evict candidate-only spam first; a held block or a
                # root with verified sidecars goes only when the table
                # is genuinely full of real work
                victim = next(
                    (
                        r
                        for r, v in self._pending.items()
                        if v.block is None and not v.sidecars
                    ),
                    next(iter(self._pending)),
                )
                self._drop_entry(victim)
            e = self._pending[block_root] = _PendingComponents()
        return e

    def _slot_in_horizon(self, slot: int) -> bool:
        if self.current_slot_fn is None:
            return True
        return slot <= self.current_slot_fn() + self.spec.SLOTS_PER_EPOCH

    def _verify_batch(self, sidecars) -> bool:
        from lighthouse_tpu_torch.kzg import verify_blob_kzg_proof_batch

        return verify_blob_kzg_proof_batch(
            [bytes(sc.blob) for sc in sidecars],
            [bytes(sc.kzg_commitment) for sc in sidecars],
            [bytes(sc.kzg_proof) for sc in sidecars],
            backend=self.backend,
            consumer="kzg",
            device=self.device,
        )

    # ------------------------------------------------------------- queries

    @staticmethod
    def block_commitments(signed_block) -> list:
        return [
            bytes(c)
            for c in getattr(
                signed_block.message.body, "blob_kzg_commitments", []
            )
        ]

    def missing_indices(self, block_root: bytes, signed_block) -> set:
        """Commitment indices with no verified sidecar yet."""
        commitments = self.block_commitments(signed_block)
        entry = self._pending.get(block_root)
        have = set(entry.sidecars) if entry is not None else set()
        return {i for i in range(len(commitments)) if i not in have}

    def is_available(self, block_root: bytes, signed_block) -> bool:
        return not self.missing_indices(block_root, signed_block)

    def pending_block_roots(self) -> list:
        return [r for r, e in self._pending.items() if e.block is not None]

    def verified_sidecars(self, block_root: bytes) -> list:
        """Verified sidecars for a root, ordered by index — the import
        path persists THESE (and only these) once the block actually
        imports, so the durable store never holds blobs for blocks that
        failed consensus validation."""
        entry = self._pending.get(block_root)
        if entry is None:
            return []
        return [entry.sidecars[i] for i in sorted(entry.sidecars)]

    # -------------------------------------------------------------- blocks

    def put_block(self, block_root: bytes, signed_block) -> set:
        """Register an arrived block; returns the missing indices (empty
        set = available now). Unverified candidates cached before the
        block arrived are settled here: those matching the body's
        commitments are verified in ONE folded batch, the rest are
        dropped. Raises on a block that can never become available
        (more commitments than MAX_BLOBS_PER_BLOCK — no sidecar for the
        excess indices would pass the index bound)."""
        commitments = self.block_commitments(signed_block)
        if not commitments:
            return set()
        if len(commitments) > self.spec.MAX_BLOBS_PER_BLOCK:
            raise DataAvailabilityError(
                f"block commits to {len(commitments)} blobs, max is "
                f"{self.spec.MAX_BLOBS_PER_BLOCK}"
            )
        entry = self._entry(block_root)
        entry.commitments = commitments
        self._settle_candidates(block_root, entry)
        missing = self.missing_indices(block_root, signed_block)
        self._hold_tail(block_root, signed_block, entry, missing)
        return missing

    def put_block_fused(self, block_root: bytes, signed_block):
        """Fused-path variant of `put_block` for the one-dispatch slot:
        partition the pre-block candidates NOW (host-only work), and —
        when the optimistic verdict could make the block available —
        DEFER the folded KZG verify into the import's chained
        slot-program instead of paying a dispatch here. Returns
        `(missing, pending)`:

          * `(missing, None)` — settled serially, byte-identical to
            `put_block` (no commitments, nothing matching to fold, or
            sidecars are genuinely missing so the block holds exactly
            as before);
          * `(set(), PendingSettle)` — every commitment is covered if
            the fold verifies; the caller rides the work on the
            import's single dispatch and calls `finalize()` for the
            real missing set."""
        commitments = self.block_commitments(signed_block)
        if not commitments:
            return set(), None
        if len(commitments) > self.spec.MAX_BLOBS_PER_BLOCK:
            raise DataAvailabilityError(
                f"block commits to {len(commitments)} blobs, max is "
                f"{self.spec.MAX_BLOBS_PER_BLOCK}"
            )
        entry = self._entry(block_root)
        entry.commitments = commitments
        matching, discarded = self._partition_candidates(
            block_root, entry
        )
        covered = set(entry.sidecars) | {i for i, _, _ in matching}
        optimistic_missing = {
            i for i in range(len(commitments)) if i not in covered
        }
        if not matching or optimistic_missing:
            # nothing to fold, or the block cannot become available
            # this import regardless of the fold's verdict: settle
            # serially now — byte-identical to put_block
            if matching:
                with span("da/settle_candidates", n=len(matching)):
                    accepted = self._verify_matching(matching)
            else:
                accepted = []
            self._apply_settle(
                block_root, entry, matching, accepted, discarded
            )
            missing = self.missing_indices(block_root, signed_block)
            self._hold_tail(block_root, signed_block, entry, missing)
            return missing, None
        return set(), PendingSettle(
            self, block_root, signed_block, entry, matching, discarded
        )

    def _hold_tail(self, block_root, signed_block, entry, missing):
        """put_block's terminal: hold an unavailable block (or drop a
        workless entry), finish an available one."""
        if missing:
            # far-future blocks are reported unavailable but NOT cached
            # — they would dodge finality pruning indefinitely
            if entry.block is None and self._slot_in_horizon(
                int(signed_block.message.slot)
            ):
                entry.block = signed_block
                entry.t_held = time.monotonic()
                _PENDING_BLOCKS.set(len(self.pending_block_roots()))
            if not entry.sidecars and entry.block is None:
                self._drop_entry(block_root)
        else:
            self._finish(block_root, entry)

    def _settle_candidates(self, block_root: bytes, entry):
        """Pre-block candidates -> verified sidecars: pick the
        body-matching candidates and verify ALL of them in one
        RLC-folded multi-pairing (the fast path); if the fold fails
        (mixed honest/forged candidates), fall back to per-sidecar
        verdicts so honest ones still land. Every candidate NOT
        accepted has its observed digest forgotten — its redelivery
        should be judged against the now-known block (mismatch/invalid
        penalties), not shrugged off as a duplicate."""
        matching, discarded = self._partition_candidates(
            block_root, entry
        )
        if matching:
            with span("da/settle_candidates", n=len(matching)):
                accepted = self._verify_matching(matching)
        else:
            accepted = []
        self._apply_settle(
            block_root, entry, matching, accepted, discarded
        )

    def _partition_candidates(self, block_root: bytes, entry):
        """Host half of the settle: split cached candidates into
        body-matching vs discarded (and note the mismatches), clearing
        the candidate table. Pure bookkeeping — no pairing work."""
        matching, discarded = [], []
        for i, cands in entry.candidates.items():
            usable = i not in entry.sidecars and i < len(entry.commitments)
            for digest, sc in cands.items():
                if usable and bytes(sc.kzg_commitment) == (
                    entry.commitments[i]
                ):
                    matching.append((i, digest, sc))
                else:
                    discarded.append((i, digest, sc))
        entry.candidates.clear()
        if discarded:
            self._note_sidecar(
                "mismatched_commitment", root=block_root, n=len(discarded)
            )
        return matching, discarded

    def _verify_each(self, matching) -> list:
        """Per-sidecar recovery verdicts (the fold failed or raised):
        honest candidates still land, each judged alone."""
        from lighthouse_tpu_torch.kzg import KzgError

        out = []
        for item in matching:
            try:
                if self._verify_batch([item[2]]):
                    out.append(item)
            except KzgError:
                pass
        return out

    def _verify_matching(self, matching) -> list:
        """Device half of the serial settle: ONE folded batch, falling
        back to per-sidecar verdicts when the fold fails or a malformed
        candidate raises."""
        from lighthouse_tpu_torch.kzg import KzgError

        try:
            if self._verify_batch([sc for _, _, sc in matching]):
                return matching
            return self._verify_each(matching)
        except KzgError:
            # one malformed candidate must not sink the rest
            return self._verify_each(matching)

    def _apply_settle(
        self, block_root: bytes, entry, matching, accepted, discarded
    ):
        """Bookkeeping half of the settle: install accepted sidecars,
        note invalid proofs, emit the da_settle event, and forget every
        discarded/rejected digest so redeliveries are judged fresh."""
        discarded = list(discarded)
        if matching:
            if len(accepted) < len(matching):
                self._note_sidecar(
                    "invalid_proof",
                    root=block_root,
                    n=len(matching) - len(accepted),
                )
            accepted_set = {id(item[2]) for item in accepted}
            discarded.extend(
                item for item in matching if id(item[2]) not in accepted_set
            )
            for i, digest, sc in accepted:
                if i in entry.sidecars:
                    continue  # two valid candidates for an index: keep one
                self._note_sidecar(
                    "verified",
                    root=block_root,
                    index=i,
                    slot=int(sc.signed_block_header.message.slot),
                )
                entry.sidecars[i] = sc
            self.journal.emit(
                "da_settle",
                root=block_root,
                outcome="ok" if len(accepted) == len(matching) else (
                    "partial"
                ),
                n_matched=len(matching),
                n_accepted=len(accepted),
            )
        for i, digest, sc in discarded:
            self.observed.forget(
                int(sc.signed_block_header.message.slot),
                block_root,
                i,
                digest,
            )

    # ------------------------------------------------------------ sidecars

    def _structural_gate(self, sidecar, precomputed=None):
        """Shared cheap checks — index bound, clock horizon, exact
        duplicate. Returns (block_root, digest); `precomputed` skips the
        two hashes when a previous precheck already paid them (the
        gossip path's root/digest plumbing)."""
        spec = self.spec
        header = sidecar.signed_block_header.message
        index = int(sidecar.index)
        slot = int(header.slot)
        if precomputed is not None:
            block_root, digest = precomputed
        else:
            block_root = type(header).hash_tree_root(header)
            digest = None  # computed only if the cheap bounds pass
        if index >= spec.MAX_BLOBS_PER_BLOCK:
            self._note_sidecar(
                "bad_index", root=block_root, index=index, slot=slot
            )
            raise DataAvailabilityError(
                f"sidecar index {index} out of range"
            )
        if not self._slot_in_horizon(slot):
            self._note_sidecar(
                "future_slot", root=block_root, index=index, slot=slot
            )
            raise DataAvailabilityError(
                f"sidecar slot {slot} beyond the clock horizon"
            )
        if digest is None:
            digest = hashlib.sha256(sidecar.to_bytes()).digest()
        if self.observed.is_known(slot, block_root, index, digest):
            self._note_sidecar(
                "duplicate", root=block_root, index=index, slot=slot
            )
            raise DataAvailabilityError("duplicate sidecar")
        return block_root, digest

    def precheck_sidecar(self, sidecar):
        """Cheap structural rejections — index bound, clock horizon,
        exact-duplicate — WITHOUT mutating any cache. The chain runs
        this BEFORE the proposer-signature pairing so junk costs O(1),
        never a pairing (cheap-checks-first DoS ordering). Returns the
        (block_root, content digest) pair so the caller can hand it
        back to put_sidecar and skip the second hashing pass."""
        return self._structural_gate(sidecar)

    def put_sidecar(self, sidecar, precomputed=None) -> list:
        """Validate + record one gossip sidecar. Returns the list of
        released (now fully-available) held blocks — usually empty or
        one. Raises DataAvailabilityError on invalid/duplicate input.
        Sidecars for still-unknown blocks are cached WITHOUT any
        pairing work (verification happens when the block names their
        commitment — see the module docstring). `precomputed` is the
        (block_root, digest) pair a precheck_sidecar call already
        derived (halves gossip-path sidecar hashing); the structural
        checks themselves are re-run as this method's own gate."""
        header = sidecar.signed_block_header.message
        index = int(sidecar.index)
        slot = int(header.slot)
        block_root, digest = self._structural_gate(
            sidecar, precomputed=precomputed
        )

        entry = self._pending.get(block_root)
        if entry is None or entry.commitments is None:
            # block not yet known: cache as an unverified candidate —
            # no pairing work until a block names this commitment
            entry = self._entry(block_root)
            cands = entry.candidates.setdefault(index, {})
            if digest not in cands:
                if len(cands) >= self.MAX_CANDIDATES_PER_INDEX:
                    # cap full: drop the NEW arrival (first-come-wins —
                    # an already-cached sidecar can never be displaced,
                    # so back-running spam is harmless; FRONT-running
                    # needs a replay of the block's real signed header
                    # since the chain verifies it before put_sidecar,
                    # and even then costs only a delayed import — see
                    # module docstring). Not observed: a post-block
                    # redelivery verifies fresh.
                    self._note_sidecar(
                        "candidate_overflow",
                        root=block_root,
                        index=index,
                        slot=slot,
                    )
                    return []
                cands[digest] = sidecar
            self.observed.observe(slot, block_root, index, digest)
            self._note_sidecar(
                "cached_pending_block",
                root=block_root,
                index=index,
                slot=slot,
            )
            return []

        # block known: cross-check against the body, then verify NOW
        if index >= len(entry.commitments) or bytes(
            sidecar.kzg_commitment
        ) != entry.commitments[index]:
            self._note_sidecar(
                "mismatched_commitment",
                root=block_root,
                index=index,
                slot=slot,
            )
            raise DataAvailabilityError(
                "sidecar commitment does not match the block body"
            )
        from lighthouse_tpu_torch.kzg import KzgError

        with span("da/verify_sidecar", index=index):
            try:
                ok = self._verify_batch([sidecar])
            except KzgError as e:
                self._note_sidecar(
                    "invalid_proof", root=block_root, index=index, slot=slot
                )
                raise DataAvailabilityError(f"malformed sidecar: {e}") from e
        if not ok:
            self._note_sidecar(
                "invalid_proof", root=block_root, index=index, slot=slot
            )
            raise DataAvailabilityError("KZG proof verification failed")

        self._note_sidecar(
            "verified", root=block_root, index=index, slot=slot
        )
        self.observed.observe(slot, block_root, index, digest)
        if index not in entry.sidecars:
            entry.sidecars[index] = sidecar

        released = []
        if entry.block is not None and set(entry.sidecars) >= set(
            range(len(entry.commitments))
        ):
            released.append(entry.block)
            self._finish(block_root, entry)
        return released

    def _finish(self, block_root: bytes, entry: _PendingComponents):
        """Mark a root complete. The entry (with its verified sidecars)
        stays until finality pruning: the released block re-enters
        `process_block`, whose DA gate consults these sidecars again —
        popping here would re-hold the block forever."""
        if entry.block is not None:
            _BLOCKS_RELEASED.inc()
            held_s = None
            if entry.t_held is not None:
                held_s = time.monotonic() - entry.t_held
                _HOLD_SECONDS.observe(held_s)
            self.journal.emit(
                "block_release",
                root=block_root,
                slot=int(entry.block.message.slot),
                outcome="complete",
                duration_s=held_s,
                n_sidecars=len(entry.sidecars),
            )
            entry.block = None
            entry.t_held = None
        _PENDING_BLOCKS.set(len(self.pending_block_roots()))

    # ------------------------------------------------------------- pruning

    def prune(self, finalized_slot: int):
        """Drop stale pending entries + the observed cache below
        finality (a held block whose slot finalized without it can never
        import on the canonical chain)."""
        self.observed.prune(finalized_slot)
        for root, entry in list(self._pending.items()):
            slots = [
                int(sc.signed_block_header.message.slot)
                for sc in entry.sidecars.values()
            ]
            for cands in entry.candidates.values():
                slots.extend(
                    int(sc.signed_block_header.message.slot)
                    for sc in cands.values()
                )
            if entry.block is not None:
                slots.append(int(entry.block.message.slot))
            if slots and max(slots) < finalized_slot:
                self._drop_entry(root)
        _PENDING_BLOCKS.set(len(self.pending_block_roots()))
