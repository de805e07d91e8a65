"""In-process chain harness: deterministic validators driving a real state
transition, block production, and attestation flow.

The port of `lighthouse_tpu/harness.py` (role of the reference client's
`BeaconChainHarness`, beacon_node/beacon_chain/src/test_utils.rs:47-66):
interop-keypair genesis, manual slot control, block production with full
attestation participation, and import through the real per-block
pipeline. Imports verify on the "gpu" backend on `device` ("cuda") unless
asked; `process_slots` runs its epoch boundaries on the same device.

An aggregate is signed once, with the summed secret key: a committee's
attestation signature is `SecretKey(sum of its members' keys mod r)`
signing the data root, and the sync aggregate counts a member once for
each seat it holds. That is the same point as the sum of the members'
signatures, so the same bytes, at one G2 multiplication a committee.

`make_blob_sidecars` builds a blob block's sidecars on the port's `kzg`.

`Harness.from_genesis` builds a harness on keypairs, a genesis state and a
pubkey cache that the caller made (`testing.chain_harness` does so at
mainnet sizes, where interop keys and decompression cost too much).
"""

import time

from lighthouse_tpu_torch import bls, ssz
from lighthouse_tpu_torch.crypto.constants import R
from lighthouse_tpu_torch.crypto.ref_curve import G2 as G2_GROUP
from lighthouse_tpu_torch.ssz.cached_hash import (
    cached_state_root,
    carry_tree_cache,
)
from lighthouse_tpu_torch.ssz.hashing import ZERO_BYTES32
from lighthouse_tpu_torch.state_processing.genesis import interop_genesis_state
from lighthouse_tpu_torch.state_processing.helpers import (
    CommitteeCache,
    get_beacon_proposer_index,
    get_block_root_at_slot,
    get_current_epoch,
    get_domain,
)
from lighthouse_tpu_torch.state_processing.per_block import (
    BlockSignatureStrategy,
    SignatureCollector,
    per_block_processing,
)
from lighthouse_tpu_torch.state_processing.per_slot import process_slots
from lighthouse_tpu_torch.state_processing.pubkey_cache import PubkeyCache
from lighthouse_tpu_torch.types.containers import types_for
from lighthouse_tpu_torch.types.helpers import compute_signing_root
from lighthouse_tpu_torch.types.spec import Spec


class Harness:
    def __init__(
        self,
        spec: Spec,
        n_validators: int,
        backend: str = "gpu",
        device="cuda",
        genesis_time: int = 0,
    ):
        keypairs = bls.interop_keypairs(n_validators)
        state = interop_genesis_state(
            [kp.pk.to_bytes() for kp in keypairs], genesis_time, spec
        )
        pubkey_cache = PubkeyCache(device=device)
        pubkey_cache.import_new(state)
        self._setup(spec, keypairs, state, pubkey_cache, backend, device)

    @classmethod
    def from_genesis(
        cls, spec: Spec, keypairs, state, pubkey_cache, backend: str = "gpu",
        device="cuda",
    ):
        """A harness on `keypairs` (validator i's at i), their genesis
        `state` and a `pubkey_cache` holding their keys on `device`."""
        h = cls.__new__(cls)
        h._setup(spec, keypairs, state, pubkey_cache, backend, device)
        return h

    def _setup(self, spec, keypairs, state, pubkey_cache, backend, device):
        self.spec = spec
        self.t = types_for(spec)
        self.keypairs = keypairs
        self.state = state
        self.backend = backend
        self.device = device
        self.pubkey_cache = pubkey_cache
        self.fork_name = spec.fork_name_at_epoch(0)
        self._secret_ints = None
        self.last_import_stats = {}
        # attestations produced at the previous slot, pending inclusion
        self.pending_attestations = []
        # optional bellatrix payload source: callable(state) -> ExecutionPayload
        # (None = pre-merge default-empty payloads)
        self.payload_builder = None

    # ------------------------------------------------------------ helpers

    def _sign(self, sk, obj_root: bytes, domain: bytes) -> bytes:
        return sk.sign(compute_signing_root(obj_root, domain)).to_bytes()

    def _sign_aggregate(self, validators, signing_root: bytes) -> bytes:
        """The aggregate of `validators`' signatures over `signing_root`
        (a validator once for each time it is listed), signed once with
        the summed secret key."""
        if self._secret_ints is None:
            self._secret_ints = [
                int.from_bytes(kp.sk.to_bytes(), "big") for kp in self.keypairs
            ]
        total = sum(self._secret_ints[v] for v in validators) % R
        if total == 0:  # the keys cancel: the identity point
            return bls.Signature(G2_GROUP.infinity).to_bytes()
        return bls.SecretKey(total).sign(signing_root).to_bytes()

    def randao_reveal(self, slot: int) -> bytes:
        """The proposer's RANDAO reveal for `slot` on the current state --
        for tests that drive a chain's production path directly."""
        spec = self.spec
        state = self.state.copy()
        if state.slot < slot:
            state = process_slots(state, slot, spec, device=self.device)
        proposer = get_beacon_proposer_index(state, spec)
        epoch = get_current_epoch(state, spec)
        domain = get_domain(state, spec.DOMAIN_RANDAO, epoch, spec)
        return self._sign(
            self.keypairs[proposer].sk,
            ssz.uint64.hash_tree_root(epoch),
            domain,
        )

    def head_block_root(self, state) -> bytes:
        header = state.latest_block_header
        if bytes(header.state_root) == ZERO_BYTES32:
            header = header.copy()
            header.state_root = cached_state_root(state)
        return type(header).hash_tree_root(header)

    # ----------------------------------------------------- attestations

    def make_attestations(self, state, slot: int):
        """Full-participation attestations for `slot` against the current
        head (call right after importing the block at `slot`)."""
        spec = self.spec
        t = self.t
        epoch = spec.slot_to_epoch(slot)
        cache = CommitteeCache(state, epoch, spec)
        head_root = self.head_block_root(state)
        start_slot = spec.epoch_start_slot(epoch)
        if start_slot == slot:
            target_root = head_root
        else:
            target_root = bytes(get_block_root_at_slot(state, start_slot, spec))
        domain = get_domain(state, spec.DOMAIN_BEACON_ATTESTER, epoch, spec)
        out = []
        for index in range(cache.committees_per_slot):
            committee = cache.get_beacon_committee(slot, index)
            data = t.AttestationData(
                slot=slot,
                index=index,
                beacon_block_root=head_root,
                source=state.current_justified_checkpoint,
                target=t.Checkpoint(epoch=epoch, root=target_root),
            )
            root = compute_signing_root(t.AttestationData.hash_tree_root(data), domain)
            out.append(
                t.Attestation(
                    aggregation_bits=[True] * len(committee),
                    data=data,
                    signature=self._sign_aggregate(committee, root),
                )
            )
        return out

    def make_sync_aggregate(self, state, block_root: bytes):
        spec = self.spec
        t = self.t
        prev_slot = max(state.slot, 1) - 1
        domain = get_domain(
            state,
            spec.DOMAIN_SYNC_COMMITTEE,
            spec.slot_to_epoch(prev_slot),
            spec,
        )
        seats = [
            self.pubkey_cache.index_of(bytes(pk))
            for pk in state.current_sync_committee.pubkeys
        ]
        return t.SyncAggregate(
            sync_committee_bits=[True] * len(seats),
            sync_committee_signature=self._sign_aggregate(
                seats, compute_signing_root(block_root, domain)
            ),
        )

    # -------------------------------------------------------- production

    def produce_block(
        self,
        slot: int,
        attestations,
        deposits=(),
        voluntary_exits=(),
        proposer_slashings=(),
        attester_slashings=(),
        sync_aggregate=None,
        blob_kzg_commitments=(),
    ):
        """Produce a signed block for `slot` on top of the current state."""
        return self._produce(
            slot, attestations, deposits, voluntary_exits, proposer_slashings,
            attester_slashings, sync_aggregate, blob_kzg_commitments,
        )[0]

    def _produce(
        self, slot, attestations, deposits=(), voluntary_exits=(),
        proposer_slashings=(), attester_slashings=(), sync_aggregate=None,
        blob_kzg_commitments=(),
    ):
        """The signed block for `slot` and the post-state its state root
        was computed on (the block applied without verification)."""
        spec = self.spec
        t = self.t
        state = self.state.copy()
        carry_tree_cache(state, self.state)
        state = process_slots(state, slot, spec, device=self.device)
        fork_name = spec.fork_name_at_epoch(get_current_epoch(state, spec))

        proposer = get_beacon_proposer_index(state, spec)
        epoch = get_current_epoch(state, spec)
        randao_domain = get_domain(state, spec.DOMAIN_RANDAO, epoch, spec)
        randao_reveal = self._sign(
            self.keypairs[proposer].sk,
            ssz.uint64.hash_tree_root(epoch),
            randao_domain,
        )

        body_cls = t.block_body_classes[fork_name]
        body = body_cls(
            randao_reveal=randao_reveal,
            eth1_data=state.eth1_data,
            graffiti=b"\x00" * 32,
            attestations=list(attestations),
            deposits=list(deposits),
            voluntary_exits=list(voluntary_exits),
            proposer_slashings=list(proposer_slashings),
            attester_slashings=list(attester_slashings),
        )
        parent_root = self.head_block_root(state)
        if fork_name != "phase0":
            # a caller-provided aggregate (e.g. a chain's contribution
            # pool) wins; the default is the harness's omniscient
            # full-participation aggregate over the parent root
            body.sync_aggregate = (
                sync_aggregate
                if sync_aggregate is not None
                else self.make_sync_aggregate(state, parent_root)
            )
        if fork_name == "bellatrix" and self.payload_builder is not None:
            body.execution_payload = self.payload_builder(state)
        if blob_kzg_commitments:
            if fork_name != "bellatrix":
                raise ValueError(
                    "blob commitments need a bellatrix-or-later body"
                )
            body.blob_kzg_commitments = [
                bytes(c) for c in blob_kzg_commitments
            ]

        block_cls = t.block_classes[fork_name]
        block = block_cls(
            slot=slot,
            proposer_index=proposer,
            parent_root=parent_root,
            state_root=ZERO_BYTES32,
            body=body,
        )

        # the post-state root, with signatures skipped, on the slot-advanced
        # copy itself (the proposal's domain read first): it is this
        # method's own, so a second copy would hold nothing
        proposal_domain = get_domain(
            state,
            spec.DOMAIN_BEACON_PROPOSER,
            spec.slot_to_epoch(slot),
            spec,
        )
        signed_cls = t.signed_block_classes[fork_name]
        trial_signed = signed_cls(message=block, signature=b"\x00" * 96)
        per_block_processing(
            state,
            trial_signed,
            spec,
            BlockSignatureStrategy.NO_VERIFICATION,
            self.pubkey_cache,
            device=self.device,
        )
        block.state_root = cached_state_root(state)

        signature = self._sign(
            self.keypairs[proposer].sk,
            block_cls.hash_tree_root(block),
            proposal_domain,
        )
        return signed_cls(message=block, signature=signature), state

    # ------------------------------------------------------------ import

    def import_block(self, signed_block, strategy=None, consumer=None,
                     collector=None):
        """Import one block as a segment of one (`import_segment`): its
        sets go to `collector`, by default the harness's own (`strategy`,
        VERIFY_BULK unless given, on the harness's backend and device,
        seeded slot + 1, `consumer` attributed); a caller that passes one
        reads the sets that were verified. `last_import_stats` keeps the
        seconds of each step: the copy, process_slots, per_block_processing's
        host work, the signature batch (verify_s) and the state root."""
        slot = int(signed_block.message.slot)
        if collector is None:
            collector = SignatureCollector(
                strategy
                if strategy is not None
                else BlockSignatureStrategy.VERIFY_BULK,
                backend=self.backend, seed=slot + 1, consumer=consumer,
                slot=slot, device=self.device,
            )
        (post_root,) = self.import_segment([signed_block], collector)
        stats = self.last_import_stats
        self.last_import_stats = dict(stats.pop("blocks")[0], **stats)
        return post_root

    def import_segment(self, signed_blocks, collector=None):
        """Import a chain segment whose signatures verify as one batch
        (block_verification.rs:509, signature_verify_chain_segment): each
        block applied in turn to one copy of the state (advanced to its
        slot first), every set of every block into `collector` (by default
        VERIFY_BULK on the harness's backend and device), one
        `collector.finish()`, then each block's claimed state root checked;
        the copy becomes the state only after both, so a bad signature or
        root anywhere leaves the state as it was. Returns the post-state
        roots; `last_import_stats` keeps the copy, the batch (verify_s)
        and, a block each in "blocks", process_slots, per_block_processing
        (host only) and the state root."""
        spec = self.spec
        if collector is None:
            collector = SignatureCollector(
                BlockSignatureStrategy.VERIFY_BULK, backend=self.backend,
                device=self.device,
            )
        t0 = time.perf_counter()
        state = self.state.copy()
        carry_tree_cache(state, self.state)
        copy_s = time.perf_counter() - t0
        roots, blocks = [], []
        for signed_block in signed_blocks:
            t0 = time.perf_counter()
            state = process_slots(
                state, signed_block.message.slot, spec, device=self.device
            )
            t1 = time.perf_counter()
            per_block_processing(
                state,
                signed_block,
                spec,
                collector.strategy,
                self.pubkey_cache,
                backend=self.backend,
                collector=collector,
                device=self.device,
            )
            t2 = time.perf_counter()
            roots.append(cached_state_root(state))
            blocks.append({
                "process_slots_s": t1 - t0, "per_block_s": t2 - t1,
                "state_root_s": time.perf_counter() - t2,
            })
        t0 = time.perf_counter()
        collector.finish()
        self.last_import_stats = {
            "copy_s": copy_s, "verify_s": time.perf_counter() - t0,
            "blocks": blocks,
        }
        for signed_block, root in zip(signed_blocks, roots):
            assert bytes(signed_block.message.state_root) == root, (
                "state root mismatch"
            )
        self.state = state
        return roots

    # ----------------------------------------------------------- driving

    def advance_slot_with_block(self, slot: int, strategy=None,
                                consumer=None):
        """Produce + import the block for `slot` including all pending
        attestations, then attest at `slot` with every committee.
        `strategy`/`consumer` forward to import_block (e.g.
        NO_VERIFICATION for a chain maker whose blocks will be verified
        elsewhere; consumer="bench" in measurement harnesses). Under
        NO_VERIFICATION the post-state is the one production computed the
        block's state root on: the same state, without a second copy and
        transition."""
        capacity = self.spec.MAX_ATTESTATIONS
        atts = self.pending_attestations[:capacity]
        self.pending_attestations = self.pending_attestations[capacity:]
        block, post = self._produce(slot, atts)
        if strategy == BlockSignatureStrategy.NO_VERIFICATION:
            self.state = post
        else:
            self.import_block(block, strategy=strategy, consumer=consumer)
        self.pending_attestations.extend(
            self.make_attestations(self.state, slot)
        )
        return block

    def make_blob_sidecars(self, signed_block, blobs, backend="gpu"):
        """Build the sidecars for a block produced with
        blob_kzg_commitments (one per blob, in index order): KZG proofs
        against the dev trusted setup, on `backend` ("gpu" on the
        harness's device unless asked; every real backend gives the same
        bytes), plus the signed header binding each sidecar to the block
        root. Column sidecars (`make_data_column_sidecars`) wait for the
        column checker (ROADMAP Queue 1 item 5)."""
        from lighthouse_tpu_torch import kzg

        t = self.t
        msg = signed_block.message
        header = t.SignedBeaconBlockHeader(
            message=t.BeaconBlockHeader(
                slot=msg.slot,
                proposer_index=msg.proposer_index,
                parent_root=bytes(msg.parent_root),
                state_root=bytes(msg.state_root),
                body_root=type(msg.body).hash_tree_root(msg.body),
            ),
            signature=bytes(signed_block.signature),
        )
        out = []
        for i, blob in enumerate(blobs):
            commitment = bytes(msg.body.blob_kzg_commitments[i])
            out.append(
                t.BlobSidecar(
                    index=i,
                    blob=bytes(blob),
                    kzg_commitment=commitment,
                    kzg_proof=kzg.compute_blob_kzg_proof(
                        bytes(blob), commitment, backend=backend,
                        consumer="kzg", device=self.device,
                    ),
                    signed_block_header=header,
                )
            )
        return out

    def run_slots(self, n: int):
        start = self.state.slot + 1
        for slot in range(start, start + n):
            self.advance_slot_with_block(slot)

    @property
    def finalized_epoch(self) -> int:
        return self.state.finalized_checkpoint.epoch

    @property
    def justified_epoch(self) -> int:
        return self.state.current_justified_checkpoint.epoch
