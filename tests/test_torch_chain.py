"""The port's chain runtime (lighthouse_tpu_torch.beacon_chain, with its
pools, caches, DA checker and light-client producer) against the JAX
package's `BeaconChain`, exactly, on the CPU.

Blocks come from the port's `Harness` ("fake" signatures, device="cpu"),
whose blocks are byte-equal to the reference harness's
(tests/test_torch_harness.py); every object crosses between the packages as
SSZ bytes. After every import the two chains must agree on the head, fork
choice (every proto-array node, the votes, the checkpoints), the bytes of
every store column, the pools' contents and the journal's events (kinds,
slots, roots, outcomes and every attribute that is not a timing). Most
cases run on "fake"; a gossip batch with one forged attestation and a
forged sidecar header verify on "ref" in both packages; one block goes
through "gpu" on the plain versions (device="cpu"). No JAX graph is
compiled."""

import pytest

from lighthouse_tpu.beacon_chain import BeaconChain as RefChain
from lighthouse_tpu.beacon_chain.attestation_verification import VerifiedAttestation as RefVerified
from lighthouse_tpu.harness import Harness as RefHarness
from lighthouse_tpu.types.containers import types_for as ref_types_for
from lighthouse_tpu.types.spec import minimal_spec as ref_minimal_spec
from lighthouse_tpu_torch import bls, kzg
from lighthouse_tpu_torch.beacon_chain import BeaconChain
from lighthouse_tpu_torch.beacon_chain.attestation_verification import VerifiedAttestation
from lighthouse_tpu_torch.beacon_chain.chain import BlockError
from lighthouse_tpu_torch.beacon_chain.sync_committee_verification import subnet_positions_for
from lighthouse_tpu_torch.beacon_chain.data_availability_checker import (
    DataAvailabilityChecker,
    DataAvailabilityError,
)
from lighthouse_tpu_torch.bls import gpu_backend
from lighthouse_tpu_torch.crypto.ref_curve import G2
from lighthouse_tpu_torch.device_plane import GUARD
from lighthouse_tpu_torch.harness import Harness
from lighthouse_tpu_torch.ops import merkle_proof
from lighthouse_tpu_torch.state_processing.helpers import get_domain
from lighthouse_tpu_torch.state_processing.per_block import BlockSignatureStrategy
from lighthouse_tpu_torch.types.containers import types_for
from lighthouse_tpu_torch.types.helpers import compute_signing_root
from lighthouse_tpu_torch.types.spec import minimal_spec

N = 16
SLOTS = 32  # four minimal epochs: justification, finality, one migration
ALTAIR = dict(ALTAIR_FORK_EPOCH=0)
BELLATRIX = dict(ALTAIR_FORK_EPOCH=0, BELLATRIX_FORK_EPOCH=1)


def _enc(obj):
    return type(obj).encode(obj)


def _convert(obj, t):
    """`obj` as the same SSZ container of the other package (types `t`)."""
    return getattr(t, type(obj).__name__).decode(_enc(obj))


def _unsigned(h):
    """`h` signing everything with the G2 generator: a valid point that
    "fake" chains parse and never check, at no scalar multiplication."""
    sig = bls.Signature(G2.generator).to_bytes()
    h._sign = lambda sk, root, domain: sig
    h._sign_aggregate = lambda validators, root: sig
    return h


@pytest.fixture(scope="module")
def altair_blocks():
    """(harness, genesis, 32 blocks): full attestations, every block
    applied unverified to the harness's state, every signature the G2
    generator (`_unsigned`)."""
    h = _unsigned(Harness(minimal_spec(**ALTAIR), N, backend="fake", device="cpu"))
    genesis = h.state.copy()
    blocks = [h.advance_slot_with_block(s, strategy=BlockSignatureStrategy.NO_VERIFICATION)
              for s in range(1, SLOTS + 1)]
    return h, genesis, blocks


# ------------------------------------------------------------- projections

# attribute names that carry timings or process-wide counters, not outcomes
_VOLATILE = ("duration_s", "t", "bus_batch", "wall_s", "queue_wait_s")


def _attrs(attrs):
    return {k: v for k, v in (attrs or {}).items()
            if k not in _VOLATILE and not k.endswith(("_s", "_ms", "_us"))}


def _journal(chain):
    out = []
    for e in chain.journal.query():
        if e["kind"] == "slot_budget":  # a waterfall of timings: its keys only
            out.append((e["kind"], e.get("slot"), e.get("root"), e.get("outcome")))
            continue
        out.append((e["kind"], e.get("slot"), e.get("root"), e.get("peer"), e.get("outcome"),
                    sorted(_attrs(e.get("attrs")).items())))
    return out


def _fork_choice(fc):
    nodes = [(n.slot, n.root, n.parent, n.justified_epoch, n.finalized_epoch, n.weight, n.best_child,
              n.best_descendant, n.execution_status, n.execution_block_hash) for n in fc.proto.nodes]
    votes = sorted((i, v.current_root, v.next_root, v.next_epoch) for i, v in fc.votes.items())
    return (fc.justified_checkpoint, fc.finalized_checkpoint, fc.current_slot, fc.proposer_boost_root,
            nodes, votes, list(fc.balances))


def _pools(chain):
    return (
        {s: {r: _enc(a) for r, a in m.items()} for s, m in chain.naive_pool._by_slot.items()},
        {r: [_enc(a) for a in v] for r, v in chain.op_pool._attestations.items()},
        {k: _enc(c) for k, c in chain.sync_message_pool._contributions.items()},
        {k: _enc(c) for k, c in chain.sync_contribution_pool._best.items()},
    )


def _store(chain):
    return {col: dict(rows) for col, rows in chain.store.kv._data.items()}


def _view(chain):
    return (chain.head_root, chain.genesis_root, _enc(chain.head_state), _fork_choice(chain.fork_choice),
            _store(chain), _pools(chain), sorted(chain._snapshots), _journal(chain),
            {k: v for k, v in chain.metrics.snapshot().items() if not k.endswith("_seconds")},
            chain.light_client_producer.stats())


def _result(r):
    if isinstance(r, bytes):
        return r
    if isinstance(r, (VerifiedAttestation, RefVerified)):
        return ("ok", list(r.indexed_indices), int(r.committee_index), int(r.slot))
    if isinstance(r, Exception):
        return ("err", type(r).__name__, str(r))
    return ("ok", type(r).__name__)


class Twin:
    """A reference chain and a port chain on the same genesis, driven by
    the same calls (port objects in, converted for the reference)."""

    def __init__(self, genesis, fork_kw, backend="fake", **port_kw):
        self.rt = ref_types_for(ref_minimal_spec(**fork_kw))
        self.ref = RefChain(_convert(genesis, self.rt), ref_minimal_spec(**fork_kw), backend=backend,
                            **{k: v for k, v in port_kw.items() if k == "slot_fuse"})
        self.port = BeaconChain(genesis.copy(), minimal_spec(**fork_kw), backend=backend, device="cpu",
                                **port_kw)

    def __call__(self, method, *args, check=True):
        out = []
        for chain, conv in ((self.ref, lambda o: _convert(o, self.rt)), (self.port, lambda o: o)):
            a = [[conv(x) for x in v] if isinstance(v, list) else
                 conv(v) if hasattr(type(v), "hash_tree_root") else v for v in args]
            try:
                r = getattr(chain, method)(*a)
                out.append(("ret", [_result(x) for x in r] if isinstance(r, list) else r))
            except (BlockError, DataAvailabilityError) as e:
                out.append(("raised", str(e)))
            except Exception as e:  # the reference's classes: compared by name and message
                out.append(("raised", str(e)) if type(e).__name__ in ("BlockError", "DataAvailabilityError")
                           else ("error", type(e).__name__, str(e)))
        assert out[0] == out[1], (method, out)
        if check:
            assert _view(self.ref) == _view(self.port), method
        return out[1]


def test_chain_equal_to_reference_after_every_block(altair_blocks):
    """32 imports to finality (the migrator moves the hot states below it),
    with the duplicate refused; a second view after the last set_slot."""
    _, genesis, blocks = altair_blocks
    tw = Twin(genesis, ALTAIR)
    assert _view(tw.ref) == _view(tw.port)
    for block in blocks:
        root = type(block.message).hash_tree_root(block.message)
        assert tw("process_block", block) == ("ret", root)
        tw("set_slot", int(block.message.slot))
        assert tw.port.head_root == root
    assert tw("process_block", blocks[-1]) == ("raised", "block already known")
    assert tw.port.finalized_checkpoint.epoch >= 2 and tw.port.migrator.runs >= 1
    assert tw.port.light_client_producer.optimistic_update is not None
    kinds = {e["kind"] for e in tw.port.journal.query()}
    assert {"block_import", "lc_update_produced", "slot_budget"} <= kinds
    # production on the head: attestation data, a block body from the pool
    data = tw.port.produce_attestation_data(SLOTS, 0)
    assert _enc(data) == _enc(tw.ref.produce_attestation_data(SLOTS, 0))
    assert tw.port.proposers_for_epoch(4) == tw.ref.proposers_for_epoch(4)


def test_segment_and_production(altair_blocks):
    """A 6-block segment in one batch on fresh chains; then a block the
    chain produces on its head (`produce_block_unsigned`) and the pool's
    sync aggregate."""
    h, genesis, blocks = altair_blocks
    tw = Twin(genesis, ALTAIR)
    roots = [type(b.message).hash_tree_root(b.message) for b in blocks[:6]]
    assert tw("process_chain_segment", blocks[:6]) == ("ret", roots)
    assert tw.port.head_state.slot == 6 and tw.port.journal.count(kind="signature_batch") == 1
    reveal = blocks[6].message.body.randao_reveal
    out = [c.produce_block_unsigned(7, bytes(reveal)) for c in (tw.ref, tw.port)]
    assert _enc(out[0]) == _enc(out[1])
    assert _enc(tw.ref.produce_sync_aggregate(7)) == _enc(tw.port.produce_sync_aggregate(7))
    assert tw("process_chain_segment", []) == ("ret", [])


def test_revert_to_fork_boundary_and_the_pre_slot_advance(altair_blocks):
    _, genesis, blocks = altair_blocks
    tw = Twin(genesis, ALTAIR)
    spe = minimal_spec().SLOTS_PER_EPOCH
    for block in blocks[:spe - 1]:
        tw("process_block", block, check=False)
        tw("set_slot", int(block.message.slot), check=False)
    assert _view(tw.ref) == _view(tw.port)
    tw("advance_head_to_slot", spe)  # across the epoch boundary, ahead of the block
    tw("process_block", blocks[spe - 1])
    assert tw.port.metrics["pre_advance_hits"] == 1
    for block in blocks[spe:2 * spe]:
        tw("process_block", block, check=False)
        tw("set_slot", int(block.message.slot), check=False)
    revert = tw("revert_to_fork_boundary", 1)
    assert revert[0] == "ret" and tw.port.head_state.slot < spe
    assert tw.port.store.get_canonical_block_root(spe) is None
    tw("recompute_head")
    assert tw.port.head_root == revert[1]


def _singles(h, chain, atts, n):
    """n single-bit attestations of committee 0 of `atts`, each signed by
    its attester alone."""
    att = atts[0]
    committee = chain.committee_for(att.data)
    domain = get_domain(h.state, h.spec.DOMAIN_BEACON_ATTESTER, att.data.target.epoch, h.spec)
    root = compute_signing_root(type(att.data).hash_tree_root(att.data), domain)
    out = []
    for i in range(n):
        single = att.copy()
        single.aggregation_bits = [j == i for j in range(len(att.aggregation_bits))]
        single.signature = h.keypairs[committee[i]].sk.sign(root).to_bytes()
        out.append(single)
    return out


def test_gossip_batch_with_one_forged_attestation_on_ref():
    """Four singles, the third signed by another attester: both packages
    refuse it alone (one batch, then per-set verdicts); a redelivery is a
    duplicate; then a forged sidecar header is refused before the DA
    checker caches anything, and the real header verifies once."""
    spec = minimal_spec()  # phase0: a block of two sets; committees of 4
    h = Harness(spec, 2 * N, backend="fake", device="cpu")
    genesis = h.state.copy()
    block = h.advance_slot_with_block(1, strategy=BlockSignatureStrategy.NO_VERIFICATION)
    tw = Twin(genesis, {}, backend="ref")
    tw("process_block", block, check=False)
    tw("set_slot", 2, check=False)
    singles = _singles(h, tw.port, h.pending_attestations, 4)
    singles[2].signature = singles[0].signature
    got = tw("process_unaggregated_attestations", singles)[1]
    assert [g[0] for g in got] == ["ok", "ok", "err", "ok"] and "invalid signature" in got[2][2]
    assert tw("process_unaggregated_attestations", singles[:1])[1][0][0] == "err"
    assert len(tw.port.naive_pool.aggregates_at_slot(1)) == 1
    batches = [e for e in tw.port.journal.query(kind="attestation_batch")]
    assert batches[0]["outcome"] == "partial" and batches[0]["attrs"]["accepted"] == 3

    t = types_for(spec)
    msg = block.message
    header = t.SignedBeaconBlockHeader(
        message=t.BeaconBlockHeader(slot=msg.slot, proposer_index=msg.proposer_index,
                                    parent_root=bytes(msg.parent_root), state_root=bytes(msg.state_root),
                                    body_root=type(msg.body).hash_tree_root(msg.body)),
        signature=bytes(msg.body.randao_reveal))  # a G2 point, over another message
    forged = t.BlobSidecar(index=0, signed_block_header=header)
    assert tw("process_blob_sidecar", forged) == ("raised", "blob sidecar proposer signature invalid")
    assert tw.port.da_checker.stats()["cached_candidates"] == 0 and not tw.port.da_checker._pending
    assert tw.port.journal.query(kind="sidecar")[-1]["outcome"] == "header_sig_invalid"
    real = forged.copy()
    real.signed_block_header.signature = bytes(block.signature)
    assert tw.port.verify_blob_sidecar_header(real) and tw.ref.verify_blob_sidecar_header(_convert(real, tw.rt))
    assert len(tw.port._verified_sidecar_headers) == 1


def test_aggregates_and_sync_committee_messages(altair_blocks):
    """Aggregates (the block's committees, aggregator its first member)
    into the op pool; every sync-committee member's message and a
    contribution a subcommittee into the sync pools; duplicates refused;
    the produced sync aggregate."""
    h, genesis, blocks = altair_blocks
    tw = Twin(genesis, ALTAIR)
    for block in blocks[:2]:
        tw("process_block", block, check=False)
    tw("set_slot", 2)
    t = types_for(minimal_spec(**ALTAIR))
    atts = blocks[2].message.body.attestations  # slot 2's block carries slot 1's committees
    aggs = []
    for att in atts:
        committee = tw.port.committee_for(att.data)
        aggs.append(t.SignedAggregateAndProof(message=t.AggregateAndProof(
            aggregator_index=committee[0], aggregate=att, selection_proof=b"\xc0" + b"\x00" * 95),
            signature=b"\xc0" + b"\x00" * 95))
    got = tw("process_aggregated_attestations", aggs)[1]
    assert got and all(g[0] == "ok" for g in got) and tw.port.op_pool.num_attestations() == len(aggs)
    assert tw("process_aggregated_attestations", aggs[:1])[1][0][0] == "err"  # duplicate aggregate

    sig = bls.Signature(G2.generator).to_bytes()
    head = tw.port.head_root
    msgs = [t.SyncCommitteeMessage(slot=2, beacon_block_root=head, validator_index=v, signature=sig)
            for v in range(N)]
    got = tw("process_sync_messages", msgs)[1]
    assert got and all(g == ("ok", "VerifiedSyncMessage") for g in got)
    assert tw("process_sync_messages", msgs[:1])[1][0][0] == "err"  # a prior message
    caps = []
    for k in range(minimal_spec().SYNC_COMMITTEE_SUBNET_COUNT):
        contribution = tw.port.sync_message_pool._contributions[(2, head, k)]
        aggregator = next(v for v in range(N) if k in subnet_positions_for(
            tw.port.head_state, v, tw.port, tw.port.spec))
        caps.append(t.SignedContributionAndProof(message=t.ContributionAndProof(
            aggregator_index=aggregator, contribution=contribution, selection_proof=sig), signature=sig))
    got = tw("process_signed_contributions", caps)[1]
    assert got and all(g == ("ok", "VerifiedContribution") for g in got)
    assert tw("process_signed_contributions", caps[:1])[1][0][0] == "err"  # a duplicate
    agg = [c.produce_sync_aggregate(3) for c in (tw.ref, tw.port)]
    assert _enc(agg[0]) == _enc(agg[1]) and sum(agg[1].sync_committee_bits) > 0


def _blob(spec, seed):
    """A canonical blob: field elements below the modulus."""
    from lighthouse_tpu_torch.crypto.constants import R

    return b"".join(((seed * 7919 + i * 104729) % R).to_bytes(32, "big")
                    for i in range(spec.FIELD_ELEMENTS_PER_BLOB))


@pytest.mark.parametrize("slot_fuse", [True, False], ids=["fused", "serial"])
def test_blob_block_held_until_its_last_sidecar(slot_fuse):
    """A bellatrix block committing to two blobs ("fake" KZG): held while
    any sidecar is missing, imported by the last one, its sidecars stored;
    make_blob_sidecars byte-equal to the reference harness's."""
    spec = minimal_spec(**BELLATRIX)
    h = _unsigned(Harness(spec, N, backend="fake", device="cpu"))
    genesis = h.state.copy()
    tw = Twin(genesis, BELLATRIX, slot_fuse=slot_fuse)
    for slot in range(1, spec.SLOTS_PER_EPOCH + 1):
        tw("process_block", h.advance_slot_with_block(slot, strategy=BlockSignatureStrategy.NO_VERIFICATION),
           check=False)
        tw("set_slot", slot, check=False)
    blobs = [_blob(spec, 20), _blob(spec, 21)]
    comms = [kzg.blob_to_kzg_commitment(b, backend="ref") for b in blobs]
    slot = spec.SLOTS_PER_EPOCH + 1
    block = h.produce_block(slot, h.pending_attestations[:spec.MAX_ATTESTATIONS], blob_kzg_commitments=comms)
    sidecars = h.make_blob_sidecars(block, blobs, backend="ref")
    ref_h = RefHarness.__new__(RefHarness)
    ref_h.t, ref_h.spec = tw.rt, ref_minimal_spec(**BELLATRIX)
    assert [_enc(s) for s in sidecars] == [_enc(s) for s in ref_h.make_blob_sidecars(_convert(block, tw.rt), blobs)]
    root = type(block.message).hash_tree_root(block.message)
    assert tw("process_block", block)[1].startswith("data unavailable")
    assert tw("process_blob_sidecar", sidecars[0]) == ("ret", [])
    assert tw.port.head_root != root
    assert tw("process_blob_sidecar", sidecars[1]) == ("ret", [root])
    assert tw.port.head_root == root
    assert [_enc(s) for s in tw.port.store.get_blob_sidecars(root)] == [_enc(s) for s in sidecars]
    assert tw.port.metrics["da_blocks_held"] == 1


def test_light_client_branches_fold_on_the_device_plane(altair_blocks, monkeypatch):
    """device_check=True: every branch the producer extracts is folded by
    `merkle_proof.batch_verify_branches` on the chain's device and lands
    on the attested state's root; the documents equal the reference's."""
    _, genesis, blocks = altair_blocks
    folds = []
    real = merkle_proof.batch_verify_branches

    def counting(queries, roots, consumer=None, device="cuda"):
        out = real(queries, roots, consumer=consumer, device=device)
        folds.append((len(queries), device, out))
        return out

    monkeypatch.setattr(merkle_proof, "batch_verify_branches", counting)
    tw = Twin(genesis, ALTAIR)
    tw.port.light_client_producer.device_check = True
    for block in blocks[:3]:
        tw("process_block", block)
    assert folds and all(f == (1, "cpu", [True]) for f in folds)
    ups = [c.light_client_producer.optimistic_update for c in (tw.ref, tw.port)]
    assert _enc(ups[0]) == _enc(ups[1])


def test_one_block_through_gpu_on_the_plain_versions(altair_blocks):
    """The default backend, "gpu", with device="cpu": one batch call
    through the bus, on the pubkey cache's table, with the plain versions;
    the head is the block."""
    h = Harness(minimal_spec(**ALTAIR), N, backend="fake", device="cpu")  # signing for real
    chain = BeaconChain(h.state.copy(), minimal_spec(**ALTAIR), device="cpu")
    block = h.produce_block(1, [])
    assert chain.backend == "gpu" and chain.da_checker.backend == "gpu"
    # the bus's canary (a per-set call on the sentinel pair, the valid
    # sentinel riding the batch) costs two more plain verifies here; the
    # bus's tests hold it, so this import runs with it off
    GUARD.configure(canary="off")
    try:
        calls = dict(gpu_backend.CALL_COUNTS)
        root = chain.process_block(block)
    finally:
        GUARD.configure(canary="auto")
    assert root == chain.head_root == type(block.message).hash_tree_root(block.message)
    assert gpu_backend.CALL_COUNTS["batch"] == calls["batch"] + 1
    assert gpu_backend.CALL_COUNTS["individual"] == calls["individual"]
    stats = gpu_backend.LAST_HOST_STATS
    assert stats["n_sets"] == 3 and stats["indexed_path"], stats


def test_filled_pubkey_cache_is_taken_as_it_is(altair_blocks, monkeypatch):
    """A cache already holding the genesis keys is used, not rebuilt: no
    key is decompressed."""
    from lighthouse_tpu_torch import bls
    from lighthouse_tpu_torch.state_processing.pubkey_cache import PubkeyCache

    _, genesis, _ = altair_blocks
    cache = PubkeyCache(device="cpu")
    cache.import_new(genesis)
    monkeypatch.setattr(bls.PublicKey, "from_bytes", lambda b: pytest.fail("decompressed a key"))
    chain = BeaconChain(genesis.copy(), minimal_spec(**ALTAIR), backend="fake", device="cpu", pubkey_cache=cache)
    assert chain.pubkey_cache is cache and len(cache) == N


def test_unported_paths_and_unknown_names_raise(altair_blocks):
    import torch

    _, genesis, _ = altair_blocks
    spec = minimal_spec(**ALTAIR)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            BeaconChain(genesis.copy(), spec)
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 5"):
        BeaconChain(genesis.copy(), spec, backend="fake", device="cpu", column_mode=True)
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 8"):
        BeaconChain(genesis.copy(), spec, backend="fake", device="cpu", execution_layer=object())
    chain = BeaconChain(genesis.copy(), spec, backend="fake", device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 8"):
        chain.produce_blinded_block_unsigned(1, b"\x00" * 96)
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 8"):
        chain.import_blinded_block(None)
    with pytest.raises(DataAvailabilityError, match="column-sampling"):
        chain.process_data_column_sidecar(None)
    for name in ("tpu", "cpu", ""):
        with pytest.raises(ValueError, match="unknown data-availability backend"):
            DataAvailabilityChecker(spec, backend=name, device="cpu")
    assert DataAvailabilityChecker(spec).backend == "gpu"


def test_attestation_production_caches_and_events(altair_blocks, monkeypatch):
    """The reference's tests/test_attester_caches.py cases on both chains:
    attestation data served by the caches without a state read, the
    early-attester cache answering for the block just imported, the
    proposer cache equal to the imported blocks' proposers and hit on its
    second call; the block and head events published; the migrator's
    periodic compaction."""
    _, genesis, blocks = altair_blocks
    spe = minimal_spec().SLOTS_PER_EPOCH
    tw = Twin(genesis, ALTAIR)
    q = tw.port.events.subscribe(["block", "head"])
    for block in blocks[:spe + 2]:
        tw("process_block", block, check=False)
        tw("set_slot", int(block.message.slot), check=False)
    assert _view(tw.ref) == _view(tw.port)
    slot = int(tw.port.head_state.slot)
    out = []
    for c in (tw.ref, tw.port):
        with monkeypatch.context() as m:
            m.setattr(c, "_attestation_parts_from_state", lambda e: pytest.fail("read the head state"))
            data = c.produce_attestation_data(slot, 0)
        epoch = c.spec.slot_to_epoch(slot)
        proposers = c.proposers_for_epoch(epoch)
        hits = c.proposer_cache.hits
        assert c.proposers_for_epoch(epoch) == proposers and c.proposer_cache.hits == hits + 1
        pinned = [int(c.store.get_block(c.store.get_canonical_block_root(s)).message.proposer_index)
                  for s in range(c.spec.epoch_start_slot(epoch), slot + 1)]
        out.append((_enc(data), proposers, pinned, c.early_attester_cache.hits))
    assert out[0] == out[1]
    assert out[1][2] == out[1][1][:len(out[1][2])]  # the imported blocks' proposers
    with pytest.raises(Exception, match="committee index out of range"):
        tw.port.produce_attestation_data(slot, 10_000)
    events = []
    while not q.empty():
        events.append(q.get_nowait())
    assert [e["event"] for e in events[:2]] == ["block", "head"] and len(events) == 2 * (spe + 2)
    assert events[-1]["data"]["root"] == "0x" + tw.port.head_root.hex()
    compactions = []
    tw.port.store.kv.compact = lambda: compactions.append(1)
    period = tw.port.migrator.COMPACTION_PERIOD
    for i in range(period * 2):
        tw.port.migrator.notify_finalized(spe * (i + 1), i + 1)
    assert len(compactions) == 2
