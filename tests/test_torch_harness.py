"""The port's harness, pubkey cache and chain maker (lighthouse_tpu_torch)
against the JAX package, exactly, on the CPU.

Blocks and attestations of the port's `Harness` must be byte-equal in SSZ
to the reference `Harness`'s, phase0 and altair, though the port signs
each aggregate once with the summed secret key; the port's cache tags its
keys so that a block's first batch takes the table path; the chain
maker's pre-filled cache equals the one `import_new` builds. One small
block goes through VERIFY_BULK on the "gpu" backend's plain versions
(device="cpu"); everything else verifies on "fake" or "ref". No JAX graph
is compiled."""

import pytest

from lighthouse_tpu.harness import Harness as RefHarness
from lighthouse_tpu.state_processing.per_block import BlockSignatureStrategy as RefStrategy
from lighthouse_tpu.types.spec import minimal_spec as ref_minimal_spec
from lighthouse_tpu_torch import bls
from lighthouse_tpu_torch import testing as T
from lighthouse_tpu_torch.bls import gpu_backend
from lighthouse_tpu_torch.crypto.ref_curve import G1
from lighthouse_tpu_torch.harness import Harness
from lighthouse_tpu_torch.ops import field as fd
from lighthouse_tpu_torch.ssz.cached_hash import cached_state_root
from lighthouse_tpu_torch.state_processing.per_block import (
    BlockProcessingError,
    BlockSignatureStrategy,
    SignatureCollector,
)
from lighthouse_tpu_torch.state_processing.pubkey_cache import PubkeyCache
from lighthouse_tpu_torch.types.spec import minimal_spec

N = 16
PHASE0 = 2**64 - 1


def _encode(obj):
    return type(obj).encode(obj)


@pytest.mark.parametrize("altair_epoch", [PHASE0, 0], ids=["phase0", "altair"])
def test_blocks_and_attestations_byte_equal_to_reference(altair_epoch):
    ref = RefHarness(ref_minimal_spec(ALTAIR_FORK_EPOCH=altair_epoch), N)
    port = Harness(minimal_spec(ALTAIR_FORK_EPOCH=altair_epoch), N, backend="fake", device="cpu")
    assert _encode(ref.state) == _encode(port.state)
    for slot in (1, 2):
        rb = ref.advance_slot_with_block(slot, strategy=RefStrategy.NO_VERIFICATION)
        pb = port.advance_slot_with_block(slot, strategy=BlockSignatureStrategy.NO_VERIFICATION)
        assert _encode(rb) == _encode(pb), slot
        assert [_encode(a) for a in ref.pending_attestations] == [
            _encode(a) for a in port.pending_attestations]
    assert len(pb.message.body.attestations) == 1
    assert _encode(ref.state) == _encode(port.state)
    assert ref.randao_reveal(3) == port.randao_reveal(3)


def test_summed_key_aggregate_equals_the_sum_of_signatures():
    """A validator listed twice (two sync seats) signs twice."""
    h = Harness.from_genesis(minimal_spec(), [bls.Keypair(bls.SecretKey(k)) for k in (5, 7, 11)],
                             None, None, backend="fake", device="cpu")
    root = b"\x42" * 32
    members = [0, 2, 2, 1]
    want = bls.aggregate_signatures([h.keypairs[v].sk.sign(root) for v in members])
    assert h._sign_aggregate(members, root) == want.to_bytes()


def test_first_bulk_batch_takes_the_table_on_plain_kernels():
    """One altair block (proposal, RANDAO, the 32-seat sync aggregate)
    through import_block on "gpu" with device="cpu": one device call, on
    the cache's table from the first batch, with the plain versions."""
    h = Harness(minimal_spec(ALTAIR_FORK_EPOCH=0), N, device="cpu")
    table = h.pubkey_cache.device_table()
    assert str(table.device) == "cpu" and table.count == N
    assert all(h.pubkey_cache.get(i).table is table for i in range(N))
    assert gpu_backend._table_for([bls.SignatureSet(None, [h.pubkey_cache.get(3)], b"")]) is table
    block = h.produce_block(1, [])
    calls = dict(gpu_backend.CALL_COUNTS)
    root = h.import_block(block)
    assert root == bytes(block.message.state_root) == cached_state_root(h.state)
    assert gpu_backend.CALL_COUNTS["batch"] == calls["batch"] + 1
    stats = gpu_backend.LAST_HOST_STATS
    assert stats["n_sets"] == 3 and stats["indexed_path"] and stats["k_bucket"] == 32
    assert set(h.last_import_stats) == {"copy_s", "process_slots_s", "per_block_s", "verify_s", "state_root_s"}


def test_chain_keypairs_hold_their_secret_keys():
    kps = T.chain_keypairs(6)
    for i in (0, 1, 5):
        assert kps[i].sk.to_bytes() == (i + 1).to_bytes(32, "big")
        pk = G1.to_affine(G1.mul_scalar(G1.generator, i + 1))
        assert kps[i].pk.point == (pk[0], pk[1], 1)
        assert bls.PublicKey.from_bytes(kps[i].pk.to_bytes()).point == kps[i].pk.point


def test_prefilled_cache_equals_the_one_import_new_builds():
    spec = minimal_spec(ALTAIR_FORK_EPOCH=0)
    kps = T.chain_keypairs(12)
    h = T.chain_harness(spec, kps, backend="fake", device="cpu")
    built = PubkeyCache(device="cpu")
    built.import_new(h.state)
    assert len(built) == len(h.pubkey_cache) == 12
    for i in range(12):
        a, b = h.pubkey_cache.get(i), built.get(i)
        assert (a.point, a.to_bytes(), a.validator_index) == (b.point, b.to_bytes(), b.validator_index) == (
            b.point, bytes(h.state.validators[i].pubkey), i)
        assert h.pubkey_cache.index_of(a.to_bytes()) == built.index_of(b.to_bytes()) == i
    for x, y in zip(h.pubkey_cache.device_table().rows(), built.device_table().rows()):
        assert x.equal(y)
    # the harness on them signs what the reference's sums would
    assert h.keypairs[3].sk.to_bytes() == (4).to_bytes(32, "big")
    with pytest.raises(ValueError, match="decoded keys differ"):
        PubkeyCache(device="cpu").import_new(h.state, decoded=[kps[1].pk] + [k.pk for k in kps[1:]])


def test_chain_harness_segment_matches_per_block_imports(monkeypatch):
    """A built chain replayed per block and as one segment (one collector,
    one finish before the state is committed): equal roots, every set
    collected; a segment whose batch fails commits nothing."""
    spec = minimal_spec(ALTAIR_FORK_EPOCH=0)
    kps = T.chain_keypairs(N)
    producer = T.chain_harness(spec, kps, backend="fake", device="cpu")
    genesis = producer.state.copy()
    producer.pending_attestations = producer.make_attestations(producer.state, 0)
    blocks = [producer.advance_slot_with_block(s, strategy=BlockSignatureStrategy.NO_VERIFICATION)
              for s in (1, 2, 3)]
    per_block = T.chain_harness(spec, kps, backend="fake", device="cpu", genesis=genesis)
    for b in blocks:
        per_block.import_block(b)
    segment = T.chain_harness(spec, kps, backend="fake", device="cpu", genesis=genesis)
    coll = SignatureCollector(BlockSignatureStrategy.VERIFY_BULK, backend="fake", device="cpu")
    verdicts = []
    real_finish = coll.finish
    coll.finish = lambda: verdicts.append(segment.state.slot) or real_finish()
    roots = segment.import_segment(blocks, collector=coll)
    assert verdicts == [0]  # one batch, before anything was committed
    assert len(coll.sets) == sum(3 + len(b.message.body.attestations) for b in blocks)
    assert roots == [bytes(b.message.state_root) for b in blocks]
    assert cached_state_root(per_block.state) == cached_state_root(segment.state) == cached_state_root(
        producer.state)
    # a segment whose batch fails leaves the state as it was
    refused = T.chain_harness(spec, kps, backend="fake", device="cpu", genesis=genesis)
    start = refused.state
    monkeypatch.setattr(bls, "verify_signature_sets", lambda sets, **kw: False)
    with pytest.raises(BlockProcessingError, match="bulk"):
        refused.import_segment(blocks)
    assert refused.state is start and start.slot == 0


def test_aggregate_set_makers_sign_with_the_summed_key():
    sets = T.make_aggregate_set_batch(3, 4, seed=1)
    assert [len(s.pubkeys) for s in sets] == [4, 4, 4]
    assert bls.verify_signature_sets(sets[1:2], backend="ref")
    block = T.make_block_sets_batch(seed=2, n_attestations=2, committee_size=3)
    assert [len(s.pubkeys) for s in block] == [1, 1, 3, 3, 1, 1]
    # set 2's keys are validators 2, 3 and 4, secret keys 3 + 4 + 5
    assert block[2].pubkeys[0].point == T.validator_pubkeys(3)[2].point
    assert block[2].signature.to_bytes() == bls.SecretKey(12).sign(block[2].message).to_bytes()


def test_block_import_without_gpu_raises():
    """The default device is the card: without one, the first batch raises
    before any plain version runs."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a GPU is present: this checks the behaviour without one")
    h = Harness(minimal_spec(), 8)
    block = h.produce_block(1, [])
    products = fd.FP_PRODUCTS
    with pytest.raises(RuntimeError, match="no CUDA device"):
        h.import_block(block)
    assert fd.FP_PRODUCTS == products and h.state.slot == 0
