"""The port's BeaconNode (lighthouse_tpu_torch.node over its network/)
against the JAX package's, exactly, on the CPU.

Each scenario runs twice, once on each package's nodes, hubs and peers
(minimal spec, altair from genesis, 32 validators, backend "fake"), from
the same genesis and blocks: the port's harness builds them, signing
everything with the G2 generator (a valid point that "fake" chains parse
and never check), and the reference's nodes get them as SSZ bytes. The
scenarios' results must be equal: heads and roots, imported counts, pools,
peer scores, quarantine sets, fault counts and the RPC's answer bytes. Then
one gossip batch on backend "gpu" with device="cpu" (the plain kernels)
and two port nodes over SocketNet on 127.0.0.1. No JAX graph is
compiled."""

import threading

import pytest

from lighthouse_tpu.network.fault_injection import FaultyRpc as RefFaultyRpc
from lighthouse_tpu.network.gossip import GossipHub as RefHub
from lighthouse_tpu.network.rpc import BlocksByRangeRequest as RefRange
from lighthouse_tpu.node import BeaconNode as RefNode
from lighthouse_tpu.types.containers import types_for as ref_types_for
from lighthouse_tpu.types.spec import minimal_spec as ref_minimal_spec
from lighthouse_tpu_torch import bls
from lighthouse_tpu_torch.bls import gpu_backend
from lighthouse_tpu_torch.crypto.ref_curve import G2
from lighthouse_tpu_torch.device_plane import GUARD
from lighthouse_tpu_torch.device_plane.executor import DeviceTimeout
from lighthouse_tpu_torch.harness import Harness
from lighthouse_tpu_torch.network import gossip
from lighthouse_tpu_torch.network.fault_injection import FaultyRpc
from lighthouse_tpu_torch.network.gossip import GossipHub
from lighthouse_tpu_torch.network.rpc import BlocksByRangeRequest
from lighthouse_tpu_torch.node import BeaconNode
from lighthouse_tpu_torch.state_processing.helpers import get_domain
from lighthouse_tpu_torch.state_processing.per_block import BlockSignatureStrategy
from lighthouse_tpu_torch.types.containers import types_for
from lighthouse_tpu_torch.types.helpers import compute_signing_root
from lighthouse_tpu_torch.types.spec import minimal_spec

N = 32
SLOTS = 12
ALTAIR = dict(ALTAIR_FORK_EPOCH=0)


def _unsigned(h):
    sig = bls.Signature(G2.generator).to_bytes()
    h._sign = lambda sk, root, domain: sig
    h._sign_aggregate = lambda validators, root: sig
    return h


@pytest.fixture(scope="module")
def chain_data():
    """(harness, genesis, SLOTS blocks), every block applied unverified."""
    h = _unsigned(Harness(minimal_spec(**ALTAIR), N, backend="fake", device="cpu"))
    genesis = h.state.copy()
    blocks = [h.advance_slot_with_block(s, strategy=BlockSignatureStrategy.NO_VERIFICATION)
              for s in range(1, SLOTS + 1)]
    return h, genesis, blocks


class Side:
    """One package's node, hub and peer classes, and its view of the
    port's objects (the reference's through SSZ bytes)."""

    def __init__(self, ref: bool):
        self.ref = ref
        self.Hub = RefHub if ref else GossipHub
        self.FaultyRpc = RefFaultyRpc if ref else FaultyRpc
        self.Range = RefRange if ref else BlocksByRangeRequest
        self.spec = ref_minimal_spec(**ALTAIR) if ref else minimal_spec(**ALTAIR)
        self.t = ref_types_for(self.spec) if ref else types_for(self.spec)

    def conv(self, obj):
        if not self.ref:
            return obj
        return getattr(self.t, type(obj).__name__).decode(type(obj).encode(obj))

    def node(self, node_id, genesis, hub=None, backend="fake"):
        if self.ref:
            return RefNode(node_id, self.conv(genesis), self.spec, hub=hub, backend=backend)
        return BeaconNode(node_id, genesis, self.spec, hub=hub, backend=backend, device="cpu")


def both(scenario, *args):
    """The scenario's result on the reference's side and on the port's,
    asserted equal; returns the port's."""
    out = [scenario(Side(ref), *args) for ref in (True, False)]
    assert out[0] == out[1]
    return out[1]


def _enc(obj):
    return type(obj).encode(obj)


def _grown(side, genesis, blocks, n=SLOTS, node_id="a", hub=None):
    """A node that imported the first n blocks, its clock at the last."""
    a = side.node(node_id, genesis, hub=hub)
    for b in blocks[:n]:
        a.on_slot(int(b.message.slot))
        a.chain.process_block(side.conv(b))
    return a


def _scores(hub):
    return {p: (v.score, v.banned) for p, v in sorted(hub.peers.items())}


def test_gossip_block_propagation(chain_data):
    _, genesis, blocks = chain_data

    def scenario(side):
        hub = side.Hub()
        a, b = side.node("a", genesis, hub=hub), side.node("b", genesis, hub=hub)
        heads = []
        for blk in blocks[:6]:
            for n in (a, b):
                n.on_slot(int(blk.message.slot))
            a.chain.process_block(side.conv(blk))
            a.publish_block(side.conv(blk))
            drained = b.processor.process_pending()
            heads.append((drained, a.chain.head_root, b.chain.head_root, _enc(b.chain.head_state)[-64:]))
        return heads, _scores(hub), b.processor.metrics, b.chain.journal.count(kind="block_import")

    heads, scores, metrics, imports = both(scenario)
    assert all(d == 1 and ra == rb for d, ra, rb, _ in heads)
    assert heads[-1][2] == type(blocks[5].message).hash_tree_root(blocks[5].message)
    assert scores["a"] == (6 * gossip.SCORE_VALID, False) and imports == 6


def _singles(side, chain, slot, n):
    """n single-bit attestations of slot's committee 0 on chain's head,
    signed with the G2 generator."""
    data = chain.produce_attestation_data(slot, 0)
    committee = chain.committee_for(data)
    sig = bls.Signature(G2.generator).to_bytes()
    return [side.t.Attestation(aggregation_bits=[j == i for j in range(len(committee))], data=data,
                               signature=sig) for i in range(min(n, len(committee)))]


def test_attestations_and_aggregates_into_the_pools(chain_data):
    _, genesis, blocks = chain_data

    def scenario(side):
        hub = side.Hub()
        a = _grown(side, genesis, blocks, 4, hub=hub)
        b = _grown(side, genesis, blocks, 4, "b", hub=hub)
        slot = 4
        subnets = [b.subscribe_for_attestation_duty(slot, k) for k in range(b.chain.committees_per_slot_at(0))]
        for att in _singles(side, a.chain, slot, 8):
            a.publish_attestation(att)
        n_single = b.processor.process_pending()
        pool = {s: sorted(_enc(x) for x in m.values()) for s, m in b.chain.naive_pool._by_slot.items()}
        votes = sorted((i, v.next_root) for i, v in b.chain.fork_choice.votes.items())
        sig = bls.Signature(G2.generator).to_bytes()
        prior = blocks[4].message.body.attestations  # slot 4's block carries slot 3's committees
        for att in prior:
            committee = b.chain.committee_for(att.data)
            a.publish_aggregate(side.t.SignedAggregateAndProof(
                message=side.t.AggregateAndProof(aggregator_index=committee[0], aggregate=side.conv(att),
                                                 selection_proof=sig), signature=sig))
        n_agg = b.processor.process_pending()
        ops = sorted(_enc(x) for v in b.chain.op_pool._attestations.values() for x in v)
        events = [(e["kind"], e.get("outcome"), sorted((e.get("attrs") or {}).items()))
                  for e in b.chain.journal.query(kind="attestation_batch")]
        return subnets, n_single, pool, votes, n_agg, ops, events, _scores(hub)

    subnets, n_single, pool, votes, n_agg, ops, events, _ = both(scenario)
    assert n_single == 1 and n_agg == 1 and len(pool[4]) == 1 and votes and ops
    assert [dict(e[2])["accepted"] for e in events] == [dict(e[2])["n"] for e in events]


def test_late_joiner_range_syncs_and_the_rpc_answers(chain_data):
    _, genesis, blocks = chain_data

    def scenario(side):
        a = _grown(side, genesis, blocks)
        c = side.node("c", genesis)
        c.clock.set_slot(SLOTS)
        c.sync.add_peer("a", a.rpc)
        imported = c.sync.run_range_sync()
        answers = [
            _enc(a.rpc.status("x")),
            [_enc(b) for b in a.rpc.blocks_by_range("x", side.Range(start_slot=3, count=5, step=1))],
            [_enc(b) for b in a.rpc.blocks_by_root("x", [a.chain.head_root, b"\x11" * 32])],
            _enc(a.rpc.metadata("x")), a.rpc.ping("x", 3),
        ]
        return imported, c.chain.head_root, a.chain.head_root, answers, c.sync.metrics["blocks_synced"]

    imported, c_head, a_head, answers, synced = both(scenario)
    assert imported == synced == SLOTS and c_head == a_head
    assert len(answers[1]) == 5 and len(answers[2]) == 1


def test_parent_lookup(chain_data):
    """B misses two blocks; the third arrives by gossip with an unknown
    parent: B walks back over blocks_by_root from A, then imports it."""
    _, genesis, blocks = chain_data

    def scenario(side):
        hub = side.Hub()
        a = _grown(side, genesis, blocks, 6, hub=hub)
        b = _grown(side, genesis, blocks, 3, "b", hub=hub)
        b.sync.add_peer("a", a.rpc)
        b.on_slot(6)
        a.publish_block(side.conv(blocks[5]))
        b.processor.process_pending()
        return b.chain.head_root, a.chain.head_root, int(b.chain.head_state.slot), _scores(hub)

    b_head, a_head, slot, scores = both(scenario)
    assert b_head == a_head and slot == 6 and scores["a"][0] == gossip.SCORE_VALID


def test_faulty_rpc_chaos_on_one_seed(chain_data):
    _, genesis, blocks = chain_data

    def scenario(side):
        a = _grown(side, genesis, blocks)
        hub = side.Hub()
        c = side.node("late", genesis, hub=hub)
        c.sync._sleep = lambda s: None
        hub.join("honest", lambda *x: None)
        hub.join("evil", lambda *x: None)
        evil = side.FaultyRpc(a.rpc, seed=1234, fault_rate=0.7)
        c.sync.add_peer("evil", evil)
        c.sync.add_peer("honest", a.rpc)
        c.clock.set_slot(SLOTS)
        imported = c.sync.run_range_sync(max_batches=32, batch_slots=2)
        return (imported, evil.injected, evil.calls, sorted(c.sync.quarantined), c.chain.head_root,
                _scores(hub), dict(c.sync.metrics))

    imported, injected, calls, quarantined, head, scores, _ = both(scenario)
    assert imported == SLOTS and sum(injected.values()) > 0 and calls > 1
    assert scores["evil"][0] < scores["honest"][0]
    assert head == type(blocks[-1].message).hash_tree_root(blocks[-1].message)


def test_peer_scores_after_invalid_and_duplicate_frames(chain_data):
    """A valid block (+SCORE_VALID), its frame again (SCORE_DUPLICATE),
    then three frames that do not decode (SCORE_INVALID_MESSAGE each): the
    third bans A, whose next publish reaches no one."""
    _, genesis, blocks = chain_data

    def scenario(side):
        hub = side.Hub()
        a, b = side.node("a", genesis, hub=hub), side.node("b", genesis, hub=hub)
        b.on_slot(1)
        a.publish_block(side.conv(blocks[0]))
        out = [b.processor.process_pending()]
        a.publish_block(side.conv(blocks[0]))  # the same frame again
        out.append(b.processor.process_pending())
        trace = [_scores(hub)["a"]]
        block_topic = gossip.topic(b.fork_digest, "beacon_block")
        agg_topic = gossip.topic(b.fork_digest, "beacon_aggregate_and_proof")
        for t, frame in ((block_topic, b"\x0a\x01\x00"),  # not snappy
                         (block_topic, gossip.encode_gossip(b"\x01" * 40)),  # too short a block
                         (agg_topic, b"\x00\x00")):  # more bytes than declared
            out.append(hub.publish("a", t, frame))
            trace.append(_scores(hub)["a"])
        out.append(hub.publish("a", block_topic, gossip.encode_gossip(_enc(side.conv(blocks[1])))))
        return out, trace, b.chain.head_root

    out, trace, head = both(scenario)
    assert out == [1, 0, 1, 1, 1, 0] and head == type(blocks[0].message).hash_tree_root(blocks[0].message)
    valid = gossip.SCORE_VALID + gossip.SCORE_DUPLICATE
    assert trace == [(valid, False)] + [(valid + k * gossip.SCORE_INVALID_MESSAGE, k == 3) for k in (1, 2, 3)]


def test_gossip_batch_on_gpu_with_the_plain_kernels(chain_data):
    """Three singles through nodes on "gpu" with device="cpu" (the plain
    kernels; the bus's canary off), the third carrying a valid signature
    of another validator: one batch that fails, then the per-set call,
    which refuses the third alone. The reference's nodes on "ref" give
    the same verdicts, pool and votes on the same inputs."""
    h, genesis, blocks = chain_data

    def scenario(side):
        hub = side.Hub()
        backend = "ref" if side.ref else "gpu"
        a = side.node("a", genesis, hub=hub, backend=backend)
        b = side.node("b", genesis, hub=hub, backend=backend)
        assert b.chain.backend == backend
        for n in (a, b):
            n.on_slot(1)
        data = a.chain.produce_attestation_data(1, 0)
        committee = a.chain.committee_for(data)
        domain = get_domain(genesis, spec.DOMAIN_BEACON_ATTESTER, 0, spec)
        root = compute_signing_root(type(data).hash_tree_root(data), domain)
        b.subscribe_for_attestation_duty(1, 0)
        for i, sig in enumerate(sigs(committee, root)):
            a.publish_attestation(b.chain.t.Attestation(
                aggregation_bits=[j == i for j in range(len(committee))], data=data, signature=sig))
        drained = b.processor.process_pending()
        verdicts = [committee[i] in b.chain.fork_choice.votes for i in range(3)]
        pool = {s: sorted(_enc(x) for x in m.values()) for s, m in b.chain.naive_pool._by_slot.items()}
        (event,) = b.chain.journal.query(kind="attestation_batch")
        return drained, verdicts, pool, event["attrs"]["accepted"], _scores(hub)

    spec = minimal_spec(**ALTAIR)
    signed = {}

    def sigs(committee, root):
        # signed once, by the port's keys; the third is the first's
        # signature on the third's attestation
        if not signed:
            signed["sigs"] = [h.keypairs[committee[i]].sk.sign(root).to_bytes() for i in range(2)]
        return signed["sigs"] + signed["sigs"][:1]

    GUARD.reset()
    GUARD.configure(canary="off")
    calls = dict(gpu_backend.CALL_COUNTS)
    try:
        drained, verdicts, pool, accepted, scores = both(scenario)
    finally:
        GUARD.reset()
    assert drained == 1 and verdicts == [True, True, False] and accepted == 2
    assert len(pool[1]) == 1 and not any(banned for _, banned in scores.values())
    assert {k: gpu_backend.CALL_COUNTS[k] - calls.get(k, 0) for k in ("batch", "individual")} == \
        {"batch": 1, "individual": 1}


def test_two_port_nodes_over_sockets(chain_data):
    """A publishes two blocks over TCP on 127.0.0.1 and B imports them;
    then a third node range-syncs from A over the socket RPC. Every wait
    is on an event, with a deadline."""
    _, genesis, blocks = chain_data
    spec = minimal_spec(**ALTAIR)
    a = BeaconNode("node-a", genesis, spec, backend="fake", device="cpu")
    b = BeaconNode("node-b", genesis, spec, backend="fake", device="cpu")
    c = BeaconNode("node-c", genesis, spec, backend="fake", device="cpu")
    arrived = threading.Semaphore(0)
    submit = b.processor.submit

    def submitted(kind, payload):
        ok = submit(kind, payload)
        arrived.release()
        return ok
    b.processor.submit = submitted
    nets = [n.attach_socket_net() for n in (a, b, c)]
    try:
        assert nets[1].connect("127.0.0.1", nets[0].tcp_port) == "node-a"
        assert nets[2].connect("127.0.0.1", nets[0].tcp_port) == "node-a"
        for blk in blocks[:2]:
            for n in (a, b):
                n.on_slot(int(blk.message.slot))
            a.chain.process_block(blk)
            a.publish_block(blk)
            assert arrived.acquire(timeout=5), "the block did not arrive"
            assert b.processor.process_pending() == 1
        assert b.chain.head_root == a.chain.head_root == type(blocks[1].message).hash_tree_root(blocks[1].message)
        assert "node-a" in c.sync.peers
        c.clock.set_slot(2)
        assert c.sync.run_range_sync() == 2 and c.chain.head_root == a.chain.head_root
    finally:
        for net in nets:
            net.close()


def test_a_device_fault_scores_no_peer(chain_data):
    """A device fault under a gossip block's import or a synced segment's
    is the card's, not the sender's: it reaches the caller, the sender's
    score stays 0 and no peer is quarantined (the reference scores and
    quarantines on every exception)."""
    _, genesis, blocks = chain_data
    side = Side(False)

    def fault(*_):
        raise DeviceTimeout("bls dispatch timed out")

    hub = GossipHub()
    a = _grown(side, genesis, blocks, 1, hub=hub)
    b = side.node("b", genesis, hub=hub)
    b.on_slot(1)
    b.chain.process_block = fault
    a.publish_block(blocks[0])
    with pytest.raises(DeviceTimeout):
        b.processor.process_pending()
    assert _scores(hub)["a"] == (0.0, False)
    assert b.chain.journal.count(kind="processor_batch") == 1
    c = side.node("c", genesis)
    c.clock.set_slot(1)
    c.sync.add_peer("a", a.rpc)
    c.chain.process_chain_segment = fault
    with pytest.raises(DeviceTimeout):
        c.sync.run_range_sync()
    assert not c.sync.quarantined


def test_unported_paths_raise_and_the_defaults_are_the_card(chain_data):
    _, genesis, _ = chain_data
    spec = minimal_spec(**ALTAIR)
    with pytest.raises(NotImplementedError, match="item 5"):
        BeaconNode("x", genesis, spec, backend="fake", device="cpu", column_mode=True)
    with pytest.raises(NotImplementedError, match="item 4"):
        BeaconNode("x", genesis, spec, backend="fake", device="cpu", slasher=object())
    node = BeaconNode("x", genesis, spec, backend="fake", device="cpu")
    with pytest.raises(NotImplementedError, match="item 6"):
        node.start_http_api()
    import torch

    if not torch.cuda.is_available():
        with pytest.raises(Exception):
            BeaconNode("x", genesis, spec)
