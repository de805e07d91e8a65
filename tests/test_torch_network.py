"""The port's network layer (lighthouse_tpu_torch.network) against the JAX
package's, exactly, on the CPU.

The same seeded inputs go through both packages' modules: snappy block and
frame bytes (the native matcher and the literal-only compressor) and the
errors of corrupt frames, topic names, subnets and message ids, the RPC
containers' bytes, token-bucket and shedding decisions, the beacon
processor's batches, duty-driven subnet subscriptions over a run of slots
and discovery queries. Nothing here builds a chain or a JAX graph; the
nodes' results are in tests/test_torch_node.py."""

import random

import numpy as np
import pytest

from lighthouse_tpu.network import beacon_processor as ref_bp
from lighthouse_tpu.network import discovery as ref_disc
from lighthouse_tpu.network import gossip as ref_gossip
from lighthouse_tpu.network import rpc as ref_rpc
from lighthouse_tpu.network import shedding as ref_shed
from lighthouse_tpu.network import snappy_codec as ref_snappy
from lighthouse_tpu.network import subnet_service as ref_subnets
from lighthouse_tpu.types.spec import minimal_spec as ref_minimal_spec
from lighthouse_tpu_torch.network import beacon_processor as bp
from lighthouse_tpu_torch.network import discovery as disc
from lighthouse_tpu_torch.network import gossip
from lighthouse_tpu_torch.network import rpc
from lighthouse_tpu_torch.network import shedding as shed
from lighthouse_tpu_torch.network import snappy_codec as snappy
from lighthouse_tpu_torch.network import subnet_service as subnets
from lighthouse_tpu_torch.types.spec import minimal_spec


def _inputs():
    """Seeded, empty, incompressible and long-run payloads; two cross the
    frame format's 65,536-byte chunk."""
    rng = np.random.default_rng(42)
    words = rng.integers(0, 16, size=5_000, dtype=np.uint8).tobytes()
    return {
        "seeded": bytes(rng.choice(list(b"abcdefgh\x00\x01"), size=5_000).astype(np.uint8)),
        "empty": b"",
        "incompressible": rng.bytes(70_000),
        "long_run": b"\x00" * 70_000 + b"\x07" * 3 + bytes(range(256)) * 40,
        "ssz_like": words * 4,
    }


INPUTS = _inputs()


@pytest.fixture(params=["native", "literal"])
def codecs(request, monkeypatch):
    """Both packages' codecs, on the native library or (its `_lib` False,
    as on a machine without cc) the literal-only compressor and the
    Python decoder."""
    if request.param == "native":
        assert snappy.native_available() and ref_snappy.native_available()
    else:
        monkeypatch.setattr(snappy, "_lib", False)
        monkeypatch.setattr(ref_snappy, "_lib", False)
    return request.param


@pytest.mark.parametrize("name", sorted(INPUTS))
def test_snappy_block_and_frame_bytes_equal_the_reference(codecs, name):
    data = INPUTS[name]
    block = snappy.compress_block(data)
    assert block == ref_snappy.compress_block(data)
    assert snappy.decompress_block(block) == data == ref_snappy.decompress_block(block)
    frame = snappy.frame_compress(data)
    assert frame == ref_snappy.frame_compress(data)
    assert snappy.frame_decompress(frame) == data
    # gossip frames are blocks; the message id hashes the compressed frame
    assert gossip.encode_gossip(data) == ref_gossip.encode_gossip(data) == block
    if codecs == "native" and name in ("ssz_like", "long_run"):
        assert len(block) < len(data) // 2  # the matcher, not literals


def test_native_and_literal_blocks_decode_alike(monkeypatch):
    """A native block decodes on the Python path and a literal-only block
    on the native one, to the same bytes."""
    native = {k: snappy.compress_block(v) for k, v in INPUTS.items()}
    monkeypatch.setattr(snappy, "_lib", False)
    literal = {k: snappy.compress_block(v) for k, v in INPUTS.items()}
    for k, v in INPUTS.items():
        assert snappy.decompress_block(native[k]) == v
    monkeypatch.undo()
    for k, v in INPUTS.items():
        assert snappy.decompress_block(literal[k]) == v


def _corrupt():
    good = snappy.frame_compress(INPUTS["seeded"])
    block = snappy.compress_block(INPUTS["seeded"])
    return {
        "block": [b"", b"\xff\xff\xff\xff\xff\xff", b"\x0a\x01\x00", b"\x05\x10abc", block[:-3],
                  b"\x80\x80\x80\x80\x01", block[:1] + b"\xfe" + block[2:]],
        "frame": [b"", b"sNaPpY", good[:12], good[:-1], good[:14] + bytes([good[14] ^ 1]) + good[15:],
                  good[:10] + b"\x03\x04\x00\x00abcd", good[:10] + b"\x00\x02\x00\x00ab"],
    }


@pytest.mark.parametrize("kind", ["block", "frame"])
def test_corrupt_frames_raise_the_same_snappy_error(codecs, kind):
    for data in _corrupt()[kind]:
        out = []
        for mod in (ref_snappy, snappy):
            fn = mod.decompress_block if kind == "block" else mod.frame_decompress
            try:
                out.append(("ok", fn(data)))
            except Exception as e:
                out.append((type(e).__name__, str(e)))
        assert out[0] == out[1], (data, out)
    for data in _corrupt()[kind][1:]:
        with pytest.raises(snappy.SnappyError):
            (snappy.decompress_block if kind == "block" else snappy.frame_decompress)(data)


def test_topics_subnets_and_message_ids():
    rng = random.Random(7)
    digest = bytes(rng.randrange(256) for _ in range(4))
    for name in ("beacon_block", "beacon_aggregate_and_proof", "voluntary_exit",
                 "light_client_finality_update"):
        assert gossip.topic(digest, name) == ref_gossip.topic(digest, name)
    for i in range(12):
        assert gossip.blob_sidecar_topic_name(i) == ref_gossip.blob_sidecar_topic_name(i)
        assert gossip.data_column_sidecar_topic_name(i) == ref_gossip.data_column_sidecar_topic_name(i)
        for count in (0, 1, 6, 128):
            assert gossip.compute_blob_subnet(i, count) == ref_gossip.compute_blob_subnet(i, count)
            assert gossip.compute_column_subnet(i, count) == ref_gossip.compute_column_subnet(i, count)
    spec, ref_spec = minimal_spec(), ref_minimal_spec()
    for slot in range(0, 20, 3):
        for index in range(4):
            for per_slot in (1, 4, 64):
                assert subnets.compute_subnet(spec, slot, index, per_slot) == \
                    ref_subnets.compute_subnet(ref_spec, slot, index, per_slot)
    assert subnets.subnet_topic_name(9) == ref_subnets.subnet_topic_name(9)
    for _ in range(16):
        data = rng.randbytes(rng.randrange(0, 300))
        assert gossip.message_id(data) == ref_gossip.message_id(data)
    assert (gossip.SCORE_VALID, gossip.SCORE_DUPLICATE, gossip.SCORE_INVALID_MESSAGE, gossip.SCORE_TIMEOUT,
            gossip.BAN_THRESHOLD, gossip.GOSSIP_MAX_SIZE) == (
        ref_gossip.SCORE_VALID, ref_gossip.SCORE_DUPLICATE, ref_gossip.SCORE_INVALID_MESSAGE,
        ref_gossip.SCORE_TIMEOUT, ref_gossip.BAN_THRESHOLD, ref_gossip.GOSSIP_MAX_SIZE)


def _hub_trace(mod):
    """Peers on one hub: deliveries, a duplicate, an oversized frame, scores
    up to a ban, and the banned peer's publish dropped."""
    hub = mod.GossipHub()
    got = []
    for pid in ("a", "b", "c"):
        hub.join(pid, lambda t, d, f, pid=pid: got.append((pid, t, d, f)))
    hub.subscribe("b", "t1")
    hub.subscribe("c", "t1")
    hub.subscribe("a", "t1")
    out = [hub.publish("a", "t1", b"x"), hub.publish("a", "t1", b"x"), hub.publish("c", "t1", b"y"),
           hub.publish("a", "t1", b"\x00" * (mod.GOSSIP_MAX_SIZE + 1))]
    hub.unsubscribe("c", "t1")
    out.append(hub.publish("a", "t1", b"z"))
    for _ in range(3):
        hub.report("b", mod.SCORE_INVALID_MESSAGE)
    out.append(hub.publish("b", "t1", b"w"))
    return out, got, {p: (v.score, v.banned) for p, v in hub.peers.items()}


def test_gossip_hub_fanout_and_scores():
    assert _hub_trace(gossip) == _hub_trace(ref_gossip)


def test_rpc_request_containers_bytes():
    rng = random.Random(3)
    for _ in range(4):
        root, head = rng.randbytes(32), rng.randbytes(32)
        vals = dict(fork_digest=rng.randbytes(4), finalized_root=root, finalized_epoch=rng.randrange(2**20),
                    head_root=head, head_slot=rng.randrange(2**30))
        bits = [rng.random() < 0.3 for _ in range(64)]
        pairs = [
            (rpc.StatusMessage(**vals), ref_rpc.StatusMessage(**vals)),
            (rpc.Ping(data=rng.randrange(2**63)), None),
            (rpc.MetaData(seq_number=5, attnets=bits), ref_rpc.MetaData(seq_number=5, attnets=bits)),
            (rpc.Goodbye(reason=3), ref_rpc.Goodbye(reason=3)),
            (rpc.BlocksByRangeRequest(start_slot=9, count=64, step=1),
             ref_rpc.BlocksByRangeRequest(start_slot=9, count=64, step=1)),
            (rpc.BlobSidecarsByRangeRequest(start_slot=2, count=128),
             ref_rpc.BlobSidecarsByRangeRequest(start_slot=2, count=128)),
            (rpc.BlobSidecarsByRootRequest(identifiers=[rpc.BlobIdentifier(block_root=root, index=i)
                                                        for i in range(3)]),
             ref_rpc.BlobSidecarsByRootRequest(identifiers=[ref_rpc.BlobIdentifier(block_root=root, index=i)
                                                            for i in range(3)])),
            (rpc.DataColumnSidecarsByRootRequest(identifiers=[rpc.DataColumnIdentifier(block_root=head, index=7)]),
             ref_rpc.DataColumnSidecarsByRootRequest(
                 identifiers=[ref_rpc.DataColumnIdentifier(block_root=head, index=7)])),
        ]
        pairs[1] = (pairs[1][0], ref_rpc.Ping(data=int(pairs[1][0].data)))
        for port_obj, ref_obj in pairs:
            assert port_obj.to_bytes() == ref_obj.to_bytes()
            assert type(port_obj).decode(ref_obj.to_bytes()).to_bytes() == ref_obj.to_bytes()
    assert rpc.QUOTAS == ref_rpc.QUOTAS
    assert (rpc.MAX_REQUEST_BLOCKS, rpc.MAX_REQUEST_BLOB_SIDECARS, rpc.MAX_REQUEST_DATA_COLUMN_SIDECARS) == (
        ref_rpc.MAX_REQUEST_BLOCKS, ref_rpc.MAX_REQUEST_BLOB_SIDECARS, ref_rpc.MAX_REQUEST_DATA_COLUMN_SIDECARS)


def _bucket_trace(mod, monkeypatch):
    """One seeded sequence of requests against a server's token buckets
    on a clock the test moves: each admitted or refused."""
    now = [100.0]
    monkeypatch.setattr(mod.time, "monotonic", lambda: now[0])
    srv = mod.RpcServer(None, "srv", b"\x00" * 4)
    rng = random.Random(11)
    out = []
    for _ in range(300):
        method = rng.choice(["status", "ping", "blocks_by_range", "blob_sidecars_by_root"])
        n = float(rng.choice([1, 1, 8, 64, 400]))
        peer = rng.choice(["p1", "p2"])
        try:
            srv._limit(peer, method, n)
            out.append(1)
        except mod.RateLimitExceeded:
            out.append(0)
        now[0] += rng.choice([0.0, 0.01, 0.5, 3.0])
    return out


def test_token_buckets_decide_alike(monkeypatch):
    got = _bucket_trace(rpc, monkeypatch)
    assert got == _bucket_trace(ref_rpc, monkeypatch)
    assert 0 < sum(got) < len(got)


def _shedding_trace(mod):
    bounds = {"gossip_attestation": 40, "gossip_aggregate": 16, "gossip_block": 8}
    pol = mod.SheddingPolicy(bounds)
    rng = random.Random(5)
    out = []
    for _ in range(400):
        kind = rng.choice(sorted(bounds))
        depth = rng.randrange(0, bounds[kind] + 1)
        if rng.random() < 0.3:
            pol.observe_depth(kind, depth)
            out.append(("o", kind, pol.is_shedding(kind)))
        else:
            out.append(("s", kind, pol.should_shed(kind, depth)))
    out.append(pol.any_open())
    out.append(pol.state())
    with pytest.raises(ValueError):
        mod.SheddingPolicy(bounds, low_water=0.8, high_water=0.5)
    return out


def test_shedding_decisions_alike():
    got = _shedding_trace(shed)
    assert got == _shedding_trace(ref_shed)
    assert any(x[2] for x in got[:-2] if x[0] == "s")
    assert shed.FORENSIC_KINDS == ref_shed.FORENSIC_KINDS


def _processor_trace(mod):
    """A seeded submission stream, then the synchronous drain: the batches
    each handler got, in order; the drops of a small bound and a handler
    that raises."""
    got = []
    handlers = {k: (lambda p, k=k: got.append((k, p))) for k in mod.PRIORITIES}

    def boom(p):
        got.append(("gossip_exit", p))
        raise RuntimeError("handler fault")
    handlers["gossip_exit"] = boom
    proc = mod.BeaconProcessor(handlers, bounds={"gossip_block": 4, "gossip_slashing": 2})
    rng = random.Random(9)
    kinds = sorted(mod.PRIORITIES)
    accepted = []
    for i in range(500):
        kind = rng.choice(kinds + ["gossip_attestation"] * 6 + ["gossip_aggregate"] * 2)
        accepted.append(proc.submit(kind, (kind, i)))
    depths = proc.queue_depths()
    drained = []
    while True:
        try:
            n = proc.process_pending()
        except RuntimeError:
            drained.append("raised")
            continue
        drained.append(n)
        if n == 0:
            break
    return accepted, depths, drained, got, dict(proc.metrics), proc.pressure_high(), proc.shed_state()


def test_beacon_processor_batches_alike():
    got = _processor_trace(bp)
    assert got == _processor_trace(ref_bp)
    batches = [p for k, p in got[3] if k == "gossip_attestation"]
    assert max(len(b) for b in batches) == bp.ATTESTATION_BATCH_MAX == ref_bp.ATTESTATION_BATCH_MAX
    assert bp.AGGREGATE_BATCH_MAX == ref_bp.AGGREGATE_BATCH_MAX and bp.PRIORITIES == ref_bp.PRIORITIES


def _subnet_trace(mod, spec):
    calls = []
    svc = mod.AttestationSubnetService(spec, "node-7", subscribe=lambda n: calls.append(("+", n)),
                                       unsubscribe=lambda n: calls.append(("-", n)))
    rng = random.Random(13)
    out = [list(svc.long_lived)]
    for slot in range(1, 40):
        for _ in range(rng.randrange(0, 4)):
            out.append(svc.subscribe_for_duty(slot + rng.randrange(0, 3), rng.randrange(0, 4),
                                              rng.choice([1, 2, 4])))
        svc.on_slot(slot)
        out.append(sorted(svc.active_subnets))
    return out, calls


def test_subnet_subscriptions_over_a_run_of_slots():
    got = _subnet_trace(subnets, minimal_spec())
    assert got == _subnet_trace(ref_subnets, ref_minimal_spec())
    assert any(c[0] == "-" for c in got[1])


def _discovery_trace(mod, monkeypatch):
    now = [50.0]
    monkeypatch.setattr(mod.time, "monotonic", lambda: now[0])
    reg = mod.BootstrapRegistry(liveness_timeout=10.0)
    rng = random.Random(17)
    out = []
    for i in range(24):
        nets = [rng.random() < 0.1 for _ in range(64)]
        reg.register(mod.PeerRecord(node_id=f"n{i % 12}", seq=rng.randrange(1, 4), attnets=nets))
        now[0] += rng.choice([0.0, 1.0, 4.0])
        if i % 5 == 0:
            reg.refresh(f"n{rng.randrange(12)}")
        out.append([r.node_id for r in reg.find_peers(exclude="n3", limit=6)])
        out.append([r.node_id for r in reg.find_subnet_peers({rng.randrange(64), 5}, exclude="n1")])
    return out


def test_discovery_queries_alike(monkeypatch):
    got = _discovery_trace(disc, monkeypatch)
    assert got == _discovery_trace(ref_disc, monkeypatch)
    assert any(got) and any(len(x) < 6 for x in got[::2])
