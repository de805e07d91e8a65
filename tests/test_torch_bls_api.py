"""The port's BLS API (`lighthouse_tpu_torch/bls`) against the reference's
(`lighthouse_tpu/bls`), on the same keys and messages: key bytes, the
aggregations, the single-signature checks, the "fake" backend, the
committed BLS and serialization vectors, and the boundary's metric deltas,
journal events, shared-batch records and consumer labels. Everything here
runs on the host backends ("ref", "fake"); the gpu backend's batches are
in tests/test_torch_verify.py and tests/test_torch_stream.py.
"""

import ast
import json
import os

import pytest

import lighthouse_tpu.bls as rbls
from lighthouse_tpu.common import device_attribution as rattr
from lighthouse_tpu.common.events_journal import Journal as RJournal
from lighthouse_tpu.common.metrics import REGISTRY as RREG
import lighthouse_tpu_torch.bls as pbls
from lighthouse_tpu_torch.common import device_attribution as pattr
from lighthouse_tpu_torch.common.events_journal import Journal as PJournal
from lighthouse_tpu_torch.common.metrics import REGISTRY as PREG

VECTORS = os.path.join(os.path.dirname(__file__), "vectors")
SIDES = {"ref": (rbls, RREG, rattr, RJournal), "port": (pbls, PREG, pattr, PJournal)}


def _sk_bytes(i: int) -> bytes:
    return (1000 + i).to_bytes(32, "big")


def _both(fn):
    """fn(bls module) on the reference and on the port."""
    return fn(rbls), fn(pbls)


def _keys(bls, n=3):
    return [bls.Keypair(bls.SecretKey.from_bytes(_sk_bytes(i))) for i in range(n)]


def test_every_reference_name_is_exported():
    with open(os.path.join(os.path.dirname(rbls.__file__), "__init__.py")) as f:
        tree = ast.parse(f.read())
    names = [a.asname or a.name for node in ast.walk(tree) if isinstance(node, ast.ImportFrom)
             for a in node.names]
    missing = [n for n in names if not hasattr(pbls, n)]
    assert not missing and len(names) > 20


def test_keys_and_aggregations_give_equal_bytes():
    ref, port = _both(lambda b: b.interop_keypairs(4))
    assert [k.sk.to_bytes() for k in ref] == [k.sk.to_bytes() for k in port]
    assert [k.pk.to_bytes() for k in ref] == [k.pk.to_bytes() for k in port]
    for k in port:
        assert pbls.SecretKey.from_bytes(k.sk.to_bytes()).to_bytes() == k.sk.to_bytes()
    for bls in (rbls, pbls):
        with pytest.raises(ValueError):
            bls.SecretKey.from_bytes(b"\x01" * 31)

    def aggregates(bls):
        kps = _keys(bls)
        sigs = [kp.sk.sign(b"agg") for kp in kps]
        return (
            bls.aggregate_signatures(sigs).to_bytes(),
            bls.aggregate_public_keys([kp.pk for kp in kps]).to_bytes(),
            bls.aggregate_pubkeys_bytes([kp.pk.to_bytes() for kp in kps]),
            bls.aggregate_pubkeys_bytes([]),
        )

    ref, port = _both(aggregates)
    assert ref == port and port[3] == pbls.INFINITY_PUBKEY_BYTES
    for bls in (rbls, pbls):
        with pytest.raises(ValueError):
            bls.aggregate_signatures([])
        with pytest.raises(ValueError):
            bls.aggregate_public_keys([])
    # __eq__ / __hash__ of the points: by their compressed bytes
    a, b = _keys(pbls, 1)[0], _keys(pbls, 1)[0]
    assert a.pk == b.pk and hash(a.pk) == hash(b.pk) and len({a.pk, b.pk}) == 1
    assert a.sk.sign(b"x") == b.sk.sign(b"x") and a.sk.sign(b"x") != a.sk.sign(b"y")


def test_single_signature_checks_agree():
    def verdicts(bls):
        kps = _keys(bls)
        pks = [kp.pk for kp in kps]
        m1, m2 = b"one", b"two"
        sig1 = kps[0].sk.sign(m1)
        agg = bls.aggregate_signatures([kp.sk.sign(m1) for kp in kps])
        agg_distinct = bls.aggregate_signatures([kps[0].sk.sign(m1), kps[1].sk.sign(m2)])
        inf = bls.Signature.from_bytes(bls.INFINITY_SIGNATURE_BYTES)
        return [
            bls.verify(pks[0], m1, sig1),
            bls.verify(pks[0], m2, sig1),  # wrong message
            bls.verify(pks[0], m1, inf),  # infinity signature
            bls.fast_aggregate_verify(pks, m1, agg),
            bls.fast_aggregate_verify([], m1, agg),  # empty
            bls.eth_fast_aggregate_verify([], m1, inf),  # empty sync aggregate
            bls.eth_fast_aggregate_verify([], m1, agg),
            bls.aggregate_verify(pks[:2], [m1, m2], agg_distinct),
            bls.aggregate_verify(pks[:2], [m2, m1], agg_distinct),  # swapped
            bls.aggregate_verify(pks[:2], [m1], agg_distinct),  # length mismatch
            bls.aggregate_verify([], [], agg_distinct),
        ]

    ref, port = _both(verdicts)
    assert ref == port == [True, False, False, True, False, True, False, True, False, False, False]


def test_fake_backend():
    def run(bls):
        kps = _keys(bls, 2)
        wrong = bls.SignatureSet(kps[0].sk.sign(b"m"), [kps[1].pk], b"not the message")
        return (
            bls.verify_signature_sets([wrong], backend="fake"),
            bls.verify_signature_sets([], backend="fake"),
            bls.verify_signature_sets_individually([wrong, wrong], backend="fake"),
            bls.verify_signature_set_batches([[wrong], []], backend="fake"),
            bls.verify_signature_sets_shared([([wrong], "bench")], backend="fake")[0],
        )

    ref, port = _both(run)
    assert ref == port == (True, False, [True, True], [True, False], True)


# ----------------------------------------------------------------- vectors


def _cases(runner, handler):
    d = os.path.join(VECTORS, runner, handler)
    for name in sorted(os.listdir(d)):
        with open(os.path.join(d, name)) as f:
            yield name, json.load(f)


def _unhex(s):
    return bytes.fromhex(s[2:])


def _verify_bytes(pk_hex, msg_hex, sig_hex) -> bool:
    try:
        pk = pbls.PublicKey.from_bytes(_unhex(pk_hex))
        sig = pbls.Signature.from_bytes(_unhex(sig_hex))
        return pbls.verify_signature_sets([pbls.SignatureSet(sig, [pk], _unhex(msg_hex))], backend="ref")
    except ValueError:
        return False


def _run_vector(handler, case):
    inp = case.get("input")
    if handler == "sign":
        sk = pbls.SecretKey.from_bytes(_unhex(inp["privkey"]))
        sig = sk.sign(_unhex(inp["message"]))
        return sig.to_bytes() == _unhex(case["output"]) and _verify_bytes(
            "0x" + sk.public_key().to_bytes().hex(), inp["message"], case["output"])
    if handler == "verify":
        return _verify_bytes(inp["pubkey"], inp["message"], inp["signature"]) == case["output"]
    if handler in ("aggregate", "eth_aggregate_pubkeys"):
        parse = pbls.Signature if handler == "aggregate" else pbls.PublicKey
        agg = pbls.aggregate_signatures if handler == "aggregate" else pbls.aggregate_public_keys
        items = [parse.from_bytes(_unhex(s)) for s in inp]
        if case["output"] is None:
            with pytest.raises(ValueError):
                agg(items)
            return True
        return agg(items).to_bytes() == _unhex(case["output"])
    if handler in ("fast_aggregate_verify", "eth_fast_aggregate_verify", "aggregate_verify"):
        try:
            pks = [pbls.PublicKey.from_bytes(_unhex(p)) for p in inp["pubkeys"]]
            sig = pbls.Signature.from_bytes(_unhex(inp["signature"]))
        except ValueError:
            return case["output"] is False
        if handler == "aggregate_verify":
            got = pbls.aggregate_verify(pks, [_unhex(m) for m in inp["messages"]], sig)
        else:
            got = getattr(pbls, handler)(pks, _unhex(inp["message"]), sig)
        return got == case["output"]
    # serialization: pubkey / signature
    if "privkey" in inp:
        sk = pbls.SecretKey.from_bytes(_unhex(inp["privkey"]))
        return sk.public_key().to_bytes() == _unhex(case["output"])
    parse = pbls.PublicKey if handler == "pubkey" else pbls.Signature
    try:
        parse.from_bytes(_unhex(inp[handler]))
        ok = True
    except ValueError:
        ok = False
    return ok == case["output"]


@pytest.mark.parametrize(
    "runner, handler",
    [("bls", h) for h in ("sign", "verify", "aggregate", "fast_aggregate_verify",
                          "eth_fast_aggregate_verify", "aggregate_verify", "eth_aggregate_pubkeys")]
    + [("serialization", "pubkey"), ("serialization", "signature")],
)
def test_committed_vectors_on_the_port(runner, handler):
    """The committed vectors, read only, through the port's API on "ref"."""
    results = {name: _run_vector(handler, case) for name, case in _cases(runner, handler)}
    assert results and all(results.values()), results


# ------------------------------------------- metrics, journal, attribution

SERIES = [
    ("lighthouse_tpu_verify_batches_total", ("ref", "ok")),
    ("lighthouse_tpu_verify_batches_total", ("ref", "fail")),
    ("lighthouse_tpu_verify_sets_total", None),
    ("lighthouse_tpu_device_sets_total", ("gossip_single",)),
    ("lighthouse_tpu_device_batches_total", ("gossip_single", "bls", "host")),
]


def _series(reg):
    return [reg.get_value(name, labels) for name, labels in SERIES]


def _event(e):
    return {k: v for k, v in e.items() if k != "t"}


def test_boundary_metrics_and_journal_agree():
    """The same sets through both boundaries on "ref", consumer
    gossip_single, each with its own journal: equal metric deltas and equal
    `signature_batch` events (batch and per-set call)."""
    out = {}
    for side, (bls, reg, _, journal_cls) in SIDES.items():
        kps = _keys(bls, 2)
        good = bls.SignatureSet(kps[0].sk.sign(b"gossip"), [kps[0].pk], b"gossip")
        inf = bls.SignatureSet(bls.Signature.from_bytes(bls.INFINITY_SIGNATURE_BYTES), [kps[1].pk], b"gossip")
        journal = journal_cls()
        before = _series(reg)
        verdicts = [
            bls.verify_signature_sets([good], backend="ref", consumer="gossip_single", journal=journal,
                                      slot=7, journal_attrs={"topic": "beacon_attestation"}),
            bls.verify_signature_sets([good, inf], backend="ref", consumer="gossip_single",
                                      journal=journal, slot=7),
            bls.verify_signature_sets_individually([good, inf], backend="ref", consumer="gossip_single",
                                                   journal=journal, slot=8),
        ]
        deltas = [a - b for a, b in zip(_series(reg), before)]
        out[side] = (verdicts, deltas, [_event(e) for e in journal.query()])
    assert out["ref"] == out["port"]
    verdicts, deltas, events = out["port"]
    assert verdicts == [True, False, [True, False]]
    assert deltas == [1, 1, 3, 5, 3] and len(events) == 3


def test_shared_batch_with_a_rider_agrees():
    """Two submissions and one attribution-free rider in one "ref" dispatch:
    the same verdict, the same record (its amortized fixed cost each side's
    own FIXED_DEVICE_COST_MS over the live sets) and the same per-consumer
    set counts."""
    out = {}
    for side, (bls, _, attr, _) in SIDES.items():
        kps = _keys(bls, 3)
        sets = [bls.SignatureSet(kp.sk.sign(b"shared"), [kp.pk], b"shared") for kp in kps]
        rider = bls.SignatureSet(bls.Signature.from_bytes(bls.INFINITY_SIGNATURE_BYTES), [kps[0].pk], b"x")
        before = attr.consumer_totals()
        ok, record = bls.verify_signature_sets_shared(
            [(sets[:1], "gossip_single"), (sets[1:], "sync_segment"), ([], "oppool")],
            backend="ref", extra_sets=[rider])
        after = attr.consumer_totals()
        counts = {c: after.get(c, 0) - before.get(c, 0) for c in ("gossip_single", "sync_segment", "oppool")}
        assert record.pop("amortized_fixed_ms") == round(attr.FIXED_DEVICE_COST_MS / 3, 3)
        assert record.pop("duration_s") > 0
        empty = bls.verify_signature_sets_shared([([], "bench")], backend="ref")
        out[side] = (ok, record, counts, empty)
    assert out["ref"] == out["port"]
    ok, record, counts, empty = out["port"]
    assert ok is False and empty == (False, None)
    assert counts == {"gossip_single": 1, "sync_segment": 2, "oppool": 0}
    assert record["consumers"] == [("gossip_single", 1), ("sync_segment", 2)] and record["live"] == 4


def test_unknown_consumer_and_backend_raise():
    for bls in (rbls, pbls):
        kp = _keys(bls, 1)[0]
        s = bls.SignatureSet(kp.sk.sign(b"m"), [kp.pk], b"m")
        with pytest.raises(ValueError, match="unknown device-plane consumer"):
            bls.verify_signature_sets([s], backend="fake", consumer="gossip_attestation")
        with pytest.raises(ValueError, match="unknown BLS backend"):
            bls.verify_signature_sets([s], backend="nope")
    assert pbls.api.default_backend() == "gpu"
    assert pattr.CONSUMERS == rattr.CONSUMERS
