"""The port's slot program (`lighthouse_tpu_torch/ops/slot_program.py`)
against its own serial calls and against the reference's
(`lighthouse_tpu/ops/slot_program.py`), on the CPU.

One program on the "gpu" backend with device="cpu" (the plain versions) is
held against the three serial calls on the same inputs and seed: the
signature fold, a KZG settle of two dev_setup(8) blobs (on "ref", the
work's own backend) and a depth-2 Merkle segment -- one counted dispatch,
the inner ones passing through the guard. On the "fake" backend the
reference's `SlotProgram` and the port's give the same structure: the
deliveries, `merkle_results`, the group verdict of a settle-only program,
"error" on a malformed commitment, the dispatch count, and under a flip
the flipped settle and Merkle verdicts. Faults reach the caller with the
work undelivered; a flip under the canary raises `CanaryViolation`.
"""

import hashlib

import pytest

import lighthouse_tpu.bls as rbls
import lighthouse_tpu.kzg as rkzg
from lighthouse_tpu.device_plane import GUARD as RGUARD
from lighthouse_tpu.device_plane import INJECTOR as RINJECTOR
from lighthouse_tpu.ops import slot_program as rsp
import lighthouse_tpu_torch.bls as pbls
import lighthouse_tpu_torch.kzg as pkzg
from lighthouse_tpu_torch.crypto.constants import R
from lighthouse_tpu_torch.device_plane import GUARD as PGUARD
from lighthouse_tpu_torch.device_plane import INJECTOR as PINJECTOR
from lighthouse_tpu_torch.device_plane import executor as pexec
from lighthouse_tpu_torch.ops import merkle_proof as pmp
from lighthouse_tpu_torch.ops import slot_program as psp

SEED = 11
SIDES = {
    "ref": (rbls, rkzg, rsp, RGUARD, RINJECTOR),
    "port": (pbls, pkzg, psp, PGUARD, PINJECTOR),
}


@pytest.fixture(autouse=True)
def clean_globals():
    for *_, guard, injector in SIDES.values():
        guard.reset()
        injector.reset()
    yield
    for *_, guard, injector in SIDES.values():
        guard.reset()
        injector.reset()


class _SettleWork:
    """The data-availability checker's pending settle, as far as a program
    sees it: a payload, and every delivered verdict recorded."""

    def __init__(self, blobs, commitments, proofs, backend):
        self._payload = (blobs, commitments, proofs, backend)
        self.verdicts = []

    def payload(self):
        return self._payload

    def deliver(self, verdict):
        self.verdicts.append(verdict)


def _blobs(n=2):
    """n blobs of 8 field elements, made from a seed with hashlib."""
    return [b"".join((int.from_bytes(hashlib.sha256(b"slot-program %d %d" % (i, j)).digest(), "big")
                      % R).to_bytes(32, "big") for j in range(8)) for i in range(n)]


def _settle(kzg, backend, tamper=False, malformed=False):
    blobs = _blobs()
    if backend == "fake":
        comms, proofs = [bytes(48)] * 2, [bytes(48)] * 2
    else:
        comms = [kzg.blob_to_kzg_commitment(b, backend="ref") for b in blobs]
        proofs = [kzg.compute_blob_kzg_proof(b, c, backend="ref") for b, c in zip(blobs, comms)]
    if tamper:
        blobs[1] = blobs[1][:40] + bytes([blobs[1][40] ^ 1]) + blobs[1][41:]
    if malformed:
        comms[0] = b"\x00" * 48  # not a point encoding
    return _SettleWork(blobs, comms, proofs, backend)


def _sets(bls, good=2, bad=0):
    kps = bls.interop_keypairs(good + bad)
    msg = b"slot-program-oracle"
    return ([bls.SignatureSet(kp.sk.sign(msg), [kp.pk], msg) for kp in kps[:good]]
            + [bls.SignatureSet(kp.sk.sign(b"wrong"), [kp.pk], msg) for kp in kps[good:]])


def _merkle():
    """Two depth-2 queries with hashlib roots, the second root corrupted."""
    queries = [(b"\x11" * 32, [b"\x22" * 32, b"\x33" * 32], 4),
               (b"\x44" * 32, [b"\x55" * 32, b"\x66" * 32], 7)]
    roots = pmp.fold_branches_host(queries)
    roots[1] = b"\x00" * 32
    return queries, roots


def test_program_matches_the_serial_calls_on_the_plain_versions():
    """The fused program's verdicts are exactly the serial calls' on the
    same inputs and seed, and the whole program is one counted dispatch
    (the inner bls and merkle_proof crossings pass through; the settle's
    "ref" backend crosses none): two plain signature verifies in all."""
    PGUARD.configure(watchdog=False, canary="off")
    work = _settle(pkzg, "ref")
    sets = _sets(pbls)
    queries, roots = _merkle()
    program = (psp.SlotProgram(seed=SEED).add_settle(work)
               .add_signatures(sets, consumer="gossip_single")
               .add_merkle(queries, roots, consumer="bench"))
    ok, record = program.run(backend="gpu", device="cpu")
    assert PGUARD.stats()["dispatches"] == 1
    assert set(PGUARD.breaker.snapshot()) == {"bls/8"}

    serial_settle = pkzg.verify_blob_kzg_proof_batch(*work.payload()[:3], backend="ref",
                                                     consumer="kzg")
    serial_sig, serial_record = pbls.verify_signature_sets_shared(
        [(sets, "gossip_single")], backend="gpu", seed=SEED, device="cpu")
    serial_merkle = pmp.batch_verify_branches(queries, roots, consumer="bench", device="cpu")
    assert work.verdicts == [serial_settle] == [True]
    assert program.merkle_results == [serial_merkle] == [[True, False]]
    assert serial_sig is True and ok is False  # the corrupted Merkle root
    for k in ("lanes", "live", "waste", "consumers", "amortized_fixed_ms"):
        assert record[k] == serial_record[k], k


def _run_both(build, backend="fake", **run_kw):
    """Build and run the same program on both packages; returns {side:
    (result or exception class name, work verdicts, merkle_results,
    dispatches)}."""
    out = {}
    for side, (bls, kzg, sp, guard, _) in SIDES.items():
        program, work = build(side, bls, kzg, sp)
        kw = dict(run_kw, device="cpu") if side == "port" else dict(run_kw)
        try:
            ok, record = program.run(backend=backend, **kw)
            result = (ok, None if record is None else {k: record.get(k) for k in ("lanes", "live")})
        except Exception as exc:
            result = type(exc).__name__
        out[side] = (result, work.verdicts if work else None, program.merkle_results,
                     guard.stats()["dispatches"])
    return out


def _full(side, bls, kzg, sp, **settle_kw):
    work = _settle(kzg, settle_kw.pop("backend", "fake"), **settle_kw)
    queries, roots = _merkle()
    program = (sp.SlotProgram(seed=SEED).add_settle(work)
               .add_signatures(_sets(bls), consumer="gossip_single")
               .add_merkle(queries, roots, consumer="bench"))
    return program, work


CASES = {
    "full": _full,
    "settle_only": lambda side, bls, kzg, sp: (lambda w: (sp.SlotProgram(seed=SEED).add_settle(w), w))(
        _settle(kzg, "fake")),
    "malformed_commitment": lambda side, bls, kzg, sp: _full(side, bls, kzg, sp, backend="ref",
                                                             malformed=True),
    "tampered_blob": lambda side, bls, kzg, sp: _full(side, bls, kzg, sp, backend="ref",
                                                      tamper=True),
    "merkle_only": lambda side, bls, kzg, sp: (
        sp.SlotProgram(seed=SEED).add_merkle(*_merkle(), consumer="bench"), None),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_structure_matches_the_reference_on_fake(case):
    out = _run_both(CASES[case])
    assert out["port"] == out["ref"]
    result, verdicts, merkle, dispatches = out["port"]
    assert dispatches == 1
    want = {"full": ((False, {"lanes": None, "live": 2}), [True], [[True, False]]),
            "settle_only": ((True, None), [True], []),
            "malformed_commitment": ((False, {"lanes": None, "live": 2}), ["error"], [[True, False]]),
            "tampered_blob": ((False, {"lanes": None, "live": 2}), [False], [[True, False]]),
            "merkle_only": ((False, None), None, [[True, False]])}[case]
    assert (result, verdicts, merkle) == want


def test_program_assembly_matches_the_reference():
    for bls, kzg, sp, *_ in SIDES.values():
        p = sp.SlotProgram(seed=1)
        assert p.empty and p.total_live() == 0
        p.add_signatures([], consumer="oppool").add_merkle([], [])
        assert p.empty
        queries, roots = _merkle()
        p.add_settle(_settle(kzg, "fake")).add_signatures(_sets(bls, 3), "oppool")
        p.add_merkle(queries, roots)
        assert not p.empty and p.total_live() == 3 + 2 + 2
        assert p.merkle_segments[0][2] == "bench"


def test_flip_flips_the_settle_and_merkle_verdicts():
    """Canary off, a flip armed on the bls plane: every verdict the program
    produces goes through the plan -- the settle's, each query's and the
    group's -- on both packages alike."""
    for guard, injector in ((RGUARD, RINJECTOR), (PGUARD, PINJECTOR)):
        guard.configure(watchdog=False, canary="off")
        injector.arm("flip", "bls", rate=1.0, seed=9)
    out = _run_both(_full)
    assert out["port"] == out["ref"]
    # the fold's True flipped to False, the queries' [True, False] to [False, True]
    assert out["port"][:3] == ((False, {"lanes": None, "live": 2}), [False], [[False, True]])


@pytest.mark.parametrize("kind, exc", [("stall", pexec.DeviceStallInjected),
                                       ("error", pexec.DeviceErrorInjected)])
def test_faults_reach_the_caller_with_the_work_undelivered(kind, exc):
    PGUARD.configure(watchdog=False, canary="off")
    PINJECTOR.arm(kind, "bls", rate=1.0, seed=1)
    program, work = _full("port", pbls, pkzg, psp)
    with pytest.raises(exc):
        program.run(backend="fake", device="cpu")
    assert work.verdicts == [] and program.merkle_results == []
    assert PGUARD.stats()["faults"] == {f"bls:{kind}": 1}


def test_flip_under_the_canary_raises_before_any_verdict():
    """Canary auto with an armed injector: the sentinel pair is checked
    first inside the attempt, comes back flipped, and the plane is
    quarantined before a settle or Merkle verdict escapes."""
    PGUARD.configure(watchdog=False)
    PINJECTOR.arm("flip", "bls", rate=1.0, seed=9)
    program, work = _full("port", pbls, pkzg, psp)
    with pytest.raises(pexec.CanaryViolation):
        program.run(backend="fake", device="cpu")
    assert work.verdicts == [] and program.merkle_results == []
    assert PGUARD.breaker.snapshot().get("bls/*") == "open"
