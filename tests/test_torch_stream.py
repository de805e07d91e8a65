"""Streamed batches through the port's gpu backend on the CPU
(`bls.verify_signature_set_batches`, `gpu_backend.verify_signature_set_batches_gpu`)
against the reference's verdicts on its "ref" backend: a valid batch, an
empty one, one with a forged signature and one with a signature outside
the subgroup. The loop launches batch N+1 before it reads batch N's
verdict; on the CPU the overlap is absent but the order is the same, and
the launch half hands back an unread 0-d tensor. Two plain verifies in
all (~3 s each).
"""

import torch

import lighthouse_tpu.bls as rbls
import lighthouse_tpu_torch.bls as pbls
from lighthouse_tpu_torch.bls import gpu_backend
from lighthouse_tpu_torch.bls.hash_to_curve import hash_to_field_fp2, iso_map, map_to_curve_sswu
from lighthouse_tpu_torch.common.events_journal import Journal
from lighthouse_tpu_torch.common.metrics import REGISTRY
from lighthouse_tpu_torch.crypto.ref_curve import G2 as RG2


def _batches():
    kps = [pbls.Keypair(pbls.SecretKey.from_bytes((2000 + i).to_bytes(32, "big"))) for i in range(4)]

    def batch(tag):
        return [pbls.SignatureSet(kp.sk.sign(tag + bytes([i])), [kp.pk], tag + bytes([i]))
                for i, kp in enumerate(kps)]

    valid, forged, outside = batch(b"valid"), batch(b"forged"), batch(b"outside")
    # a signature of another message by the right key: in the subgroup, wrong
    forged[0] = pbls.SignatureSet(kps[0].sk.sign(b"other"), [kps[0].pk], forged[0].message)
    sswu = RG2.from_affine(iso_map(map_to_curve_sswu(hash_to_field_fp2(b"outside", 1)[0])))
    outside[2] = pbls.SignatureSet(pbls.Signature(sswu), [kps[2].pk], outside[2].message)
    return [valid, [], forged, outside]


def _to_reference(batches):
    return [[rbls.SignatureSet(rbls.Signature.from_bytes(s.signature.to_bytes()),
                               [rbls.PublicKey.from_bytes(p.to_bytes()) for p in s.pubkeys], s.message)
             for s in b] for b in batches]


def test_streamed_batches_match_the_reference(monkeypatch):
    batches = _batches()
    log = []
    launch, read_later, scalars = gpu_backend._launch, gpu_backend._read_later, gpu_backend._rlc_scalars

    def logged_launch(m, rand_bits, device, ladder="window"):
        log.append(("launch", m.s_bucket))
        return launch(m, rand_bits, device, ladder)

    def logged_read_later(ok):
        log.append(("queued", type(ok).__name__, ok.dim(), ok.dtype))
        read = read_later(ok)

        def logged_read():
            log.append(("read", len([e for e in log if e[0] == "read"])))
            return read()

        return logged_read

    def logged_scalars(n, seed):
        log.append(("seed", seed))
        return scalars(n, seed)

    monkeypatch.setattr(gpu_backend, "_launch", logged_launch)
    monkeypatch.setattr(gpu_backend, "_read_later", logged_read_later)
    monkeypatch.setattr(gpu_backend, "_rlc_scalars", logged_scalars)
    calls = gpu_backend.CALL_COUNTS["batch"]
    key = ("oppool", "bls", "4")
    before = REGISTRY.get_value("lighthouse_tpu_device_batches_total", key)
    journal = Journal()
    got = pbls.verify_signature_set_batches(batches, seed=7, device="cpu", backend="gpu",
                                            consumer="oppool", journal=journal, slot=3)
    want = rbls.verify_signature_set_batches(_to_reference(batches), backend="ref")
    assert got == want == [True, False, False, False]
    # two dispatches: the empty batch and the non-subgroup one never launch
    assert gpu_backend.CALL_COUNTS["batch"] - calls == 2
    # batch 2 is launched before batch 0's verdict is read; what a launch
    # hands over is an unread 0-d bool tensor
    queued = ("queued", "Tensor", 0, torch.bool)
    assert log == [("seed", 7), ("launch", 4), queued, ("seed", 9), ("launch", 4), queued,
                   ("read", 0), ("read", 1)]
    stats = gpu_backend.LAST_STREAM_STATS
    assert set(stats) == {"batches", "dispatched", "host_marshal_ms", "wall_ms"}
    assert (stats["batches"], stats["dispatched"]) == (4, 2) and stats["wall_ms"] >= stats["host_marshal_ms"]
    assert REGISTRY.get_value("lighthouse_tpu_device_batches_total", key) - before == 2
    events = journal.query(kind="signature_batch")
    assert [(e["outcome"], e["attrs"]["n_sets"], e["attrs"]["streamed"]) for e in events] == [
        ("ok", 4, True), ("failed", 4, True), ("failed", 4, True)]
