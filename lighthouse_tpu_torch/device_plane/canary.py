"""Known-answer sentinel material for canary-verified device batches.

The port of `lighthouse_tpu/device_plane/canary.py`, on its three planes:
`bls`, `kzg` and `merkle_proof`. The only way to catch a card that
COMPLETES but LIES is to keep asking it questions whose answers are known:
one sentinel that must verify and one that must not. The port keeps its
own copy of the reference's committed pairs beside this module: the bls
pair (`tests/vectors/sentinel/bls/{valid,invalid}.json`, interop keypair 0
over a fixed message, the invalid one with a tampered message) in
`sentinel_bls.json`, the kzg pair
(`tests/vectors/sentinel/kzg/{valid,invalid}.json`, a 4-element blob with
its commitment and proof, the invalid one with a tampered blob) in
`sentinel_kzg.json`, and the merkle_proof pair
(`tests/vectors/sentinel/merkle_proof/{valid,invalid}.json`, a depth-3
branch at gindex 11, the invalid one with its root's first byte flipped)
in `sentinel_merkle_proof.json`. Two uses:

  * the verification bus splices the VALID sentinel into every canaried
    shared batch (an attribution-free extra set) and checks the
    (valid, invalid) PAIR per set inside the same guarded attempt
    (`check_pair`): on the card that is K2, then K3's per-set entry. A
    batch verdict can only be trusted if the pair comes back exactly
    (True, False): a flipped or stuck verdict plane fails that check,
    raises `CanaryViolation` and quarantines the plane;
  * the startup self-test (`GUARD.self_test`) runs `self_test_plane`
    against the host oracle on each plane, so a node never goes live
    with corrupt sentinel material or a broken oracle path.
"""

import json
import os
import threading

from lighthouse_tpu_torch.device_plane.executor import (
    NULL_PLAN,
    CanaryViolation,
)

PLANES = ("bls", "kzg", "merkle_proof")

_HERE = os.path.dirname(os.path.abspath(__file__))
SENTINEL_FILE = os.path.join(_HERE, "sentinel_bls.json")
KZG_SENTINEL_FILE = os.path.join(_HERE, "sentinel_kzg.json")
MERKLE_SENTINEL_FILE = os.path.join(_HERE, "sentinel_merkle_proof.json")

_lock = threading.Lock()
_bls_sets: tuple | None = None


def bls_vectors() -> dict:
    """{"valid": case, "invalid": case}, each {"pubkeys", "message",
    "signature"} as hex, as the reference commits them."""
    with open(SENTINEL_FILE) as f:
        return json.load(f)


def kzg_vectors() -> dict:
    """{"valid": case, "invalid": case}, each {"blob", "commitment",
    "proof"} as hex, as the reference commits them."""
    with open(KZG_SENTINEL_FILE) as f:
        return json.load(f)


def merkle_vectors() -> dict:
    """{"valid": case, "invalid": case}, each {"leaf", "branch" (hex
    lists), "gindex", "root"}, as the reference commits them."""
    with open(MERKLE_SENTINEL_FILE) as f:
        return json.load(f)


def bls_sentinels() -> tuple:
    """(valid_set, invalid_set) as `SignatureSet`s — the valid one is
    spliced into canaried shared batches, the pair feeds `check_pair`."""
    global _bls_sets
    with _lock:
        if _bls_sets is not None:
            return _bls_sets
    from lighthouse_tpu_torch import bls

    cases = bls_vectors()
    sets = tuple(
        bls.SignatureSet(
            bls.Signature.from_bytes(bytes.fromhex(cases[name]["signature"])),
            [bls.PublicKey.from_bytes(bytes.fromhex(p)) for p in cases[name]["pubkeys"]],
            bytes.fromhex(cases[name]["message"]),
        )
        for name in ("valid", "invalid")
    )
    with _lock:
        _bls_sets = sets
    return _bls_sets


def riding_sentinel(sets):
    """The valid sentinel as it rides a shared batch of `sets`: where every
    key of the batch lies in one `DevicePubkeyTable`, its key is that
    table's extra row (`DevicePubkeyTable.extra`), so the batch keeps the
    table path on the card; else the sentinel as it is."""
    valid = bls_sentinels()[0]
    table = None
    for s in sets:
        for p in s.pubkeys:
            if p.table is None or (table is not None and p.table is not table):
                return valid
            table = p.table
    if table is None:
        return valid
    from lighthouse_tpu_torch import bls

    return bls.SignatureSet(valid.signature, [table.extra(p) for p in valid.pubkeys], valid.message)


def check_pair(backend: str, plan=NULL_PLAN, device="cuda") -> list:
    """Verify the (valid, invalid) sentinel pair per set on `backend`,
    verdicts routed through the dispatch's injection plan (so an
    injected flip flips the canary too — by construction every flip is
    caught). Anything but exactly [True, False] raises `CanaryViolation`;
    returns the verdicts.

    On "gpu" this is one extra per-set device call per canaried batch
    (`verify_signature_sets_gpu_individual` on `device`: K2, then K3's
    per-set entry) — the price of catching FALSE-ACCEPTS, which the
    batch-riding valid sentinel cannot see. Sentinel sets stay out of
    the consumers' attribution (no note_sets, no journal n_sets)."""
    valid, invalid = bls_sentinels()
    if backend == "gpu":
        from lighthouse_tpu_torch.bls.gpu_backend import verify_signature_sets_gpu_individual

        verdicts = [
            bool(v)
            for v in verify_signature_sets_gpu_individual(
                [valid, invalid], device=device, consumer="bench"
            )
        ]
    else:
        from lighthouse_tpu_torch.bls.api import _verify_one_ref

        verdicts = [_verify_one_ref(valid), _verify_one_ref(invalid)]
    verdicts = list(plan.verdict(verdicts))
    if verdicts != [True, False]:
        raise CanaryViolation(
            f"bls sentinel pair came back {verdicts} on backend "
            f"{backend!r} (expected [True, False]) — the device plane "
            "is producing wrong verdicts"
        )
    return verdicts


def self_test_plane(plane: str) -> bool:
    """Host-oracle known-answer check for one plane: the valid sentinel
    must pass, the invalid one must fail."""
    if plane == "bls":
        from lighthouse_tpu_torch.bls.api import _verify_one_ref

        valid, invalid = bls_sentinels()
        return _verify_one_ref(valid) and not _verify_one_ref(invalid)
    if plane == "kzg":
        from lighthouse_tpu_torch.kzg.api import verify_blob_kzg_proof

        ok = True
        for name, want in (("valid", True), ("invalid", False)):
            case = kzg_vectors()[name]
            got = verify_blob_kzg_proof(
                bytes.fromhex(case["blob"]),
                bytes.fromhex(case["commitment"]),
                bytes.fromhex(case["proof"]),
            )
            ok = ok and (got is want)
        return ok
    if plane == "merkle_proof":
        from lighthouse_tpu_torch.ops.merkle_proof import fold_branches_host

        ok = True
        for name, want in (("valid", True), ("invalid", False)):
            case = merkle_vectors()[name]
            computed = fold_branches_host(
                [(bytes.fromhex(case["leaf"]), [bytes.fromhex(b) for b in case["branch"]],
                  int(case["gindex"]))]
            )[0]
            ok = ok and ((computed == bytes.fromhex(case["root"])) is want)
        return ok
    raise ValueError(f"no self-test for plane {plane!r} in the port (planes: {PLANES})")
