"""The port's slice as a whole on device="cpu": bls.api.verify_signature_sets
through the gpu backend (host marshalling, then the plain versions of the
kernels) in the flat and the message-grouped layout, against the JAX
package's `ref` backend and the port's own. Negative probes (a forged
signature, a wrong key, an infinity or non-subgroup signature, an empty
batch) are rejected by all three, and a pubkey table carried across from
the JAX package with `from_jax_rows` gives the same verdicts."""

import numpy as np
import pytest
import torch

from lighthouse_tpu.bls import api as japi
from lighthouse_tpu.bls.device_pubkey_table import DevicePubkeyTable as JaxTable
from lighthouse_tpu_torch import testing as T
from lighthouse_tpu_torch.bls import api, gpu_backend
from lighthouse_tpu_torch.bls.device_pubkey_table import DevicePubkeyTable
from lighthouse_tpu_torch.bls.hash_to_curve import hash_to_field_fp2, iso_map, map_to_curve_sswu
from lighthouse_tpu_torch.crypto.ref_curve import G2 as RG2

torch.set_num_threads(1)

N_VALIDATORS = 8


def _jax_sets(sets):
    """The same sets as the JAX package's api objects (same point ints)."""
    return [
        japi.SignatureSet(
            japi.Signature(s.signature.point),
            [japi.PublicKey(p.point) for p in s.pubkeys],
            s.message,
        )
        for s in sets
    ]


def _verdicts(sets, seed=1):
    """(port gpu backend on the CPU, port ref, JAX ref)."""
    return (
        api.verify_signature_sets(sets, seed=seed, device="cpu"),
        api.verify_signature_sets(sets, backend="ref"),
        japi.verify_signature_sets(_jax_sets(sets), backend="ref"),
    )


def _flat():
    return T.flat_sets(T.validator_pubkeys(N_VALIDATORS), 3, max_keys=2, seed=1)


def _jax_table_pubkeys():
    """Validator keys registered in a port table carried across from a JAX
    DevicePubkeyTable's rows (`from_jax_rows`), so batches of them take the
    indexed (gather) path."""
    jt = JaxTable()
    jt.append([japi.PublicKey(p.point) for p in T.validator_pubkeys(N_VALIDATORS)])
    x, y = (np.asarray(r) for r in jt.rows())
    assert x.shape[0] > jt.count + 1  # padded capacity rows are dropped
    table = DevicePubkeyTable.from_jax_rows(x, y, jt.count, device="cpu")
    pubkeys = T.validator_pubkeys(N_VALIDATORS)
    table.tag(pubkeys)
    return pubkeys


@pytest.mark.parametrize("probe", ["valid", "forged"])
def test_flat_layout(probe):
    """Distinct messages, 1-2 untagged keys a set: the point path."""
    sets = _flat()
    if probe == "forged":
        sets = T.forge(sets, 1)
    assert max(len(s.pubkeys) for s in sets) == 2
    want = probe == "valid"
    assert _verdicts(sets) == (want, want, want)
    stats = gpu_backend.LAST_HOST_STATS
    assert stats["grouped"] is False and stats["indexed_path"] is False


def test_ladder_form_keeps_the_verdict():
    """K1's per-bit chain body (`ladder="chain"`) verifies the valid flat
    batch of test_flat_layout, as the window body does; the 2-bit body
    fails the forged flat batch of test_torch_individual.py. chip_smoke.py
    holds both bodies on a valid and a forged 1,024-set batch on the card;
    here each plain end-to-end run costs ~3 s of CPU."""
    assert api.verify_signature_sets(_flat(), seed=1, device="cpu", ladder="chain") is True


@pytest.mark.parametrize("probe", ["valid", "forged", "wrong_key"])
def test_grouped_layout(probe):
    """Two committees of two sets. Valid and forged batches go through the
    indexed path of a table carried across from the JAX package; a wrong
    key (another validator's, untagged) also sends the batch down the
    point path."""
    sets = T.committee_sets(_jax_table_pubkeys(), 2, 2, seed=2)
    if probe == "forged":
        sets = T.forge(sets, 0)
    elif probe == "wrong_key":
        other = T.validator_pubkeys(N_VALIDATORS + 1)[-1]
        sets[2] = api.SignatureSet(sets[2].signature, [other], sets[2].message)
    want = probe == "valid"
    assert _verdicts(sets) == (want, want, want)
    stats = gpu_backend.LAST_HOST_STATS
    assert stats["grouped"] is True and stats["n_groups"] == 2
    assert stats["indexed_path"] is (probe != "wrong_key")


def test_from_jax_rows_matches_append():
    pubkeys = T.validator_pubkeys(N_VALIDATORS)
    jt = JaxTable()
    jt.append([japi.PublicKey(p.point) for p in pubkeys])
    carried = DevicePubkeyTable.from_jax_rows(*(np.asarray(r) for r in jt.rows()), jt.count, "cpu")
    native = DevicePubkeyTable("cpu")
    native.append(T.validator_pubkeys(N_VALIDATORS))
    assert carried.count == native.count == N_VALIDATORS
    for a, b in zip(carried.rows(), native.rows()):
        assert torch.equal(a, b)
    assert not carried.rows()[0][0].any()  # row 0 stays the zero row


def _non_subgroup_point():
    """A point of E'(Fp2) off the r-torsion: the isogeny image of one
    simplified-SWU output, before cofactor clearing."""
    u0, _ = hash_to_field_fp2(b"not in G2", 2)
    pt = RG2.from_affine(iso_map(map_to_curve_sswu(u0)))
    assert RG2.is_on_curve(pt) and not RG2.in_subgroup(pt)
    return pt


@pytest.mark.parametrize("probe", ["infinity", "non_subgroup"])
def test_bad_signature_fails_the_batch(probe):
    """The host policy rejects the batch before any device work."""
    sets = _flat()
    point = RG2.infinity if probe == "infinity" else _non_subgroup_point()
    s = sets[1]
    sets[1] = api.SignatureSet(api.Signature(point), s.pubkeys, s.message)
    calls = gpu_backend.CALL_COUNTS["batch"]
    assert _verdicts(sets) == (False, False, False)
    assert gpu_backend.CALL_COUNTS["batch"] == calls


def test_keys_and_signatures_match_jax():
    """SecretKey -> PublicKey / Signature, their compressed bytes and the
    decode path agree with the JAX package's api; the set verifies."""
    msg = b"port key round trip"
    sk, jsk = api.SecretKey(123456789), japi.SecretKey(123456789)
    pk, sig = sk.public_key(), sk.sign(msg)
    assert pk.to_bytes() == jsk.public_key().to_bytes()
    assert sig.to_bytes() == jsk.sign(msg).to_bytes()
    pk2 = api.PublicKey.from_bytes(pk.to_bytes())
    sig2 = api.Signature.from_bytes(sig.to_bytes())
    assert api.verify_signature_sets([api.SignatureSet(sig2, [pk2], msg)], backend="ref")
    with pytest.raises(api.BlsError):
        api.SecretKey(0)


def test_empty_batch_fails():
    assert api.verify_signature_sets([], device="cpu") is False
    assert api.verify_signature_sets([], backend="ref") is False
    assert japi.verify_signature_sets([], backend="ref") is False


@pytest.mark.parametrize(
    "n_sets, n_msgs, grouped",
    [(4, 2, True), (4, 3, False), (8, 4, True), (8, 1, True), (3, 3, False), (1, 1, False)],
)
def test_group_plan(n_sets, n_msgs, grouped):
    """Grouping pays only when it at least halves the pairs (G * 2 <= S)."""
    sets = [
        api.SignatureSet(None, [None], T.message("plan", i % n_msgs, 0)) for i in range(n_sets)
    ]
    plan = gpu_backend._group_plan(sets)
    assert (plan is not None) == grouped
    if plan is not None:
        assert [ix for _, ix in plan] == [list(range(g, n_sets, n_msgs)) for g in range(n_msgs)]


@pytest.mark.parametrize("n, minimum, want", [(1, 4, 4), (4, 4, 4), (5, 4, 8), (30720, 4, 32768), (3, 1, 4)])
def test_bucket(n, minimum, want):
    assert gpu_backend._bucket(n, minimum) == want


def test_marshal_grouped_shapes():
    sets = T.committee_sets(T.validator_pubkeys(N_VALIDATORS), 2, 2, seed=2)
    m = gpu_backend._marshal(sets)
    assert m.grouped and m.n_groups == 2
    assert m.set_mask.shape == (2, 2) and m.set_mask.all()
    assert m.key_mask.shape == (2, 2, 1)
    assert m.sigs[0].shape == (2, 2, 2, 12) and m.msgs[0].shape == (2, 2, 12)
    assert m.pubkeys[0].shape == (2, 2, 1, 1, 12)


def test_marshal_flat_pads_to_bucket():
    sets = _flat()
    m = gpu_backend._marshal(sets)
    assert not m.grouped and m.s_bucket == 4 and m.k_bucket == 2
    assert m.set_mask.tolist() == [True, True, True, False]
    assert m.key_mask.shape == (4, 2) and not m.key_mask[3].any()
    # a padding lane carries no signature: zero words, masked
    assert not m.sigs[0][3].any() and not m.sigs[1][3].any()


def test_rlc_scalars_seeded_and_nonzero():
    a = gpu_backend._rlc_scalars(64, seed=5)
    assert np.array_equal(a, gpu_backend._rlc_scalars(64, seed=5))
    assert a.dtype == np.uint64 and (a > 0).all()
    fresh = gpu_backend._rlc_scalars(64, seed=None)
    assert (fresh > 0).all()
    bits = gpu_backend._scalar_bits(a)
    assert bits.shape == (64, 64)
    back = (bits.astype(np.uint64) << np.arange(64, dtype=np.uint64)).sum(axis=1, dtype=np.uint64)
    assert np.array_equal(back, a)
