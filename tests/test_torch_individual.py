"""The port's per-set verdicts after a failed batch on device="cpu":
bls.api.verify_signature_sets_individually through the gpu backend (the
signature policy per set, flat unpadded marshalling, 2 S Miller pairs and
K3's per-set entry, as plain versions) against the JAX package's `ref`
backend, with the reference client's rule that a failed batch plus the
per-set call costs exactly two device calls."""

import numpy as np
import pytest
import torch

from lighthouse_tpu.bls import api as japi
from lighthouse_tpu_torch import testing as T
from lighthouse_tpu_torch.bls import api, gpu_backend
from lighthouse_tpu_torch.bls.device_pubkey_table import DevicePubkeyTable
from lighthouse_tpu_torch.ops import batch_verify, field as fd
from lighthouse_tpu_torch.crypto.ref_curve import G2 as RG2

torch.set_num_threads(1)


def _jax_sets(sets):
    return [
        japi.SignatureSet(
            japi.Signature(s.signature.point),
            [japi.PublicKey(p.point) for p in s.pubkeys],
            s.message,
        )
        for s in sets
    ]


def _non_subgroup_signature():
    """A point of E'(Fp2) off the r-torsion (the isogeny image of one
    simplified-SWU output, before cofactor clearing)."""
    from lighthouse_tpu_torch.bls.hash_to_curve import hash_to_field_fp2, iso_map, map_to_curve_sswu

    u0, _ = hash_to_field_fp2(b"not in G2", 2)
    pt = RG2.from_affine(iso_map(map_to_curve_sswu(u0)))
    assert RG2.is_on_curve(pt) and not RG2.in_subgroup(pt)
    return api.Signature(pt)


def _committee_with_bad_sets():
    """Two committees of two single-key sets, keys in a table (the indexed
    path): set 1 forged, set 2 claims another message."""
    keys = T.validator_pubkeys(4)
    DevicePubkeyTable("cpu").append(keys)
    sets = T.forge(T.committee_sets(keys, 2, 2, seed=3), 1)
    sets[2] = api.SignatureSet(sets[2].signature, sets[2].pubkeys, b"wrong message")
    return sets


def test_failed_batch_then_per_set_verdicts_in_two_device_calls():
    """The batch (flat: three messages over four sets) fails through K1's
    2-bit body, `ladder="w2"` -- that body's verdict on a forged flat batch
    -- and the per-set call flags exactly the two bad sets."""
    sets = _committee_with_bad_sets()
    gpu_backend.CALL_COUNTS.update(batch=0, individual=0)
    assert api.verify_signature_sets(sets, seed=3, device="cpu", ladder="w2") is False
    assert gpu_backend.LAST_HOST_STATS["grouped"] is False
    verdicts = api.verify_signature_sets_individually(sets, device="cpu")
    assert gpu_backend.CALL_COUNTS["batch"] + gpu_backend.CALL_COUNTS["individual"] == 2
    assert verdicts == [True, False, False, True]
    assert verdicts == japi.verify_signature_sets_individually(_jax_sets(sets), backend="ref")
    stats = gpu_backend.LAST_HOST_STATS
    assert stats["individual"] and stats["indexed_path"] and not stats["grouped"]


def test_bad_signatures_never_reach_the_device():
    """An infinity or non-subgroup signature is False for its set on the
    host, as in the JAX package's ref backend; with no live set there is
    no device call."""
    good = T.flat_sets(T.validator_pubkeys(2), 1, max_keys=1, seed=4)[0]
    sets = [
        api.SignatureSet(api.Signature(RG2.infinity), good.pubkeys, good.message),
        api.SignatureSet(_non_subgroup_signature(), good.pubkeys, good.message),
    ]
    calls = gpu_backend.CALL_COUNTS["individual"]
    assert api.verify_signature_sets_individually(sets, device="cpu") == [False, False]
    assert gpu_backend.CALL_COUNTS["individual"] == calls
    assert japi.verify_signature_sets_individually(_jax_sets(sets), backend="ref") == [False, False]


def test_live_sets_map_back_to_their_positions(monkeypatch):
    """Only the sets that pass the policy go to the device, flat and
    unpadded, and their verdicts land at their own positions."""
    sets = T.flat_sets(T.validator_pubkeys(4), 3, max_keys=2, seed=5)
    sets.insert(1, api.SignatureSet(api.Signature(RG2.infinity), sets[0].pubkeys, b"m"))
    seen = {}

    def device_call(msgs, sigs, pubkeys, key_mask, set_mask, device):
        seen["shape"] = tuple(key_mask.shape)
        seen["set_mask"] = set_mask.tolist()
        return torch.tensor([True, False, True])

    monkeypatch.setattr(batch_verify, "verify_signature_sets_individual", device_call)
    assert api.verify_signature_sets_individually(sets, device="cpu") == [True, False, False, True]
    assert seen["shape"][0] == 3 and seen["set_mask"] == [True, True, True]


def test_empty_input_gives_an_empty_list():
    assert api.verify_signature_sets_individually([], device="cpu") == []
    assert api.verify_signature_sets_individually([], backend="ref") == []
    assert japi.verify_signature_sets_individually([], backend="ref") == []


def test_unknown_backend_raises():
    with pytest.raises(api.BlsError, match="unknown BLS backend"):
        api.verify_signature_sets_individually(_committee_with_bad_sets(), backend="tpu")


@pytest.mark.parametrize("n_sets", [1, 3, 4, 5])
def test_per_set_marshalling_is_flat_and_unpadded(n_sets):
    """The per-set path lays out exactly one lane per set (no power-of-two
    bucket), keys padded to a power of two; the batch path pads lanes."""
    sets = T.flat_sets(T.validator_pubkeys(4), n_sets, max_keys=3, seed=6)
    m = gpu_backend._marshal_flat(sets, pow2=False)
    k = m.k_bucket
    assert not m.grouped and m.s_bucket == n_sets and m.set_mask.all()
    assert m.sigs[0].shape == m.msgs[0].shape == (n_sets, 2, fd.NW)
    assert m.pubkeys[0].shape == (n_sets, k, 1, fd.NW) and m.key_mask.shape == (n_sets, k)
    assert k & (k - 1) == 0 and m.key_mask.sum() == sum(len(s.pubkeys) for s in sets)
    assert gpu_backend._marshal_flat(sets).s_bucket == max(4, 1 << (n_sets - 1).bit_length())


def test_individual_pairs_masks():
    """2 S pairs: (agg_pk_i, H_i) masked by set & ~(agg_pk_i is the
    identity), then (-G1, sig_i) masked by set; a padding set is masked in
    both."""
    sets = T.flat_sets(T.validator_pubkeys(4), 3, max_keys=1, seed=7)
    m = gpu_backend._marshal_flat(sets)  # 4 lanes, the last one padding
    key_mask = m.key_mask.copy()
    key_mask[1] = False  # set 1's aggregate key is the identity
    g1, g2, mask, sm = batch_verify._individual_pairs(
        m.msgs, m.sigs, m.pubkeys, key_mask, m.set_mask, device="cpu"
    )
    assert mask.tolist() == [True, False, True, False, True, True, True, False]
    assert sm.tolist() == [True, True, True, False]
    assert g1[0].shape == (1, fd.NW, 8) and g2[0].shape == (2, fd.NW, 8)
    neg_x, neg_y = (np.asarray(c) for c in batch_verify.NEG_G1_AFFINE)
    assert (g1[0][0, :, 4:].numpy().T == neg_x).all() and (g1[1][0, :, 4:].numpy().T == neg_y).all()
    assert np.array_equal(g2[0][..., 4:].permute(2, 0, 1).numpy(), m.sigs[0])


@pytest.mark.parametrize("form, rows", [("window", 17), ("chain", 64), ("w2", 64)])
def test_batch_digits_per_ladder_form(form, rows):
    """One RLC operand per batch for K1: window-major signed digits and
    signs for "window", the (64, N) LSB-first bits for "chain" and "w2"."""
    bits = gpu_backend._scalar_bits(gpu_backend._rlc_scalars(4, seed=8))
    ops = batch_verify._digits(bits, "cpu", form)
    assert len(ops) == (2 if form == "window" else 1)
    assert all(o.shape == (rows, 4) and o.dtype == torch.int32 and o.is_contiguous() for o in ops)
    if form != "window":
        assert np.array_equal(ops[0].numpy(), bits.T)
