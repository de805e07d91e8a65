"""The port's KZG slice (`lighthouse_tpu_torch/kzg`, `ops/kzg_verify.py`,
`ops/msm.py`) against the reference's host code (`lighthouse_tpu.kzg.api`,
which imports no JAX) and the committed vectors, on the CPU:

* the dev trusted setup, [tau]G2 and the window tables equal the
  reference's;
* the "ref" and "fake" backends reproduce every committed vector and the
  reference's own backends; the "gpu" backend, on CPU tensors (the
  kernels' plain versions), gives byte-equal commitments and proofs and
  equal verdicts: n = 1, an empty batch, a batch, a tampered blob, a wrong
  commitment or proof, swapped proofs;
* the two G1 pair points of `ops/kzg_verify` equal the reference's host
  fold, both MSMs equal the host Pippenger oracle on the committed edges,
  and K1's plain window ladder at 255 bits equals `ref_curve.mul_scalar`;
* the seeded fault kinds on the `kzg` and `msm` planes raise their
  classes before any device work, with no fallback, and a flip comes back
  flipped; so does the signature subgroup check, which now crosses the
  guard too;
* the kzg sentinel pair is the committed one and its self-test passes.

A plain version's cost on the CPU grows with its tensor operations and
with its lanes: a plain verify costs ~2.5 s, a plain fixed-base MSM ~2 s,
most of it K1 at 64 windows (on 64 Horner lanes for an MSM). The cases
below therefore share their plain device passes where they can: the
single-proof verdicts, the swapped batch and the three-vector batch of
the pair-point check (`_verify_pass`), the variable-base MSM vectors
with K1's edge lanes (`_k1_pass`), and the blob commitments with the
one-scalar MSM (`_fixed_pass`), each a case's lanes side by side in one
K1 call, then folded on their own. Each backend entry point still runs
its plain device path once in full: a batch verify
(`test_verify_valid_batch_gpu`), a fixed-base MSM (the proof and the edge
scalars) and a variable-base MSM (`single_point`). The JAX graphs are held
against the port in tests/test_torch_parity_slow.py.
"""

import functools
import json
import os

import numpy as np
import pytest
import torch

from lighthouse_tpu.bls.point_serde import g1_compress as r_compress
from lighthouse_tpu.crypto.ref_curve import G1 as RG1
from lighthouse_tpu.device_plane import canary as rcanary
from lighthouse_tpu.kzg import api as rapi
from lighthouse_tpu.kzg import trusted_setup as rts
from lighthouse_tpu.ops import window_ladder as jwl
from lighthouse_tpu_torch import bls as pbls
from lighthouse_tpu_torch import kzg
from lighthouse_tpu_torch.bls import gpu_backend as bls_gpu
from lighthouse_tpu_torch.bls.point_serde import g1_compress
from lighthouse_tpu_torch.crypto.constants import R
from lighthouse_tpu_torch.crypto.ref_curve import G1
from lighthouse_tpu_torch.device_plane import GUARD, INJECTOR, canary, executor
from lighthouse_tpu_torch.kzg import api, gpu_backend, trusted_setup
from lighthouse_tpu_torch.ops import cuda_build, curve_kernels, field as fd
from lighthouse_tpu_torch.ops import batch_verify as bv
from lighthouse_tpu_torch.ops import final_exp, kzg_verify, ladder, ladder_rows, miller, msm
from lighthouse_tpu_torch.ops import subgroup
from lighthouse_tpu_torch.ops import window_ladder as wl

torch.set_num_threads(1)

VECTORS = os.path.join(os.path.dirname(__file__), "vectors")


def _load(handler):
    d = os.path.join(VECTORS, "kzg", handler)
    out = {}
    for name in sorted(os.listdir(d)):
        with open(os.path.join(d, name)) as f:
            out[name[:-5]] = json.load(f)
    return out


def _unhex(s):
    return bytes.fromhex(s[2:])


def _triple(case):
    i = case["input"]
    return _unhex(i["blob"]), _unhex(i["commitment"]), _unhex(i["proof"])


BLOBS = _load("blob_to_commitment")
VERIFY = _load("verify_blob_proof")
MSM_SMALL = {k: v for k, v in _load("msm").items() if len(v["input"]["scalars"]) <= 64}
VALID = [k for k, v in VERIFY.items() if v["output"]]
INVALID = [k for k, v in VERIFY.items() if not v["output"]]
SINGLES = ["valid_0"] + INVALID
# K1's 255-bit edge lanes: 0, 1, r - 1, 2^254, a top-window carry
# (2^255 - 1, not reduced mod r), two random scalars, an identity lane
EDGE_POINTS = [G1.mul_scalar(G1.generator, k) for k in (3, 5, 7, 11, 13, 17, 19)] + [None]
EDGE_SCALARS = [0, 1, R - 1, 2**254, 2**255 - 1, 0xDEADBEEF << 200, 12345678901234567890, 9]


@pytest.fixture
def clean_guard():
    GUARD.reset()
    INJECTOR.reset()
    yield
    GUARD.reset()
    INJECTOR.reset()


# ------------------------------------------------- shared plain passes


def _cat(parts):
    """Projective lane tuples side by side."""
    return tuple(torch.cat(cs, dim=-1) for cs in zip(*parts))


def _lanes_slice(pt, start, n):
    return tuple(c[..., start:start + n].contiguous() for c in pt)


def _affine_lanes(affs):
    x, y, valid = gpu_backend._affine_words(affs)
    return bv._from_affine(bv._lanes(x, "cpu"), bv._lanes(y, "cpu"), bv._mask(valid, "cpu"))


def _digits(scalars):
    mags, negs = wl.signed_digit_arrays(scalars, nbits=msm.SCALAR_BITS)
    return msm.digit_tensors(mags, negs, "cpu")


@functools.cache
def _verify_pass():
    """The gpu backend's verdict of each single-proof vector (seed 5, so
    r = 1), of two valid blobs with their proofs swapped (seed 13) and of
    the first three valid vectors (seed 11, "fold"):
    each case's host half as the backend runs it (`api._batch_inputs`,
    `gpu_backend.verify_lanes`), then the plain device steps of
    `ops/kzg_verify.py` for all cases at once -- their lanes side by side
    in one K1 call at 255 bits, each case's fold (`lane_sum(seg=2b)`) to
    its two pair points, `to_affine`, K2 on every pair against (the G2
    generator, [tau]G2), and K3's per-set entry, which multiplies a case's
    two Miller values before its exponentiation as the fold entry does for
    one case. {case: (verdict, the two affine pair points as int pairs)}."""
    cases = {name: ([_triple(VERIFY[name])], 5) for name in SINGLES}
    two = [_triple(VERIFY[k]) for k in VALID[:2]]
    cases["swapped"] = ([two[0][:2] + (two[1][2],), two[1][:2] + (two[0][2],)], 13)
    cases["fold"] = ([_triple(VERIFY[k]) for k in VALID[:3]], 11)
    affs, scalars, sizes = [], [], []
    for triples, seed in cases.values():
        blobs, comms, proofs = zip(*triples)
        setup, zs, ys, cs, ws = api._batch_inputs(blobs, comms, proofs, None)
        a, sc = gpu_backend.verify_lanes(cs, ws, api._rlc_scalars(len(blobs), seed), zs, ys)
        affs += a
        scalars += sc
        sizes.append(len(a))
    out = ladder.ladder(_affine_lanes(affs), *_digits(scalars))
    sums, start = [], 0
    for n in sizes:
        sums.append(curve_kernels.lane_sum(_lanes_slice(out, start, n), n // 2))
        start += n
    S = len(sums)
    left, right = _cat([_lanes_slice(t, 0, 1) for t in sums]), _cat([_lanes_slice(t, 1, 1) for t in sums])
    px, py, inf = curve_kernels.to_affine(_cat([left, right]))
    tau = [fd.mont_words(c) for c in setup.tau_g2]
    g2 = tuple(torch.from_numpy(np.stack([gen] * S + [t] * S, axis=-1))
               for gen, t in zip(kzg_verify.G2_GEN_AFFINE, tau))
    _, ok = final_exp.pair_final_exp(miller.miller_loop((px, py), g2, ~inf))
    xs, ys = fd.words_from_mont(px[0].t()), fd.words_from_mont(py[0].t())
    return {case: (ok[k].item(), None if inf[k] or inf[S + k] else
                   [(xs[k], ys[k]), (xs[S + k], ys[S + k])])
            for k, case in enumerate(cases)}


def _msm_case(case):
    pts = [None if p is None else (int(p["x"], 16), int(p["y"], 16))
           for p in case["input"]["points"]]
    return pts, [int(s, 16) for s in case["input"]["scalars"]], _unhex(case["output"])


@functools.cache
def _k1_pass():
    """Every small variable-base MSM vector, laid out as `g1_msm_gpu` lays
    it out (points and reduced scalars padded to the power-of-two bucket
    with the identity and 0), and K1's edge lanes, side by side in one
    plain K1 call at 255 bits; each MSM then folded on its own
    (`lane_sum(seg=N)`) and read as the backend reads it. ({name: point},
    the edge lanes' projective words)."""
    affs, scalars, sizes = [], [], {}
    for name, case in MSM_SMALL.items():
        pts, sc, _ = _msm_case(case)
        pad = gpu_backend._bucket(len(sc)) - len(sc)
        affs += pts + [None] * pad
        scalars += [s % R for s in sc] + [0] * pad
        sizes[name] = len(sc) + pad
    affs += [None if p is None else G1.to_affine(p) for p in EDGE_POINTS]
    out = ladder.ladder(_affine_lanes(affs), *_digits(scalars + EDGE_SCALARS))
    points, start = {}, 0
    for name, n in sizes.items():
        points[name] = gpu_backend._read_point(curve_kernels.lane_sum(_lanes_slice(out, start, n), n))
        start += n
    return points, _lanes_slice(out, start, len(EDGE_SCALARS))


@functools.cache
def _fixed_pass():
    """The three blob vectors' commitments and the one-scalar MSM [r - 1]
    P_0, each laid out as `g1_msm_fixed_base_gpu` lays it out (the setup's
    packed table at the bucket, the padded scalars' digits, the selection
    and the fold to the 64 window sums), their Horner ladders side by side
    in one plain K1 call (64 lanes each), each then folded
    (`lane_sum(seg=64)`) and read as the backend reads it. {case: point}."""
    cases = {name: api.blob_to_polynomial(_unhex(case["input"]["blob"]))
             for name, case in BLOBS.items()}
    cases["single"] = [R - 1]
    setup = kzg.dev_setup(8)
    windows, horner = [], []
    for scalars in cases.values():
        bucket = gpu_backend._bucket(len(scalars))
        table = torch.from_numpy(gpu_backend._host_table(setup, bucket))
        mags, negs = _digits([s % R for s in scalars] + [0] * (bucket - len(scalars)))
        windows.append(curve_kernels.lane_sum(msm.select_fixed(table, mags, negs), bucket))
        horner.append(msm.horner_digits(mags.shape[0], "cpu"))
    W = horner[0][0].shape[0]
    acc = ladder.ladder(_cat(windows), *(torch.cat(d, dim=1) for d in zip(*horner)))
    return {name: gpu_backend._read_point(curve_kernels.lane_sum(_lanes_slice(acc, k * W, W), W))
            for k, name in enumerate(cases)}


# ------------------------------------------------------------ trusted setup


def test_dev_setup_matches_reference():
    p, r = trusted_setup.dev_setup(8), rts.dev_setup(8)
    assert trusted_setup.DEV_TAU == rts.DEV_TAU
    assert p.g1_powers == r.g1_powers and p.tau_g2 == r.tau_g2
    assert p.g1_window_table(8, 4) == r.g1_window_table(8, 4)
    assert p.tau_g2_power(2) == r.tau_g2_power(2)
    assert trusted_setup.g1_generator_multiples(5) == rts.g1_generator_multiples(5)
    assert trusted_setup.dev_setup(8) is p  # cached


def test_meta_setup_vector():
    meta = _load("meta")["setup"]
    assert meta["dev_secret_seed"] == trusted_setup.DEV_SECRET_SEED.decode()
    assert meta["challenge_dst"] == api.CHALLENGE_DST.decode()
    s = kzg.dev_setup(meta["size"])
    assert hex(s.tau_g2[0][0]) == meta["tau_g2"]["x_re"]
    assert hex(s.tau_g2[0][1]) == meta["tau_g2"]["x_im"]


# ------------------------------------------------ commitments and proofs


@pytest.mark.parametrize("backend", ["ref", "fake", "gpu"])
@pytest.mark.parametrize("name", sorted(BLOBS))
def test_blob_to_commitment_vectors(name, backend):
    """gpu: the fixed-base MSM's plain steps as the backend runs them
    (`_fixed_pass`); the entry point's own plain run is the proof's."""
    blob = _unhex(BLOBS[name]["input"]["blob"])
    if backend == "gpu":
        got = g1_compress(_fixed_pass()[name])
    else:
        got = kzg.blob_to_kzg_commitment(blob, backend=backend, device="cpu")
    if backend == "fake":
        assert got == rapi.blob_to_kzg_commitment(blob, backend="fake")
    else:
        assert got == _unhex(BLOBS[name]["output"])


def test_proof_gpu_byte_equal_to_ref():
    """The quotient MSM (n - 1 scalars, the commitment's bucket) at the
    blob's own challenge, and at an arbitrary point."""
    blob = _unhex(BLOBS["blob_0"]["input"]["blob"])
    comm = _unhex(BLOBS["blob_0"]["output"])
    launches = dict(cuda_build.LAUNCHES)
    got = kzg.compute_blob_kzg_proof(blob, comm, backend="gpu", device="cpu")
    assert gpu_backend.LAST_MSM_STATS["kind"] == "fixed" and cuda_build.LAUNCHES == launches
    assert got == rapi.compute_blob_kzg_proof(blob, comm)
    assert got == kzg.compute_blob_kzg_proof(blob, comm, backend="ref")
    assert kzg.compute_kzg_proof(blob, 12345, backend="ref") == rapi.compute_kzg_proof(blob, 12345)


# ------------------------------------------------------------ verification


@pytest.mark.parametrize("backend", ["ref", "fake"])
@pytest.mark.parametrize("name", sorted(VERIFY))
def test_verify_vectors_host_backends(name, backend):
    b, c, p = _triple(VERIFY[name])
    want = VERIFY[name]["output"] if backend == "ref" else True
    assert kzg.verify_blob_kzg_proof_batch([b], [c], [p], backend=backend, seed=5) is want
    assert rapi.verify_blob_kzg_proof_batch([b], [c], [p], backend=backend, seed=5) is want
    assert kzg.verify_blob_kzg_proof(b, c, p) is VERIFY[name]["output"]


@pytest.mark.parametrize("name", SINGLES)
def test_verify_single_gpu(name):
    """n = 1: r = 1, the fold is the plain single-proof check; each
    corrupted case alone is False (the gpu backend's host half and plain
    device steps, `_verify_pass`)."""
    assert _verify_pass()[name][0] is VERIFY[name]["output"]


def test_verify_valid_batch_gpu():
    """Every valid vector in one batch (the zero blob's commitment is the
    identity): True, counted under the reference's metric names."""
    blobs, comms, proofs = zip(*(_triple(VERIFY[k]) for k in VALID))
    ok_before = api._BATCHES.labels("gpu", "ok").value
    proofs_before = api._PROOFS.value
    assert kzg.verify_blob_kzg_proof_batch(blobs, comms, proofs, backend="gpu", device="cpu",
                                           seed=3)
    assert api._BATCHES.labels("gpu", "ok").value == ok_before + 1
    assert api._PROOFS.value == proofs_before + len(VALID)
    st = gpu_backend.LAST_HOST_STATS
    assert st["n_proofs"] == len(VALID) and st["lanes"] == 4 * 8
    assert {"challenge_ms", "evaluate_ms", "decompress_ms", "device_ms"} <= set(st)


def test_verify_swapped_proofs_gpu():
    """Valid points, wrong openings: False on the gpu backend's plain steps
    (`_verify_pass`) and on the reference's host backend."""
    blobs, comms, proofs = zip(*(_triple(VERIFY[k]) for k in VALID[:2]))
    bad = [proofs[1], proofs[0]]
    assert _verify_pass()["swapped"][0] is False
    assert not rapi.verify_blob_kzg_proof_batch(blobs, comms, bad, seed=13)


@pytest.mark.parametrize("backend", ["gpu", "ref", "fake"])
def test_empty_batch_and_policy(backend):
    """An empty batch is available without device work; unequal lengths
    and a malformed commitment raise KzgError before any dispatch."""
    launches = dict(cuda_build.LAUNCHES)
    assert kzg.verify_blob_kzg_proof_batch([], [], [], backend=backend, device="cpu")
    b, c, p = _triple(VERIFY["valid_0"])
    with pytest.raises(kzg.KzgError):
        kzg.verify_blob_kzg_proof_batch([b], [], [p], backend=backend, device="cpu")
    if backend != "fake":
        GUARD.reset()
        with pytest.raises(kzg.KzgError):
            kzg.verify_blob_kzg_proof_batch([b], [b"\x00" * 48], [p], backend=backend,
                                            device="cpu")
        assert GUARD.stats()["dispatches"] == 0
    with pytest.raises(kzg.KzgError):
        kzg.verify_blob_kzg_proof_batch([b], [c], [p], backend="tpu")
    assert cuda_build.LAUNCHES == launches


def test_rlc_scalars_match_reference():
    assert api._rlc_scalars(1, 7) == [1] == rapi._rlc_scalars(1, None)
    assert api._rlc_scalars(6, 7) == rapi._rlc_scalars(6, 7)
    assert all(1 <= r < 1 << 64 for r in api._rlc_scalars(6, None))


def test_pair_points_equal_reference_fold():
    """The two affine G1 points of ops/kzg_verify's pairs (the lane layout
    of `gpu_backend.verify_lanes`, K1 at 255 bits, one fold; the "fold"
    case of `_verify_pass`) are the reference's `_verify_batch_ref` lhs
    and -w_sum, and the batch is True."""
    blobs, comms, proofs = zip(*(_triple(VERIFY[k]) for k in VALID[:3]))
    seed = 11
    _, zs, ys, cs, ws = rapi._batch_inputs(blobs, comms, proofs, None)
    rs = rapi._rlc_scalars(len(blobs), seed)
    lhs, w_sum, ry = RG1.infinity, RG1.infinity, 0
    for r, z, y, c, w in zip(rs, zs, ys, cs, ws):
        lhs = RG1.add(lhs, RG1.add(RG1.mul_scalar(c, r), RG1.mul_scalar(w, r * z % R)))
        w_sum = RG1.add(w_sum, RG1.mul_scalar(w, r))
        ry = (ry + r * y) % R
    lhs = RG1.add(lhs, RG1.mul_scalar(RG1.generator, (-ry) % R))
    want = [RG1.to_affine(lhs), RG1.to_affine(RG1.neg(w_sum))]

    _, pzs, pys, pcs, pws = api._batch_inputs(blobs, comms, proofs, None)
    affs, scalars = gpu_backend.verify_lanes(pcs, pws, api._rlc_scalars(len(blobs), seed), pzs, pys)
    assert len(affs) == 4 * 4
    mags, _ = wl.signed_digit_arrays(scalars, nbits=msm.SCALAR_BITS)
    assert mags.shape == (64, 16)
    assert _verify_pass()["fold"] == (True, want)


# ---------------------------------------------------------------- the MSMs


@pytest.mark.parametrize("backend", ["ref", "gpu"])
@pytest.mark.parametrize("name", sorted(MSM_SMALL))
def test_msm_vectors(name, backend):
    """The variable-base MSM on the committed edges: zero scalars, identity
    points, r - 1, duplicate points, a single point. gpu: the backend's
    layout and plain steps (`_k1_pass`), and for the single point also
    the entry point's own plain run."""
    pts, scalars, want = _msm_case(MSM_SMALL[name])
    if backend == "ref":
        got = api._g1_lincomb(pts, scalars)
    else:
        got = _k1_pass()[0][name]
        if name == "single_point":
            assert g1_compress(gpu_backend.g1_msm_gpu(pts, scalars, device="cpu")) == want
    assert g1_compress(got) == want


@pytest.mark.parametrize(
    "scalars",
    [[1, 0, R - 1, 2**254, 7, 7, 0xABCDEF, R - 2], [R - 1], [0] * 8],
    ids=["edges", "single", "zero"],
)
def test_fixed_base_matches_host_oracle(scalars):
    """The entry point's plain run on the edge scalars and the zeros; the
    one-scalar MSM's plain steps ride `_fixed_pass`."""
    s = kzg.dev_setup(8)
    launches = dict(cuda_build.LAUNCHES)
    if scalars == [R - 1]:
        got = _fixed_pass()["single"]
    else:
        got = gpu_backend.g1_msm_fixed_base_gpu(scalars, s, device="cpu")
    want = rapi._g1_lincomb(s.g1_powers[: len(scalars)], scalars)
    assert r_compress(want) == g1_compress(got)
    assert cuda_build.LAUNCHES == launches
    with pytest.raises(ValueError):
        gpu_backend.g1_msm_fixed_base_gpu([1] * 9, s, device="cpu")


def test_fixed_table_and_selection():
    """The packed table's entry d + 8 of lane i is [d] P_i (Y negated for
    d < 0, the identity for d = 0 and past the setup), and a window's
    digits select exactly those entries."""
    s = kzg.dev_setup(8)
    rows = s.g1_window_table(3, 4)
    table = msm.pack_fixed_table(rows, 4)
    assert table.shape == (3, fd.NW, 17, 4)
    words = table.transpose(0, 3, 2, 1)  # [coordinate][lane][entry][word]
    for i in range(4):
        for d in range(-8, 9):
            X, Y, Z = (fd.words_from_mont(words[c, i, d + 8][None])[0] for c in range(3))
            if d == 0 or i >= 3:
                assert (X, Y, Z) == (0, 1, 0)
            else:
                assert (X, Y) == G1.to_affine(G1.mul_scalar(G1.from_affine(s.g1_powers[i]),
                                                            d % R)) and Z == 1
    mags = np.array([[1, 8, 0, 3], [2, 0, 8, 1]], np.int32)
    negs = np.array([[False, True, False, True], [False, False, True, False]])
    sel = msm.select_fixed(torch.from_numpy(table), mags, negs)
    assert sel[0].shape == (1, fd.NW, 8)
    for w in range(2):
        for i in range(4):
            d = int(mags[w, i]) * (-1 if negs[w, i] else 1)
            for c in range(3):
                assert torch.equal(sel[c][0, :, w * 4 + i], torch.from_numpy(table[c, :, d + 8, i]))


def test_signed_digits_at_255_bits():
    """The vectorised recoding equals the per-scalar rule and the
    reference's, W = 64, the top window taking its carry."""
    scalars = [0, 1, R - 1, 2**254, 2**255 - 1, 8 * 2**252 - 1, 0x88888888] + [
        int(v) for v in np.random.default_rng(3).integers(0, 2**62, 8)]
    mags, negs = wl.signed_digit_arrays(scalars, nbits=255)
    jm, jn = jwl.signed_digit_arrays(scalars, nbits=255)
    assert mags.shape == (64, len(scalars))
    assert np.array_equal(mags, np.asarray(jm)) and np.array_equal(negs, np.asarray(jn))
    for k, s in enumerate(scalars):
        d = [int(m) * (-1 if n else 1) for m, n in zip(mags[:, k], negs[:, k])]
        assert d == wl.signed_digits(s, 4, 255) and sum(v << (4 * w) for w, v in enumerate(d)) == s
    assert mags[63, 4] == 8  # 2^255 - 1: the top window's 7 plus the carry
    with pytest.raises(ValueError):
        wl.signed_digit_arrays([2**255], nbits=255)


def test_k1_plain_at_255_bits_matches_ref_curve():
    """K1's plain window ladder on 8 G1 lanes (`EDGE_SCALARS`, riding
    `_k1_pass`): 0, 1, r - 1, 2^254, a top window carry, two random
    scalars, and an identity lane."""
    ax, ay, inf = curve_kernels.to_affine(_k1_pass()[1])
    for k, (p, s) in enumerate(zip(EDGE_POINTS, EDGE_SCALARS)):
        want = G1.infinity if p is None else G1.mul_scalar(p, s)
        if G1.is_infinity(want):
            assert bool(inf[k])
        else:
            got = (fd.words_from_mont(ax[0, :, k][None])[0], fd.words_from_mont(ay[0, :, k][None])[0])
            assert got == G1.to_affine(want), k


def test_window_steps_needed():
    """The bound's count of what the window form needs: [1] P nothing,
    [16] P four doublings, [2^64 - 1] P = [2^64] P - P 64 doublings and
    one addition, 0x88 a table to 8 (4 doublings, 3 additions), 4
    doublings and one addition; a zero scalar nothing; the products of a
    Horner chain over 64 windows."""
    mags, _ = wl.signed_digit_arrays([1, 16, 2**64 - 1, 0x88, 0], nbits=255)
    per_lane = [ladder_rows.window_steps_needed(mags[:, [k]]) for k in range(5)]
    assert per_lane == [(0, 0), (4, 0), (64, 1), (8, 4), (0, 0)]
    assert ladder_rows.window_steps_needed(mags) == (76, 5)
    n_dbl, n_add = ladder_rows.lane_steps("window", 17)
    assert ladder_rows.step_products(1, n_dbl, n_add) == ladder_rows.lane_products(1, 17) == 816
    assert ladder_rows.step_products(1, 4 * 63, 63) == 2772


# ------------------------------------------------------------- the guard


def _no_device(monkeypatch):
    """Record every device entry of the kzg backend instead of running it."""
    calls = []
    for mod, name in ((kzg_verify, "verify_kzg_proof_batch"), (msm, "msm_fixed_base"),
                      (msm, "msm_variable")):
        monkeypatch.setattr(mod, name, lambda *a, _n=name, **k: calls.append(_n))
    return calls


@pytest.mark.parametrize("kind", ["stall", "error"])
@pytest.mark.parametrize("plane", ["kzg", "msm"])
def test_faults_raise_before_device_work(clean_guard, monkeypatch, plane, kind):
    calls = _no_device(monkeypatch)
    INJECTOR.arm(kind, plane, rate=1.0, seed=0)
    exc = {"stall": executor.DeviceStallInjected, "error": executor.DeviceErrorInjected}[kind]
    s = kzg.dev_setup(8)
    b, c, p = _triple(VERIFY["valid_0"])
    entries = {
        "kzg": [lambda: kzg.verify_blob_kzg_proof_batch([b], [c], [p], backend="gpu",
                                                        device="cpu")],
        "msm": [lambda: kzg.blob_to_kzg_commitment(b, backend="gpu", device="cpu"),
                lambda: gpu_backend.g1_msm_gpu([s.g1_powers[0]], [5], device="cpu")],
    }[plane]
    for entry in entries:
        with pytest.raises(exc):
            entry()
    assert calls == []
    st = GUARD.stats()
    assert st["dispatches"] == len(entries) and st["faults"] == {f"{plane}:{kind}": len(entries)}


def test_flip_comes_back_flipped(clean_guard, monkeypatch):
    """A flip inverts the kzg verdict (through plan.verdict) and leaves an
    MSM's point as it is."""
    monkeypatch.setattr(kzg_verify, "verify_kzg_proof_batch", lambda *a, **k: torch.tensor(True))
    b, c, p = _triple(VERIFY["valid_0"])
    verify = lambda: kzg.verify_blob_kzg_proof_batch([b], [c], [p], backend="gpu", device="cpu")  # noqa: E731
    assert verify() is True
    INJECTOR.arm("flip", "kzg", rate=1.0, seed=0)
    assert verify() is False
    point = G1.mul_scalar(G1.generator, 9)
    monkeypatch.setattr(msm, "msm_fixed_base", lambda *a, **k: None)
    monkeypatch.setattr(gpu_backend, "_read_point", lambda pt: point)
    INJECTOR.arm("flip", "msm", rate=1.0, seed=0)
    assert gpu_backend.g1_msm_fixed_base_gpu([1, 2], kzg.dev_setup(8), device="cpu") is point


def test_device_fault_is_typed(clean_guard, monkeypatch):
    """An untyped failure inside the attempt (a refused launch) reaches the
    caller as a DeviceFaultError, counted on the plane; no fallback."""
    def refuse(*a, **k):
        raise RuntimeError("lh_ladder_g1: CUDA launch failed with error 2")

    monkeypatch.setattr(kzg_verify, "verify_kzg_proof_batch", refuse)
    b, c, p = _triple(VERIFY["valid_0"])
    with pytest.raises(executor.DeviceFaultError):
        kzg.verify_blob_kzg_proof_batch([b], [c], [p], backend="gpu", device="cpu")
    assert GUARD.stats()["faults"] == {"kzg:error": 1}


@pytest.mark.parametrize("kind", ["stall", "error"])
def test_subgroup_check_crosses_the_guard(clean_guard, monkeypatch, kind):
    """check_signature_subgroups: an injected stall or error raises before
    any device work and leaves every memo unset."""
    calls = []
    monkeypatch.setattr(subgroup, "g2_in_subgroup", lambda *a, **k: calls.append(1))
    sigs = [kp.sk.sign(b"m") for kp in pbls.interop_keypairs(2)]
    for s in sigs:
        s._subgroup_ok = None
    INJECTOR.arm(kind, "bls", rate=1.0, seed=0)
    exc = {"stall": executor.DeviceStallInjected, "error": executor.DeviceErrorInjected}[kind]
    launches = dict(cuda_build.LAUNCHES)
    with pytest.raises(exc):
        bls_gpu.check_signature_subgroups(sigs, device="cpu")
    assert calls == [] and cuda_build.LAUNCHES == launches
    assert [s._subgroup_ok for s in sigs] == [None, None]
    assert GUARD.stats()["faults"] == {f"bls:{kind}": 1}


def test_subgroup_check_flip(clean_guard, monkeypatch):
    """A flip inverts every verdict of the list, and the memos hold what
    the dispatch returned."""
    ok = torch.tensor([True, False, True])
    monkeypatch.setattr(subgroup, "g2_in_subgroup", lambda *a, **k: ok)
    sigs = [kp.sk.sign(b"m") for kp in pbls.interop_keypairs(3)]
    assert bls_gpu.check_signature_subgroups(sigs, device="cpu") == [True, False, True]
    INJECTOR.arm("flip", "bls", rate=1.0, seed=0)
    assert bls_gpu.check_signature_subgroups(sigs, device="cpu") == [False, True, False]
    assert [s._subgroup_ok for s in sigs] == [False, True, False]
    assert GUARD.stats()["dispatches"] == 2


# ------------------------------------------------------------ the canary


def test_kzg_sentinel_is_the_committed_pair(clean_guard):
    committed = {}
    for name in ("valid", "invalid"):
        with open(os.path.join(VECTORS, "sentinel", "kzg", f"{name}.json")) as f:
            committed[name] = json.load(f)
    assert canary.kzg_vectors() == committed
    assert "kzg" in canary.PLANES and "kzg" in executor.DEFAULT_SELFTEST_PLANES
    assert canary.self_test_plane("kzg") is True is rcanary.self_test_plane("kzg")
    assert GUARD.self_test(("kzg",)) == {"kzg": True}


def test_cuda_without_gpu_raises():
    """device="cuda" with no card raises before the guard, on every entry."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: this checks the behaviour without one")
    s = kzg.dev_setup(8)
    b, c, p = _triple(VERIFY["valid_0"])
    for call in (
        lambda: kzg.verify_blob_kzg_proof_batch([b], [c], [p], backend="gpu", device="cuda"),
        lambda: kzg.blob_to_kzg_commitment(b, backend="gpu"),
        lambda: gpu_backend.g1_msm_gpu([s.g1_powers[0]], [3], device="cuda"),
    ):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert GUARD.stats()["faults"] == {}
