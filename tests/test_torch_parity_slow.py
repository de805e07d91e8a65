"""Whole-graph parity of the port's plain versions with the JAX package,
exactly (canonical words): the transposed Miller loop before the final
exponentiation, the lane fold plus final exponentiation, the windowed RLC
ladder, the Pallas batch verify in interpret mode, the Pallas chain and
2-bit ladder kernels in interpret mode, the per-set verification graph
(values after the final exponentiation, and verdicts), and the G2 subgroup
check over all of r (verdicts), the KZG batch verify and MSM graphs, and the
DA cell verify (verdicts).

Marked slow: each JAX reference is a whole jitted graph whose cold compile
takes minutes on a CPU (the Miller loop alone about a minute, the final
exponentiation about a minute and a half).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lighthouse_tpu import testing as td
from lighthouse_tpu.crypto import ref_curve as rc
from lighthouse_tpu.crypto.constants import P
from lighthouse_tpu.ops import batch_verify as jbv
from lighthouse_tpu.ops import curve as jcurve
from lighthouse_tpu.ops import fieldb as fb
from lighthouse_tpu.ops import pairing as jpairing
from lighthouse_tpu.ops import tcurve, tfexp as jfe, tower as jtower, tpairing as jtp
from lighthouse_tpu.ops import window_ladder as jwl
from lighthouse_tpu.ops.pallas_ladder import ladder_pallas
from lighthouse_tpu_torch.ops import batch_verify, curve, field as fd
from lighthouse_tpu_torch.ops import final_exp, ladder, miller, tfexp, tpairing
from lighthouse_tpu_torch.ops import window_ladder as wl

pytestmark = pytest.mark.slow

torch.set_num_threads(1)

R = 1 << 384


def _bundle(lanes):
    """[lane][slot] plain ints -> (slots, NB, lanes) Montgomery limbs."""
    limbs = np.array([fb.pack_ints([v * R % P for v in lane]) for lane in lanes], np.int32)
    return np.ascontiguousarray(np.moveaxis(limbs, 0, -1))


def _canon(x):
    """Port or JAX relaxed bundle -> canonical kernel words (exact compare)."""
    return fd.bundle_to_words(torch.as_tensor(np.array(x))).numpy()


def _coords(v, w):
    return [v] if w == 1 else list(v)


def test_miller_loop_t_matches():
    """Two live pairs and one masked pair, the value before the final
    exponentiation (the line scaling of tpairing, not just the pairing)."""
    g1s = [rc.G1.to_affine(rc.G1.mul_scalar(rc.G1.generator, k)) for k in (3, 5, 7)]
    g2s = [rc.G2.to_affine(rc.G2.mul_scalar(rc.G2.generator, k)) for k in (11, 13, 17)]
    p = (_bundle([[a[0]] for a in g1s]), _bundle([[a[1]] for a in g1s]))
    q = (_bundle([list(b[0]) for b in g2s]), _bundle([list(b[1]) for b in g2s]))
    mask = np.array([True, False, True])
    want = jax.jit(jtp.miller_loop_t)(
        tuple(map(jnp.asarray, p)), tuple(map(jnp.asarray, q)), jnp.asarray(mask)
    )
    got = tpairing.miller_loop_t(
        tuple(map(torch.as_tensor, p)), tuple(map(torch.as_tensor, q)), torch.as_tensor(mask)
    )
    assert np.array_equal(_canon(got), _canon(want))


def test_fold_and_final_exponentiation_match():
    rng = np.random.default_rng(7)
    lanes = [[int.from_bytes(rng.bytes(48), "little") % P for _ in range(12)] for _ in range(3)]
    f = _bundle(lanes)
    frob = jnp.asarray(jfe.frob_consts())[:, :, None]

    def jax_tail(x):
        return jfe.final_exponentiation_t(jfe.fold_lanes(x), frob[:12], frob[12:])

    want = jax.jit(jax_tail)(jnp.asarray(f))
    got = tfexp.final_exponentiation_t(tfexp.fold_lanes(torch.as_tensor(f)))
    assert np.array_equal(_canon(got), _canon(want))


def _ladder_inputs(name):
    """4 lanes (3, 5, 9, 17 times the generator, lane 1 the identity) and
    64-bit scalars (zero, one, all ones, random) as (64, 4) LSB-first bits."""
    w, G = {"G1": (1, rc.G1), "G2": (2, rc.G2)}[name]
    affs = [G.to_affine(G.mul_scalar(G.generator, k)) for k in (3, 5, 9, 17)]
    lanes_x = [_coords(a[0], w) for a in affs]
    lanes_y = [_coords(a[1], w) for a in affs]
    lanes_z = [[1] + [0] * (w - 1) for _ in affs]
    lanes_x[1], lanes_y[1], lanes_z[1] = [0] * w, [1] + [0] * (w - 1), [0] * w  # identity
    pt = tuple(_bundle(c) for c in (lanes_x, lanes_y, lanes_z))
    scalars = [0, 1, (1 << 64) - 1, 0x9E3779B97F4A7C15]
    return pt, np.ascontiguousarray(wl.scalars_to_bits(scalars, 64).T)


@pytest.mark.parametrize("name", ["G1", "G2"])
def test_windowed_ladder_matches(name):
    """64-bit scalars (zero, one, all ones, random) with an identity lane,
    projective X:Y:Z compared exactly."""
    w, tg = {"G1": (1, tcurve.TPG1), "G2": (2, tcurve.TPG2)}[name]
    pt, bits = _ladder_inputs(name)

    def jax_ladder(X, Y, Z, b):
        return jwl.mul_scalar_bits_windowed_t(tg, (X, Y, Z), b)

    want = jax.jit(jax_ladder)(*map(jnp.asarray, pt), jnp.asarray(bits))
    got = wl.mul_scalar_bits_windowed_t(
        curve.group(w), tuple(map(torch.as_tensor, pt)), torch.as_tensor(bits)
    )
    for a, b in zip(got, want):
        assert np.array_equal(_canon(a), _canon(b))


@pytest.mark.parametrize("corrupt", [False, True], ids=["valid", "corrupt"])
def test_batch_verify_matches_pallas_interpret(corrupt):
    """The JAX package's Pallas verify (interpret mode, block_b=4, as its own
    tests run it) and the port's flat verify on the same S = 2 batch."""
    args = td.make_signature_set_batch(
        2, max_keys=2, seed=2, corrupt_indices=(1,) if corrupt else ()
    )
    fn = functools.partial(jbv.verify_signature_sets_pallas, block_b=4, interpret=True)
    want = bool(np.asarray(jax.jit(fn)(*args)))
    msgs, sigs, pks, km, rb, sm = args
    port_args = (
        tuple(fd.from_jax_bundle(c) for c in msgs),
        tuple(fd.from_jax_bundle(c) for c in sigs),
        tuple(fd.from_jax_bundle(c) for c in pks),
        np.asarray(km),
        np.asarray(rb),
        np.asarray(sm),
    )
    got = bool(batch_verify.verify_signature_sets(*port_args, device="cpu"))
    assert got == want == (not corrupt)


@pytest.mark.parametrize("kind", ["chain", "w2"])
@pytest.mark.parametrize("name", ["G1", "G2"])
def test_pallas_chain_and_w2_kernels_match(name, kind):
    """The JAX package's Pallas ladder kernels `_ladder_kernel` ("chain")
    and `_ladder_kernel_w2` ("w2") in interpret mode against K1's plain
    forms, projective X:Y:Z exactly, at 64 bits."""
    pt, bits = _ladder_inputs(name)
    want = ladder_pallas(
        tuple(map(jnp.asarray, pt)), jnp.asarray(bits), group_name=name, block_b=4,
        interpret=True, kind=kind,
    )
    words = tuple(fd.bundle_to_words(torch.as_tensor(c)) for c in pt)
    got = ladder.ladder_plain(words, torch.as_tensor(bits), form=kind)
    for a, b in zip(got, want):
        assert np.array_equal(a.numpy(), _canon(b))


def test_individual_graph_matches():
    """The JAX package's per-set graph, batch_verify.
    verify_signature_sets_individual (verdicts), and the per-set values of
    its own stages (aggregate_pubkeys, to_affine, miller_loop over the 2 S
    pairs, tower.fp12_mul of f[:S] and f[S:], final_exponentiation) against
    the port's per-set path on a 2-set batch whose second set is corrupt."""
    msgs, sigs, pks, km, _, sm = td.make_signature_set_batch(
        2, max_keys=2, seed=2, corrupt_indices=(1,)
    )
    want_ok = np.asarray(jax.jit(jbv.verify_signature_sets_individual)(msgs, sigs, pks, km, sm))

    def jax_values(msgs, sigs, pks, km, sm):
        S = sm.shape[0]
        pk_x, pk_y, pk_inf = jcurve.PG1.to_affine(jbv.aggregate_pubkeys(pks, km))
        neg = [jnp.broadcast_to(jnp.asarray(c), pk_x.shape) for c in jbv.NEG_G1_AFFINE]
        g1 = (jnp.concatenate([pk_x, neg[0]]), jnp.concatenate([pk_y, neg[1]]))
        g2 = (jnp.concatenate([msgs[0], sigs[0]]), jnp.concatenate([msgs[1], sigs[1]]))
        mask = jnp.concatenate([sm & ~pk_inf, sm])
        f = jpairing.miller_loop(g1, g2, valid_mask=mask)
        return jpairing.final_exponentiation(jtower.fp12_mul(f[:S], f[S:]))

    want = fd.from_jax_bundle(np.asarray(jax.jit(jax_values)(msgs, sigs, pks, km, sm)))
    port = (
        tuple(fd.from_jax_bundle(c) for c in msgs),
        tuple(fd.from_jax_bundle(c) for c in sigs),
        tuple(fd.from_jax_bundle(c) for c in pks),
        np.asarray(km),
        np.asarray(sm),
    )
    g1, g2, mask, _ = batch_verify._individual_pairs(*port, device="cpu")
    values, _ = final_exp.pair_final_exp(miller.miller_loop(g1, g2, mask))
    assert np.array_equal(values.permute(2, 0, 1).numpy(), want)
    got_ok = batch_verify.verify_signature_sets_individual(*port, device="cpu")
    assert got_ok.tolist() == want_ok.tolist() == [True, False]


def test_g2_points_in_subgroup_matches_jax_and_ref():
    """The whole subgroup check, `jax.jit(batch_verify.g2_points_in_subgroup)`
    against the port's plain version (`batch_verify.g2_points_in_subgroup`
    on the CPU) and `ref_curve.G2.in_subgroup`: the points of
    tests/test_curve_device.py:136-141, a point of order 13 and its
    negation, the subgroup points with Z != 1, a masked SSWU lane and a
    masked (0, 0) lane."""
    from lighthouse_tpu_torch.crypto.ref_curve import G2 as RG2
    from tests.test_torch_subgroup import _check_points, _sswu

    pts = _check_points()
    affs = [RG2.to_affine(p) for p in pts] + [RG2.to_affine(_sswu(b"masked", 1)[0]), ((0, 0), (0, 0))]
    xs = fd.mont_words([c for a in affs for c in a[0]]).reshape(-1, 2, fd.NW)
    ys = fd.mont_words([c for a in affs for c in a[1]]).reshape(-1, 2, fd.NW)
    mask = np.array([True] * len(pts) + [False, False])
    got = batch_verify.g2_points_in_subgroup((xs, ys), mask, device="cpu").tolist()
    want = [RG2.in_subgroup(p) for p in pts] + [True, True]
    assert got == want and want[:6] == [True, True, False, False, False, False]
    jax_out = jax.jit(jbv.g2_points_in_subgroup)(
        (jnp.asarray(fd.to_jax_bundle(xs)), jnp.asarray(fd.to_jax_bundle(ys))), jnp.asarray(mask))
    assert np.asarray(jax_out).tolist() == got


def test_check_signature_subgroups_memo_matches_ref():
    """Every signature's memo from `gpu_backend.check_signature_subgroups`
    on the CPU, over all of r, equals ref_curve.G2.in_subgroup, the point at
    infinity included."""
    from lighthouse_tpu_torch.bls import api, gpu_backend
    from lighthouse_tpu_torch.crypto.ref_curve import G2 as RG2
    from tests.test_torch_subgroup import _check_points

    sigs = [api.Signature(p) for p in _check_points()] + [api.Signature(RG2.infinity)]
    want = [RG2.in_subgroup(s.point) for s in sigs]
    assert gpu_backend.check_signature_subgroups(sigs, device="cpu") == want
    assert [s._subgroup_ok for s in sigs] == want and want.count(False) == 4 and want[-1]


def test_emulated_subgroup_rows_over_r_on_the_edge_set():
    """The subgroup kernel's generated rows (`ops/subgroup_rows.py`), run on
    Python integers over all of r as one warp, on every point of the edge
    set -- subgroup points with Z != 1, SSWU points, a point of order 13,
    its negation -- give ref_curve.G2.in_subgroup."""
    from lighthouse_tpu_torch.crypto.ref_curve import G2 as RG2
    from lighthouse_tpu_torch.ops import subgroup_rows
    from tests.test_torch_subgroup import _check_points

    pts = _check_points()
    lanes = []
    for pt in pts:
        x, y = RG2.to_affine(pt)
        lanes.append([c % P * R % P for c in (*x, *y, 1, 0)])
    got = [acc[4] == acc[5] == 0 for acc, _ in
           (trace[-1] for trace in subgroup_rows.emulate_warp(lanes))]
    assert got == [RG2.in_subgroup(p) for p in pts] and got.count(False) == 4


# ---------------------------------------------------------------- KZG


def _kzg_vectors(valid_only=True):
    import json
    import os

    d = os.path.join(os.path.dirname(__file__), "vectors", "kzg", "verify_blob_proof")
    out = []
    for name in sorted(os.listdir(d)):
        with open(os.path.join(d, name)) as f:
            case = json.load(f)
        if case["output"] or not valid_only:
            i = case["input"]
            out.append(tuple(bytes.fromhex(i[k][2:]) for k in ("blob", "commitment", "proof")))
    return out


def test_kzg_batch_verify_matches_jax_graph():
    """The reference's jitted `ops.kzg_verify.verify_kzg_proof_batch` (through
    `kzg.tpu_backend`) and the port's plain device path give the same verdict
    at 2 proofs: valid, then with the proofs swapped."""
    from lighthouse_tpu.kzg import tpu_backend
    from lighthouse_tpu_torch.kzg import gpu_backend as kzg_gpu

    blobs, comms, proofs = zip(*_kzg_vectors()[:2])
    for prs, want in ((proofs, True), ((proofs[1], proofs[0]), False)):
        got_jax = tpu_backend.verify_blob_kzg_proof_batch_tpu(blobs, comms, prs, seed=21)
        got = kzg_gpu.verify_blob_kzg_proof_batch_gpu(blobs, comms, prs, seed=21, device="cpu")
        assert bool(got_jax) is got is want


def test_kzg_msm_graphs_match_jax():
    """The reference's jitted `ops.msm.msm_fixed_base` and `msm_pippenger`
    (through `kzg.tpu_backend`) against the port's fixed-base and
    variable-base MSMs at 8 points: the same point."""
    from lighthouse_tpu.crypto.constants import R as ORDER
    from lighthouse_tpu.kzg import dev_setup as r_dev_setup
    from lighthouse_tpu.kzg import tpu_backend
    from lighthouse_tpu.kzg.trusted_setup import g1_generator_multiples
    from lighthouse_tpu_torch.crypto.ref_curve import G1 as PG1
    from lighthouse_tpu_torch.kzg import dev_setup
    from lighthouse_tpu_torch.kzg import gpu_backend as kzg_gpu

    scalars = [1, 0, ORDER - 1, 2**254, 7, 7, 0xABCDEF, ORDER - 2]
    want = rc.G1.to_affine(tpu_backend.g1_msm_fixed_base_tpu(scalars, r_dev_setup(8)))
    assert PG1.to_affine(kzg_gpu.g1_msm_fixed_base_gpu(scalars, dev_setup(8), device="cpu")) == want
    pts = g1_generator_multiples(8)
    pts[3] = None
    want = rc.G1.to_affine(tpu_backend.g1_msm_tpu(pts, scalars))
    assert PG1.to_affine(kzg_gpu.g1_msm_gpu(pts, scalars, device="cpu")) == want


# ------------------------------------------------------------------ DA


def test_da_cell_verify_matches_jax_graph():
    """The reference's `da.cells.verify_cell_proof_batch(backend="tpu")`
    (the jitted KZG verify graph over its cell lanes) and the port's "gpu"
    backend on the plain versions give the same verdict on two cells of
    two blobs: honest, then with one cell byte flipped."""
    from lighthouse_tpu import kzg as rkzg
    from lighthouse_tpu.crypto.constants import R as ORDER
    from lighthouse_tpu.da import cells as rcells
    from lighthouse_tpu.da.domain import geometry as rgeometry
    from lighthouse_tpu_torch.da import cells as pcells
    from lighthouse_tpu_torch.da.domain import geometry

    rng = np.random.default_rng(44)
    blobs = [b"".join((int.from_bytes(rng.bytes(32), "big") % ORDER).to_bytes(32, "big")
                      for _ in range(8)) for _ in range(2)]
    rgeo = rgeometry(8, 4)
    items = []
    for blob, k in zip(blobs, (1, 2)):
        cells, proofs = rcells.compute_cells_and_kzg_proofs(blob, rgeo, backend="ref")
        items.append((rkzg.blob_to_kzg_commitment(blob, backend="ref"), k, cells[k], proofs[k]))
    comm, k, cell, proof = items[1]
    bad = items[:1] + [(comm, k, cell[:9] + bytes([cell[9] ^ 1]) + cell[10:], proof)]
    for batch, want in ((items, True), (bad, False)):
        got_jax = rcells.verify_cell_proof_batch(batch, rgeo, backend="tpu", seed=6)
        got = pcells.verify_cell_proof_batch(batch, geometry(8, 4), backend="gpu", seed=6,
                                             device="cpu")
        assert bool(got_jax) is got is want
