"""The port's plain Miller loop, product fold and final exponentiation
(lighthouse_tpu_torch/ops/tpairing.py, tfexp.py, through the CPU path of
the K2 and K3 wrappers) against the JAX package: tpairing's fused
double/add steps (exact point and line), and crypto/ref_pairing's pairing
values after the final exponentiation -- the same exponent 3 (p^12 - 1) / r,
so the values agree exactly although ref_pairing's affine Miller loop
scales its lines differently. K3's per-set entry (`pair_final_exp`) is held
to ref_pairing the same way."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lighthouse_tpu.crypto import ref_curve as rc
from lighthouse_tpu.crypto import ref_fields as rf
from lighthouse_tpu.crypto import ref_pairing as rp
from lighthouse_tpu.crypto.constants import P
from lighthouse_tpu.ops import tpairing as jtp
from lighthouse_tpu_torch.ops import field as fd, final_exp, miller
from lighthouse_tpu_torch.ops import tpairing as tp

torch.set_num_threads(1)

R = 1 << 384


def _jit(fn, *args):
    opts = {"xla_backend_optimization_level": 0}
    return jax.jit(fn).lower(*args).compile(compiler_options=opts)


def _mont_words(ints, n_lanes_first=False):
    """[lane][slot] ints -> (slots, 12, lanes) Montgomery words tensor."""
    arr = np.stack([fd.mont_words(lane) for lane in ints], axis=-1)
    return torch.tensor(arr)


def _g1(ks):
    return [rc.G1.to_affine(rc.G1.mul_scalar(rc.G1.generator, k)) for k in ks]


def _g2(ks):
    return [rc.G2.to_affine(rc.G2.mul_scalar(rc.G2.generator, k)) for k in ks]


def _pairs_words(g1s, g2s):
    px = _mont_words([[a[0]] for a in g1s])
    py = _mont_words([[a[1]] for a in g1s])
    qx = _mont_words([list(b[0]) for b in g2s])
    qy = _mont_words([list(b[1]) for b in g2s])
    return (px, py), (qx, qy)


def _fp12_ints(words, lane=0):
    """(12, 12, B) words -> crypto.ref_fields Fp12 value of one lane."""
    ints = fd.words_from_mont(words[:, :, lane].numpy())
    return tuple(
        tuple((ints[6 * i + 2 * j], ints[6 * i + 2 * j + 1]) for j in range(3)) for i in range(2)
    )


def _canon(x) -> list:
    """(S, NB, B) relaxed bundle (port or JAX) -> canonical Montgomery words."""
    return fd.bundle_to_words(torch.tensor(np.array(x))).tolist()


def _step_inputs(seed):
    """A projective twist point T with a random scale, P, Q; 3 lanes."""
    rng = np.random.default_rng(seed)
    ks = [int(rng.integers(2, 1 << 60)) for _ in range(3)]
    t_aff = _g2(ks)
    lams = [int.from_bytes(rng.bytes(48), "little") % P for _ in range(3)]
    # Jacobian-style twist point (x l^2, y l^3, l), as the Miller loop keeps it
    T = [
        [[c * l * l % P for c in a[0]], [c * l * l * l % P for c in a[1]], [l, 0]]
        for a, l in zip(t_aff, lams)
    ]
    (px, py), (qx, qy) = _pairs_words(_g1([k + 7 for k in ks]), _g2([k + 11 for k in ks]))
    t = tuple(fd.words_to_bundle(_mont_words([lane[j] for lane in T])) for j in range(3))
    b = lambda w: fd.words_to_bundle(w)  # noqa: E731
    return t, b(px), b(py), b(qx), b(qy)


def test_dbl_step_matches_tpairing():
    t, px, py, _, _ = _step_inputs(1)
    args = (tuple(jnp.asarray(c.numpy()) for c in t), jnp.asarray(px.numpy()), jnp.asarray(py.numpy()))
    (jx, jy, jz), jline = _jit(jtp._dbl_step, *args)(*args)
    (x, y, z), line = tp.dbl_step(t, px, py)
    for a, b in ((x, jx), (y, jy), (z, jz), (line, jline)):
        assert _canon(a) == _canon(b)


def test_add_step_matches_tpairing():
    t, px, py, qx, qy = _step_inputs(2)
    args = (
        tuple(jnp.asarray(c.numpy()) for c in t),
        (jnp.asarray(qx.numpy()), jnp.asarray(qy.numpy())),
        jnp.asarray(px.numpy()),
        jnp.asarray(py.numpy()),
    )
    (jx, jy, jz), jline = _jit(jtp._add_step, *args)(*args)
    (x, y, z), line = tp.add_step(t, (qx, qy), px, py)
    for a, b in ((x, jx), (y, jy), (z, jz), (line, jline)):
        assert _canon(a) == _canon(b)


def test_multi_pairing_matches_ref_pairing():
    """Miller loop + fold + final exponentiation over 3 pairs, the middle
    one masked, equals ref_pairing's product of the two live pairings."""
    g1s, g2s = _g1([3, 5, 7]), _g2([11, 13, 17])
    p, q = _pairs_words(g1s, g2s)
    mask = torch.tensor([True, False, True])
    value, ok = final_exp.fold_final_exp(miller.miller_loop(p, q, mask))
    want = rf.fp12_mul(rp.pairing(g1s[0], g2s[0]), rp.pairing(g1s[2], g2s[2]))
    assert _fp12_ints(value) == want
    assert not bool(ok)


def test_final_exponentiation_of_random_fp12_matches_ref():
    rng = np.random.default_rng(3)
    vals = [int.from_bytes(rng.bytes(48), "little") % P for _ in range(12)]
    f = tuple(tuple((vals[6 * i + 2 * j], vals[6 * i + 2 * j + 1]) for j in range(3)) for i in range(2))
    value, ok = final_exp.fold_final_exp(_mont_words([vals]))
    assert _fp12_ints(value) == rp.final_exponentiation(f)
    assert not bool(ok)


def test_pair_final_exp_matches_ref():
    """K3's per-set entry on 2 sets (4 Miller values): set i's value is
    final_exponentiation(f_i * f_{2+i}); set 1's two values are inverses,
    so its value is 1 and it alone passes."""
    rng = np.random.default_rng(4)

    def rand_fp12():
        v = [int.from_bytes(rng.bytes(48), "little") % P for _ in range(12)]
        return tuple(tuple((v[6 * i + 2 * j], v[6 * i + 2 * j + 1]) for j in range(3)) for i in range(2))

    a0, a1, b0 = rand_fp12(), rand_fp12(), rand_fp12()
    lanes = [a0, a1, b0, rf.fp12_inv(a1)]
    flat = [[c for half in f for pair in half for c in pair] for f in lanes]
    values, ok = final_exp.pair_final_exp(_mont_words(flat))
    assert values.shape == (12, 12, 2) and ok.tolist() == [False, True]
    assert _fp12_ints(values, 0) == rp.final_exponentiation(rf.fp12_mul(a0, b0))
    assert _fp12_ints(values, 1) == rf.fp12_mul(a1, rf.fp12_inv(a1))


def test_is_one_per_lane_and_pair_count():
    """`is_one` reads each lane of a (12, 12, B) value; the per-set entry
    takes an even number of Miller values (two per set)."""
    one = torch.tensor(fd.mont_words([1])[0])
    v = torch.zeros((12, fd.NW, 3), dtype=torch.int32)
    v[0, :, 0] = one
    v[0, :, 2] = one
    v[5, 0, 2] = 1
    assert final_exp.is_one(v).tolist() == [True, False, False]
    with pytest.raises(ValueError, match="expected 2 S"):
        final_exp.pair_final_exp(torch.zeros((12, fd.NW, 3), dtype=torch.int32))


def test_bilinearity_on_port():
    """e(aP, Q) == e(P, aQ) on the port alone, as the verify path's tail
    checks it: e(aP, Q) * e(-P, aQ) == 1."""
    a = 0x1234567
    P1 = rc.G1.mul_scalar(rc.G1.generator, 5)
    Q1 = rc.G2.mul_scalar(rc.G2.generator, 9)
    g1s = [rc.G1.to_affine(rc.G1.mul_scalar(P1, a)), rc.G1.to_affine(rc.G1.neg(P1))]
    g2s = [rc.G2.to_affine(Q1), rc.G2.to_affine(rc.G2.mul_scalar(Q1, a))]
    p, q = _pairs_words(g1s, g2s)
    _, ok = final_exp.fold_final_exp(miller.miller_loop(p, q, torch.tensor([True, True])))
    assert bool(ok)


@pytest.mark.parametrize("bit", [0, 1], ids=["double_only", "double_add"])
def test_x_bits_drive_the_add_steps(bit):
    """The loop's schedule is the 63 bits of |x| below its top bit, with
    an add step exactly on the set bits (5 of them)."""
    assert len(tp.X_BITS) == 63
    assert sum(tp.X_BITS) == 5
    assert [i for i, b in enumerate(tp.X_BITS) if b == bit] == [
        i for i, b in enumerate(jtp._X_BITS.tolist()) if b == bit
    ]
