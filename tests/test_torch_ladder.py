"""The port's plain complete projective G1/G2 plane and K1's three ladder
forms (lighthouse_tpu_torch/ops/curve.py, window_ladder.py, ladder.py)
against the JAX package: tcurve.TPG1/TPG2's add, double, window_step,
mul_scalar_bits and mul_scalar_bits_w2 (canonical X:Y:Z, exactly),
window_ladder's digit recoding, and crypto/ref_curve's scalar
multiplication for the whole 64-bit ladder of every form."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lighthouse_tpu.crypto import ref_curve as rc
from lighthouse_tpu.crypto.constants import P
from lighthouse_tpu.ops import fieldb as fb
from lighthouse_tpu.ops import tcurve
from lighthouse_tpu.ops import window_ladder as jwl
from lighthouse_tpu_torch.ops import curve, curve_kernels, field as fd, ladder
from lighthouse_tpu_torch.ops import window_ladder as wl

torch.set_num_threads(1)

R = 1 << 384
R_INV = pow(R, -1, P)
GROUPS = {"G1": (1, rc.G1, tcurve.TPG1), "G2": (2, rc.G2, tcurve.TPG2)}


def _jit(fn, *args):
    opts = {"xla_backend_optimization_level": 0}
    return jax.jit(fn).lower(*args).compile(compiler_options=opts)


def _coords(v, w):
    return [v] if w == 1 else list(v)


def _points(name, n, seed, identity_lane=True):
    """n projective points as ((w, NB, n) bundles, affine ints): random
    multiples of the generator with a random projective scale, lane 1 the
    identity (0 : 1 : 0)."""
    w, G, _ = GROUPS[name]
    rng = np.random.default_rng(seed)
    cols, affs = [], []
    for i in range(n):
        k = int(rng.integers(2, 1 << 62))
        aff = G.to_affine(G.mul_scalar(G.generator, k))
        if identity_lane and i == 1:
            aff = None
        lam = int.from_bytes(rng.bytes(48), "little") % P or 1
        if aff is None:
            xyz = [[0] * w, [1] + [0] * (w - 1), [0] * w]
        else:
            # (x, y, 1) scaled by lam in Fp (componentwise on Fp2)
            xyz = [[c * lam % P for c in _coords(aff[0], w)],
                   [c * lam % P for c in _coords(aff[1], w)],
                   [lam] + [0] * (w - 1)]
        cols.append([[v * R % P for v in coord] for coord in xyz])
        affs.append(aff)
    bundles = []
    for j in range(3):
        limbs = np.array([fb.pack_ints(c[j]) for c in cols], np.int32)  # (n, w, NB)
        bundles.append(np.ascontiguousarray(np.moveaxis(limbs, 0, -1)))
    return tuple(bundles), affs


def _canon(bundles) -> np.ndarray:
    """Port or JAX (w, NB, B) relaxed bundles -> canonical plain ints array."""
    t = [fd.bundle_to_words(torch.tensor(np.array(c))) for c in bundles]
    return np.array([[fd.words_from_mont(c[s].T.numpy()) for s in range(c.shape[0])] for c in t],
                    dtype=object)


class _JaxGroup(tcurve.TProjective):
    """tcurve's TProjective with its add/double/neg compiled once, so its
    own window_step runs as written without compiling the whole step, and
    its scans (mul_scalar_bits, mul_scalar_bits_w2) run step by step under
    `jax.disable_jit()` on the same compiled add and double."""

    def __init__(self, base, sample):
        super().__init__(base.pg)
        self._add = _jit(base.add, sample, sample)
        self._dbl = _jit(base.double, sample)
        self._neg = _jit(base.neg, sample)

    def add(self, p, q):
        with jax.disable_jit(False):
            return self._add(p, q)

    def double(self, pt):
        with jax.disable_jit(False):
            return self._dbl(pt)

    def neg(self, pt):
        with jax.disable_jit(False):
            return self._neg(pt)


_JAX: dict = {}


def _jax_group(name, sample):
    if name not in _JAX:
        _JAX[name] = _JaxGroup(GROUPS[name][2], tuple(jnp.asarray(c) for c in sample))
    return _JAX[name]


def _port(bundles):
    return tuple(torch.as_tensor(c) for c in bundles)


@pytest.mark.parametrize("name", ["G1", "G2"])
def test_add_and_double_match_tcurve(name):
    w = GROUPS[name][0]
    p, _ = _points(name, 4, seed=1)
    q, _ = _points(name, 4, seed=2, identity_lane=False)
    jg = _jax_group(name, p)
    group = curve.group(w)
    jp, jq = tuple(map(jnp.asarray, p)), tuple(map(jnp.asarray, q))
    assert (_canon(group.add(_port(p), _port(q))) == _canon(jg.add(jp, jq))).all()
    # p + p goes through the same complete formula
    assert (_canon(group.add(_port(p), _port(p))) == _canon(jg.add(jp, jp))).all()
    assert (_canon(group.double(_port(p))) == _canon(jg.double(jp))).all()


@pytest.mark.parametrize("name", ["G1", "G2"])
def test_window_step_matches_tcurve(name):
    w = GROUPS[name][0]
    acc, _ = _points(name, 4, seed=3)
    base, _ = _points(name, 4, seed=4)
    jg = _jax_group(name, acc)
    group = curve.group(w)
    mag = np.array([0, 1, 5, 8], np.int32)
    neg = np.array([False, True, True, False])
    j_table = jg.window_table(tuple(map(jnp.asarray, base)), 4)
    j_out = jg.window_step(tuple(map(jnp.asarray, acc)), j_table, jnp.asarray(mag),
                           jnp.asarray(neg), 4)
    table = group.window_table(_port(base), 4)
    out = group.window_step(_port(acc), table, torch.as_tensor(mag), torch.as_tensor(neg), 4)
    assert (_canon(out) == _canon(j_out)).all()
    assert all((_canon(a) == _canon(b)).all() for a, b in zip(table, j_table))


@pytest.mark.parametrize("name", ["G1", "G2"])
def test_ladder_matches_ref_scalar_mul(name):
    """The whole 64-bit plain ladder (the CPU path of K1's wrapper), to
    affine, against ref_curve: a zero scalar, 1, 2^64 - 1 and a random one,
    with an identity lane."""
    w, G, _ = GROUPS[name]
    pts, affs = _points(name, 4, seed=5)
    scalars = [0, (1 << 64) - 1, 1, 0xDEADBEEFCAFE1234]
    bits = torch.tensor(wl.scalars_to_bits(scalars, 64))
    mags, negs = wl.recode_bits(bits)
    words = tuple(fd.bundle_to_words(c) for c in _port(pts))
    out = ladder.ladder(words, mags, negs.to(torch.int32))
    x, y, inf = curve_kernels.to_affine(out)
    for lane, (aff, k) in enumerate(zip(affs, scalars)):
        want = None if aff is None else G.to_affine(G.mul_scalar(G.from_affine(aff), k))
        assert bool(inf[lane]) == (want is None)
        if want is not None:
            got_x = fd.words_from_mont(x[:, :, lane].numpy())
            got_y = fd.words_from_mont(y[:, :, lane].numpy())
            assert got_x == _coords(want[0], w) and got_y == _coords(want[1], w)


@pytest.mark.parametrize("name", ["G1", "G2"])
def test_lane_sum_and_to_affine_match_ref(name):
    w, G, _ = GROUPS[name]
    pts, affs = _points(name, 4, seed=6)
    words = tuple(fd.bundle_to_words(c) for c in _port(pts))
    x, y, inf = curve_kernels.to_affine(curve_kernels.lane_sum(words, 2))
    for seg in range(2):
        acc = G.infinity
        for a in affs[2 * seg : 2 * seg + 2]:
            acc = G.add(acc, G.from_affine(a))
        want = G.to_affine(acc)
        assert fd.words_from_mont(x[:, :, seg].numpy()) == _coords(want[0], w)
        assert fd.words_from_mont(y[:, :, seg].numpy()) == _coords(want[1], w)
        assert not bool(inf[seg])
    # the identity lane alone maps to (0, 0) with its flag set
    xi, yi, infi = curve_kernels.to_affine(tuple(c[..., 1:2] for c in words))
    assert bool(infi[0]) and not xi.any() and not yi.any()


@pytest.mark.parametrize("nbits", [1, 4, 63, 64, 255])
def test_recode_matches_jax_window_ladder(nbits):
    rng = np.random.default_rng(nbits)
    scalars = [0, (1 << nbits) - 1] + [
        int.from_bytes(rng.bytes(32), "little") % (1 << nbits) for _ in range(6)
    ]
    assert wl.num_windows(nbits) == jwl.num_windows(nbits)
    for s in scalars:
        assert wl.signed_digits(s, nbits=nbits) == jwl.signed_digits(s, nbits=nbits)
    j_mags, j_negs = jwl.signed_digit_arrays(scalars, nbits=nbits)
    mags, negs = wl.recode_bits(torch.tensor(wl.scalars_to_bits(scalars, nbits)))
    assert np.array_equal(mags.numpy(), j_mags) and np.array_equal(negs.numpy(), j_negs)


# ------------------------------------------- K1's chain and 2-bit window forms

JAX_FORMS = {"chain": "mul_scalar_bits", "w2": "mul_scalar_bits_w2"}


@pytest.mark.parametrize("form", ["chain", "w2"])
@pytest.mark.parametrize("name", ["G1", "G2"])
def test_form_matches_tcurve_8_bits(name, form):
    """tcurve's own scan (digits, table and step order included) on the
    compiled add/double shared with the tests above, 8 random bits a lane
    (odd-length 7-bit prefix too for w2's padding), projective X:Y:Z."""
    pt, _ = _points(name, 4, seed=7)
    jg = _jax_group(name, pt)
    bits = np.random.default_rng(8).integers(0, 2, (8, 4)).astype(np.int32)
    words = tuple(fd.bundle_to_words(c) for c in _port(pt))
    for n in (8, 7) if form == "w2" else (8,):
        with jax.disable_jit():
            want = getattr(jg, JAX_FORMS[form])(tuple(map(jnp.asarray, pt)), jnp.asarray(bits[:n]))
        got = ladder.ladder(words, torch.as_tensor(bits[:n]), form=form)
        assert (_canon([fd.words_to_bundle(c) for c in got]) == _canon(want)).all()


@pytest.mark.parametrize("form", ["chain", "w2"])
@pytest.mark.parametrize("name", ["G1", "G2"])
def test_form_matches_ref_scalar_mul(name, form):
    """The whole 64-bit plain ladder of each form (K1's CPU path), to
    affine, against ref_curve, as for the window form above."""
    w, G, _ = GROUPS[name]
    pts, affs = _points(name, 4, seed=5)
    scalars = [0, (1 << 64) - 1, 1, 0xDEADBEEFCAFE1234]
    bits = torch.tensor(wl.scalars_to_bits(scalars, 64)).t().contiguous()
    words = tuple(fd.bundle_to_words(c) for c in _port(pts))
    x, y, inf = curve_kernels.to_affine(ladder.ladder(words, bits, form=form))
    for lane, (aff, k) in enumerate(zip(affs, scalars)):
        want = None if aff is None else G.to_affine(G.mul_scalar(G.from_affine(aff), k))
        assert bool(inf[lane]) == (want is None)
        if want is not None:
            assert fd.words_from_mont(x[:, :, lane].numpy()) == _coords(want[0], w)
            assert fd.words_from_mont(y[:, :, lane].numpy()) == _coords(want[1], w)


@pytest.mark.parametrize("n_bits", [1, 2, 3, 7, 8, 63, 64, 255])
def test_digits_w2_match_tcurve_rule(n_bits):
    """MSB-first 2-bit digits, an odd count padded with a zero top bit, as
    mul_scalar_bits_w2 builds them; the digits spell the scalar."""
    bits = np.random.default_rng(n_bits).integers(0, 2, (n_bits, 3)).astype(np.int32)
    padded = np.concatenate([bits, np.zeros((n_bits % 2, 3), np.int32)])
    want = (padded[0::2] + 2 * padded[1::2])[::-1]
    got = wl.digits_w2(torch.as_tensor(bits))
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    scalar = (bits.astype(object) * (1 << np.arange(n_bits, dtype=object))[:, None]).sum(0)
    spelled = [sum(int(d) << (2 * i) for i, d in enumerate(got.numpy()[::-1, j])) for j in range(3)]
    assert spelled == list(scalar)


@pytest.mark.parametrize(
    "form, n_operands, match",
    [("w4", 1, "unknown form"), ("window", 1, "takes 2 digit operand"),
     ("chain", 2, "takes 1 digit operand"), ("w2", 2, "takes 1 digit operand")],
)
def test_unknown_form_or_operands_raise(form, n_operands, match):
    """Both the wrapper and the plain version refuse a form they do not
    know and a digit operand count that does not fit the form."""
    pts, _ = _points("G1", 2, seed=9, identity_lane=False)
    words = tuple(fd.bundle_to_words(c) for c in _port(pts))
    operands = [torch.zeros((8, 2), dtype=torch.int32)] * n_operands
    for call in (ladder.ladder, ladder.ladder_plain):
        with pytest.raises(ValueError, match=match):
            call(words, *operands, form=form)
