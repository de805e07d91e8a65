"""The port's G2 subgroup check against the JAX package and the reference
curve: the unified Jacobian step (`ops/curve.py` `Jacobian` against
`lighthouse_tpu/ops/curve.py` `JacobianGroup`), the ladder of
`batch_verify.g2_points_in_subgroup` over a few bits, the full check
against `ref_curve.G2.in_subgroup` through the kernel's step programs, read
out of `csrc/subgroup.cu` and run on Python integers, and the masks and the
signature memo of `gpu_backend.check_signature_subgroups` on a ladder over
13's bits. The plain version over all of r (~3-5 s on the CPU) is in
tests/test_torch_parity_slow.py, against `ref_curve` and the JAX function.

Inputs are exceptional on purpose: P + P, P + (-P), the point at infinity,
Z != 1, and a point of order 13 on the twist (13^2 divides the cofactor
h2), on which a ladder meets those cases inside its run. Equality is exact
(canonical words, or the verdict).
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lighthouse_tpu.ops import curve as jcurve
from lighthouse_tpu_torch.bls import api, gpu_backend
from lighthouse_tpu_torch.bls.hash_to_curve import hash_to_field_fp2, iso_map, map_to_curve_sswu
from lighthouse_tpu_torch.crypto.constants import P, R
from lighthouse_tpu_torch.crypto.ref_curve import G2 as RG2
from lighthouse_tpu_torch.ops import batch_verify, cuda_build, curve, field as fd, subgroup

# a point of order 13 on E'(Fp2): [h2 r / 169] of an SSWU point (the
# 13-part of E'(Fp2) is Z/13 x Z/13)
ORDER13 = (
    (
        2836965131823123410263967203666700228366617764832011880822917003009180422710328672880982742971667089130324726186765,
        1493440553737758395317049093622249216134088697031662027075306454103180847581429911027814653483157864376196648859787,
    ),
    (
        1883875369676256757931724051005444337857183088130947247092686437224487482716351955195424734420382938063040663037738,
        3553509992304783018100897154919395512649485085278091884435216652014597959035275330737888638199572964083532338401018,
    ),
)
INF = ((1, 0), (1, 0), (0, 0))  # JacobianGroup.infinity_like: (1, 1, 0)

# 179 = 0b10110011, LSB first: from infinity the first addition has an
# infinite operand, and on a point of order 13 the additions at bits 4 and
# 5 meet acc == addend (the doubling branch); from acc = Q the one at bit 1
# meets acc == -addend
LADDER_BITS = [(179 >> i) & 1 for i in range(8)]


def _order13():
    return RG2.from_affine(ORDER13)


def _sswu(tag: bytes, n: int = 2):
    return [RG2.from_affine(iso_map(map_to_curve_sswu(u))) for u in hash_to_field_fp2(tag, n)]


def _rescale(pt, k: int):
    """The same point with Z multiplied by k: (k^2 X, k^3 Y, k Z)."""
    X, Y, Z = pt
    F = RG2.F
    kk = (k % P, 0)
    return (F.mul(F.mul(kk, kk), X), F.mul(F.mul(F.mul(kk, kk), kk), Y), F.mul(kk, Z))


def _words(points):
    """Jacobian points (ref_curve coordinates) -> three (B, 2, 12)
    Montgomery word arrays X, Y, Z."""
    return tuple(
        fd.mont_words([c for pt in points for c in pt[i]]).reshape(-1, 2, fd.NW) for i in range(3)
    )


def _port(points):
    """Port bundles (2, NB, B) of the points' coordinates."""
    return tuple(fd.words_to_bundle(torch.from_numpy(w).permute(1, 2, 0).contiguous())
                 for w in _words(points))


def _jax(points):
    return tuple(jnp.asarray(fd.to_jax_bundle(w)) for w in _words(points))


def _port_words(pt):
    """Port bundles -> (B, 2, 12) canonical words."""
    return [fd.bundle_to_words(c).permute(2, 0, 1).numpy() for c in pt]


def _jax_words(pt):
    return [fd.from_jax_bundle(np.asarray(c)) for c in pt]


@jax.jit
def _jax_ladder(acc, addend, bits):
    """batch_verify.g2_points_in_subgroup's scan step (:457-463) over
    `bits`, every step's (acc, addend) kept."""
    G = jcurve.G2
    batch = acc[0].shape[:-2]

    def step(carry, bit):
        acc, addend = carry
        added = G.add(acc, addend)
        acc = G.select(jnp.broadcast_to(bit == 1, batch), added, acc)
        addend = G.double(addend)
        return (acc, addend), (acc, addend)

    _, hist = jax.lax.scan(step, (acc, addend), bits)
    return hist


def _assert_equal_steps(hist, acc0, addend0, bits):
    acc, addend = acc0, addend0
    for i, bit in enumerate(bits):
        acc, addend = subgroup.ladder_step(acc, addend, bit)
        for name, port_pt, jax_pt in (("acc", acc, hist[0]), ("addend", addend, hist[1])):
            want = _jax_words(tuple(c[i] for c in jax_pt))
            for coord, a, b in zip("XYZ", _port_words(port_pt), want):
                np.testing.assert_array_equal(a, b, err_msg=f"step {i} {name} {coord}")


def test_order13_point():
    Q = _order13()
    assert RG2.is_on_curve(Q) and not RG2.is_infinity(Q)
    assert RG2.is_infinity(RG2.mul_scalar(Q, 13))
    assert not RG2.in_subgroup(Q)


def test_jacobian_step_matches_jax():
    """One step with bit 1: acc + addend and the addend's doubling, on every
    case of JacobianGroup.add's selects, word for word."""
    g = RG2.generator
    p = RG2.add(RG2.mul_scalar(g, 5), g)  # Z != 1
    q = RG2.mul_scalar(g, 9)
    cases = [
        (p, q),  # generic, both Z != 1
        (p, p),  # P + P, one representation
        (p, _rescale(p, 7)),  # P + P, two representations
        (p, RG2.neg(p)),  # P + (-P)
        (INF, q),  # inf + P
        (p, INF),  # P + inf
        (INF, INF),
        (_order13(), RG2.add(_order13(), _order13())),  # Q + 2Q on the twist's 13-torsion
    ]
    accs, addends = [c[0] for c in cases], [c[1] for c in cases]
    hist = _jax_ladder(_jax(accs), _jax(addends), jnp.asarray([1] + [0] * 7, jnp.int32))
    acc0, add0 = _port(accs), _port(addends)
    _assert_equal_steps(hist, acc0, add0, [1])
    # and the group laws, against the reference curve
    got = curve.J2.add(acc0, add0)
    ref = [RG2.add(a, b) for a, b in cases]
    for lane, r in enumerate(ref):
        X, Y, Z = (fd.words_from_mont(w[lane]) for w in _port_words(got))
        pt = ((X[0], X[1]), (Y[0], Y[1]), (Z[0], Z[1]))
        assert RG2.is_infinity(pt) == RG2.is_infinity(r), lane
        if not RG2.is_infinity(r):
            assert RG2.to_affine(pt) == RG2.to_affine(r), lane


def test_short_ladder_matches_jax():
    """Eight steps of the subgroup ladder over the bits of 179, every step
    word for word, on the order-13 point (the doubling and infinity
    branches fire inside the run), its negation, Q from acc = Q (P + (-P)
    inside the run), 2Q, two subgroup points and an SSWU point."""
    Q = _order13()
    g = RG2.generator
    sswu = _sswu(b"ladder", 1)[0]
    addends = [Q, RG2.neg(Q), Q, RG2.add(Q, Q), RG2.mul_scalar(g, 3),
               RG2.add(RG2.mul_scalar(g, 11), g), sswu, Q]
    accs = [INF, INF, Q, INF, INF, INF, INF, RG2.add(Q, Q)]
    hist = _jax_ladder(_jax(accs), _jax(addends), jnp.asarray(LADDER_BITS, jnp.int32))
    _assert_equal_steps(hist, _port(accs), _port(addends), LADDER_BITS)


def _check_points():
    """The points of tests/test_curve_device.py:136-141 (two subgroup
    multiples, two SSWU points before cofactor clearing), the order-13
    point and its negation, and each subgroup multiple once more with
    Z != 1."""
    g = RG2.generator
    good = [RG2.mul_scalar(g, k) for k in (5, 9)]
    return good + _sswu(b"probe") + [_order13(), RG2.neg(_order13())] + [
        _rescale(p, 3) for p in good]


def test_masked_and_infinity_lanes_pass(monkeypatch):
    """The plain check's lanes, on a ladder over 13's bits in place of r's
    (the order-13 point is then "in the subgroup"): a masked lane passes
    whatever its point, a (0, 0) lane under the mask too, and an unmasked
    lane is [13] P == O."""
    monkeypatch.setattr(subgroup, "R_BITS", tuple((13 >> i) & 1 for i in range(4)))
    Q = _order13()
    pts = [Q, RG2.neg(Q), RG2.add(Q, Q), RG2.mul_scalar(RG2.generator, 5), _sswu(b"masked", 1)[0]]
    affs = [RG2.to_affine(p) for p in pts] + [((0, 0), (0, 0))]
    xs = fd.mont_words([c for a in affs for c in a[0]]).reshape(-1, 2, fd.NW)
    ys = fd.mont_words([c for a in affs for c in a[1]]).reshape(-1, 2, fd.NW)
    mask = np.array([True, True, True, True, False, False])
    got = batch_verify.g2_points_in_subgroup((xs, ys), mask, device="cpu").tolist()
    assert got == [True, True, True, False, True, True]


def test_check_signature_subgroups_sets_every_memo(monkeypatch):
    """Each signature's memo is its own lane's verdict, the point at
    infinity a masked lane that passes, no kernel launches on the CPU; on a
    ladder over 13's bits (the full r, against ref_curve.G2.in_subgroup,
    is in tests/test_torch_parity_slow.py)."""
    monkeypatch.setattr(subgroup, "R_BITS", tuple((13 >> i) & 1 for i in range(4)))
    sigs = [api.Signature(p) for p in _check_points()] + [api.Signature(RG2.infinity)]
    before = dict(cuda_build.LAUNCHES)
    got = gpu_backend.check_signature_subgroups(sigs, device="cpu")
    assert cuda_build.LAUNCHES == before
    want = [RG2.is_infinity(RG2.mul_scalar(s.point, 13)) for s in sigs]
    assert got == want and [s._subgroup_ok for s in sigs] == want
    assert want == [False] * 4 + [True, True, False, False, True]
    assert gpu_backend.check_signature_subgroups([], device="cpu") == []


# ------------------------------------------- the kernel's programs, emulated

CU = os.path.join(os.path.dirname(cuda_build.CSRC), "csrc", "subgroup.cu")
SLOT_NAMES = ["X1", "Y1", "Z1", "X2", "Y2", "Z2"] + [f"T{i}" for i in range(14)]


def _kernel_tables():
    """R's words and the three step programs as subgroup.cu writes them."""
    with open(CU) as f:
        text = f.read()
    r_words = re.search(r"R_W\[8\] = \{([^}]*)\}", text).group(1)
    r = sum(int(w.strip().rstrip("u"), 16) << (32 * i) for i, w in enumerate(r_words.split(",")))
    ops = {"MUL": 0, "ADD": 1, "SUB": 2, "SCL": 3}

    def steps(body):
        out = []
        for op, d, a, b in re.findall(r"\{(\w+), (\w+), (\w+), (\w+)\}", body):
            ref = (lambda t: SLOT_NAMES.index(t))
            out.append((ops[op], ref(d), ref(a), int(b) if op == "SCL" else ref(b)))
        return out

    macro = re.search(r"#define LH_DOUBLE\(X, Y, Z\)(.*?)constexpr", text, re.S).group(1)
    macro = macro.replace("\\", "")

    def double(x, y, z):
        return steps(macro.replace(" X,", f" {x},").replace(" X}", f" {x}}}")
                     .replace(" Y,", f" {y},").replace(" Y}", f" {y}}}")
                     .replace(" Z,", f" {z},").replace(" Z}", f" {z}}}"))

    add = steps(re.search(r"ADD_GENERIC\[ADD_STEPS\] = \{(.*?)\};", text, re.S).group(1))
    return r, double("X2", "Y2", "Z2"), double("X1", "Y1", "Z1"), add


def _emulate(x, y, tables):
    """The kernel's lane on Python integers: the slot file, the interpreter
    and add_step's branches as subgroup.cu runs them."""
    r, dbl_addend, dbl_acc, add = tables
    F = RG2.F
    f = [(0, 0)] * len(SLOT_NAMES)
    f[3], f[4], f[5] = x, y, (1, 0)
    f[0], f[1], f[2] = (1, 0), (1, 0), (0, 0)

    def run(prog):
        for op, d, a, b in prog:
            if op == 0:
                f[d] = F.mul(f[a], f[b])
            elif op == 1:
                f[d] = F.add(f[a], f[b])
            elif op == 2:
                f[d] = F.sub(f[a], f[b])
            else:
                f[d] = F.scalar(f[a], b)

    n = r.bit_length()
    for i in range(n):
        if (r >> i) & 1:
            if f[2] == (0, 0):
                f[0], f[1], f[2] = f[3], f[4], f[5]
            elif f[5] != (0, 0):
                run(add)
                if f[SLOT_NAMES.index("T6")] == (0, 0) and f[SLOT_NAMES.index("T7")] == (0, 0):
                    run(dbl_acc)
                else:
                    f[0], f[1], f[2] = (f[SLOT_NAMES.index(t)] for t in ("T11", "T13", "T10"))
        if i + 1 < n:
            run(dbl_addend)
    return f[2] == (0, 0)


def test_kernel_programs_emulated():
    """subgroup.cu's r and its doubling and addition programs, run on
    Python integers as the kernel runs them, give ref_curve's verdict;
    the programs hold 7 and 16 Fp2 products, as `subgroup` counts them."""
    tables = _kernel_tables()
    r, dbl_addend, dbl_acc, add = tables
    assert r == R
    assert sum(op == 0 for op, *_ in dbl_addend) == subgroup.DOUBLE_PRODUCTS
    assert sum(op == 0 for op, *_ in add) == subgroup.ADD_PRODUCTS
    for p in _check_points():
        x, y = RG2.to_affine(p)
        assert _emulate(x, y, tables) == RG2.in_subgroup(p)


@pytest.mark.parametrize("lanes", [1, 30_720])
def test_kernel_products(lanes):
    assert subgroup.kernel_products(lanes) == 3 * (7 * 254 + 16 * 134) * lanes
    assert subgroup.jax_form_products(lanes) == 22_950 * lanes
