"""The port's G2 subgroup check against the JAX package and the reference
curve: the unified Jacobian step (`ops/curve.py` `Jacobian` against
`lighthouse_tpu/ops/curve.py` `JacobianGroup`), the ladder of
`batch_verify.g2_points_in_subgroup` over a few bits, the kernel's generated
rows (`ops/subgroup_rows.py`: the header, the slot map's check, the counts,
the rows run on Python integers lane by lane and warp by warp against the
plain ladder word for word, and over all of r against
`ref_curve.G2.in_subgroup`), and the masks and the signature memo of
`gpu_backend.check_signature_subgroups` on a ladder over 13's bits. The
plain version and the emulated rows over all of r on every edge point (~3-5
s each on the CPU) are in tests/test_torch_parity_slow.py, against
`ref_curve` and the JAX function.

Inputs are exceptional on purpose: P + P, P + (-P), the point at infinity,
Z != 1, and a point of order 13 on the twist (13^2 divides the cofactor
h2), on which a ladder meets those cases inside its run. Equality is exact
(canonical words, or the verdict).
"""

import copy
import functools

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
from lighthouse_tpu_torch.ops import subgroup_rows

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
    `bits` (steps, lanes): each lane its own bit a step; every step's
    (acc, addend) kept."""
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


def _step_cases():
    """(acc, addend) on every case of JacobianGroup.add's selects."""
    g = RG2.generator
    p = RG2.add(RG2.mul_scalar(g, 5), g)  # Z != 1
    q = RG2.mul_scalar(g, 9)
    return [
        (p, q),  # generic, both Z != 1
        (p, p),  # P + P, one representation
        (p, _rescale(p, 7)),  # P + P, two representations
        (p, RG2.neg(p)),  # P + (-P)
        (INF, q),  # inf + P
        (p, INF),  # P + inf
        (INF, INF),
        (_order13(), RG2.add(_order13(), _order13())),  # Q + 2Q on the twist's 13-torsion
    ]


def _short_ladder_cases():
    """(acc, addend) of the short ladder: the order-13 point (the doubling
    and infinity branches fire inside the run), its negation, Q from acc = Q
    (P + (-P) inside the run), 2Q, two subgroup points and an SSWU point."""
    Q = _order13()
    g = RG2.generator
    sswu = _sswu(b"ladder", 1)[0]
    addends = [Q, RG2.neg(Q), Q, RG2.add(Q, Q), RG2.mul_scalar(g, 3),
               RG2.add(RG2.mul_scalar(g, 11), g), sswu, Q]
    accs = [INF, INF, Q, INF, INF, INF, INF, RG2.add(Q, Q)]
    return list(zip(accs, addends))


STEP_BITS = [1] + [0] * 7


@functools.cache
def _jax_histories():
    """Both tests' lanes side by side through ONE jitted scan (each lane
    its own bits), so a process traces the graph once: {name: (the
    lanes' (acc, addend) history, their cases)}."""
    named = {"step": (_step_cases(), STEP_BITS), "ladder": (_short_ladder_cases(), LADDER_BITS)}
    cases = [c for cs, _ in named.values() for c in cs]
    bits = np.array([b for cs, bs in named.values() for b in [bs] * len(cs)], dtype=np.int32).T
    hist = _jax_ladder(_jax([c[0] for c in cases]), _jax([c[1] for c in cases]), jnp.asarray(bits))
    out, lo = {}, 0
    for name, (cs, _) in named.items():
        out[name] = (tuple(tuple(c[:, lo:lo + len(cs)] for c in pt) for pt in hist), cs)
        lo += len(cs)
    return out


def test_jacobian_step_matches_jax():
    """One step with bit 1: acc + addend and the addend's doubling, on every
    case of JacobianGroup.add's selects, word for word."""
    hist, cases = _jax_histories()["step"]
    accs, addends = [c[0] for c in cases], [c[1] for c in cases]
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
    word for word, on `_short_ladder_cases`."""
    hist, cases = _jax_histories()["ladder"]
    _assert_equal_steps(hist, _port([c[0] for c in cases]), _port([c[1] for c in cases]), LADDER_BITS)


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


# --------------------------------------------- the kernel's rows, emulated


def _lane(pt):
    """A Jacobian point (ref_curve coordinates) -> the emulator's lane: the
    Montgomery ints X0, X1, Y0, Y1, Z0, Z1."""
    return [c % P * (1 << 384) % P for coord in pt for c in coord]


def _lanes(pt):
    """Port bundles -> each lane's 6 Montgomery ints."""
    ints = [fd.words_to_ints(w) for w in _port_words(pt)]  # lane-major, 2 components a lane
    return [[ints[c][2 * lane + k] for c in range(3) for k in range(2)]
            for lane in range(len(ints[0]) // 2)]


def _plain_trace(accs, addends, bits):
    """The plain ladder (`subgroup.ladder_step` on bundles): each bit's
    (acc lanes, addend lanes)."""
    acc, addend = _port(accs), _port(addends)
    out = []
    for bit in bits:
        acc, addend = subgroup.ladder_step(acc, addend, bit)
        out.append((_lanes(acc), _lanes(addend)))
    return out


def _assert_trace(trace, plain, lane, bits):
    """The emulated lane equals the plain ladder, acc after every bit and
    the addend after every bit but the last (whose doubling the kernel
    skips)."""
    for i, ((acc, addend), (p_acc, p_addend)) in enumerate(zip(trace, plain)):
        assert acc == p_acc[lane], f"bit {i}: acc"
        if i + 1 < len(bits):
            assert addend == p_addend[lane], f"bit {i}: addend"


def _ladder_cases():
    """(acc, addend) pairs that meet every select: infinity on either side,
    acc == addend (the doubling branch, order 13 at bits 4 and 5), acc ==
    -addend, Z != 1 on either side, points off the subgroup."""
    Q, g = _order13(), RG2.generator
    return {
        "order13": (INF, Q),
        "order13_negated": (INF, RG2.neg(Q)),
        "acc_equals_addend": (Q, Q),
        "acc_is_minus_addend": (RG2.neg(Q), Q),
        "order13_doubled": (INF, RG2.add(Q, Q)),
        "addend_at_infinity": (Q, INF),
        "both_at_infinity": (INF, INF),
        "subgroup_z_not_1": (INF, _rescale(RG2.mul_scalar(g, 5), 7)),
        "acc_z_not_1": (_rescale(RG2.mul_scalar(g, 3), 2), RG2.mul_scalar(g, 11)),
        "sswu": (INF, _sswu(b"ladder", 1)[0]),
    }


def test_header_is_generated():
    with open(subgroup_rows.HEADER) as f:
        assert f.read() == subgroup_rows.header_text(), \
            "regenerate: python -m lighthouse_tpu_torch.ops.subgroup_rows"


def test_slot_map_passes_its_check_and_a_clobber_fails_it():
    """Every program's slot map passes `check` (reads find the values the
    formulas name, the phase rule, the test's slots, the persistent values
    in place); a doubling row that writes over the addend before the
    addition's last read of it fails."""
    for prog in subgroup_rows.PROGRAMS.values():
        subgroup_rows.check(prog)
    prog = copy.deepcopy(subgroup_rows.PROGRAMS["FUSED"])
    a = next(i for i, row in enumerate(prog.phases[0][1]) if row[0] == "a")  # a = X2^2
    per = prog.rows[0][1]
    for t, rows in enumerate(per):
        for j, row in enumerate(rows):
            if prog.sources[0][t][j] == a:
                per[t][j] = (row[0], subgroup_rows.PERSISTENT.index("X2") * 2 + (row[1] & 1), *row[2:])
    with pytest.raises(AssertionError):
        subgroup_rows.check(prog)


def test_row_product_counts():
    """7 and 16 Fp2 products a doubling and an addition, 23 a fused set bit,
    3,922 a lane over r; the warp's work in 24-word products and
    reductions, 9 a clear bit and 28 a set bit (15 and 30 in whole rows)."""
    rows = subgroup_rows
    assert (rows.DOUBLE_PRODUCTS, rows.ADD_PRODUCTS) == (subgroup.DOUBLE_PRODUCTS,
                                                        subgroup.ADD_PRODUCTS) == (7, 16)
    assert rows.PROGRAMS["FUSED"].products() == 23 and rows.PROGRAMS["DBL_ACC"].products() == 7
    assert rows.lane_rows() == 133 * 23 + 121 * 7 + 16 == 3_922
    assert [rows.PROGRAMS[n].work() for n in ("DBL", "FUSED", "ADD", "DBL_ACC")] == [9, 28, 24, 9]
    assert rows.lane_work() == 133 * 28 + 121 * 9 + 24 == 4_837
    assert subgroup.row_products(2) == 2 * 3_922 * 2.5


@functools.lru_cache(maxsize=None)
def _plain_cases():
    """The plain ladder over 179's bits on every case, one batch."""
    cases = _ladder_cases()
    return _plain_trace([c[0] for c in cases.values()], [c[1] for c in cases.values()], LADDER_BITS)


@pytest.mark.parametrize("case", list(_ladder_cases()))
def test_emulated_lane_matches_plain_ladder(case):
    """One lane of the kernel's rows, bit by bit over 179's bits, word for
    word against the plain curve.J2 ladder."""
    cases = _ladder_cases()
    acc, addend = cases[case]
    trace = subgroup_rows.emulate_lane(_lane(addend), LADDER_BITS, acc=_lane(acc))
    _assert_trace(trace, _plain_cases(), list(cases).index(case), LADDER_BITS)


def test_mixed_warp_matches_plain_ladder():
    """A warp of seven subgroup points and one point of order 13: the warp
    runs the doubling of acc where the order-13 lane needs it (bits 4 and
    5), and every lane's words stay the plain ladder's."""
    g = RG2.generator
    addends = [RG2.mul_scalar(g, k) for k in (3, 4, 6, 7)] + [
        _rescale(RG2.mul_scalar(g, k), 5) for k in (8, 9, 10)] + [_order13()]
    stats = {}
    traces = subgroup_rows.emulate_warp([_lane(p) for p in addends], LADDER_BITS, stats=stats)
    plain = _plain_trace([INF] * len(addends), addends, LADDER_BITS)
    for lane, trace in enumerate(traces):
        _assert_trace(trace, plain, lane, LADDER_BITS)
    assert stats["dbl_acc"] == 2


@pytest.mark.parametrize("point", ["subgroup", "order13"])
def test_emulated_rows_over_r_give_ref_verdict(point):
    """Over all of r the kernel's rows give ref_curve.G2.in_subgroup, with
    3,922 Fp2 products on a subgroup point."""
    pt = RG2.mul_scalar(RG2.generator, 5) if point == "subgroup" else _order13()
    x, y = RG2.to_affine(pt)
    stats = {}
    got = subgroup_rows.in_subgroup(tuple(_lane((x,))[:2]), tuple(_lane((y,))[:2]), stats)
    assert got == RG2.in_subgroup(pt) == (point == "subgroup")
    if point == "subgroup":
        assert stats == {"products": 3_922}


@pytest.mark.parametrize("kind", ["square_c0", "square_c1", "product_c0", "product_c1"])
def test_half_row_wide_sums(kind):
    """A half row's one or two 24-word products summed into T0 = p^2 + ..:
    operands below 2p, T0 in [0, p 2^384), and its Montgomery reduction
    (fp_product.reduce_words, the kernel's word for word) the component:
    (A0 + A1)(A0 - A1) and 2 A0 A1 of a square, A0 B0 - A1 B1 and A0 B1 +
    A1 B0 of a product."""
    from lighthouse_tpu_torch.ops.fp_product import reduce_words

    r_inv = pow(1 << 384, -1, P)
    rng = np.random.default_rng(13)
    rand = lambda: int.from_bytes(rng.bytes(48), "little") % P  # noqa: E731
    cases = [[(P - 1) * ((k >> j) & 1) for j in range(4)] for k in range(16)]
    cases += [[rand() for _ in range(4)] for _ in range(100)]
    for a0, a1, b0, b1 in cases:
        if kind == "square_c0":
            terms, want = [(a0 + a1, (a0 - a1) % P, 1)], a0 * a0 - a1 * a1
        elif kind == "square_c1":
            terms, want = [(2 * a0, a1, 1)], 2 * a0 * a1
        elif kind == "product_c0":
            terms, want = [(a0, b0, 1), (a1, b1, -1)], a0 * b0 - a1 * b1
        else:
            terms, want = [(a0, b1, 1), (a1, b0, 1)], a0 * b1 + a1 * b0
        assert all(x < 2 * P and y < 2 * P for x, y, _ in terms)
        t = P * P + sum(sign * x * y for x, y, sign in terms)
        assert 0 <= t < P << 384
        assert reduce_words(t) == want * r_inv % P


@pytest.mark.parametrize("lanes", [1, 30_720])
def test_kernel_products(lanes):
    assert subgroup.kernel_products(lanes) == 3 * (7 * 254 + 16 * 134) * lanes
    assert subgroup.jax_form_products(lanes) == 22_950 * lanes
