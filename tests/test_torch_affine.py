"""The redesigned helper kernels' plans and the Jacobian entry, on the CPU:

* the inversion of the to-affine kernel, modelled word for word
  (ops/fp_inverse.inv_words), against Fermat's a^(p-2);
* the kernel's product-tree plan with zero and padding lanes
  (fp_inverse.tree_inverse) against per-lane inversion;
* the lane-sum fold's launch plan (curve_kernels.fold_plan) and the
  columns each launch folds, run with the plain group addition, word for
  word against lane_sum_plain; the fold's row tables, read from its
  source, run one addition as curve.Projective.add does;
* the Jacobian plain-word entry's plain version against the JAX package's
  host conversion (tpu_backend.batch_to_affine_g2 + _pack_g2_affine, and
  G1_GROUP.to_affine + _pack_g1_affine for keys);
* the words at K1's and K2's inputs after the marshalling moved onto the
  device, against the parent's host conversion, on the grouped, flat and
  per-set paths.
"""

import numpy as np
import pytest
import torch

from lighthouse_tpu.bls import tpu_backend as jtb
from lighthouse_tpu.crypto import ref_curve as jrc
from lighthouse_tpu_torch import testing as T
from lighthouse_tpu_torch.bls import gpu_backend
from lighthouse_tpu_torch.crypto.constants import P
from lighthouse_tpu_torch.crypto.ref_curve import G1 as RG1
from lighthouse_tpu_torch.crypto.ref_curve import G2 as RG2
from lighthouse_tpu_torch.ops import batch_verify as bv
from lighthouse_tpu_torch.ops import curve, curve_kernels, field as fd
from lighthouse_tpu_torch.ops import fp_inverse

torch.set_num_threads(1)

R = 1 << 384


def _fermat_mont_inverse(a: int) -> int:
    """The Montgomery form of the inverse of a Montgomery value a."""
    return pow(a, P - 2, P) * R * R % P


def _seeded(n: int, seed: int) -> list:
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(48), "little") % P for _ in range(n)]


@pytest.mark.parametrize(
    "case", ["zero", "one", "p_minus_1", "two", "high_power_of_two", "mont_one", "seeded"]
)
def test_inverse_model_matches_fermat(case):
    values = {
        "zero": [0],
        "one": [1],
        "p_minus_1": [P - 1],
        "two": [2],
        "high_power_of_two": [1 << 380],  # one long run of trailing zeros
        "mont_one": [R % P],
        "seeded": _seeded(12, 1),
    }[case]
    for a in values:
        assert fp_inverse.inv_words(a) == _fermat_mont_inverse(a)


@pytest.mark.parametrize("n, lanes", [(8, 8), (21, 8), (5, 16)], ids=["full", "two_blocks_and_part", "padded"])
def test_tree_plan_matches_per_lane_inverse(n, lanes):
    """Zero lanes (every third, and the last) become 1 in the tree and 0 in
    the output; padding lanes fill the last block."""
    values = _seeded(n, 2)
    for i in list(range(0, n, 3)) + [n - 1]:
        values[i] = 0
    got = fp_inverse.tree_inverse(values, lanes)
    assert got == [_fermat_mont_inverse(v) if v else 0 for v in values]


@pytest.mark.parametrize(
    "seg, plan", [(1, []), (4, [2]), (128, [7]), (512, [2, 7]), (1024, [3, 7]),
                  (32_768, [8, 7]), (1 << 17, [2, 8, 7])],
)
def test_fold_plan(seg, plan):
    """The last launch takes up to 7 levels, earlier ones up to 8: two
    launches up to 2^15 lanes a segment (the slot's 32,768)."""
    assert curve_kernels.fold_plan(seg) == plan
    assert sum(plan) == seg.bit_length() - 1 and all(L <= curve_kernels.FOLD_LEVELS for L in plan)
    assert (1 << plan[-1] if plan else 1) <= curve_kernels.FOLD_POINTS // 2


def _projective_words(w: int, n: int, seed: int):
    """n projective points (w, 12, n) Montgomery words: chained multiples
    of the generator scaled by a random lambda, every fifth the identity."""
    G = RG1 if w == 1 else RG2
    lams = _seeded(n, seed)
    cols, acc = [], G.generator
    for i in range(n):
        acc = G.add(acc, G.generator)
        x, y = G.to_affine(acc)
        coords = [[x], [y], [1]] if w == 1 else [list(x), list(y), [1, 0]]
        if i % 5 == 2:
            coords = [[0] * w, [1] + [0] * (w - 1), [0] * w]
        cols.append([[v * lams[i] % P for v in c] for c in coords])
    return tuple(
        torch.from_numpy(fd.mont_words([v for col in cols for v in col[j]]).reshape(n, w, fd.NW))
        .permute(1, 2, 0).contiguous()
        for j in range(3)
    )


def _fold_lanes(B: int, seg: int, L: int) -> torch.Tensor:
    """(B >> L, 2^L) lane indices, as fold_kernel computes them: column c
    of a launch that takes L levels folds lanes g seg + j + k (seg >> L),
    k < 2^L, for segment g = c // (seg >> L) and j = c mod (seg >> L)."""
    stride = seg >> L
    c = torch.arange(B >> L)[:, None]
    k = torch.arange(1 << L)[None, :]
    return (c // stride) * seg + c % stride + k * stride


def _planned_fold(pt, seg: int, plan: list):
    """The fold's launches with the plain group addition: each launch
    gathers its columns (_fold_lanes) and folds each with sum_lanes, in
    which point k of a column takes point k + 2^(L-1)."""
    group = curve.group(pt[0].shape[0])
    B = pt[0].shape[-1]
    for L in plan:
        cols = _fold_lanes(B, seg, L).reshape(-1)
        gathered = tuple(fd.words_to_bundle(c[..., cols]) for c in pt)
        pt = tuple(fd.bundle_to_words(c) for c in group.sum_lanes(gathered, 1 << L))
        B, seg = B >> L, seg >> L
    return pt


@pytest.mark.parametrize(
    "w, B, seg, plan",
    [(1, 16, 16, [2, 2]), (1, 16, 8, [1, 2]), (2, 16, 16, [1, 3]), (2, 16, 4, [1, 1]),
     (1, 32, 16, [1, 1, 2])],
    ids=["g1_one_segment", "g1_two_segments", "g2_one_segment", "g2_four_segments", "g1_three_launches"],
)
def test_lane_fold_plan_matches_sum_lanes(w, B, seg, plan):
    """Launches that split the levels of the halving tree compose into the
    whole tree: the projective words equal lane_sum_plain's, word for word,
    whatever the split."""
    pt = _projective_words(w, B, seed=3 + B + seg)
    want = curve_kernels.lane_sum_plain(pt, seg)
    for got_c, want_c in zip(_planned_fold(pt, seg, plan), want):
        assert torch.equal(got_c, want_c)


def _jax_canon(bundle) -> np.ndarray:
    return fd.from_jax_bundle(np.asarray(bundle))


def _port_affine(points, w: int):
    """The Jacobian plain-word entry (plain version) on packed host points:
    (N, w, 12) x and y words and the identity flags."""
    words = gpu_backend._pack_jacobian(points, w)
    x, y, inf = curve_kernels.jacobian_to_affine(tuple(bv._lanes(c, "cpu") for c in words))
    return x.permute(2, 0, 1).numpy(), y.permute(2, 0, 1).numpy(), inf.tolist()


def test_jacobian_entry_matches_jax_host_conversion_g2():
    """Signatures with Z != 1 (chained additions), Z = 1 (as decompressed
    from the wire), the identity, and padding (None, Z = 0)."""
    sets = T.committee_sets(T.validator_pubkeys(4), 1, 4, seed=4)
    chained = [s.signature.point for s in sets[1:]]
    assert all(p[2] != RG2.F.one for p in chained)
    z_one = RG2.from_affine(RG2.to_affine(chained[-1]))
    points = chained + [z_one, RG2.infinity]
    x, y, inf = _port_affine(points + [None], 2)
    jx, jy = jtb._pack_g2_affine(jtb.batch_to_affine_g2(points) + [None])
    assert np.array_equal(x, _jax_canon(jx)) and np.array_equal(y, _jax_canon(jy))
    assert inf == [False] * 4 + [True, True]
    assert not x[4:].any() and not y[4:].any()


def test_jacobian_entry_matches_jax_host_conversion_g1():
    """Keys with Z != 1 (chained additions), Z = 1, and padding."""
    keys = [p.point for p in T.validator_pubkeys(3)]
    keys.append(RG1.from_affine(RG1.to_affine(keys[-1])))
    x, y, inf = _port_affine(keys + [None], 1)
    jx, jy = jtb._pack_g1_affine([jrc.G1.to_affine(p) for p in keys] + [None])
    assert np.array_equal(x, _jax_canon(jx)) and np.array_equal(y, _jax_canon(jy))
    assert inf == [False] * 4 + [True]


def _parent_words(m, sets, order):
    """The parent's host conversion of the batch's signatures and point-path
    keys: affine ints (batch_to_affine_g2, G1_GROUP.to_affine), packed as
    Montgomery words, (x, y) in the marshalled shapes."""
    sig_aff = jtb.batch_to_affine_g2([s.signature.point for s in sets])
    sigs = gpu_backend._pack_g2([None if i is None else sig_aff[i] for i in order])
    keys = []
    for i in order:
        row = [] if i is None else [RG1.to_affine(p.point) for p in sets[i].pubkeys]
        keys += row + [None] * (m.k_bucket - len(row))
    kx = fd.mont_words([a[0] if a else 0 for a in keys])
    ky = fd.mont_words([a[1] if a else 0 for a in keys])
    shape = m.key_mask.shape + (1, fd.NW)
    return (
        tuple(c.reshape(m.sigs[0].shape) for c in sigs),
        (kx.reshape(shape), ky.reshape(shape)),
    )


def _order(m, sets):
    """The marshalled lanes' set indices (None = padding)."""
    if not m.grouped:
        return list(range(len(sets))) + [None] * (m.s_bucket - len(sets))
    order = []
    for _, ix in gpu_backend._group_plan(sets):
        order += list(ix) + [None] * (m.set_mask.shape[1] - len(ix))
    return order + [None] * (m.s_bucket - len(order))


def _equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("layout", ["grouped", "flat", "per_set"])
def test_device_inputs_at_k1_and_k2_equal_the_parents(layout):
    """The device batch's signatures and point-path keys, converted on the
    device from the Jacobian words the host now ships, give K1 (RLC paths)
    and K2 (per-set path) the words of the parent's host conversion."""
    keys = T.validator_pubkeys(6)
    if layout == "grouped":
        sets = T.committee_sets(keys, 2, 3, seed=5)
    else:
        sets = T.flat_sets(keys, 3, max_keys=3, seed=6)
    m = gpu_backend._marshal_flat(sets, pow2=False) if layout == "per_set" else gpu_backend._marshal(sets)
    assert m.grouped == (layout == "grouped") and m.table is None and len(m.sigs) == 3
    sigs_old, keys_old = _parent_words(m, sets, _order(m, sets))
    if layout == "per_set":
        new = bv._individual_pairs(m.msgs, m.sigs, m.pubkeys, m.key_mask, m.set_mask, "cpu")
        old = bv._individual_pairs(m.msgs, sigs_old, keys_old, m.key_mask, m.set_mask, "cpu")
        for a, b in zip(new, old):
            assert _equal(a, b) if isinstance(a, tuple) else torch.equal(a, b)
        return
    sm = bv._mask(m.set_mask, "cpu")
    sig_new = bv._from_affine(*bv._affine(m.sigs, "cpu"), sm)
    sig_old = bv._from_affine(*bv._affine(sigs_old, "cpu"), sm)
    assert _equal(sig_new, sig_old)
    agg_new = bv._aggregate_keys(m.pubkeys, m.key_mask, "cpu")
    agg_old = bv._aggregate_keys(keys_old, m.key_mask, "cpu")
    assert _equal(agg_new, agg_old)


def _cu_tables():
    """FOLD_ROWS_G1 / _G2 (rows of (k, s) terms) and STAGE2_A / _B, read
    from csrc/curve_helpers.cu."""
    import os
    import re

    with open(os.path.join(os.path.dirname(curve_kernels.__file__), "..", "csrc", "curve_helpers.cu")) as f:
        text = f.read()
    rows = {}
    for w in (1, 2):
        body = re.search(r"FOLD_ROWS_G%d\[\d+\]\[FOLD_TERMS\] = \{(.*?)\n\};" % w, text, re.S).group(1)
        rows[w] = [[(int(k), int(s)) for k, s in re.findall(r"T\((-?\d+), (\d+)\)", line)]
                   for line in body.strip().splitlines()]
    stage2 = [[int(v) for v in re.search(r"STAGE2_%s\[6\] = \{([^}]*)\}" % n, text).group(1).split(",")]
              for n in "AB"]
    return rows, stage2


def _kernel_addition(w, p_coords, q_coords, rows, stage2):
    """One complete addition as the fold kernel runs it, on Python ints
    (values mod p, Montgomery words): the stage-1 operands and their
    Karatsuba parts, fp_mul, the rows, the stage-2 operands by STAGE2_A/B,
    the rows again."""
    from lighthouse_tpu_torch.ops.fp_product import mul_words

    K = 1 if w == 1 else 3

    def parts(a, b):  # a, b: w components each
        if w == 1:
            return [mul_words(a[0], b[0])]
        return [mul_words(a[0], b[0]), mul_words(a[1], b[1]), mul_words(a[0] + a[1], b[0] + b[1])]

    def rowsum(row, prods):
        return sum(k * prods[s] for k, s in row) % P

    def stage1(c, i):
        pairs = {3: (0, 1), 4: (1, 2), 5: (0, 2)}
        if i < 3:
            return c[i]
        a, b = pairs[i]
        return [(x + y) % P for x, y in zip(c[a], c[b])]

    prods = [v for i in range(6) for v in parts(stage1(p_coords, i), stage1(q_coords, i))]
    combos = [rowsum(rows[r], prods) for r in range(6 * w)]
    cval = [combos[w * j : w * j + w] for j in range(6)]
    prods = [v for i in range(6) for v in parts(cval[stage2[0][i]], cval[stage2[1][i]])]
    assert len(prods) == 6 * K
    out = [rowsum(rows[6 * w + r], prods) for r in range(3 * w)]
    return [out[w * o : w * o + w] for o in range(3)]


@pytest.mark.parametrize("w", [1, 2], ids=["G1", "G2"])
def test_fold_rows_are_the_plain_addition(w):
    """The fold kernel's row tables and stage-2 operand indices, read from
    its source, run one addition word for word as curve.Projective.add
    does: general points, P + P, P + (-P) and the identity."""
    rows, stage2 = _cu_tables()
    pt = _projective_words(w, 6, seed=9)
    lanes = [[[int(v) for v in fd.words_to_ints(c[:, :, i].numpy())] for c in pt] for i in range(6)]
    neg1 = [lanes[1][0], [(P - v) % P for v in lanes[1][1]], lanes[1][2]]
    pairs = [(lanes[0], lanes[1]), (lanes[3], lanes[3]), (lanes[1], neg1), (lanes[2], lanes[4])]
    assert not any(lanes[2][2])  # lane 2 is the identity
    def words(points, j):  # coordinate j of each point -> (w, 12, n)
        return torch.stack([torch.from_numpy(fd.ints_to_words(pt[j])) for pt in points], -1)

    group = curve.group(w)
    want = group.add(*(tuple(fd.words_to_bundle(words(side, j)) for j in range(3))
                       for side in zip(*pairs)))
    want = [fd.bundle_to_words(c) for c in want]
    for n, (p_, q_) in enumerate(pairs):
        got = _kernel_addition(w, p_, q_, rows[w], stage2)
        for o in range(3):
            assert got[o] == [int(v) for v in fd.words_to_ints(want[o][:, :, n].numpy())]
