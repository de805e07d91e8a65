"""K1 on lane groups (lighthouse_tpu_torch/ops/ladder_rows.py, the rows
and the forms' steps of csrc/ladder.cu's kernel) on the CPU, in plain
Python integers:

* the generated header csrc/ladder_rows.cuh matches the generator;
* the rows keep the kernel's rules (no slot read and written in a phase,
  operand sums within lin_sum's bound) and split the products evenly over
  a lane's two threads;
* the rows, decoded from the table's words and run through each form's
  steps as the kernel's threads run them (`emulate`), give the plain
  ladder's words exactly on G1 and G2: the window form for 8-bit scalars
  and for the edge digits (zero, +8, -8, the top window's carry, signs on
  zero digits) and identity points; the chain and w2 forms for 8-16-bit
  scalars and for identity points, all-zero and all-one bits, one bit and
  an odd bit count; each run the MUL rows that `lane_products` counts for
  the bound, whose row counts by form are pinned;
* the addition rows are symmetric in their two points (the chain adds the
  accumulator to the addend) on P + Q, P + P, P + (-P) and the identity;
* csrc/ladder.cu has one kernel body, and no source includes the retired
  one-thread-a-lane field header;
* the operand sum's quotient estimate holds at the new L1 bound of 256;
* the device-side timing of `cuda_build.time_ms` refuses to run without a
  CUDA device;
* the shared Fp product's word-level model (fp_product.mul_words: each
  reduction row's carry folded into the next row) and G2's lazily reduced
  Karatsuba product hold at the operands' bounds.
"""

import os
import re

import numpy as np
import pytest
import torch

from lighthouse_tpu_torch.crypto import ref_curve as rc
from lighthouse_tpu_torch.crypto.constants import P
from lighthouse_tpu_torch.ops import cuda_build, field as fd, ladder, ladder_rows as lr
from lighthouse_tpu_torch.ops import window_ladder as wl
from lighthouse_tpu_torch.ops.lanes import lin_sum_words

R = 1 << 384


def test_header_is_generated():
    with open(lr.HEADER) as f:
        assert f.read() == lr.header_text(), "regenerate: python -m lighthouse_tpu_torch.ops.ladder_rows"


@pytest.mark.parametrize("w", [1, 2])
def test_rows_keep_the_kernel_rules(w):
    lr.check(w)
    tab = lr.Table(w)
    assert tab.slots == 12 * w and len(tab.words) % 4 == 0
    for per in tab.mul_rows:  # products: an even split of every phase
        assert len(per) == lr.T and len({len(rows) for rows in per}) == 1
    for per in tab.lin_rows:  # linear rows: within one of even
        assert abs(len(per[0]) - len(per[1])) <= 1
    bounds = [sum(abs(c) for c in f.values()) for ph in lr.lin_phases(w).values() for _, f in ph]
    assert 64 < max(bounds) <= lr.L1_MAX  # above lanes' 64: 8 b3 (m0 m2) in the doubling's Y3


def _points(w, n, seed):
    """(X, Y, Z) (w, 12, n) canonical Montgomery words: multiples of the
    generator with a projective scale, every third lane the identity."""
    G = rc.G1 if w == 1 else rc.G2
    rng = np.random.default_rng(seed)
    cols = [[[] for _ in range(w)] for _ in range(3)]
    for i in range(n):
        if i % 3 == 1:
            xyz = [[0] * w, [1] + [0] * (w - 1), [0] * w]
        else:
            x, y = G.to_affine(G.mul_scalar(G.generator, int(rng.integers(2, 1 << 20))))
            lam = int(rng.integers(2, 1 << 62))
            xs, ys = ([x], [y]) if w == 1 else (list(x), list(y))
            xyz = [[c * lam % P for c in xs], [c * lam % P for c in ys], [lam] + [0] * (w - 1)]
        for c in range(3):
            for j in range(w):
                cols[c][j].append(xyz[c][j] * R % P)
    return tuple(torch.from_numpy(np.stack([fd.ints_to_words(cols[c][j]).T for j in range(w)]).copy())
                 for c in range(3))


def _edge_digits(n):
    """(3, n) window digits by lane mod 6: zero; +8; -8; the recoding of
    255 (its top window takes the carry); random magnitudes and signs, with
    signs on zero digits; +8 and -8 alternating."""
    rng = np.random.default_rng(3)
    mags, negs = np.zeros((3, n), np.int32), np.zeros((3, n), np.int32)
    m255, n255 = wl.recode_bits(torch.ones((1, 8), dtype=torch.int32))
    for lane in range(n):
        kind = lane % 6
        if kind in (1, 2):
            mags[:, lane], negs[:, lane] = 8, kind == 2
        elif kind == 3:
            mags[:, lane], negs[:, lane] = m255[:, 0].numpy(), n255[:, 0].numpy()
        elif kind == 4:
            mags[:, lane] = rng.integers(0, 9, 3)
            negs[:, lane] = rng.integers(0, 2, 3)
            mags[0, lane], negs[0, lane] = 0, 1  # a sign on a zero digit
        elif kind == 5:
            mags[:, lane], negs[:, lane] = 8, np.arange(3) % 2
    assert m255[-1, 0] == 1  # the top window is the carry
    return torch.from_numpy(mags), torch.from_numpy(negs)


@pytest.mark.parametrize("w", [1, 2])
def test_emulated_rows_match_plain_window_ladder(w):
    pt = _points(w, 4, seed=w)
    bits = torch.from_numpy(np.random.default_rng(w).integers(0, 2, (4, 8)).astype(np.int32))
    mags, negs = wl.recode_bits(bits)
    mags, negs = mags.to(torch.int32), negs.to(torch.int32)
    want = ladder.ladder_plain(pt, mags, negs)
    stats = {}
    got = lr.emulate(pt, mags, negs, stats=stats)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    # the products chip_smoke.py's bound counts are the rows the lanes ran
    rows_madds = stats["mul_rows"] * lr.ROW_MADDS[w]
    assert rows_madds == 4 * lr.lane_products(w, mags.shape[0]) * lr.ROW_MADDS[1]


@pytest.mark.parametrize("w", [1, 2])
def test_emulated_rows_match_plain_on_edge_digits(w):
    pt = _points(w, 6, seed=10 + w)
    mags, negs = _edge_digits(6)
    want = ladder.ladder_plain(pt, mags, negs)
    got = lr.emulate(pt, mags, negs)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def _form_rows(pt, bits, form, w):
    """The emulated form against the plain version, word for word; returns
    the emulated MUL rows over lockstep `lane_products`."""
    want = ladder.ladder_plain(pt, bits, form=form)
    stats = {}
    got = lr.emulate(pt, bits, form=form, stats=stats)
    assert all(torch.equal(a, b) for a, b in zip(got, want)), form
    n = bits.shape[0] if form == "chain" else -(-bits.shape[0] // 2)
    return stats["mul_rows"] * lr.ROW_MADDS[w] / lr.ROW_MADDS[1], pt[0].shape[-1] * lr.lane_products(w, n, form)


@pytest.mark.parametrize("w", [1, 2])
@pytest.mark.parametrize("form", ["chain", "w2"])
def test_emulated_forms_match_plain(form, w):
    """chain and w2 through the rows on random 8-16-bit scalars, every
    third lane the identity."""
    rng = np.random.default_rng(20 + w)
    n_bits = int(rng.integers(8, 17))
    bits = torch.from_numpy(rng.integers(0, 2, (n_bits, 4)).astype(np.int32))
    got, want = _form_rows(_points(w, 4, seed=30 + w), bits, form, w)
    assert got == want


@pytest.mark.parametrize("n_bits", [1, 7])
@pytest.mark.parametrize("w", [1, 2])
@pytest.mark.parametrize("form", ["chain", "w2"])
def test_emulated_forms_on_edge_bits(form, w, n_bits):
    """By lane: all-zero bits; all-one bits on the identity; all-one
    bits; random bits; all-zero bits on the identity; the top bit alone.
    One bit runs the chain without a doubling; seven give w2 a padded top
    digit."""
    bits = np.zeros((n_bits, 6), np.int32)
    bits[:, 1] = bits[:, 2] = 1
    bits[:, 3] = np.random.default_rng(n_bits).integers(0, 2, n_bits)
    bits[-1, 5] = 1
    got, want = _form_rows(_points(w, 6, seed=40 + w), torch.from_numpy(bits), form, w)
    assert got == want


@pytest.mark.parametrize("form, n, set_bits, rows", [
    ("window", 17, None, 816), ("w2", 32, None, 916), ("chain", 64, None, 1272), ("chain", 64, 32, 888)])
def test_lane_products_by_form(form, n, set_bits, rows):
    """A 64-bit scalar's MUL rows a lane: window 17 windows, w2 32 digits
    (65 doublings, 33 additions), the chain in lockstep (63 x 8 + 64 x 12)
    and on its set bits alone; a G2 row is 2.5 products' multiply-adds."""
    assert lr.lane_products(1, n, form, set_bits) == rows
    assert lr.lane_products(2, n, form, set_bits) == 2.5 * rows


@pytest.mark.parametrize("w", [1, 2])
def test_addition_rows_are_symmetric(w):
    """add(a, b) and add(b, a) through the rows give the same words for
    P + Q, P + P, P + (-P), P + O and O + O, the chain's addend-first
    order included."""
    pt = _points(w, 3, seed=50 + w)  # lanes 0, 2 points, lane 1 the identity
    lanes = [[int(x) for c in pt for i in range(w) for x in
              fd.words_to_ints(c[i, :, [lane]].t().contiguous().numpy())] for lane in range(3)]
    P_, O, Q = lanes
    negP = P_[:w] + [(-y) % P for y in P_[w:2 * w]] + P_[2 * w:]
    for a, b in ((P_, Q), (P_, P_), (P_, negP), (P_, O), (O, O)):
        out = []
        for x, y in ((a, b), (b, a)):
            g = lr._Group(w)
            g.set_point(x)
            g.add(y, False)
            out.append(g.point())
        assert out[0] == out[1]


def test_one_kernel_body_and_no_retired_header():
    """csrc/ladder.cu has one kernel, templated on the form's schedule and
    launched by all six C entries, and no noinline field call; no source of
    the port includes bls12_381.cuh, which is gone."""
    with open(os.path.join(cuda_build.CSRC, "ladder.cu")) as f:
        text = f.read()
    assert len(re.findall(r"__global__", text)) == 1 and "__noinline__" not in text
    assert len(re.findall(r"ladder_kernel<W, S><<<", text)) == 1
    assert len(re.findall(r'extern "C" int lh_ladder_g[12]\w*\(', text)) == 6
    assert not os.path.exists(os.path.join(cuda_build.CSRC, "bls12_381.cuh"))
    for d, _, files in os.walk(cuda_build.PKG):
        for name in files:
            if name.endswith((".cu", ".cuh", ".py", ".c", ".h")):
                with open(os.path.join(d, name)) as f:
                    assert '#include "bls12_381.cuh"' not in f.read(), name


@pytest.mark.parametrize("kind", ["max", "min", "mixed"])
def test_operand_sum_at_the_l1_bound(kind):
    """lin_sum's one quotient estimate still finishes at L1 = 256 (the K1
    rows' bound; lanes' rows stay within 64): `lin_sum_words` asserts that
    the estimate leaves less than 2p."""
    rng = np.random.default_rng(0)
    xs = {"max": [P - 1] * 4, "min": [1] * 4,
          "mixed": [int(rng.integers(0, 1 << 62)) * (1 << 318) % P for _ in range(4)]}[kind]
    for cs in ([128, 96, 24, 8], [-128, -96, -24, -8], [96, -96, 1, -63], [-193, 63, 0, 0]):
        assert sum(abs(c) for c in cs) <= lr.L1_MAX
        value, _ = lin_sum_words(xs, cs)
        assert value == sum(c * x for c, x in zip(cs, xs)) % P


def test_time_ms_needs_a_cuda_device():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: this checks the behaviour without one")
    calls = []
    with pytest.raises(RuntimeError, match="CUDA device"):
        cuda_build.time_ms(lambda: calls.append(1))
    with pytest.raises(RuntimeError, match="CUDA device"):
        cuda_build.call_ms(lambda: calls.append(1))
    assert calls == []


@pytest.mark.parametrize("kind", ["extremes", "random", "carry_edges", "ones_above"])
def test_product_word_model(kind):
    """fp_reg.cuh `fp_mul`, word for word (fp_product.mul_words: the
    product's rows with 64-bit carries, the reduction's carry chains): no
    step overflows, no chain's carry is lost, and the result is a b
    2^-384 mod p for operands below 2p, and
    `reduce_words` gives t 2^-384 mod p over the lazy rows' wide sums [0,
    6 p^2), with all-ones words where the reduction's chains carry into
    words the product wrote (carry_edges: the edges; ones_above: random
    sums whose words 11-23 are 0xffffffff or 0xfffffffe)."""
    from lighthouse_tpu_torch.ops.fp_product import mul_wide_words, mul_words, reduce_words

    r_inv = pow(R, -1, P)
    rng = np.random.default_rng(7)
    if kind in ("extremes", "random"):
        if kind == "extremes":
            vals = [0, 1, P - 1, P, 2 * P - 1, (1 << 380) - 1, (1 << 32) - 1, 1 << 352]
            pairs = [(a, b) for a in vals for b in vals]
        else:
            pairs = [(int.from_bytes(rng.bytes(48), "little") % (2 * P),
                      int.from_bytes(rng.bytes(48), "little") % (2 * P)) for _ in range(300)]
        for a, b in pairs:
            assert sum(w << (32 * k) for k, w in enumerate(mul_wide_words(a, b))) == a * b
            assert mul_words(a, b) == a * b * r_inv % P
        return
    m32 = (1 << 32) - 1
    if kind == "carry_edges":
        ts = [0, 1, P * P, 6 * P * P - 1, (1 << 416) - (1 << 352) + 1]
        ts += [((1 << (32 * j)) - 1 << 352) + low for j in range(1, 13) for low in (1, m32, P >> 200)]
        ts.append(2 * P * P + (1 << 384) - 1)
    else:
        ts = []
        for _ in range(300):
            w = [int(v) for v in rng.integers(0, 1 << 32, 24, dtype=np.uint64)]
            w[11:23] = [int(v) for v in rng.choice([m32, m32 - 1], 12)]
            w[23] = int(rng.integers(0, (6 * P * P) >> 736))
            ts.append(sum(v << (32 * k) for k, v in enumerate(w)))
    for t in ts:
        assert reduce_words(t) == t * r_inv % P


def test_lazy_karatsuba_model():
    """fp2_row.cuh `fp2_row` for (a + a')(b + b') over Fp2: canonical
    component sums x0, x1 for the products a0 b0 and a1 b1, the four
    canonical terms' sum less 2p where it reaches 2p for the third product,
    the three 24-word products summed unreduced into T0 = P0 - P1 + p^2 and
    T1 = P2 - P0 - P1 + 2 p^2 in 25-word two's complement (then in [0,
    2 p^2) and [0, 6 p^2)), each reduced once, give the product's
    components."""
    from lighthouse_tpu_torch.ops.fp_product import reduce_words

    r_inv, wrap = pow(R, -1, P), 1 << (32 * 25)
    rng = np.random.default_rng(9)
    rand = lambda: int.from_bytes(rng.bytes(48), "little") % P  # noqa: E731
    cases = [[(P - 1) * ((k >> j) & 1) for j in range(8)] for k in (0, 0x55, 0xAA, 0xFF, 0x0F, 0xF0)]
    cases += [[rand() for _ in range(8)] for _ in range(150)]
    cases += [[rand() for _ in range(4)] + [0] * 4 for _ in range(50)]  # no second terms
    for a0, a1, b0, b1, e0, e1, g0, g1 in cases:  # (a + e)(b + g)
        x0, x1, y0, y1 = (a0 + e0) % P, (a1 + e1) % P, (b0 + g0) % P, (b1 + g1) % P
        x2 = a0 + a1 + e0 + e1
        x2 -= 2 * P if x2 >= 2 * P else 0
        y2 = b0 + b1 + g0 + g1
        y2 -= 2 * P if y2 >= 2 * P else 0
        assert x2 < 2 * P and y2 < 2 * P
        p0, p1, p2 = x0 * y0, x1 * y1, x2 * y2
        t0 = (P * P + p0 - p1) % wrap
        t1 = (2 * P * P + (p2 - p0 - p1) % wrap) % wrap
        assert t0 < 2 * P * P and t1 < 6 * P * P < P << 384
        assert reduce_words(t0) == (x0 * y0 - x1 * y1) * r_inv % P
        assert reduce_words(t1) == (x0 * y1 + x1 * y0) * r_inv % P


def test_kernel_p_squared_constant():
    """fp2_row.cuh's constants of the lazy product (K1's and the subgroup
    check's): p^2, 2 p^2 and 2p, word for word."""
    text = open(os.path.join(cuda_build.CSRC, "fp2_row.cuh")).read()
    for name, want in (("P2_W", P * P), ("P2X2_W", 2 * P * P)):
        body = text[text.index(f"{name}[2 * NW] = {{"):]
        words = [int(x, 16) for x in re.findall(r"0x([0-9a-f]+)u", body[: body.index("};")])]
        assert sum(w << (32 * k) for k, w in enumerate(words)) == want and len(words) == 24
    body = text[text.index("const u32 p2[NW] = {"):]
    words = [int(x, 16) for x in re.findall(r"0x([0-9a-f]+)u", body[: body.index("};")])]
    assert sum(w << (32 * k) for k, w in enumerate(words)) == 2 * P
