"""The port's Fr field (`lighthouse_tpu_torch/ops/rfield.py`) and the plain
version of its Horner kernel (`ops/rs_extend.py`) against the reference's
`lighthouse_tpu/ops/rfield.py`, on the CPU.

The two keep different Montgomery radices (the port 2^256 on 8 words, the
reference 2^264 on 23 limbs), so they are compared on canonical plain
integers: the port's `mul`, `add`, `sub`, `neg`, `to_mont` and `from_mont`
against the reference's functions (one small jitted graph) on seeded
values and edges (0, 1, r - 1, r - 2, 2^254, 2^255 - 19 mod r), exactly.
The kernel's own word-level steps are modelled in Python integers
(`rfield.mul_words`, its PTX carry chains flag by flag, and
`horner_step_words`, with their bounds asserted) and held against
(a b 2^-256) mod r, the product's closed form and the plain Horner,
all-ones words and the largest lazy accumulators among the inputs; the
kernel's split chain (`split_eval_words`: segments, y = x^L, the combine)
against the unsplit chain, the plain version and host Horner at n_coeff
from 1 to 4,097; its constants are read out of `csrc/rs_extend.cu`.
Inputs come from a numpy seed.
"""

import functools
import os
import re

import numpy as np
import pytest
import torch

from lighthouse_tpu.ops import rfield as jrf
from lighthouse_tpu_torch.crypto.constants import R
from lighthouse_tpu_torch.ops import cuda_build, rs_extend
from lighthouse_tpu_torch.ops import rfield as rf

torch.set_num_threads(1)

SOURCE = os.path.join(cuda_build.CSRC, "rs_extend.cu")
EDGES = [0, 1, R - 1, R - 2, 2**254 % R, (2**255 - 19) % R]


def _seeded(n, seed, top=R):
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(32), "little") % top for _ in range(n)]


VALUES = EDGES + _seeded(26, 1)
OTHERS = list(reversed(EDGES)) + _seeded(26, 2)


_JAX_R = 1 << 264  # the reference's Montgomery radix
_JAX_R_INV = pow(_JAX_R, -1, R)


@functools.cache
def _jax_results() -> dict:
    """The reference's ops on VALUES and OTHERS in one small jitted graph
    (one compile): the products and sums on Montgomery bundles packed on
    the host, read back as plain ints (a bundle's value times 2^-264),
    and its to_mont and from_mont once each."""
    import jax

    def mont(values):
        return jrf.pack_ints([v * _JAX_R % R for v in values])

    def graph(plain, ma, mb):
        return {"mul": jrf.mul_lazy(ma, mb), "add": jrf.add(ma, mb), "sub": jrf.sub(ma, mb),
                "neg": jrf.neg(ma), "to_mont": jrf.to_mont(plain), "from_mont": jrf.from_mont(ma)}

    out = jax.jit(graph)(jrf.pack_ints(VALUES), mont(VALUES), mont(OTHERS))
    res = {k: [v * _JAX_R_INV % R for v in jrf.unpack_ints(np.asarray(x))]
           for k, x in out.items() if k != "from_mont"}
    res["from_mont"] = jrf.unpack_ints(np.asarray(out["from_mont"]))
    return res


def _port_plain(op, a, b=None):
    xa = torch.from_numpy(rf.mont_words(a))
    args = (xa,) if b is None else (xa, torch.from_numpy(rf.mont_words(b)))
    return rf.words_from_mont(op(*args).numpy())


@pytest.mark.parametrize("name", ["mul", "add", "sub"])
def test_binary_ops_match_the_reference(name):
    want = {"mul": lambda x, y: x * y, "add": lambda x, y: x + y,
            "sub": lambda x, y: x - y}[name]
    got = _port_plain(getattr(rf, name), VALUES, OTHERS)
    assert got == _jax_results()[name]
    assert got == [want(x, y) % R for x, y in zip(VALUES, OTHERS)]


def test_neg_matches_the_reference():
    got = _port_plain(rf.neg, VALUES)
    assert got == _jax_results()["neg"] == [(-x) % R for x in VALUES]


def test_mont_round_trip_matches_the_reference():
    plain = torch.from_numpy(rf.pack_ints(VALUES))
    mont = rf.to_mont(plain)
    assert rf.words_to_ints(mont.numpy()) == [x * 2**256 % R for x in VALUES]
    assert rf.words_from_mont(mont.numpy()) == VALUES
    back = rf.unpack_ints(rf.from_mont(mont).numpy())
    assert back == _jax_results()["from_mont"] == _jax_results()["to_mont"] == VALUES
    # the host converters agree with the tensor ones
    assert np.array_equal(rf.mont_words(VALUES), mont.numpy())


def test_products_are_counted():
    before = rf.FR_PRODUCTS
    a = torch.from_numpy(rf.mont_words(VALUES))
    rf.mul(a, a)
    assert rf.FR_PRODUCTS - before == len(VALUES)


def test_digit_product_bounds():
    """The largest digits a product takes (the accumulator's relaxed
    bound, every digit 2^17 + 2^7 - 1, against all-ones digits) leave
    relaxed digits of at most 2^16 + 1, the value congruent to a b 2^-256;
    zero gives zero, and the low half's carry is taken when it is due."""
    for K in (rf.ND, rf.ND + 1):
        a = torch.full((1, K), (1 << 17) + (1 << 7) - 1, dtype=torch.int64)
        b = torch.full((1, rf.ND), (1 << 16) - 1, dtype=torch.int64)
        out = rf._mont_digits(a, b)
        assert int(out[..., :-1].max()) <= (1 << 16) + 1

        def value(d):
            return sum(int(v) << (16 * j) for j, v in enumerate(d[0]))

        assert value(out) % R == value(a) * value(b) * rf.R_INV % R
        assert value(out) < value(a) * value(b) // 2**256 + 1.01 * R
        assert not rf._mont_digits(torch.zeros_like(a), b).any()


# ------------------------------------------- the kernel's steps, modelled


def _kernel_constants():
    with open(SOURCE) as f:
        text = f.read()
    body = re.search(r"constexpr uint32_t r_word\(int j\) \{(.*?)\}", text, re.S).group(1)
    words = [int(x, 16) for x in re.findall(r"(0x[0-9a-f]+)u", body)]
    n0 = int(re.search(r"constexpr uint32_t N0 = (0x[0-9a-f]+)u", text).group(1), 16)
    return words, n0


def test_kernel_constants():
    words, n0 = _kernel_constants()
    assert words == rf.R_WORDS and sum(w << (32 * k) for k, w in enumerate(words)) == R
    assert n0 == rf.N0 == (-pow(R, -1, 1 << 32)) % (1 << 32)


ALL_ONES = (1 << 256) - 1
LAZY = [0, 1, R - 1, R, 2 * R - 1, ALL_ONES, ALL_ONES - (1 << 128)] + _seeded(24, 3, 1 << 256)
POINTS = [0, 1, R - 1, R - 2, int("ffffffff" * 7 + "00000000", 16) % R] + _seeded(12, 4)


NPRIME = -pow(R, -1, rf.MONT_R) % rf.MONT_R


def _mont_value(a, b):
    """The CIOS product's closed form: (a b + M r) / 2^256 with M = -a b
    r^-1 mod 2^256, the one M < 2^256 that zeroes the low half, which the
    rows' m_i make up word by word."""
    t = a * b
    return (t + (t * NPRIME & (rf.MONT_R - 1)) * R) >> 256


@pytest.mark.parametrize("a", LAZY, ids=range(len(LAZY)))
def test_word_product_model(a):
    for b in POINTS:
        t = rf.mul_words(a, b)
        assert t < b + R and t % R == a * b * rf.R_INV % R
        assert t == _mont_value(a, b)


def test_horner_step_model_keeps_the_accumulator_lazy():
    accs = [0, R - 1, R, 2 * R - 1] + _seeded(8, 5, 2 * R)
    cs = [0, 1, R - 1] + _seeded(4, 6)
    for acc in accs:
        for x in POINTS[:6]:
            for c in cs:
                s = rf.horner_step_words(acc, x, c)
                assert s < 2 * R and s % R == (acc * x * rf.R_INV + c) % R


def test_plain_horner_matches_the_word_model():
    """eval_poly_batch_plain on Montgomery words equals the kernel's chain
    in the word model, lane by lane, with either output form: 9
    coefficients (one all r - 1, one zero), 3 blobs, 6 points (0, 1 and
    r - 1 among them)."""
    n, blobs = 9, 3
    coeffs = np.array(_seeded(n * blobs, 7), dtype=object).reshape(n, blobs)
    coeffs[2, :] = R - 1
    coeffs[5, :] = 0
    pts = [0, 1, R - 1] + _seeded(3, 8)
    cw = torch.from_numpy(rf.mont_words(coeffs.reshape(-1)).reshape(n, blobs, rf.NW))
    pw = torch.from_numpy(rf.mont_words(pts))
    cints = np.array(rf.words_to_ints(cw.numpy()), dtype=object).reshape(n, blobs)
    pints = rf.words_to_ints(pw.numpy())
    for plain_out in (False, True):
        got = rf.words_to_ints(rs_extend.eval_poly_batch_plain(cw, pw, plain_out).numpy())
        want = [rf.eval_words(list(cints[:, b]), pints[p], plain_out)
                for p in range(len(pts)) for b in range(blobs)]
        assert got == want
    plain = rf.unpack_ints(rs_extend.rs_extend_graph(cw, pw).numpy())
    assert plain == [sum(int(coeffs[i, b]) * pow(x, i, R) for i in range(n)) % R
                     for x in pts for b in range(blobs)]


def test_bound_counts():
    assert rs_extend.horner_products(4096, 8192, 6) == 201_326_592
    assert rs_extend.horner_bytes(1, 1, 1) == 96


# ------------------------------- the carry chains and the split chain


def test_canonical_subtraction_model():
    assert [rf.canon_words(v) for v in (0, R - 1, R, 2 * R - 1)] == [0, R - 1, 0, R - 1]


def test_pow_words_by_squarings():
    for L in (1, 2, 3, 7, 512, 513, 1024):
        for X in (0, 1, R - 1, 5):
            x = X * rf.MONT_R % R
            assert rf.pow_words(x, L) == pow(X, L, R) * rf.MONT_R % R


# points 0, 1 and r - 1, as Montgomery words
EDGE_POINTS = [int(w) for w in rf.words_to_ints(rf.mont_words([0, 1, R - 1]))]


def _host_horner(coeffs, x_mont):
    X = x_mont * rf.R_INV % R
    return sum(c * pow(X, i, R) for i, c in enumerate(coeffs)) % R


def _plain(coeffs, plain_out):
    """eval_poly_batch_plain on one blob at the three edge points."""
    cw = torch.from_numpy(rf.ints_to_words(coeffs).reshape(len(coeffs), 1, rf.NW))
    pw = torch.from_numpy(rf.ints_to_words(EDGE_POINTS))
    return rf.words_to_ints(rs_extend.eval_poly_batch_plain(cw, pw, plain_out).numpy())


SPLIT_CASES = [(S, n) for S in (1, 4, 8) for n in sorted({1, 2, 3, max(1, S - 1), S, 33})]


@pytest.mark.parametrize("segments,n", SPLIT_CASES, ids=[f"S{S}-n{n}" for S, n in SPLIT_CASES])
def test_split_chain_matches_the_unsplit_chain(segments, n):
    """The kernel's split chain in its word model (the carry-chain product
    throughout) equals the unsplit chain `eval_words`, the plain version
    and host Horner, coefficients all r - 1, at points 0, 1 and r - 1,
    either output form; n below S leaves segments of zeros."""
    coeffs = [R - 1] * n
    for plain_out in (False, True):
        got = [rf.split_eval_words(coeffs, x, segments, plain_out) for x in EDGE_POINTS]
        assert got == [rf.eval_words(coeffs, x, plain_out) for x in EDGE_POINTS]
        assert got == _plain(coeffs, plain_out)
        if not plain_out:
            assert got == [_host_horner(coeffs, x) for x in EDGE_POINTS]


@pytest.mark.parametrize("n", [4095, 4096, 4097])
def test_split_chain_at_a_blob_length(n, monkeypatch):
    """At n = 4,095, 4,096 and 4,097 (S divides only 4,096) the split's
    segments, y = x^L and combine equal the unsplit chain and host Horner,
    coefficients all r - 1 and seeded. The chains take the product in its
    closed form here (equal to the carry chains: test_word_product_model),
    for speed. (The plain version takes some 3 s a call at this length on
    one core: it is held against the same chains at the short lengths
    above.)"""
    monkeypatch.setattr(rf, "mul_words", _mont_value)
    for coeffs in ([R - 1] * n, _seeded(n, 11)):
        want = [rf.eval_words(coeffs, x) for x in EDGE_POINTS]
        assert want == [_host_horner(coeffs, x) for x in EDGE_POINTS]
        for S in (4, 8):
            assert [rf.split_eval_words(coeffs, x, S) for x in EDGE_POINTS] == want


def test_split_counts():
    # 8 segments of 512: 9 squarings and 7 combine steps a lane
    assert rs_extend.split_products(4096, 8192, 6, 8) == 8192 * 6 * 8 * 16
    # 4,097 = 8 x 513 - 7: 9 squarings, 1 product, 7 steps a lane; 7 zero steps
    assert rs_extend.split_products(4097, 1, 1, 8) == 8 * 17 + 7
    assert rs_extend.split_products(4096, 8192, 6, 1) == 0
    assert [rf.split_length(n, 8) for n in (1, 7, 8, 9, 4096, 4097)] == [1, 1, 1, 2, 512, 513]
