"""The lane programs of K2 and K3 (lighthouse_tpu_torch/ops/lanes.py, the
generated csrc/lane_programs.cuh) on the CPU, in plain Python integers:

* the committed header is what the generator emits from ops/programs.py;
* per-lane operand rows, one Montgomery product per lane, then the C
  combination: FP12_MUL, FP12_SQR and LINE_MUL equal crypto/ref_fields'
  fp12_mul, fp12_sqr and the product with the sparse line as an Fp12;
* K2's iteration schedule (f^2 beside the doubling step's Fp2 products,
  then the line product, and with the addition step) equals the port's
  tpairing steps; K2's whole call list equals the plain Miller loop and
  K3's the reference final exponentiation;
* the word-level model of the kernels' operand sum (lanes.cuh `lin_sum`)
  reduces correctly at its bound, and every encoded row keeps that bound.

No JAX graph, no end-to-end verify: the file runs in about a second.
"""

import os

import numpy as np
import pytest
import torch

from lighthouse_tpu.crypto import ref_fields as rf
from lighthouse_tpu.crypto import ref_pairing as rp
from lighthouse_tpu.crypto.constants import P
from lighthouse_tpu_torch.ops import field as fd
from lighthouse_tpu_torch.ops import fp_product, lanes, miller
from lighthouse_tpu_torch.ops import tpairing as tp

torch.set_num_threads(1)

K2 = lanes.k2_tables()
K3 = lanes.k3_tables()


def _rand(rng, n):
    return [int.from_bytes(rng.bytes(48), "little") % P for _ in range(n)]


def _fp12(v):
    """12 slot values -> ref_fields Fp12 ((c0, c1, c2), (c0, c1, c2))."""
    return tuple(tuple((v[6 * i + 2 * j], v[6 * i + 2 * j + 1]) for j in range(3)) for i in range(2))


def _slots(x):
    return [c for fp6 in x for fp2 in fp6 for c in fp2]


def _run_bilinear(fn, x, y):
    """One program out = fn(recorder, x, y) on regions 1, 2 -> 3, emulated."""
    b = lanes.Recorder()
    out = fn(b, b.value(1, 0, len(x)), b.value(2, 0, len(y)))
    for i, v in enumerate(out):
        b.out(3, i, v)
    prog = lanes.Program("p", b, 36)
    kt = lanes.KernelTables("T", 36 + prog.n_scratch, [prog], {"C": [("p", 0, 12, 24)]}, [], {})
    file = [0] * kt.ns
    for i, v in enumerate(x):
        file[i] = lanes.mont(v)
    for i, v in enumerate(y):
        file[12 + i] = lanes.mont(v)
    lanes.emulate(kt, "C", file)
    return [file[24 + i] * lanes.R_INV % P for i in range(len(out))], prog


def test_header_matches_generator():
    with open(lanes.HEADER) as f:
        assert f.read() == lanes.header_text(), "regenerate: python -m lighthouse_tpu_torch.ops.lanes"


@pytest.mark.parametrize("source, line", [
    ("lanes.cuh", "constexpr int G = LANES;"),
    ("final_exp.cu", "constexpr int SET_LANES = K3::SET_LANES;"),
])
def test_kernels_take_their_widths_from_the_header(source, line):
    """The widths that the shared-memory figures use are the compiled ones:
    the kernels read them from the generated header, and no macro can
    change them at build time."""
    with open(os.path.join(os.path.dirname(lanes.HEADER), source)) as f:
        text = f.read()
    assert line in text and "#ifndef" not in text and "#if " not in text
    assert f"constexpr int LANES = {lanes.LANES};" in lanes.header_text()
    assert f"static constexpr int SET_LANES = {lanes.K3_SET_LANES};" in lanes.header_text()


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("name", ["FP12_MUL", "FP12_SQR", "LINE_MUL"])
def test_program_on_lanes_matches_ref_fields(name, seed):
    rng = np.random.default_rng(seed)
    x = _rand(rng, 12)
    if name == "FP12_MUL":
        y = _rand(rng, 12)
        got, prog = _run_bilinear(lanes.fp12_mul, x, y)
        want = rf.fp12_mul(_fp12(x), _fp12(y))
    elif name == "FP12_SQR":
        got, prog = _run_bilinear(lambda b, u, v: lanes.fp12_sqr(b, u), x, [])
        want = rf.fp12_sqr(_fp12(x))
    else:
        line = _rand(rng, 6)  # [l0, l2, l3]: slots (w^0 v^0, w^0 v^1, w^1 v^1)
        got, prog = _run_bilinear(lanes.line_mul, x, line)
        z = (0, 0)
        want = rf.fp12_mul(_fp12(x), ((tuple(line[0:2]), tuple(line[2:4]), z),
                                      (z, tuple(line[4:6]), z)))
    assert got == _slots(want)
    # one product a lane, the C combination a step later
    n = {"FP12_MUL": 54, "FP12_SQR": 36, "LINE_MUL": 39}[name]
    assert prog.n_products == n and len(prog.steps) == 2


def _k2_file(rng):
    """A K2 slot file with random f, T = (X, Y, Z), P and Q (Montgomery)."""
    file = [0] * K2.ns
    s = K2.symbols
    vals = {"F": 12, "TX": 2, "TY": 2, "TZ": 2, "PX": 1, "PY": 1, "QX": 2, "QY": 2}
    for name, n in vals.items():
        for i, v in enumerate(_rand(rng, n)):
            file[s[name] + i] = lanes.mont(v)
    return file


def _bundle(file, base, n):
    vals = [file[base + i] * lanes.R_INV % P for i in range(n)]
    return fd.words_to_bundle(torch.tensor(fd.mont_words(vals)[:, :, None]))


def _ints(bundle):
    return [v * lanes.R % P for v in fd.words_from_mont(fd.bundle_to_words(bundle)[..., 0].numpy())]


@pytest.mark.parametrize("with_add", [False, True], ids=["dbl", "dbl_add"])
def test_k2_iteration_schedule_matches_tpairing(with_add):
    rng = np.random.default_rng(5)
    file = _k2_file(rng)
    s = K2.symbols
    f = _bundle(file, s["F"], 12)
    t = tuple(_bundle(file, s[k], 2) for k in ("TX", "TY", "TZ"))
    p = (_bundle(file, s["PX"], 1), _bundle(file, s["PY"], 1))
    q = (_bundle(file, s["QX"], 2), _bundle(file, s["QY"], 2))
    f = tp.fp12_sqr(f)
    t, line = tp.dbl_step(t, *p)
    f = tp.mul_by_line(f, line)
    if with_add:
        t, line = tp.add_step(t, q, *p)
        f = tp.mul_by_line(f, line)
    prog = K2.programs[K2.prog_id["dbl_add" if with_add else "dbl"]]
    kt = lanes.KernelTables("K2", K2.ns, [prog], {"one": [(prog.name, 0, 0, 0)]}, [], {})
    stats = {}
    lanes.emulate(kt, "one", file, stats)
    assert [file[s["F"] + i] for i in range(12)] == _ints(f)
    for name, v in zip(("TX", "TY", "TZ"), t):
        assert [file[s[name] + i] for i in range(2)] == _ints(v)
    # f^2 shares the first step with the doubling step's Fp2 products
    first = prog.steps[0]
    assert sum(r.kind for r in first) == 36 + 12
    assert stats["steps"] == (7 if with_add else 5)


def test_k2_call_list_matches_plain_miller_loop():
    rng = np.random.default_rng(6)
    px, py = _rand(rng, 2)
    qx, qy = _rand(rng, 2), _rand(rng, 2)
    file = [0] * K2.ns
    s, m = K2.symbols, lanes.mont
    file[s["F"]], file[s["TZ"]] = m(1), m(1)
    file[s["PX"]], file[s["PY"]] = m(px), m(py)
    for i in range(2):
        file[s["QX"] + i] = file[s["TX"] + i] = m(qx[i])
        file[s["QY"] + i] = file[s["TY"] + i] = m(qy[i])
    lanes.emulate(K2, "LOOP", file)

    def words(vals):
        return torch.tensor(fd.mont_words(vals)[:, :, None])

    f = miller.miller_loop_plain((words([px]), words([py])), (words(qx), words(qy)),
                                 torch.ones(1, dtype=torch.bool))
    assert [file[s["F"] + i] for i in range(12)] == \
        [v * lanes.R % P for v in fd.words_from_mont(f[:, :, 0].numpy())]


def test_k3_call_lists_match_ref_final_exponentiation():
    rng = np.random.default_rng(7)
    a, b = _rand(rng, 12), _rand(rng, 12)
    file = [0] * K3.ns
    for slot, v in K3.consts:
        file[slot] = v
    A, B = K3.symbols["REG_A"], K3.symbols["REG_B"]
    for i in range(12):
        file[A + i], file[B + i] = lanes.mont(a[i]), lanes.mont(b[i])
    stats = {}
    lanes.emulate(K3, "MUL", file)
    lanes.emulate_fexp(K3, file, stats)
    want = rp.final_exponentiation(rf.fp12_mul(_fp12(a), _fp12(b)))
    assert [file[A + i] * lanes.R_INV % P for i in range(12)] == _slots(want)
    assert stats["steps"] == 720


def _decoded_rows(kt):
    tab, sec = kt.table, kt.sections
    for r in range((sec["TERMS"] - sec["ROWS"]) // 2):
        w0, w1 = tab[sec["ROWS"] + 2 * r], tab[sec["ROWS"] + 2 * r + 1]
        nl, nr = (w0 >> 14) & 63, (w0 >> 20) & 63
        terms = tab[sec["TERMS"] + w1: sec["TERMS"] + w1 + nl + nr]
        coeff = [(t >> 12) - ((t >> 31) << 20) for t in terms]
        yield (w0 >> 12) & 3, nl, nr, coeff


@pytest.mark.parametrize("kt", [K2, K3], ids=["K2", "K3"])
def test_every_row_keeps_the_operand_sum_bound(kt):
    rows = list(_decoded_rows(kt))
    assert rows
    for kind, nl, nr, coeff in rows:
        assert kind in (lanes.KIND_LIN, lanes.KIND_MUL)
        assert nl >= 1 and (kind == lanes.KIND_LIN) == (nr == 0)
        assert sum(abs(c) for c in coeff[:nl]) <= lanes.L1_MAX
        assert sum(abs(c) for c in coeff[nl:]) <= lanes.L1_MAX


@pytest.mark.parametrize("case", ["random", "all_high_positive", "all_high_mixed"])
def test_lin_sum_word_model_reduces_at_its_bound(case):
    rng = np.random.default_rng(8)
    for _ in range(40):
        if case == "random":
            n = int(rng.integers(1, 20))
            xs = _rand(rng, n)
            cs = [int(c) for c in rng.integers(-4, 5, n)]
        else:
            xs = [P - 1 - int(rng.integers(0, 1 << 20)) for _ in range(16)]
            cs = [4] * 16 if case == "all_high_positive" else [4, -4] * 8
        while sum(abs(c) for c in cs) > lanes.L1_MAX:
            cs = cs[:-1]
            xs = xs[:-1]
        value, operand = lanes.lin_sum_words(xs, cs)
        assert value == sum(c * x for c, x in zip(cs, xs)) % P
        assert operand < 2 * P and operand % P == value


@pytest.mark.parametrize("length", [1, 3, 64])
def test_fp_product_chain_plain(length):
    x, y = fp_product.random_words(3, 1), fp_product.random_words(3, 2)
    got = fp_product._ints(fp_product.chain(x, y, length))
    want = fp_product._ints(x)
    for _ in range(length):
        want = [lanes.mont_mul(a, b) for a, b in zip(want, fp_product._ints(y))]
    assert got == want


def test_fp_product_chain_refuses_cpu_tensor_for_kernel():
    x = fp_product.random_words(2, 1)
    with pytest.raises(ValueError, match="CUDA kernel was requested for a CPU tensor"):
        fp_product.chain(x, x, 1, require_kernel=True)


def test_chain_profile_counts_what_the_emulator_runs():
    file = [0] * K3.ns
    stats = {}
    lanes.emulate_fexp(K3, file, stats)
    prof = lanes.chain_profile(K3, ["FEXP_A", "inv", "FEXP_B"])
    assert prof["steps"] == stats["steps"]
    assert prof["products"] == stats["products"] + lanes.INV_PRODUCTS
    # the inversion: 14 table products, then 4 squarings a window and one
    # product a nonzero window below the top one (which is 1)
    w = lanes.INV_WINDOWS
    assert w[0] == 1 and len(w) == 96
    assert lanes.INV_PRODUCTS == 14 + 4 * 95 + sum(d != 0 for d in w[1:])


@pytest.mark.parametrize("kernel", ["miller", "fold", "pair"])
def test_shared_memory_fits_a_block(kernel):
    kt, threads, width = {
        "miller": (K2, lanes.K2_THREADS, lanes.LANES),
        "fold": (K3, lanes.K3_FOLD_THREADS, lanes.LANES),
        "pair": (K3, lanes.K3_SET_THREADS, lanes.K3_SET_LANES),
    }[kernel]
    assert len(kt.table) % 4 == 0  # the slot files stay 16-byte aligned
    assert lanes.shared_bytes(kt, threads, width) <= 227 * 1024
