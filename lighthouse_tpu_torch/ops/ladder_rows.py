"""K1 on lane groups: the slot map and the rows that `csrc/ladder.cu`'s
kernel runs, generated, the three forms' step schedules, and an emulator.

A group of T = 2 threads runs one lane's ladder, on G1 (w = 1, values in
Fp) and G2 (w = 2, values in Fp2) alike, in each of the three forms
(`window`, `w2`, `chain`: `steps` below). Its values live in a file of Fp
slots in shared memory; a value takes w consecutive slots. Each complete
doubling and addition (the RCB formulas of `ops/curve.py`, in its stage
order) is two rounds of two phases, a barrier after each:

  MUL -- the stage's independent products, half on each thread: a row
         writes (a + a') (b + b') for values a, a', b, b', where a' and b'
         may be absent (NONE); the sums are canonical, so each product's
         operands stay below 2p. On G2 one thread runs the three Karatsuba
         products of its Fp2 product in registers and recombines them.
  LIN -- the stage's linear recombination, one Fp output a row, rows
         alternating between the threads: a row is sum_t c_t slot_t with
         small signed coefficients (L1 norm at most 256), reduced to a
         canonical value (fp_reg.cuh `lin_sum`).

An addition starts with ADD_IN: the addend sign * table[|d|] into the
values V3..V5, its 3 w Fp slots alternating between the threads, Y negated
for a negative digit.

Layout (value i at slot w i):
  V0..V5  the point X, Y, Z (V0..V2) and the addend (V3..V5) between the
          operations, the stage's linear values inside them;
  PR0..PR5 (values 6..11) the stage's products.

Outside the file each lane has ENTRIES[form] points of scratch (the
wrapper allocates it): the window forms' table [0, E) P, or the chain's
accumulator and addend. A step loads V0..V2 from an entry or not, runs one
doubling or one addition of sign * entry, and stores V0..V2 to an entry or
not (`steps`).

    python -m lighthouse_tpu_torch.ops.ladder_rows   # rewrites the header

writes `csrc/ladder_rows.cuh`; `emulate(pt, *operands, form=)` decodes the
table's words as the kernel does and runs each form's steps on Python
integers with the kernel's rules
(canonical slots, operands below 2p, the word-level operand sum of
`lanes.lin_sum_words`, the phase rule of `lanes.commit_step`) and returns
the kernel's words, which the CPU tests hold against `ladder.ladder_plain`.

Why not `ops/lanes.py`'s rows. The term words and `lin_sum` are lanes'
(`lanes.term_word`), and so is the emulator's phase rule. Its row format is
not: a lanes MUL row is one Fp product of two reduced operand sums, while
a K1 MUL row on G2 is a whole Fp2 product, Karatsuba with lazy reduction
(three 24-word products, two reductions: 2.5 products' multiply-adds, not
3, and the recombination in registers, not in LIN rows), over operands
that are plain sums of two values with no reduction. Written as lanes
rows, every G2 product would take three MUL rows and a LIN phase more.
"""

import os

import numpy as np
import torch

from lighthouse_tpu_torch.crypto.constants import P
from lighthouse_tpu_torch.ops import field as fd
from lighthouse_tpu_torch.ops.lanes import commit_step, lin_sum_words, term_parts, term_word
from lighthouse_tpu_torch.ops.window_ladder import digits_w2

NW = 12
R = 1 << 384
R_INV = pow(R, -1, P)
ONE = R % P  # the Montgomery one
T = 2  # threads a lane
BLOCK = 64  # threads a block
# the forms' schedules: points of scratch a lane; the window forms'
# doublings a window (the chain doubles once between bits)
ENTRIES = {"window": 9, "w2": 4, "chain": 2}
DOUBLINGS = {"window": 4, "w2": 2}
L1_MAX = 256  # a LIN row's coefficients' L1 norm (lin_sum's bound)
NONE = 63  # an absent second term of a MUL operand
PROD = 6  # value index of PR0

HEADER = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "csrc", "ladder_rows.cuh")


def PR(k):
    return PROD + k


# MUL phases over value indices: (dst, (a, a'), (b, b')). They compute the
# values of `curve.Projective`'s stages, with the small scalars moved past
# the products where that saves linear rows: doubling Y3 = t2v z8 + t0f y3s
# = 8 b3 (m0 m2) + t0f y3s and Z3 = m1 z8 = 8 m0 m1; addition X3 = t2x -
# t4 y3c = t2x - b3 (t4 t5), Y3 = t1z + y3c T0 = t1z + 3 b3 (t5 m0), Z3 =
# Z3a + T0 t3 = Z3a + 3 m0 t3 (b3 is multiplication by the constant 3b, so
# it commutes with the product)
_ = None
MUL_PHASES = {
    # doubling, stage 1: Y Y, Z Z, Y Z, X Y = m0, m2, m1, m3
    "D1": [(PR(0), (1, _), (1, _)), (PR(2), (2, _), (2, _)),
           (PR(1), (1, _), (2, _)), (PR(3), (0, _), (1, _))],
    # stage 2, over DBL_MID's V2 = y3s, V3 = t0f: t0f m3, m0 m2, t0f y3s,
    # m0 m1
    "D3": [(PR(4), (3, _), (PR(3), _)), (PR(5), (PR(0), _), (PR(2), _)),
           (4, (3, _), (2, _)), (5, (PR(1), _), (PR(0), _))],
    # addition, stage 1: X1 X2, Y1 Y2, (X1+Y1)(X2+Y2), (Y1+Z1)(Y2+Z2),
    # Z1 Z2, (X1+Z1)(X2+Z2) (rows of one kind side by side where they can)
    "A1": [(PR(0), (0, _), (3, _)), (PR(1), (1, _), (4, _)),
           (PR(3), (0, 1), (3, 4)), (PR(4), (1, 2), (4, 5)),
           (PR(2), (2, _), (5, _)), (PR(5), (0, 2), (3, 5))],
    # stage 2, over ADD_MID's V0..V4 = t3, t4, t5, Z3s, t1m and m0: t4 t5,
    # t2x = t3 t1m, t5 m0, t1z = t1m Z3s, m0 t3, Z3a = Z3s t4
    "A3": [(PR(1), (1, _), (2, _)), (PR(2), (0, _), (4, _)),
           (PR(3), (2, _), (PR(0), _)), (PR(4), (4, _), (3, _)),
           (PR(5), (PR(0), _), (0, _)), (5, (3, _), (1, _))],
}
MUL_ORDER = ("D1", "D3", "A1", "A3")
LIN_ORDER = ("DBL_MID", "DBL_OUT", "ADD_MID", "ADD_OUT")


# ------------------------------------------------ linear forms over slots


class Forms:
    """Linear forms of one group width: a value is w forms (dict slot ->
    coefficient), one a component."""

    def __init__(self, w):
        self.w = w

    def val(self, i):
        return [{self.w * i + c: 1} for c in range(self.w)]

    @staticmethod
    def _combo(forms, coeffs):
        out = {}
        for f, k in zip(forms, coeffs):
            for s, c in f.items():
                out[s] = out.get(s, 0) + k * c
        return {s: c for s, c in out.items() if c}

    def lin(self, vals, coeffs):
        return [self._combo([v[c] for v in vals], coeffs) for c in range(self.w)]

    def b3(self, v):
        """3b x: G1 12 x; G2 12 (x0 - x1) + 12 (x0 + x1) u."""
        if self.w == 1:
            return [self._combo(v, [12])]
        return [self._combo(v, [12, -12]), self._combo(v, [12, 12])]


def lin_phases(w):
    """LIN phase -> [(dst slot, form)], one Fp output a row."""
    F = Forms(w)
    V, M = F.val, lambda k: F.val(PR(k))
    b3m2 = F.b3(M(2))
    # y3s = m0 + b3 m2 into V2, t0f = m0 - 3 b3 m2 into V3
    dbl_mid = {2: F.lin([M(0), b3m2], [1, 1]), 3: F.lin([M(0), b3m2], [1, -3])}
    # X3 = 2 t0f m3, Y3 = 8 b3 (m0 m2) + t0f y3s, Z3 = 8 m0 m1
    dbl_out = {0: F.lin([M(4)], [2]), 1: F.lin([F.b3(M(5)), V(4)], [8, 1]), 2: F.lin([V(5)], [8])}
    # t3, t4, t5 = m3 - m0 - m1, m4 - m1 - m2, m5 - m0 - m2; Z3s, t1m =
    # m1 + b3 m2, m1 - b3 m2
    add_mid = {0: F.lin([M(3), M(0), M(1)], [1, -1, -1]), 1: F.lin([M(4), M(1), M(2)], [1, -1, -1]),
               2: F.lin([M(5), M(0), M(2)], [1, -1, -1]), 3: F.lin([M(1), b3m2], [1, 1]),
               4: F.lin([M(1), b3m2], [1, -1])}
    # X3 = t2x - b3 (t4 t5), Y3 = t1z + 3 b3 (t5 m0), Z3 = Z3a + 3 m0 t3
    add_out = {0: F.lin([M(2), F.b3(M(1))], [1, -1]), 1: F.lin([M(4), F.b3(M(3))], [1, 3]),
               2: F.lin([V(5), M(5)], [1, 3])}
    out = {}
    for name, vals in zip(LIN_ORDER, (dbl_mid, dbl_out, add_mid, add_out)):
        out[name] = [(w * i + c, v[c]) for i, v in vals.items() for c in range(w)]
    return out


def mul_rows(w):
    """MUL phase -> [(dst, a, a2, b, b2)] as the slots of component 0,
    NONE for an absent term."""
    sl = lambda i: NONE if i is None else w * i  # noqa: E731
    return {ph: [(w * d, sl(a), sl(a2), sl(b), sl(b2)) for d, (a, a2), (b, b2) in rows]
            for ph, rows in MUL_PHASES.items()}


# multiply-adds (32 x 32 -> 64) of a MUL row: a G1 row is one product, a
# 24-word product and a Montgomery reduction of 144 each; a G2 row three
# 24-word products and two reductions
ROW_MADDS = {1: 2 * 144, 2: 5 * 144}


def lane_steps(form: str, n: int, set_bits=None) -> tuple:
    """(doublings, additions) one lane runs for n windows (`window`, `w2`)
    or n bits (`chain`): the table's even entries by doubling, odd ones by
    addition, then C doublings and an addition a window; the chain's n - 1
    doublings and, in lockstep, n additions (`set_bits`: the additions of a
    schedule that skipped the clear bits, a mean over lanes if need be)."""
    if form == "chain":
        return max(n - 1, 0), n if set_bits is None else set_bits
    E = ENTRIES[form]
    return (E - 1) // 2 + DOUBLINGS[form] * n, (E - 2) // 2 + n


def lane_products(w: int, n: int, form: str = "window", set_bits=None) -> float:
    """The kernel's MUL rows for one lane (`lane_steps`), in 12-word
    products' worth of multiply-adds (288 each): window 816 a 17-window
    lane, w2 916 a 32-digit lane, chain 1,272 a 64-bit lane in lockstep
    (~888 on set bits only)."""
    return step_products(w, *lane_steps(form, n, set_bits))


def step_products(w: int, n_dbl, n_add) -> float:
    """n_dbl doublings and n_add additions of the kernel's MUL rows, in
    12-word products' worth of multiply-adds."""
    n_rows = {ph: len(rows) for ph, rows in MUL_PHASES.items()}
    rows = n_dbl * (n_rows["D1"] + n_rows["D3"]) + n_add * (n_rows["A1"] + n_rows["A3"])
    return rows * ROW_MADDS[w] / ROW_MADDS[1]


def window_steps_needed(mags) -> tuple:
    """(doublings, additions) that the window form needs for the digit
    magnitudes mags (W, L), summed over the lanes: a lane builds its table
    up to its largest magnitude m (m // 2 doublings, (m - 1) // 2
    additions), takes its top non-zero digit's entry, then C doublings a
    window below it and one addition a non-zero digit; a zero scalar needs
    nothing. The kernel itself runs every lane through the whole table and
    every window (`lane_steps`)."""
    m = np.asarray(mags)
    nz = m != 0
    live = nz.any(axis=0)
    top = m.shape[0] - 1 - np.argmax(nz[::-1], axis=0)
    big = m.max(axis=0, initial=0)
    dbl = big // 2 + DOUBLINGS["window"] * top
    add = (big - 1) // 2 + nz.sum(axis=0) - 1
    return int(dbl[live].sum()), int(add[live].sum())


def split(rows):
    """Row r on thread r mod T."""
    return [rows[t::T] for t in range(T)]


def slots(w):
    return w * (PROD + 6)  # V0..V5, PR0..PR5


def check(w):
    """The kernel's rules: slots in range, each slot written once a phase,
    no slot both read and written in a phase, LIN forms within lin_sum's
    bound."""
    n = slots(w)
    for ph, rows in mul_rows(w).items():
        dsts = {d + c for d, *_ in rows for c in range(w)}
        reads = {s + c for _, *ops in rows for s in ops if s != NONE for c in range(w)}
        assert len(dsts) == w * len(rows) and not dsts & reads, ph
        assert all(s == NONE or 0 <= s and s + w <= n for r in rows for s in r[1:]), ph
        assert all(r[1] != NONE and r[3] != NONE and r[0] + w <= n for r in rows), ph
    for ph, rows in lin_phases(w).items():
        dsts = [d for d, _ in rows]
        reads = {s for _, f in rows for s in f}
        assert len(set(dsts)) == len(dsts) and not set(dsts) & reads, ph
        for _, f in rows:
            assert 0 < len(f) < 64 and sum(abs(c) for c in f.values()) <= L1_MAX, (ph, f)
            assert all(0 <= s < n for s in f), ph


# ----------------------------------------------------------------- table


class Table:
    """One group width's u32 table: [MUL index | LIN index | MUL rows |
    LIN rows | terms]. An index word is offset | count << 16 for each phase
    and thread; a MUL row is dst | a << 6 | a2 << 12 | b << 18 | b2 << 24; a
    LIN row is dst | n_terms << 8 | first term << 16; a term is
    `lanes.term_word` (fp_reg.cuh `lin_sum`)."""

    def __init__(self, w):
        check(w)
        self.w = w
        muls = [split(mul_rows(w)[ph]) for ph in MUL_ORDER]
        lins = [split(lin_phases(w)[ph]) for ph in LIN_ORDER]
        n_index = 2 * 4 * T
        words = [0] * n_index
        mul_words, lin_words, terms = [], [], []
        mul_base = n_index
        mul_len = sum(len(r) for ph in muls for r in ph)
        lin_base = mul_base + mul_len
        lin_len = sum(len(r) for ph in lins for r in ph)
        term_base = lin_base + lin_len
        for p, per in enumerate(muls):
            for t, rows in enumerate(per):
                words[p * T + t] = (mul_base + len(mul_words)) | len(rows) << 16
                for d, a, a2, b, b2 in rows:
                    mul_words.append(d | a << 6 | a2 << 12 | b << 18 | b2 << 24)
        for p, per in enumerate(lins):
            for t, rows in enumerate(per):
                words[(4 + p) * T + t] = (lin_base + len(lin_words)) | len(rows) << 16
                for d, form in rows:
                    lin_words.append(d | len(form) << 8 | (term_base + len(terms)) << 16)
                    terms += [term_word(s, c) for s, c in sorted(form.items())]
        self.words = words + mul_words + lin_words + terms
        self.words += [0] * (-len(self.words) % 4)
        self.mul_rows, self.lin_rows = muls, lins
        self.slots = slots(w)


# ---------------------------------------------------------------- header


def header_text() -> str:
    out = [
        "// K1 on lane groups: the rows of csrc/ladder.cu's kernel and the forms'",
        "// schedules, generated by lighthouse_tpu_torch/ops/ladder_rows.py. Do not",
        "// edit; regenerate with",
        "//     python -m lighthouse_tpu_torch.ops.ladder_rows",
        "// Table: [MUL index | LIN index | MUL rows | LIN rows | terms], u32",
        "// words; an index word is first row | rows << 16, for each phase",
        "// (D1, D3, A1, A3, then DBL_MID, DBL_OUT, ADD_MID, ADD_OUT) and thread;",
        "// a MUL row is dst | a << 6 | a2 << 12 | b << 18 | b2 << 24, the Fp",
        "// slots of values (component 0), writing (a + a2)(b + b2) (a2, b2 NONE:",
        "// absent); a LIN row is",
        "// dst | terms << 8 | first term << 16, writing sum_t c_t slot_t with a",
        "// term slot | c << 12.",
        "#pragma once",
        "",
        "#include <stdint.h>",
        "",
        "namespace k1rows {",
        "",
        f"constexpr int T = {T};  // threads a lane",
        f"constexpr int BLOCK = {BLOCK};  // threads a block",
        "// the forms' points of scratch a lane and the window forms' doublings a window",
        *(f"constexpr int ENTRIES_{f.upper()} = {n};" for f, n in ENTRIES.items()),
        *(f"constexpr int DOUBLINGS_{f.upper()} = {n};" for f, n in DOUBLINGS.items()),
        f"constexpr int NONE = {NONE};  // an absent second term of a MUL operand",
        f"constexpr int MUL_INDEX = 0, LIN_INDEX = {4 * T};",
    ]
    for w in (1, 2):
        tab = Table(w)
        out += [
            "",
            f"// G{w}: {tab.slots} Fp slots a lane, {len(tab.words)} table words",
            f"constexpr int SLOTS_G{w} = {tab.slots};",
            f"constexpr int WORDS_G{w} = {len(tab.words)};",
            f"__device__ const uint32_t TABLE_G{w}[{len(tab.words)}] = {{",
        ]
        for i in range(0, len(tab.words), 8):
            out.append("    " + ", ".join(f"0x{x:08x}u" for x in tab.words[i:i + 8]) + ",")
        out.append("};")
    out += ["", "}  // namespace k1rows", ""]
    return "\n".join(out)


# -------------------------------------------------------------- emulator


def _index(words, base, p, t):
    """Rows [r0, r0 + n) of phase p on thread t, from the index word."""
    idx = words[base + p * T + t]
    return range(idx & 0xFFFF, (idx & 0xFFFF) + (idx >> 16))


class _Group:
    """One lane's group on Python integers, running the table's words as
    the kernel's threads do: each phase reads the file as it was before it
    (`lanes.commit_step` checks that no row needs otherwise)."""

    def __init__(self, w):
        self.w = w
        self.tab = Table(w)
        self.f = [0] * self.tab.slots
        self.mul_rows = 0  # MUL rows run

    def _value(self, s):
        return [self.f[s + c] for c in range(self.w)]

    def mul(self, p):
        w, words, rows = self.w, self.tab.words, []
        for t in range(T):
            for r in _index(words, 0, p, t):
                row = words[r]
                d, a, a2, b, b2 = (row >> sh & 63 for sh in (0, 6, 12, 18, 24))
                reads = {s + c for s in (a, a2, b, b2) if s != NONE for c in range(w)}
                x, y = self._value(a), self._value(b)
                if a2 != NONE:
                    x = [u + v for u, v in zip(x, self._value(a2))]
                if b2 != NONE:
                    y = [u + v for u, v in zip(y, self._value(b2))]
                if w == 1:
                    assert x[0] < 2 * P and y[0] < 2 * P
                    out = [x[0] * y[0] * R_INV % P]
                else:  # canonical sums, Karatsuba in registers
                    x, y = [u % P for u in x], [u % P for u in y]
                    assert x[0] + x[1] < 2 * P and y[0] + y[1] < 2 * P
                    p0, p1 = x[0] * y[0] * R_INV % P, x[1] * y[1] * R_INV % P
                    p2 = (x[0] + x[1]) * (y[0] + y[1]) * R_INV % P
                    out = [(p0 - p1) % P, (p2 - p0 - p1) % P]
                rows.append(({d + c: out[c] for c in range(w)}, reads))
                self.mul_rows += 1
        commit_step(self.f, rows, MUL_ORDER[p])

    def lin(self, p):
        words, rows = self.tab.words, []
        for t in range(T):
            for r in _index(words, 4 * T, p, t):
                row = words[r]
                n, first = (row >> 8) & 255, row >> 16
                terms = [term_parts(x) for x in words[first:first + n]]
                value = lin_sum_words([self.f[s] for s, _ in terms], [c for _, c in terms])[0]
                rows.append(({row & 255: value}, {s for s, _ in terms}))
        commit_step(self.f, rows, LIN_ORDER[p])

    def add_in(self, entry, neg):
        """Q = V3..V5 <- sign * entry, slot k of the entry on thread k mod T."""
        vals = {}
        for k in range(3 * self.w):
            x = entry[k]
            if neg and self.w <= k < 2 * self.w:
                x = (-x) % P
            vals[3 * self.w + k] = x
        commit_step(self.f, [(vals, set())], "ADD_IN")

    def double(self):
        self.mul(0)
        self.lin(0)
        self.mul(1)
        self.lin(1)

    def add(self, entry, neg):
        self.add_in(entry, neg)
        self.mul(2)
        self.lin(2)
        self.mul(3)
        self.lin(3)

    def point(self):
        return list(self.f[: 3 * self.w])

    def set_point(self, words):
        self.f[: 3 * self.w] = list(words)


def _identity(w):
    return [0] * w + [ONE] + [0] * (w - 1) + [0] * w


def steps(form: str, *ops):
    """One lane's steps in the kernel's order (csrc/ladder.cu `Windowed`,
    `Chain`), from its operands (window: magnitudes and signs, LSB-first by
    window; w2: `digits_w2`'s digits, MSB first; chain: LSB-first bits):
    (load, add, neg, store) -- V0..V2 <- entry `load` first (None: no
    load), then a doubling (add None) or an addition of sign * entry `add`,
    then entry `store` <- V0..V2 (None: no store). Entry 0 starts as the
    identity, entry 1 as P.

    window / w2: entries 2..E-1 of the table [0, E) P (even ones by doubling
    entry d / 2, odd ones by adding P to the last), then MSB first per
    window C doublings (the first loads the identity) and an addition of
    sign * table[digit]: a magnitude clamped to 0..8 with its sign, or a
    w2 digit & 3, whose 0 adds the identity entry. chain: per bit, LSB
    first, the addend (V0..V2) plus the accumulator (entry 0), kept as the
    accumulator where the bit is 1; the addend (entry 1) doubles between
    bits. RCB's complete addition is symmetric in its inputs, so the
    addend plus the accumulator has the canonical words of acc + addend."""
    if form == "chain":
        for i, bit in enumerate(ops[0]):
            if i:
                yield 1, None, False, 1
            yield None, 0, False, 0 if int(bit) == 1 else None
        return
    E, C = ENTRIES[form], DOUBLINGS[form]
    for d in range(2, E):
        yield (None, 1, False, d) if d % 2 else (d // 2, None, False, d)
    n = len(ops[0])
    for j in range(n):  # MSB first
        for k in range(C):
            yield 0 if j == 0 and k == 0 else None, None, False, None
        if form == "window":
            wi = n - 1 - j
            yield None, min(max(int(ops[0][wi]), 0), E - 1), bool(ops[1][wi]), None
        else:
            yield None, int(ops[0][j]) & (E - 1), False, None


def result_entry(form: str, n: int):
    """The entry that holds a lane's result, None for V0..V2: the chain's
    accumulator; the identity of a window form run on no windows."""
    return 0 if form == "chain" or n == 0 else None


def emulate_lane(w: int, point, *ops, form: str = "window", stats=None) -> list:
    """One lane: point = 3 w Montgomery ints (X, Y, Z components), ops its
    operands (`steps`); the kernel's steps -> the 3 w ints of the result.
    `stats["mul_rows"]` counts the MUL rows run."""
    g = _Group(w)
    ent = [_identity(w), list(point)] + [None] * (ENTRIES[form] - 2)
    g.set_point(point)
    for load, add, neg, store in steps(form, *ops):
        if load is not None:
            g.set_point(ent[load])
        if add is None:
            g.double()
        else:
            g.add(ent[add], neg)
        if store is not None:
            ent[store] = g.point()
    if stats is not None:
        stats["mul_rows"] = stats.get("mul_rows", 0) + g.mul_rows
    r = result_entry(form, len(ops[0]))
    return g.point() if r is None else list(ent[r])


def emulate(pt, *operands, form: str = "window", stats=None):
    """`ladder.ladder(pt, *operands, form=form)` on the rows, phases and
    steps above, lane by lane on Python integers: pt (X, Y, Z) (w, 12, B)
    int32 words; operands (mags, negs) (W, B) for `window`, the (n, B)
    LSB-first bits for `chain` and `w2` (made into `window_ladder.digits_w2`
    digits as the wrapper does) -> (X, Y, Z) words."""
    w, _, B = pt[0].shape
    if form == "w2":
        operands = (digits_w2(torch.as_tensor(operands[0])),)
    coords = [[fd.words_to_ints(c[i].t().contiguous().numpy()) for i in range(w)] for c in pt]
    ops = [np.asarray(o) for o in operands]
    res = [emulate_lane(w, [coords[c][i][lane] for c in range(3) for i in range(w)],
                        *(o[:, lane] for o in ops), form=form, stats=stats) for lane in range(B)]
    return tuple(
        torch.from_numpy(np.stack([fd.ints_to_words([r[w * c + i] for r in res]).T
                                   for i in range(w)]).copy())
        for c in range(3)
    )


def main():
    with open(HEADER, "w") as f:
        f.write(header_text())
    print(HEADER)


if __name__ == "__main__":
    main()
