"""The G2 subgroup check on lane groups: the programs that
`csrc/subgroup.cu`'s kernel runs, their slot map, generated, and an
emulator.

A group of T = 4 threads runs one lane's ladder over r's bits, LSB first,
on the unified Jacobian group of the twist (`curve.Jacobian`, the port of
`JacobianGroup`: dbl-2001-b and the generic addition with its selects).
The lane's values live in a file of Fp slots in shared memory; an Fp2
value takes two consecutive slots. A bit is one program of rounds, each a
MUL phase and a LIN phase with a warp barrier after each:

  MUL -- the round's independent Fp2 products (a + a') (b + b') for
         values a, a', b, b' (a' and b' may be absent), rows k on thread
         k mod T. A whole row is K1's Fp2 product (`ladder_rows`,
         csrc/fp2_row.cuh): Karatsuba with lazy reduction, three 24-word
         products and two Montgomery reductions. A product may instead be
         split into two half rows on two threads, one Fp component each:
         for a square (A0 + A1)(A0 - A1) or 2 A0 A1, one 24-word product
         and one reduction; for a product A0 B0 - A1 B1 or A0 B1 + A1 B0,
         two and one. The kernel runs a row as product micro-ops (`micro_ops`), its threads' k-th
         micro-ops together, so a round costs a product and the most
         reductions of any thread's k-th micro-op for each k (`round_work`):
         a round of whole rows costs 5, of two square halves a thread 4, of
         one product half a thread 3;
  LIN -- the round's linear recombinations, one canonical Fp sum
         sum_t c_t slot_t a row (fp_reg.cuh `lin_sum`), row k on thread
         k mod T. A conditional row writes only where the lane keeps the
         step's sum.

The programs (values named as in `curve.Jacobian`, products with the small
scalars moved past them):

  DBL     -- a clear bit: the addend doubles in three rounds of half rows,
             7 products: a, b = X^2, Y^2; c, aa, (X + b)^2 = b^2, a^2, ..;
             a t and Y Z for t = d - X3; X3 = 9 aa - 4 d', Y3 = 3 a t -
             8 c, Z3 = 2 yz with d' = (X + b)^2 - a - c, t = 6 d' - 9 aa
             (work 2 + 4 + 3 = 9, where three rounds of whole rows cost 15);
  FUSED   -- a set bit: acc + addend and the addend's doubling in six
             rounds of 4, 4, 4, 4, 4 and 3 products (16 + 7), the squares of
             rounds 1 and 4 split (work 4 + 5 + 5 + 4 + 5 + 5 = 28). The
             doubling writes each new addend coordinate only after the
             addition's last read of the old one (`check` proves it on the
             slots);
  ADD     -- r's top bit: the addition alone (the last doubling is dead);
  DBL_ACC -- the doubling of the accumulator, for the lanes where acc ==
             addend (H = 0 and R = 0); the warp runs it after a set bit's
             program when any of its lanes needs it, and only those lanes
             store its result.

The addition's selects are per lane. At a set bit's start each thread
reads Z1 and Z2: Z1 = 0 (acc at infinity) copies the addend into acc, Z2
= 0 (addend at infinity) leaves acc as it is, and neither keeps the
generic sum. After the program's test phase each thread reads H and R:
both 0 (acc == addend) takes DBL_ACC; H = 0 alone needs nothing, the
generic Z3 is 0. Every value stays
canonical, so a lane's accumulator equals the plain ladder's words after
every bit, on any input, points off the curve included.

Slots. The accumulator X1, Y1, Z1 and the addend X2, Y2, Z2 hold value
slots 0..5 between bits; the temporaries are allocated by liveness (a
value may take the slot of one that dies in the phase that writes it, when
one thread's row writes it and is that value's only reader there), and may
use an addend slot between the last read of the old coordinate and the
write of the new one. The accumulator's slots are never scratch: a lane
that does not keep a step's sum keeps its old accumulator.

    python -m lighthouse_tpu_torch.ops.subgroup_rows   # rewrites the header

writes `csrc/subgroup_rows.cuh`; `emulate_warp` / `emulate_lane` decode the
table as the kernel does and run it on Python integers with the kernel's
rules (canonical slots, operands below 2p, the micro-ops' wide sums within
their bounds, the word-level `lin_sum` of `lanes.lin_sum_words`, the phase
rule of `lanes.commit_step`, the selects and the warp's vote), and return
the accumulator's and the addend's words after each bit, which the CPU
tests hold against the plain ladder.

What it shares with K1's rows (`ladder_rows`). The Karatsuba product and
its lazy reduction, the term words and `lin_sum`, and the phase rule.
What it does not: K1 runs RCB's complete formulas, two rounds a step, on a
fixed slot map of two threads a lane, one whole Fp2 product a MUL row; here
the formulas are the unified Jacobian ones, which are not complete and
need per-lane selects, the rounds are six, four threads share a round's
rows, a product may be split into half rows, and the slots are allocated
by liveness.
"""

import os

from lighthouse_tpu_torch.crypto.constants import P, R as ORDER
from lighthouse_tpu_torch.ops.lanes import commit_step, lin_sum_words, term_parts, term_word

NW = 12
MONT = 1 << 384
R_INV = pow(MONT, -1, P)
ONE = MONT % P  # the Montgomery one
T = 4  # threads a lane
BLOCK = 32  # threads a block: one warp, 8 lanes
LANES = BLOCK // T
PAD_WORDS = 4  # a lane's file is padded by 16 bytes, so 8 lanes' files start on other banks
NONE = 63  # an absent second term of an operand
L1_MAX = 256  # a LIN row's coefficients' L1 norm (lin_sum's bound)
COND = 1 << 6  # a LIN row's condition bit

# a MUL row's kind: a whole Fp2 product (Karatsuba), or one component of a
# square or of a product, the component being dst's parity
KARA, SQ, MUL = 0, 1, 2
# a micro-op operand's second component: none
NO_V = 2
# where a product goes in T0 and T1
ACC_ADD, ACC_SUB = 1, 2

# r's bits, LSB first: 255 bits, 134 of them set
R_BITS = tuple((ORDER >> i) & 1 for i in range(ORDER.bit_length()))

HEADER = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "csrc", "subgroup_rows.cuh")

ACC = ("X1", "Y1", "Z1")
ADDEND = ("X2", "Y2", "Z2")
PERSISTENT = ACC + ADDEND  # value slots 0..5


def _new(name):
    """The name of a persistent value's new words (X2 -> X2n)."""
    return name + "n"


# ------------------------------------------------------------ the programs
#
# A round is (MUL rows, LIN rows). A MUL row is (dst, a, b) or (dst, a, b,
# HALF) for a product split into half rows: a and b are a value or
# (value, value) summed. A LIN row is (dst, {value: coefficient}) or (dst,
# form, True) for a conditional one.
HALF = "half"


def _dbl_rounds(X, Y, Z, cond=False):
    """dbl-2001-b on (X, Y, Z) in three rounds of half rows, its results into
    the same three slots: a = X^2, b = Y^2, c = b^2, e = 3a, f = e^2 = 9 a^2,
    d = 2 ((X + b)^2 - a - c) = 2 d', X3 = f - 2d, Y3 = e (d - X3) - 8c, Z3 =
    2 Y Z."""
    return [
        ([("a", X, X, HALF), ("b", Y, Y, HALF)], []),
        ([("c", "b", "b", HALF), ("aa", "a", "a", HALF), ("xb2", (X, "b"), (X, "b"), HALF)],
         [(_new(X), {"aa": 9, "xb2": -4, "a": 4, "c": 4}, cond),
          ("t", {"xb2": 6, "a": -6, "c": -6, "aa": -9})]),
        ([("at", "a", "t", HALF), ("yz", Y, Z, HALF)],
         [(_new(Y), {"at": 3, "c": -8}, cond), (_new(Z), {"yz": 2}, cond)]),
    ]


# JacobianGroup.add's generic formulas with the scalars moved past the
# products: U1 = X1 z2s, U2 = X2 z1s, S1 = Y1 z2c, S2 = Y2 z1c, H = U2 - U1,
# R = S2 - S1; I = (2H)^2 = 4 hh, J = H I = 4 hhh, V = U1 I = 4 u1hh; X3 =
# (2R)^2 - J - 2V = 4 rr - 4 hhh - 8 u1hh; Y3 = 2R (V - X3) - 2 S1 J = 2 r w
# - 8 s1hhh for w = V - X3 = 12 u1hh - 4 rr + 4 hhh; Z3 = 2 Z1 Z2 H. The
# addend's doubling (`_dbl_rounds` on X2, Y2, Z2) runs beside it; rounds 1
# and 4 are squares alone, split.
FUSED_ROUNDS = [
    ([("z1s", "Z1", "Z1", HALF), ("z2s", "Z2", "Z2", HALF), ("a", "X2", "X2", HALF),
      ("b", "Y2", "Y2", HALF)], []),
    ([("u1", "X1", "z2s"), ("u2", "X2", "z1s"), ("z2c", "z2s", "Z2"), ("z1c", "z1s", "Z1")],
     [("h", {"u2": 1, "u1": -1})]),
    ([("s1", "Y1", "z2c"), ("s2", "Y2", "z1c"), ("zz", "Z1", "Z2"), ("yz", "Y2", "Z2")],
     [("r", {"s2": 1, "s1": -1}), ("Z2n", {"yz": 2})]),
    ([("hh", "h", "h", HALF), ("rr", "r", "r", HALF), ("c", "b", "b", HALF),
      ("aa", "a", "a", HALF)], []),
    ([("hhh", "h", "hh"), ("u1hh", "u1", "hh"), ("zzh", "zz", "h"),
      ("xb2", ("X2", "b"), ("X2", "b"))],
     [("X1n", {"rr": 4, "hhh": -4, "u1hh": -8}, True),
      ("w", {"u1hh": 12, "rr": -4, "hhh": 4}),
      ("X2n", {"aa": 9, "xb2": -4, "a": 4, "c": 4}),
      ("t", {"xb2": 6, "a": -6, "c": -6, "aa": -9})]),
    ([("rw", "r", "w"), ("s1hhh", "s1", "hhh"), ("at", "a", "t")],
     [("Y1n", {"rw": 2, "s1hhh": -8}, True), ("Y2n", {"at": 3, "c": -8}),
      ("Z1n", {"zzh": 2}, True)]),
]
TEST_ROUND = 2  # H and R are tested after this round's LIN phase
DOUBLING = {"yz", "a", "b", "c", "xb2", "aa", "t", "at", "Z2n", "X2n", "Y2n"}


def _without_doubling(rounds):
    return [([m for m in mul if m[0] not in DOUBLING], [r for r in lin if r[0] not in DOUBLING])
            for mul, lin in rounds]


# name -> (rounds, test round or None, persistent values the program keeps
# intact, persistent values it writes only conditionally)
SPECS = {
    "DBL": (_dbl_rounds("X2", "Y2", "Z2"), None, ACC, ()),
    "FUSED": (FUSED_ROUNDS, TEST_ROUND, (), ACC),
    "ADD": (_without_doubling(FUSED_ROUNDS), TEST_ROUND, ADDEND, ACC),
    "DBL_ACC": (_dbl_rounds("X1", "Y1", "Z1", cond=True), None, ADDEND, ACC),
}
ORDER_OF = ("DBL", "FUSED", "ADD", "DBL_ACC")


# ------------------------------------------------------- slots by liveness


def _operand(x):
    """A MUL operand as (value, second value or None)."""
    return x if isinstance(x, tuple) else (x, None)


class Program:
    """One program: its symbolic phases, the value slot of every name, and
    the physical rows thread by thread."""

    def __init__(self, name):
        rounds, test_round, kept, cond = SPECS[name]
        self.name = name
        self.test_phase = None if test_round is None else 2 * test_round + 1
        self.kept, self.cond = set(kept), set(cond)
        # phases: ("MUL", [(dst, A, B, half)]) with A, B `_operand`s /
        # ("LIN", [(dst, form, cond)])
        self.phases = []
        for mul, lin in rounds:
            self.phases.append(("MUL", [(r[0], _operand(r[1]), _operand(r[2]), HALF in r[3:])
                                        for r in mul]))
            self.phases.append(("LIN", [(r[0], r[1], len(r) > 2 and r[2]) for r in lin]))
        self._liveness()
        self._allocate()
        self._emit()

    @staticmethod
    def _sources(kind, row):
        if kind == "LIN":
            return list(row[1])
        return [v for op in row[1:3] for v in op if v is not None]

    def _liveness(self):
        """def phase and the rows reading each value at each phase."""
        self.defs, self.reads = {}, {}
        for p, (kind, rows) in enumerate(self.phases):
            for i, row in enumerate(rows):
                for s in self._sources(kind, row):
                    self.reads.setdefault(s, {}).setdefault(p, set()).add(i)
                assert row[0] not in self.defs, (self.name, row[0])
                self.defs[row[0]] = (p, i)
        for v in self.reads:
            assert v in self.defs or v in PERSISTENT, (self.name, v)
        for v in self.defs:
            assert v in self.reads or v[:-1] in PERSISTENT, (self.name, v, "never read")

    def _interval(self, v):
        """[first, last] phases a value holds its slot (-1 before the
        program, len(phases) after it)."""
        end = len(self.phases)
        if v in PERSISTENT:
            if v in self.kept or v in self.cond:
                return -1, end
            return -1, max(self.reads.get(v, {-1: 0}))
        if v[:-1] in PERSISTENT:
            return self.defs[v][0], end
        return self.defs[v][0], max(self.reads[v])

    def _one_thread(self, v):
        """Whether the row that writes v runs on one thread: a whole MUL
        row, or a LIN row (whose component c reads only components c)."""
        p, i = self.defs[v]
        kind, rows = self.phases[p]
        return kind == "LIN" or not rows[i][3]

    def _shares(self, u, v):
        """Whether u and v may hold one slot: disjoint intervals, or one
        dies in the phase the other is written by its only reader there,
        on one thread."""
        (du, lu), (dv, lv) = self._interval(u), self._interval(v)
        if lu < dv or lv < du:
            return True
        for old, new, d in ((u, v, dv), (v, u, du)):
            if new in self.defs and self._interval(old)[1] == d and d == self.defs[new][0]:
                if self.reads[old][d] == {self.defs[new][1]} and self._one_thread(new):
                    return True
        return False

    def _allocate(self):
        """Value slots: persistent values at 0..5 (a new coordinate in its
        old slot), temporaries greedily in order of definition, each in the
        lowest slot it may share, never one of the accumulator's."""
        slot = {v: k for k, v in enumerate(PERSISTENT)}
        slot.update({_new(v): k for k, v in enumerate(PERSISTENT) if _new(v) in self.defs})
        held = {}
        for v, k in slot.items():
            if v in self.defs or v in self.reads or v in self.kept or v in self.cond:
                held.setdefault(k, []).append(v)
        temps = sorted((v for v in self.defs if v not in slot), key=lambda v: self.defs[v])
        for v in temps:
            k = len(ACC)
            while not all(self._shares(u, v) for u in held.get(k, [])):
                k += 1
            slot[v] = k
            held.setdefault(k, []).append(v)
        self.slot = slot
        self.value_slots = max(slot.values()) + 1

    def _emit(self):
        """Physical rows, row k of a phase on thread k mod T. A MUL row is
        (kind, dst, A, B), A and B (Fp slot, second Fp slot or NONE) at
        component 0; dst at component 0 for a whole row, at the component a
        half row writes. A LIN row is (dst, {Fp
        slot: coefficient}, cond) per component. `self.sources[p]` maps each
        physical row to its symbolic row."""
        fp = lambda v: NONE if v is None else 2 * self.slot[v]  # noqa: E731
        self.rows, self.sources = [], []
        for kind, rows in self.phases:
            out, src = [], []
            for i, row in enumerate(rows):
                if kind == "MUL":
                    dst, A, B, half = row
                    ops = tuple((fp(a), fp(a2)) for a, a2 in (A, B))
                    if not half:
                        out.append((KARA, fp(dst), *ops))
                        src.append(i)
                        continue
                    k = SQ if A == B else MUL
                    out += [(k, fp(dst) + c, *ops) for c in range(2)]
                    src += [i, i]
                else:
                    dst, form, cond = row
                    out += [(2 * self.slot[dst] + c, {2 * self.slot[s] + c: k for s, k in form.items()},
                             cond) for c in range(2)]
                    src += [i, i]
            self.rows.append((kind, [out[t::T] for t in range(T)]))
            self.sources.append([src[t::T] for t in range(T)])
        if self.test_phase is not None:
            # read after the test's barrier: live into the next phase, so no row writes them there
            assert all(self._interval(v)[1] > self.test_phase for v in ("h", "r"))
            self.test_slots = (2 * self.slot["h"], 2 * self.slot["r"])
        else:
            self.test_slots = (-1, -1)

    def products(self):
        """Fp2 products of one run."""
        return sum(len(rows) for kind, rows in self.phases if kind == "MUL")

    def work(self):
        """The warp's cost of one run's MUL phases in 24-word products and
        reductions (`round_work`, summed)."""
        return sum(round_work(per) for kind, per in self.rows if kind == "MUL")


def _opcode(op, u, v=NO_V, sub=False):
    """A micro-op's operand word: Fp slot | second slot << 6 | u << 12 | v
    << 13 | sub << 15, component u of the value at the slot (plus the value
    at the second), plus (an integer below 2p) or minus (mod p) component
    v unless v is NO_V."""
    s, s2 = op
    return s | s2 << 6 | u << 12 | v << 13 | int(sub) << 15


def micro_ops(row):
    """A physical MUL row as the kernel runs it: [(x operand, y operand,
    word)], one 24-word product each; the word is acc0 | acc1 << 2 |
    reductions << 4 | dst << 6: the product added to or taken from T0 =
    p^2 + .. and T1 = 2 p^2 + .., and after a row's last product T0 reduced
    into dst (a whole row: T1 into dst + 1). Whole: A0 B0, A1 B1, (A0 +
    A1)(B0 + B1); SQ c = 0: (A0 + A1)(A0 - A1), c = 1: (A0 + A0) A1; MUL c
    = 0: A0 B0 - A1 B1, c = 1: A0 B1 + A1 B0."""
    kind, d, A, B = row
    X = lambda *a: _opcode(A, *a)  # noqa: E731
    Y = lambda *a: _opcode(B, *a)  # noqa: E731
    fin = lambda n: n << 4 | d << 6  # noqa: E731
    if kind == KARA:
        return [(X(0), Y(0), ACC_ADD | ACC_SUB << 2), (X(1), Y(1), ACC_SUB | ACC_SUB << 2),
                (X(0, 1), Y(0, 1), ACC_ADD << 2 | fin(2))]
    if kind == SQ:
        if d & 1 == 0:
            return [(X(0, 1), X(0, 1, True), ACC_ADD | fin(1))]
        return [(X(0, 0), X(1), ACC_ADD | fin(1))]
    if d & 1 == 0:
        return [(X(0), Y(0), ACC_ADD), (X(1), Y(1), ACC_SUB | fin(1))]
    return [(X(0), Y(1), ACC_ADD), (X(1), Y(0), ACC_ADD | fin(1))]


def round_work(per_thread) -> int:
    """A MUL phase's cost to a warp in 24-word products and reductions: its
    threads run their k-th micro-ops together, so each k costs a product
    and the most reductions any thread's k-th micro-op ends with."""
    ops = [[w >> 4 & 3 for row in rows for _, _, w in micro_ops(row)] for rows in per_thread]
    return sum(1 + max(o[k] for o in ops if k < len(o)) for k in range(max(map(len, ops))))


def check(prog: Program) -> None:
    """The kernel's rules, on the physical rows: every read finds the value
    the formulas name (so the doubling writes the addend only after the
    addition's last read of it, and no temporary clobbers a live value), no
    Fp slot written twice in a phase, no row reading a slot that another
    row of the phase writes, half rows of a square or a product whose
    operands say so, conditional rows only after the test phase and never
    read again, H and R in place at the test, the persistent values where
    the next bit expects them, LIN forms within lin_sum's bound."""
    file = {2 * k + c: (v, c) for k, v in enumerate(PERSISTENT) for c in range(2)}
    after_test = lambda p: prog.name == "DBL_ACC" or (  # noqa: E731
        prog.test_phase is not None and p > prog.test_phase)
    for p, ((kind, rows), (_, per_thread)) in enumerate(zip(prog.phases, prog.rows)):
        writes, races = {}, []
        for t, phys_rows in enumerate(per_thread):
            for phys, i in zip(phys_rows, prog.sources[p][t]):
                if kind == "MUL":
                    dst, A, B, half = rows[i]
                    k, d, pa, pb = phys
                    assert k == (KARA if not half else SQ if A == B else MUL)
                    r = set()
                    for (name, name2), (s, s2) in ((A, pa), (B, pb)):
                        assert (name2 is None) == (s2 == NONE)
                        for n_, s_ in ((name, s), (name2, s2)):
                            if n_ is not None:
                                for c in range(2):
                                    assert file.get(s_ + c) == (n_, c), (prog.name, p, n_, file.get(s_ + c))
                                    r.add(s_ + c)
                    assert all(0 <= s < 2 * prog.value_slots for s in r | {d})
                    cs = range(2) if k == KARA else (d & 1,)
                    base = d - (d & 1)
                    w = {base + c: (dst, c) for c in cs}
                else:
                    dst, form, cond = rows[i]
                    d, terms, c_ = phys
                    c = d & 1
                    assert c_ == cond and (not cond or after_test(p)), (prog.name, dst)
                    assert 0 < len(terms) < 256 and sum(map(abs, terms.values())) <= L1_MAX
                    for (name, k), (s, k2) in zip(form.items(), terms.items()):
                        assert k == k2 and file.get(s) == (name, c), (prog.name, p, name, file.get(s))
                    w = {d: (dst + "?", c) if cond else (dst, c)}
                    r = set(terms)
                for s in w:
                    assert s not in writes, (prog.name, p, "written twice", s)
                    writes[s] = w[s]
                races.append((w, r))
        for w, r in races:
            assert not (r - set(w)) & set(writes), (prog.name, p, "read/write race")
        file.update(writes)
        if p == prog.test_phase:
            for name, s in zip(("h", "r"), prog.test_slots):
                assert file.get(s) == (name, 0) and file.get(s + 1) == (name, 1), (prog.name, name)
    for k, v in enumerate(PERSISTENT):
        want = v if v in prog.kept else (_new(v) + "?" if v in prog.cond else _new(v))
        for c in range(2):
            assert file[2 * k + c] == (want, c), (prog.name, v, file[2 * k + c])


PROGRAMS = {name: Program(name) for name in ORDER_OF}
for _prog in PROGRAMS.values():
    check(_prog)

# Fp2 products of one doubling and one generic addition, as the rows run them
DOUBLE_PRODUCTS = PROGRAMS["DBL"].products()
ADD_PRODUCTS = PROGRAMS["ADD"].products()
SLOTS = 2 * max(p.value_slots for p in PROGRAMS.values())  # Fp slots a lane
LANE_WORDS = NW * SLOTS + PAD_WORDS


def _bit_programs(bits):
    last = len(bits) - 1
    for i, bit in enumerate(bits):
        if bit:
            yield "ADD" if i == last else "FUSED"
        elif i < last:
            yield "DBL"


def lane_rows(bits=R_BITS) -> int:
    """Fp2 products one unmasked lane runs over `bits`, with no lane of its
    warp at acc == addend: a fused step a set bit, a doubling a clear one,
    the addition alone on the last bit (r: 3,922)."""
    return sum(PROGRAMS[name].products() for name in _bit_programs(bits))


def lane_work(bits=R_BITS) -> int:
    """The warp's cost of a lane's MUL phases over `bits`, in 24-word
    products and reductions (`Program.work`; r: 4,837, where whole rows
    alone would take 5,835)."""
    return sum(PROGRAMS[name].work() for name in _bit_programs(bits))


# multiply-adds (32 x 32 -> 64) of an Fp2 product's worth of rows: three
# 24-word products and two Montgomery reductions of 144 each, 2.5 Fp
# products' worth, whole or in two half rows
ROW_MADDS = 5 * 144


# ----------------------------------------------------------------- table


class Table:
    """The u32 table: [index | micro-ops | LIN rows | terms]. The index has
    one word a (global phase, thread), first | count << 16, the programs'
    phases in ORDER_OF order (MUL phases even); a MUL phase's entries are
    its rows' micro-ops, two words each (`micro_ops`: x | y << 16, then the
    accumulation and reduction word); a LIN row dst | cond << 6 | terms <<
    8 | first term << 16; a term `lanes.term_word` (slot | c << 12)."""

    def __init__(self):
        self.first = {}
        phases = []
        for name in ORDER_OF:
            assert len(PROGRAMS[name].rows) % 2 == 0  # MUL phases stay even
            self.first[name] = len(phases)
            phases += PROGRAMS[name].rows
        n_index = len(phases) * T
        mul_words, lin_words, terms = [], [], []
        n_mul = sum(2 * len(micro_ops(row)) for kind, per in phases if kind == "MUL"
                    for r in per for row in r)
        n_lin = sum(len(r) for kind, per in phases if kind == "LIN" for r in per)
        mul_base, lin_base = n_index, n_index + n_mul
        term_base = lin_base + n_lin
        index = []
        for kind, per in phases:
            for rows in per:
                if kind == "MUL":
                    ops = [op for row in rows for op in micro_ops(row)]
                    index.append((mul_base + len(mul_words)) | len(ops) << 16)
                    for x, y, w in ops:
                        mul_words += [x | y << 16, w]
                else:
                    index.append((lin_base + len(lin_words)) | len(rows) << 16)
                    for d, form, cond in rows:
                        lin_words.append(d | (COND if cond else 0) | len(form) << 8
                                         | (term_base + len(terms)) << 16)
                        terms += [term_word(s, c) for s, c in sorted(form.items())]
        self.words = index + mul_words + lin_words + terms
        self.words += [0] * (-len(self.words) % 4)
        assert len(self.words) < 1 << 16
        self.phases = len(phases)


TABLE = Table()


def program_meta(name):
    """(first phase, phases, test phase or -1, H's and R's Fp slots)."""
    p = PROGRAMS[name]
    return (TABLE.first[name], len(p.rows), -1 if p.test_phase is None else p.test_phase,
            *p.test_slots)


# ---------------------------------------------------------------- header


def header_text() -> str:
    out = [
        "// The G2 subgroup check on lane groups: the programs that",
        "// csrc/subgroup.cu's kernel runs, generated by",
        "// lighthouse_tpu_torch/ops/subgroup_rows.py. Do not edit; regenerate with",
        "//     python -m lighthouse_tpu_torch.ops.subgroup_rows",
        "// Table: [index | micro-ops | LIN rows | terms], u32 words; an index",
        "// word is first | count << 16, one a (phase, thread), the programs'",
        "// phases in order (MUL phases even). A MUL phase's entries are product",
        "// micro-ops, two words each: the operands x | y << 16, an operand slot |",
        "// second slot << 6 | u << 12 | v << 13 | sub << 15 (component u of the",
        "// value at slot, plus the value at the second slot unless NONE, plus",
        "// or (sub) minus component v unless v is NO_V), then acc0 | acc1 << 2",
        "// | reductions << 4 | dst << 6 (the product added to or taken from T0",
        "// and T1; a row's last micro-op reduces T0 into dst and T1 into dst +",
        "// 1). A LIN row is dst | cond << 6 | terms << 8 | first term << 16,",
        "// writing sum_t c_t slot_t with a term slot | c << 12, where cond is 0",
        "// or the lane keeps the step's sum.",
        "#pragma once",
        "",
        "#include <stdint.h>",
        "",
        "namespace sgrows {",
        "",
        f"constexpr int T = {T};  // threads a lane",
        f"constexpr int BLOCK = {BLOCK};  // threads a block",
        f"constexpr int SLOTS = {SLOTS};  // Fp slots a lane",
        f"constexpr int LANE_WORDS = {LANE_WORDS};  // a lane's file, padded by {PAD_WORDS} words",
        f"constexpr int NONE = {NONE};  // an absent second slot of an operand",
        f"constexpr uint32_t COND = {COND};  // a LIN row's condition bit",
        f"constexpr uint32_t NO_V = {NO_V};  // an operand without a second component",
        f"constexpr uint32_t ACC_ADD = {ACC_ADD}, ACC_SUB = {ACC_SUB};  // a product into T0 or T1",
        f"constexpr int R_BITS = {len(R_BITS)};  // r's bits, LSB first",
        "// r, little-endian 32-bit words",
        "__device__ const uint32_t R_W[8] = {"
        + ", ".join(f"0x{ORDER >> (32 * k) & 0xFFFFFFFF:08x}u" for k in range(8)) + "};",
        "// the accumulator X1, Y1, Z1 and the addend X2, Y2, Z2: Fp slots 0..11",
        "constexpr int X1 = 0, Y1 = 2, Z1 = 4, X2 = 6, Y2 = 8, Z2 = 10;",
        "// programs: DBL (a clear bit), FUSED (a set bit), ADD (r's top bit),",
        "// DBL_ACC (acc == addend)",
        "enum { " + ", ".join(f"{n} = {i}" for i, n in enumerate(ORDER_OF)) + " };",
        "// per program: first phase, phases, the phase after which H and R are",
        "// tested (-1: none), H's and R's Fp slots",
        "struct Program {",
        "  int first, phases, test, h, r;",
        "};",
        "__constant__ Program PROGRAMS[4] = {",
        *("    {" + ", ".join(str(x) for x in program_meta(n)) + f"}},  // {n}" for n in ORDER_OF),
        "};",
        "",
        f"// {TABLE.phases} phases, {len(TABLE.words)} table words",
        f"constexpr int WORDS = {len(TABLE.words)};",
        f"__device__ const uint32_t TABLE[{len(TABLE.words)}] = {{",
    ]
    for i in range(0, len(TABLE.words), 8):
        out.append("    " + ", ".join(f"0x{x:08x}u" for x in TABLE.words[i:i + 8]) + ",")
    out += ["};", "", "}  // namespace sgrows", ""]
    return "\n".join(out)


# -------------------------------------------------------------- emulator


def _entries(q, t):
    """Entries [r0, r0 + n) of global phase q on thread t, from the index
    (a MUL phase's n micro-ops take two words each from r0)."""
    idx = TABLE.words[q * T + t]
    return idx & 0xFFFF, idx >> 16


def _value(f, code):
    """A micro-op's operand as the kernel forms it: a canonical component
    (the second slot added mod p), plus another (an integer below 2p) or
    minus it (mod p)."""
    s, s2, u, v, sub = code & 63, code >> 6 & 63, code >> 12 & 1, code >> 13 & 3, code >> 15 & 1
    comp = lambda c: (f[s + c] + (0 if s2 == NONE else f[s2 + c])) % P  # noqa: E731
    x = comp(u)
    if v != NO_V:
        x = (x - comp(v)) % P if sub else x + comp(v)
    assert 0 <= x < 2 * P
    return x, {s, s + 1} | (set() if s2 == NONE else {s2, s2 + 1})


def _mul_phase(f, q, stats):
    """A MUL phase as the kernel runs its micro-ops: each 24-word product
    added to or taken from T0 = p^2 + .. and T1 = 2 p^2 + .. (which must
    stay in [0, p 2^384)), reduced into its slots after a row's last
    product."""
    words, rows = TABLE.words, []
    for t in range(T):
        acc, reads = [P * P, 2 * P * P], set()
        r0, n = _entries(q, t)
        for j in range(n):
            w0, w = words[r0 + 2 * j], words[r0 + 2 * j + 1]
            (x, rx), (y, ry) = _value(f, w0 & 0xFFFF), _value(f, w0 >> 16)
            reads |= rx | ry
            for k in range(2):
                a = w >> 2 * k & 3
                acc[k] += x * y if a == ACC_ADD else -x * y if a == ACC_SUB else 0
            nred, d = w >> 4 & 3, w >> 6 & 63
            if nred:
                assert all(0 <= v < P * MONT for v in acc[:nred]), "a wide sum out of range"
                rows.append(({d + k: acc[k] * R_INV % P for k in range(nred)}, reads))
                stats["products"] = stats.get("products", 0) + (1 if nred == 2 or d & 1 == 0 else 0)
                acc, reads = [P * P, 2 * P * P], set()
    commit_step(f, rows, f"MUL {q}")


def _lin_phase(f, q, keep):
    words, rows = TABLE.words, []
    for t in range(T):
        r0, n = _entries(q, t)
        for k in range(r0, r0 + n):
            row = words[k]
            n_terms, first = (row >> 8) & 255, row >> 16
            terms = [term_parts(x) for x in words[first:first + n_terms]]
            value = lin_sum_words([f[s] for s, _ in terms], [c for _, c in terms])[0]
            write = {row & 63: value} if keep or not row & COND else {}
            rows.append((write, {s for s, _ in terms}))
    commit_step(f, rows, f"LIN {q}")


def _is_zero(f, s):
    return f[s] == 0 and f[s + 1] == 0


def _run(files, name, keeps, stats, on_test=None):
    first, n, test = program_meta(name)[:3]
    for ph in range(n):
        for f, keep in zip(files, keeps):
            if ph % 2:
                _lin_phase(f, first + ph, keep)
            else:
                _mul_phase(f, first + ph, stats)
        if ph == test:
            keeps[:] = on_test()


def emulate_warp(points, bits=R_BITS, accs=None, stats=None):
    """The kernel's lanes of one warp on Python integers: each lane's addend
    `points[i]` (6 Montgomery ints X0, X1, Y0, Y1, Z0, Z1) and accumulator
    `accs[i]` (default the point at infinity (1, 1, 0)), run over `bits`
    LSB first -- a set bit FUSED (ADD on the last bit) with the selects, a
    clear bit DBL (none on the last bit), DBL_ACC for the whole warp after
    a set bit where any lane has acc == addend, stored only by those lanes.
    Returns each lane's [(acc, addend)] after each bit, as 6 ints each.
    `stats` counts "products" (Fp2 products, a whole row or two half rows,
    summed over the lanes) and "dbl_acc" (the warp's runs of DBL_ACC)."""
    stats = {} if stats is None else stats
    inf = [ONE, 0, ONE, 0, 0, 0]
    files = []
    for i, pt in enumerate(points):
        f = [0] * SLOTS
        f[0:6] = list(accs[i]) if accs is not None else inf
        f[6:12] = list(pt)
        files.append(f)
    trace = [[] for _ in files]
    last = len(bits) - 1
    for i, bit in enumerate(bits):
        if bit:
            inf1 = [f[4] == f[5] == 0 for f in files]
            inf2 = [f[10] == f[11] == 0 for f in files]
            for f, z in zip(files, inf1):
                if z:  # acc at infinity: the sum is the addend
                    f[0:6] = f[6:12]
            dbl = [False] * len(files)
            name = "ADD" if i == last else "FUSED"
            hs, rs = program_meta(name)[3:]

            def on_test():
                for k, f in enumerate(files):
                    dbl[k] = not inf1[k] and not inf2[k] and _is_zero(f, hs) and _is_zero(f, rs)
                return [not a and not b and not d for a, b, d in zip(inf1, inf2, dbl)]

            _run(files, name, [False] * len(files), stats, on_test)
            if any(dbl):
                stats["dbl_acc"] = stats.get("dbl_acc", 0) + 1
                _run(files, "DBL_ACC", list(dbl), stats)
        elif i < last:
            _run(files, "DBL", [False] * len(files), stats)
        for f, tr in zip(files, trace):
            tr.append((list(f[0:6]), list(f[6:12])))
    return trace


def emulate_lane(point, bits=R_BITS, acc=None, stats=None):
    """`emulate_warp` on one lane: its [(acc, addend)] after each bit."""
    return emulate_warp([point], bits, None if acc is None else [acc], stats)[0]


def in_subgroup(x, y, stats=None) -> bool:
    """The kernel's verdict on the affine point (x, y) (Fp2 pairs of
    Montgomery ints): [r] (x, y, 1) == O over all of r's bits."""
    acc, _ = emulate_lane([x[0], x[1], y[0], y[1], ONE, 0], stats=stats)[-1]
    return acc[4] == 0 and acc[5] == 0


def main():
    with open(HEADER, "w") as f:
        f.write(header_text())
    print(HEADER)


if __name__ == "__main__":
    main()
