"""Lane programs: the tables that K2 (csrc/miller.cu) and K3 (csrc/final_exp.cu)
run on a group of lanes, generated from the tower's bilinear programs.

On the TPU the products of one bilinear program (`ops/programs.py`: A, B, C
with z = C ((A x) * (B y))) filled the vector unit's sublanes. On the H100 a
group of lanes takes their place: one lane forms one row of A x and of B y,
multiplies the two in registers and writes the product into the group's slot
file in shared memory; after a barrier, lanes form the output rows of C from
the products. This module builds those rows for every Fp12 operation of the
Miller loop and the final exponentiation, schedules them into steps (one
barrier after each), allocates slots, and encodes everything as one u32
table per kernel in `csrc/lane_programs.cuh`, which is generated:

    python -m lighthouse_tpu_torch.ops.lanes     # rewrites the header

`emulate` runs a table on Python integers exactly as the kernels' lanes do
(Montgomery products, canonical slots, the same per-step read/write rules),
so the tests check every schedule on the CPU.

Terms. A row's operand is a sum sum_t c_t * slot_t with small signed
integer coefficients (L1 norm at most 64, so the kernels' 13-word sum stays
below 64 p < 2^387 and one quotient estimate reduces it, see `lin_sum_words`).
A MUL row multiplies its two operands (Montgomery product); a LIN row writes
its one operand.

Steps. A step's rows read slots written by earlier steps and write fresh
slots; no row reads a slot that another row of the same step writes (a row
may overwrite a slot only it reads). Rows beyond the group's width wrap onto
the lanes again within the step.

Calls. A program addresses its operands through three region bases (an
Fp12 value is 12 consecutive slots) that each call of the kernel's call
list supplies, so one MUL program serves every product of the chain.
"""

import os

from lighthouse_tpu_torch.crypto.constants import BLS_X_ABS, FROB_GAMMA, P
from lighthouse_tpu_torch.ops.programs import FP2_MUL, FP6_MUL, FP12_MUL, FP12_SQR, LINE_MUL

NW = 12
R = 1 << 384
R_INV = pow(R, -1, P)
L1_MAX = 64  # a row's sum S <= 64 p < 2^387: words 11-12 give the quotient
MAX_TERMS = 63  # 6-bit term counts
# a product operand of more terms than this materialises its values first:
# a term costs a lane about a twentieth of a product, and the LIN rows that
# materialise run beside the products of an earlier step
OPERAND_TERMS = 16
KIND_LIN, KIND_MUL = 0, 1

X_BITS = [int(b) for b in bin(BLS_X_ABS)[3:]]  # MSB first, below the top bit

HEADER = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "csrc", "lane_programs.cuh")


def mont(v: int) -> int:
    return v % P * R % P


def mont_mul(a: int, b: int) -> int:
    return a * b * R_INV % P


# ----------------------------------------------------------- the recorder


class Slot:
    """A value in the slot file: a fixed slot (region, offset) or a
    temporary that one row writes and the allocator places."""

    __slots__ = ("ref", "row", "phys")

    def __init__(self, ref=None):
        self.ref = ref  # (region, offset) for fixed slots
        self.row = None  # the row that writes it, for all but the inputs
        self.phys = ref


class Row:
    __slots__ = ("kind", "dst", "left", "right", "step")

    def __init__(self, kind, dst, left, right):
        self.kind, self.dst, self.left, self.right = kind, dst, left, right
        self.step = None

    def reads(self):
        return list(self.left) + list(self.right)


def _l1(lin):
    return sum(abs(c) for c in lin.values())


def _ok(lin):
    return 0 < len(lin) <= MAX_TERMS and _l1(lin) <= L1_MAX


def combo(vals, coeffs):
    """sum_j coeffs[j] * vals[j] over linear forms (dict slot -> int)."""
    out = {}
    for v, k in zip(vals, coeffs):
        k = int(k)
        if k:
            for s, c in v.items():
                out[s] = out.get(s, 0) + k * c
    return {s: c for s, c in out.items() if c}


def neg(v):
    return {s: -c for s, c in v.items()}


class Recorder:
    """Records the rows of one program."""

    def __init__(self):
        self.rows = []
        self._fixed = {}
        self._kept = {}
        self.written = set()

    def fixed(self, region, off):
        ref = (region, off)
        assert ref not in self.written, f"{ref} read after this program wrote it"
        if ref not in self._fixed:
            self._fixed[ref] = Slot(ref=ref)
        return {self._fixed[ref]: 1}

    def value(self, region, base, n):
        return [self.fixed(region, base + i) for i in range(n)]

    def _row(self, kind, left, right, out):
        assert _ok(left) and (kind == KIND_LIN or _ok(right)), (left, right)
        if out is None:
            dst = Slot()
        else:
            assert out not in self.written
            self.written.add(out)
            dst = Slot(ref=out)
        row = Row(kind, dst, dict(left), dict(right))
        dst.row = row
        self.rows.append(row)
        return {dst: 1}

    def mul(self, left, right, out=None):
        if not left or not right:  # a zero operand: the product is 0
            assert out is None
            return {}
        return self._row(KIND_MUL, left, right, out)

    def keep(self, v):
        """Materialise a linear form into a slot of its own (a LIN row)."""
        if len(v) == 1 and next(iter(v.values())) == 1:
            return v
        key = frozenset(v.items())
        if key not in self._kept:
            self._kept[key] = self._row(KIND_LIN, v, {}, None)
        return self._kept[key]

    def out(self, region, off, v):
        """Write form v to fixed slot (region, off): the program's output."""
        self._row(KIND_LIN, v, {}, (region, off))

    def bilinear(self, prog, x, y):
        """Output forms of C ((A x) * (B y)); operands whose composed rows
        exceed the term limits are materialised first."""

        def rows(mat, vals):
            return [combo(vals, mat[k]) for k in range(mat.shape[0])]

        def small(forms):
            return all(not v or (_ok(v) and len(v) <= OPERAND_TERMS) for v in forms)

        lefts, rights = rows(prog.A, x), rows(prog.B, y)
        if not small(lefts):
            x = [self.keep(v) for v in x]
            lefts = rows(prog.A, x)
        if not small(rights):
            y = [self.keep(v) for v in y]
            rights = rows(prog.B, y)
        prods = [self.mul(a, b) for a, b in zip(lefts, rights)]
        return [combo(prods, prog.C[j]) for j in range(prog.C.shape[0])]


# ---------------------------------------------------- tower in the recorder


def fp2_mul(b, x, y):
    return b.bilinear(FP2_MUL, x, y)


def fp2_combo(vals, coeffs):
    """Componentwise combination of Fp2 values (pairs of forms)."""
    return [combo([v[i] for v in vals], coeffs) for i in range(2)]


def fp2_xi(a):
    """(c0 + c1 u)(1 + u) = (c0 - c1) + (c0 + c1) u"""
    return [combo(a, [1, -1]), combo(a, [1, 1])]


def fp6_mul(b, x, y):
    return b.bilinear(FP6_MUL, x, y)


def fp6_by_v(a):
    """(a0, a1, a2) v = (xi a2, a0, a1) on 6 forms."""
    return fp2_xi(a[4:6]) + a[0:2] + a[2:4]


def fp12_mul(b, x, y):
    return b.bilinear(FP12_MUL, x, y)


def fp12_sqr(b, x):
    return b.bilinear(FP12_SQR, x, x)


def line_mul(b, f, line):
    return b.bilinear(LINE_MUL, f, line)


# ------------------------------------------------------------- scheduling


def _live(rows):
    """The rows an output needs, in their original order."""
    live = {id(r) for r in rows if r.dst.ref is not None}
    for r in reversed(rows):
        if id(r) in live:
            live.update(id(s.row) for s in r.reads() if s.row is not None)
    return [r for r in rows if id(r) in live]


class Program:
    """Rows grouped into steps, slots placed; `scratch` temporaries."""

    def __init__(self, name, rec, scratch_base):
        self.name = name
        rows = _live(rec.rows)
        # ASAP: a row runs one step after the last writer of what it reads;
        # a row writing a fixed slot also runs after every reader of it
        for row in rows:
            row.step = 1 + max((s.row.step for s in row.reads() if s.row is not None),
                               default=-1)
        for row in rows:
            if row.dst.ref is not None:
                readers = [r.step for r in rows if r is not row
                           and any(s.ref == row.dst.ref and s.row is None for s in r.reads())]
                row.step = max([row.step] + [st + 1 for st in readers])
        n_steps = 1 + max(r.step for r in rows)
        # place temporaries: a slot is free again once the step after its
        # last read begins
        last_read = {}
        for r in rows:
            for s in r.reads():
                if s.ref is None:
                    last_read[s] = max(last_read.get(s, -1), r.step)
        free_at = []  # per physical scratch slot: first step it may be written
        for r in sorted(rows, key=lambda r: r.step):
            if r.dst.ref is not None:
                continue
            assert r.dst in last_read, "a temporary nobody reads"
            for i, f in enumerate(free_at):
                if f <= r.step:
                    break
            else:
                i = len(free_at)
                free_at.append(0)
            free_at[i] = last_read[r.dst] + 1
            r.dst.phys = (0, scratch_base + i)
        self.n_scratch = len(free_at)
        self.steps = [[r for r in rows if r.step == k] for k in range(n_steps)]
        for st in self.steps:
            # LIN rows after MUL rows, so that product lanes sit together
            st.sort(key=lambda r: -r.kind)
        self.n_products = sum(r.kind == KIND_MUL for r in rows)


# ----------------------------------------------------------------- tables


def _ref_bits(ref):
    region, off = ref
    assert 0 <= region < 4 and 0 <= off < 1024, ref
    return region << 10 | off


def term_word(ref_bits: int, c: int) -> int:
    """A term of a row's sum as fp_reg.cuh `lin_sum` reads it, for K1's
    rows too: slot reference (bits 0-11) | signed coefficient << 12."""
    assert 0 <= ref_bits < 1 << 12 and -(1 << 19) <= c < (1 << 19)
    return (ref_bits | (c << 12)) & 0xFFFFFFFF


def term_parts(t: int):
    """term_word's inverse: (slot reference, coefficient)."""
    return t & 0xFFF, (t >> 12) - ((t >> 31) << 20)  # arithmetic shift of the 32-bit word


def _term(slot, c):
    return term_word(_ref_bits(slot.phys), c)


class KernelTables:
    """Programs, slot layout and call list of one kernel, as one u32 table:
    [progs | steps | rows | terms | calls | consts]."""

    def __init__(self, name, ns, programs, calls, consts, symbols):
        self.name, self.ns = name, ns
        self.programs = programs  # list of Program
        self.prog_id = {p.name: i for i, p in enumerate(programs)}
        self.calls = calls  # name -> list of (prog name, b1, b2, b3)
        self.consts = consts  # list of (slot, Montgomery value)
        self.symbols = symbols  # name -> int, for the header
        self._encode()

    def _encode(self):
        progs, steps, rows, terms = [], [], [], []
        for p in self.programs:
            progs.append(len(steps))
            for st in p.steps:
                steps.append(len(rows) // 2)
                for r in st:
                    left = list(r.left.items())
                    right = list(r.right.items())
                    w0 = (_ref_bits(r.dst.phys) | r.kind << 12 | len(left) << 14
                          | len(right) << 20)
                    w1 = len(terms)
                    assert w1 < 1 << 16
                    rows += [w0, w1]
                    terms += [_term(s, c) for s, c in left + right]
        progs.append(len(steps))
        steps.append(len(rows) // 2)
        call_words, self.call_range = [], {}
        for name, lst in self.calls.items():
            start = len(call_words)
            for prog, b1, b2, b3 in lst:
                assert max(b1, b2, b3) < 256
                call_words.append(self.prog_id[prog] | b1 << 8 | b2 << 16 | b3 << 24)
            self.call_range[name] = (start, len(call_words))
        const_words = []
        for _, v in self.consts:
            const_words += [(v >> (32 * j)) & 0xFFFFFFFF for j in range(NW)]
        self.sections = {}
        table = []
        for sec, words in (("PROGS", progs), ("STEPS", steps), ("ROWS", rows),
                           ("TERMS", terms), ("CALLS", call_words), ("CONSTS", const_words)):
            self.sections[sec] = len(table)
            table += words
        # the slot files follow the table in shared memory, 16-byte aligned
        self.table = table + [0] * (-len(table) % 4)

    def decode_call(self, word):
        return word & 255, (word >> 8) & 255, (word >> 16) & 255, word >> 24


# ------------------------------------------------------------- emulation


def _slot_index(ref_bits, bases):
    region, off = ref_bits >> 10, ref_bits & 1023
    return off + (bases[region - 1] if region else 0)


def _sum(terms, bases, file, reads):
    s = 0
    for t in terms:
        ref, c = term_parts(t)
        idx = _slot_index(ref, bases)
        reads.add(idx)
        s += c * file[idx]
    return s % P


def commit_step(file: list, rows, where="") -> None:
    """One step (a phase, in K1's words) of a group's rows, each (writes
    {slot: value}, reads {slot}) computed from `file` as it was before the
    step, applied to `file` with the rule the kernels' one barrier a step
    relies on: no slot written twice, and no row reading a slot that
    another row writes (a row may overwrite what it reads itself)."""
    writes = {}
    for w, _ in rows:
        for dst, v in w.items():
            assert dst not in writes, f"{where}: slot {dst} written twice"
            writes[dst] = v
    for w, reads in rows:
        assert not (set(reads) - set(w)) & set(writes), f"{where}: read/write race"
    for dst, v in writes.items():
        file[dst] = v


def emulate(kt: KernelTables, calls: str, file: list, stats=None) -> list:
    """Run call list `calls` of `kt` on `file` (ns Python ints, canonical
    Montgomery values) the way the kernel's lanes do, step by step: every
    row of a step reads the slot file as it was before the step. Raises if
    a step reads a slot that another row of it writes, or writes one slot
    twice. Returns the file."""
    tab = kt.table
    sec = kt.sections
    c0, c1 = kt.call_range[calls]
    for word in tab[sec["CALLS"] + c0: sec["CALLS"] + c1]:
        prog, *bases = kt.decode_call(word)
        s0, s1 = tab[sec["PROGS"] + prog], tab[sec["PROGS"] + prog + 1]
        for s in range(s0, s1):
            r0, r1 = tab[sec["STEPS"] + s], tab[sec["STEPS"] + s + 1]
            rows = []
            for r in range(r0, r1):
                w0, w1 = tab[sec["ROWS"] + 2 * r], tab[sec["ROWS"] + 2 * r + 1]
                nl, nr = (w0 >> 14) & 63, (w0 >> 20) & 63
                terms = tab[sec["TERMS"] + w1: sec["TERMS"] + w1 + nl + nr]
                reads = set()
                v = _sum(terms[:nl], bases, file, reads)
                if (w0 >> 12) & 3 == KIND_MUL:
                    v = mont_mul(v, _sum(terms[nl:], bases, file, reads))
                    if stats is not None:
                        stats["products"] = stats.get("products", 0) + 1
                rows.append(({_slot_index(w0 & 0xFFF, bases): v}, reads))
            commit_step(file, rows, f"step {s}")
            if stats is not None:
                stats["steps"] = stats.get("steps", 0) + 1
    return file


def lin_sum_words(xs, cs):
    """Word-level model of fp_reg.cuh `lin_sum`: sum_t cs[t] xs[t] mod p for
    canonical xs and sum |cs| <= 64 (K1's rows go to 256, tested too). Each
    word j accumulates k * x_j in 64 bits, with x complemented for a
    negative coefficient -k (so that term
    adds k (2^384 - 1 - x)); one carry pass folds in kneg (p + 1) and takes
    kneg 2^384 off the top word; a quotient estimate from words 11-12 and
    one conditional subtraction finish. Returns (canonical value, the value
    before the subtraction, which a product's operand uses)."""
    m32, m64 = 0xFFFFFFFF, (1 << 64) - 1
    acc = [0] * NW
    kneg = 0
    for x, c in zip(xs, cs):
        k, m = abs(c), m32 if c < 0 else 0
        kneg += k if c < 0 else 0
        for j in range(NW):
            acc[j] = (acc[j] + (((x >> (32 * j)) & m32) ^ m) * k) & m64
            assert acc[j] < 1 << 63
    w = []
    carry = kneg
    for j in range(NW):
        v = acc[j] + carry + kneg * ((P >> (32 * j)) & m32)
        assert v < 1 << 64
        w.append(v & m32)
        carry = v >> 32
    w.append((carry - kneg) & m32)
    s = sum(wj << (32 * j) for j, wj in enumerate(w))
    assert s == sum(c * x for c, x in zip(cs, xs)) + kneg * P
    q = ((w[12] << 32) | w[11]) // ((P >> 352) + 1)
    r = (s - q * P) % (1 << 384)
    assert r == s - q * P and r < 2 * P, "quotient estimate off by more than one"
    return (r - P if r >= P else r), r


# ------------------------------------------------------------ K2 programs

# lanes a group: one warp, joined by __syncwarp (the header carries it to
# lanes.cuh as G; PERF.md says why not 64)
LANES = 32
# threads a block of each entry (miller.cu, final_exp.cu read them here)
K2_THREADS = 256
K3_FOLD_THREADS = 512
K3_SET_THREADS = 128
K3_SET_LANES = 16  # lanes a chain in the per-set entry

# slot file of K2: f, T = (X, Y, Z) on the twist, P and affine Q
K2_F, K2_TX, K2_TY, K2_TZ, K2_PX, K2_PY, K2_QX, K2_QY = 0, 12, 14, 16, 18, 19, 20, 22
K2_SCRATCH = 24


def _k2_state(b):
    f = b.value(0, K2_F, 12)
    t = (b.value(0, K2_TX, 2), b.value(0, K2_TY, 2), b.value(0, K2_TZ, 2))
    p = (b.fixed(0, K2_PX), b.fixed(0, K2_PY))
    q = (b.value(0, K2_QX, 2), b.value(0, K2_QY, 2))
    return f, t, p, q


def _line_scale(b, ca, cb, px, py):
    """(ca px, cb py) for Fp2 forms ca, cb and Fp slots px, py."""
    return [b.mul(v, px) for v in ca], [b.mul(v, py) for v in cb]


def dbl_step(b, t, p):
    """tpairing.dbl_step on forms: returns the new T and the line."""
    X, Y, Z = t
    px, py = p
    a, bb, z2, yz = (fp2_mul(b, X, X), fp2_mul(b, Y, Y), fp2_mul(b, Z, Z), fp2_mul(b, Y, Z))
    xb = fp2_combo([X, bb], [1, 1])
    e = fp2_combo([a], [3])
    c, xb2, f, x3c, x2z2, yz3 = (fp2_mul(b, bb, bb), fp2_mul(b, xb, xb), fp2_mul(b, e, e),
                                 fp2_mul(b, X, a), fp2_mul(b, a, z2), fp2_mul(b, yz, z2))
    vals = [xb2, a, c, f, x3c, bb, x2z2, yz3, yz]
    x3 = fp2_combo(vals, [-4, 4, 4, 1, 0, 0, 0, 0, 0])
    dmx = fp2_combo(vals, [6, -6, -6, -1, 0, 0, 0, 0, 0])
    c0 = fp2_combo(vals, [0, 0, 0, 0, 3, -2, 0, 0, 0])
    m3xz = fp2_combo(vals, [0, 0, 0, 0, 0, 0, -3, 0, 0])
    c3p = fp2_combo(vals, [0, 0, 0, 0, 0, 0, 0, 2, 0])
    z3 = fp2_combo(vals, [0, 0, 0, 0, 0, 0, 0, 0, 2])
    edmx = fp2_mul(b, e, dmx)
    c2, c3 = _line_scale(b, m3xz, c3p, px, py)
    y3 = fp2_combo([edmx, c], [1, -8])
    return (x3, y3, z3), c0 + c2 + c3


def add_step(b, t, q, p):
    """tpairing.add_step (mixed addition with affine Q) on forms."""
    X1, Y1, Z1 = t
    qx, qy = q
    px, py = p
    z1s = fp2_mul(b, Z1, Z1)
    u2, z1c = fp2_mul(b, qx, z1s), fp2_mul(b, z1s, Z1)
    gamma = fp2_combo([u2, X1], [1, -1])
    qyz, hh, z1gam = fp2_mul(b, qy, z1c), fp2_mul(b, gamma, gamma), fp2_mul(b, Z1, gamma)
    theta = fp2_combo([qyz, Y1], [1, -1])
    tt, hhh, v, tqx, qyz3 = (fp2_mul(b, theta, theta), fp2_mul(b, gamma, hh), fp2_mul(b, X1, hh),
                             fp2_mul(b, theta, qx), fp2_mul(b, qy, z1gam))
    vals = [tt, hhh, v, tqx, qyz3, theta]
    x3 = fp2_combo(vals, [1, -1, -2, 0, 0, 0])
    vmx = fp2_combo(vals, [-1, 1, 3, 0, 0, 0])
    c0 = fp2_combo(vals, [0, 0, 0, 1, -1, 0])
    mtheta = fp2_combo(vals, [0, 0, 0, 0, 0, -1])
    tvmx, y1hhh = fp2_mul(b, theta, vmx), fp2_mul(b, Y1, hhh)
    c2, c3 = _line_scale(b, mtheta, z1gam, px, py)
    y3 = fp2_combo([tvmx, y1hhh], [1, -1])
    return (x3, y3, z1gam), c0 + c2 + c3


def _k2_iteration(with_add: bool):
    """One Miller loop iteration in place: f <- f^2 l_{T,T}(P), T <- 2T, and
    for a set bit f <- f l_{T,Q}(P), T <- T + Q."""
    b = Recorder()
    f, t, p, q = _k2_state(b)
    f2 = fp12_sqr(b, f)
    t, line = dbl_step(b, t, p)
    f = line_mul(b, f2, line)
    if with_add:
        t, line = add_step(b, t, q, p)
        f = line_mul(b, f, line)
    for base, v in zip((K2_TX, K2_TY, K2_TZ), t):
        for i in range(2):
            b.out(0, base + i, v[i])
    for i in range(12):
        b.out(0, K2_F + i, f[i])
    return b


def _conj_program(src_region, src_base, dst_region, dst_base):
    b = Recorder()
    x = b.value(src_region, src_base, 12)
    for i in range(12):
        b.out(dst_region, dst_base + i, x[i] if i < 6 else neg(x[i]))
    return b


def k2_tables() -> KernelTables:
    progs = [
        Program("dbl", _k2_iteration(False), K2_SCRATCH),
        Program("dbl_add", _k2_iteration(True), K2_SCRATCH),
        Program("conj", _conj_program(0, K2_F, 0, K2_F), K2_SCRATCH),
    ]
    calls = [("dbl_add" if bit else "dbl", 0, 0, 0) for bit in X_BITS] + [("conj", 0, 0, 0)]
    ns = K2_SCRATCH + max(p.n_scratch for p in progs)
    symbols = {"F": K2_F, "TX": K2_TX, "TY": K2_TY, "TZ": K2_TZ, "PX": K2_PX, "PY": K2_PY,
               "QX": K2_QX, "QY": K2_QY, "THREADS": K2_THREADS}
    return KernelTables("K2", ns, progs, {"LOOP": calls}, [], symbols)


# ------------------------------------------------------------ K3 programs

_ORDER = [0, 2, 4, 1, 3, 5]  # Fp12 slot order of the Frobenius gammas
GAMMAS = [FROB_GAMMA[i] for i in _ORDER]
NORMS = [(g[0] * g[0] + g[1] * g[1]) % P for g in GAMMAS]

# slot file of K3: constants, six Fp12 regions, the values the Fp12
# inversion hands across its Fp inversion, then scratch
K3_CONSTS = [(k, i) for i in range(6) for k in range(2) if GAMMAS[i][k]]
K3_GAMMA = {key: n for n, key in enumerate(K3_CONSTS)}
K3_NORM = len(K3_CONSTS)  # 6 norm slots follow the gammas
_REGIONS = ("A", "B", "T", "U", "F", "X")
K3_REGION = {r: K3_NORM + 6 + 12 * i for i, r in enumerate(_REGIONS)}
K3_INV = K3_NORM + 6 + 12 * len(_REGIONS)  # c0, c1, c2 (Fp2), norm (Fp2), in, out
K3_INV_IN, K3_INV_OUT = K3_INV + 8, K3_INV + 9
K3_SCRATCH = K3_INV + 10


def _k3_binary(fn):
    b = Recorder()
    x, y = b.value(1, 0, 12), b.value(2, 0, 12)
    out = fn(b, x, y)
    for i in range(12):
        b.out(3, i, out[i])
    return b


def _k3_frob():
    """a^p: each Fp2 coefficient conjugated, times its gamma."""
    b = Recorder()
    x = b.value(1, 0, 12)
    for i in range(6):
        g = [b.fixed(0, K3_GAMMA[(k, i)]) if (k, i) in K3_GAMMA else {} for k in range(2)]
        c = fp2_mul(b, [x[2 * i], neg(x[2 * i + 1])], g)
        for k in range(2):
            b.out(3, 2 * i + k, c[k])
    return b


def _k3_frob2():
    """a^(p^2): each Fp2 coefficient times the Fp norm of its gamma."""
    b = Recorder()
    x = b.value(1, 0, 12)
    for j in range(12):
        b.mul(x[j], b.fixed(0, K3_NORM + j // 2), out=(3, j))
    return b


# p - 2 as 4-bit windows from the top; the top window is 1
INV_WINDOWS = [((P - 2) >> (4 * i)) & 15 for i in range(((P - 2).bit_length() + 3) // 4)][::-1]
# products of the kernels' Fp inversion (final_exp.cu `fp_inv_window`): the
# table x^2 .. x^15, then 4 squarings and one table product a window
INV_PRODUCTS = 14 + sum(4 + (d != 0) for d in INV_WINDOWS[1:])


def mont_inv(v: int) -> int:
    """The Montgomery form of 1/x for the Montgomery form v of x (0 -> 0)."""
    return R * R * pow(v, -1, P) % P if v else 0


def _k3_inv_pre():
    """First half of 1/a for a in Fp12 (tower inversion): the Fp6 norm n =
    a0^2 - v a1^2, its adjugate c = (c0, c1, c2), the Fp2 norm of n and the
    Fp value to invert, into the hand-over slots."""
    b = Recorder()
    a = b.value(1, 0, 12)
    a0, a1 = a[:6], a[6:]
    s0, s1 = fp6_mul(b, a0, a0), fp6_mul(b, a1, a1)
    vs1 = fp6_by_v(s1)
    n = [b.keep(combo([s0[i], vs1[i]], [1, -1])) for i in range(6)]
    n0, n1, n2 = n[0:2], n[2:4], n[4:6]
    sq0, sq1, sq2 = fp2_mul(b, n0, n0), fp2_mul(b, n1, n1), fp2_mul(b, n2, n2)
    p01, p12, p02 = fp2_mul(b, n0, n1), fp2_mul(b, n1, n2), fp2_mul(b, n0, n2)
    c = (fp2_combo([sq0, fp2_xi(p12)], [1, -1]) + fp2_combo([fp2_xi(sq2), p01], [1, -1])
         + fp2_combo([sq1, p02], [1, -1]))
    c = [b.keep(v) for v in c]
    q0, q1, q2 = fp2_mul(b, n0, c[0:2]), fp2_mul(b, n2, c[2:4]), fp2_mul(b, n1, c[4:6])
    norm = fp2_combo([q0, fp2_xi(fp2_combo([q1, q2], [1, 1]))], [1, 1])
    norm = [b.keep(v) for v in norm]
    m0, m1 = b.mul(norm[0], norm[0]), b.mul(norm[1], norm[1])
    for i, v in enumerate(c + norm):
        b.out(0, K3_INV + i, v)
    b.out(0, K3_INV_IN, combo([m0, m1], [1, 1]))
    return b


def _k3_inv_post():
    """Second half: with 1 / (norm0^2 + norm1^2) in slot INV_OUT, 1/a into
    region 3."""
    b = Recorder()
    a = b.value(1, 0, 12)
    a0, a1 = a[:6], a[6:]
    c = b.value(0, K3_INV, 6)
    norm = b.value(0, K3_INV + 6, 2)
    ninv = b.fixed(0, K3_INV_OUT)
    inv2 = [b.mul(norm[0], ninv), b.mul(neg(norm[1]), ninv)]
    inv6 = fp2_mul(b, c[0:2], inv2) + fp2_mul(b, c[2:4], inv2) + fp2_mul(b, c[4:6], inv2)
    inv6 = [b.keep(v) for v in inv6]
    r0 = fp6_mul(b, a0, inv6)
    r1 = fp6_mul(b, a1, inv6)
    for i in range(6):
        b.out(3, i, r0[i])
        b.out(3, 6 + i, neg(r1[i]))
    return b


def _pow_x(calls, src, dst):
    """dst = src^|x| by square-and-multiply from the top bit of |x|."""
    calls.append(("sqr", src, 0, dst))
    if X_BITS[0]:
        calls.append(("mul", dst, src, dst))
    for bit in X_BITS[1:]:
        calls.append(("sqr", dst, 0, dst))
        if bit:
            calls.append(("mul", dst, src, dst))


def k3_fexp_calls(reg):
    """tfexp.final_exponentiation_t as two call lists, input in A, result in
    A: FEXP_A ends with the Fp value to invert in slot INV_IN; the kernel
    writes its inverse to INV_OUT (`fp_inv_window`, one lane a chain, so the
    per-set entry inverts all sets of a block at once); FEXP_B goes on. With
    P(y) = y^|x| and conj the p^6 Frobenius (a ring automorphism, so
    P(conj y) = conj P(y)), the chain's
        t0 = conj(P(f)) conj(f), t1 = conj(P(t0)) conj(t0),
        t2 = conj(P(t1)) frob(t1), t3 = P(P(t2)) frob2(t2) conj(t2)
    are computed as X = P(f) f, t1 = P(X) X, and t2, t3 as written: the
    same values with three conjugations fewer."""
    A, T, U, F, X = (reg[k] for k in ("A", "T", "U", "F", "X"))
    head = [("conj", A, 0, T), ("inv_pre", A, 0, 0)]
    c = [("inv_post", A, 0, U), ("mul", T, U, F), ("frob2", F, 0, T), ("mul", T, F, F)]
    _pow_x(c, F, T)
    c.append(("mul", T, F, X))  # X = P(f) f, t0 = conj(X)
    _pow_x(c, X, T)
    c.append(("mul", T, X, X))  # t1
    _pow_x(c, X, T)
    c += [("conj", T, 0, A), ("frob", X, 0, U), ("mul", A, U, X)]  # t2
    _pow_x(c, X, T)
    _pow_x(c, T, A)  # A = P(P(t2))
    c += [("frob2", X, 0, U), ("conj", X, 0, T), ("mul", U, T, U), ("mul", A, U, A),  # t3
          ("mul", F, F, T), ("mul", T, F, T), ("mul", A, T, A)]
    return head, c


def emulate_fexp(kt: KernelTables, file: list, stats=None) -> list:
    """FEXP_A, the Fp inversion of slot INV_IN into INV_OUT, FEXP_B."""
    emulate(kt, "FEXP_A", file, stats)
    file[K3_INV_OUT] = mont_inv(file[K3_INV_IN])
    emulate(kt, "FEXP_B", file, stats)
    return file


def k3_tables() -> KernelTables:
    progs = [
        Program("mul", _k3_binary(fp12_mul), K3_SCRATCH),
        Program("sqr", _k3_binary(lambda b, x, y: fp12_sqr(b, x)), K3_SCRATCH),
        Program("conj", _conj_program(1, 0, 3, 0), K3_SCRATCH),
        Program("frob", _k3_frob(), K3_SCRATCH),
        Program("frob2", _k3_frob2(), K3_SCRATCH),
        Program("inv_pre", _k3_inv_pre(), K3_SCRATCH),
        Program("inv_post", _k3_inv_post(), K3_SCRATCH),
    ]
    reg = K3_REGION
    head, tail = k3_fexp_calls(reg)
    calls = {"MUL": [("mul", reg["A"], reg["B"], reg["A"])], "FEXP_A": head, "FEXP_B": tail}
    ns = K3_SCRATCH + max([15] + [p.n_scratch for p in progs])  # 15: the inversion's table
    consts = [(K3_GAMMA[key], mont(GAMMAS[key[1]][key[0]])) for key in K3_CONSTS]
    consts += [(K3_NORM + i, mont(NORMS[i])) for i in range(6)]
    symbols = {"REG_" + k: v for k, v in reg.items()} | {
        "CONST_SLOT": 0, "NCONST": len(consts),
        "INV_IN": K3_INV_IN, "INV_OUT": K3_INV_OUT, "INV_TABLE": K3_SCRATCH,
        "FOLD_THREADS": K3_FOLD_THREADS, "SET_THREADS": K3_SET_THREADS,
        "SET_LANES": K3_SET_LANES}
    return KernelTables("K3", ns, progs, calls, consts, symbols)


def shared_bytes(kt: KernelTables, threads: int, width: int = LANES) -> int:
    """Dynamic shared memory of a block: the table and one slot file a group."""
    return 4 * (len(kt.table) + threads // width * NW * kt.ns)


def chain_profile(kt: KernelTables, calls) -> dict:
    """Steps of call lists, the steps holding a product and all their
    products; "inv" stands for the kernels' Fp inversion, INV_PRODUCTS
    dependent products on one lane. product_steps + inv_products is the
    chain's length in dependent products."""
    out = {"steps": 0, "product_steps": 0, "products": 0, "inv_products": 0}
    for name in calls:
        if name == "inv":
            out["products"] += INV_PRODUCTS
            out["inv_products"] += INV_PRODUCTS
            continue
        c0, c1 = kt.call_range[name]
        for word in kt.table[kt.sections["CALLS"] + c0: kt.sections["CALLS"] + c1]:
            for st in kt.programs[word & 255].steps:
                n = sum(r.kind == KIND_MUL for r in st)
                out["steps"] += 1
                out["product_steps"] += n > 0
                out["products"] += n
    return out


# ---------------------------------------------------------------- header


def _array(name, words):
    lines = [f"__device__ const u32 {name}[{len(words)}] = {{"]
    for i in range(0, len(words), 8):
        lines.append("    " + ", ".join(f"0x{w:08x}u" for w in words[i:i + 8]) + ",")
    lines.append("};")
    return lines


def header_text() -> str:
    out = [
        "// Lane programs of K2 (miller.cu) and K3 (final_exp.cu): generated by",
        "// lighthouse_tpu_torch/ops/lanes.py from the tower's bilinear programs",
        "// (ops/programs.py). Do not edit; regenerate with",
        "//     python -m lighthouse_tpu_torch.ops.lanes",
        "// Table: [PROGS | STEPS | ROWS | TERMS | CALLS | CONSTS], u32 words;",
        "// lanes.cuh says how a group of lanes runs it.",
        "#pragma once",
        "",
        "#include <stdint.h>",
        "",
        "namespace lanes {",
        "",
        "typedef uint32_t u32;",
        "",
        "// lanes a group (lanes.cuh's G)",
        f"constexpr int LANES = {LANES};",
    ]
    for kt in (k2_tables(), k3_tables()):
        out += ["", f"struct {kt.name} {{", f"  static constexpr int NS = {kt.ns};",
                f"  static constexpr int WORDS = {len(kt.table)};"]
        out += [f"  static constexpr int {k} = {v};" for k, v in kt.sections.items()]
        for name, (c0, c1) in kt.call_range.items():
            out += [f"  static constexpr int CALLS_{name} = {c0};",
                    f"  static constexpr int CALLS_{name}_END = {c1};"]
        out += [f"  static constexpr int {k} = {v};" for k, v in kt.symbols.items()]
        out += [f"  // {p.name}: {len(p.steps)} steps, {p.n_products} products, "
                f"{p.n_scratch} scratch slots" for p in kt.programs]
        out += ["};", ""]
        out += _array(f"{kt.name}_TABLE", kt.table)
    out += ["", "}  // namespace lanes", ""]
    return "\n".join(out)


def main():
    with open(HEADER, "w") as f:
        f.write(header_text())
    print(HEADER)


if __name__ == "__main__":
    main()
