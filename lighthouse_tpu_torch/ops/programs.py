"""Bilinear multiplication programs for the tower, built symbolically.

A bilinear program is (A, B, C): left operands = A @ slots(x), right =
B @ slots(y), stacked Montgomery product, output slots = C @ products.
The programs are derived here from the SAME tower formulas as the validated
pure-Python reference (crypto/ref_fields.py): Karatsuba Fp2, the 6-mul
Fp6 schedule, Karatsuba Fp12 — so an Fp12 product is one 18-slot stacked
multiply plus two small einsums.

Slot order: Fp2 = [c0, c1]; Fp6 = [a0c0, a0c1, a1c0, a1c1, a2c0, a2c1];
Fp12 = first Fp6 then second (w) Fp6.
"""

import numpy as np


class _Lin:
    """Linear form over input slots: dict slot -> int coefficient."""

    def __init__(self, coeffs=None):
        self.c = dict(coeffs or {})

    @classmethod
    def unit(cls, i):
        return cls({i: 1})

    def __add__(self, o):
        out = dict(self.c)
        for k, v in o.c.items():
            out[k] = out.get(k, 0) + v
        return _Lin({k: v for k, v in out.items() if v})

    def __sub__(self, o):
        return self + o.scale(-1)

    def scale(self, s):
        return _Lin({k: v * s for k, v in self.c.items()})

    def __neg__(self):
        return self.scale(-1)


class _Prod:
    """Reference to one registered product (by index)."""

    def __init__(self, idx):
        self.c = {idx: 1}

    @classmethod
    def combo(cls, coeffs):
        p = cls.__new__(cls)
        p.c = dict(coeffs)
        return p

    def __add__(self, o):
        out = dict(self.c)
        for k, v in o.c.items():
            out[k] = out.get(k, 0) + v
        return _Prod.combo({k: v for k, v in out.items() if v})

    def __sub__(self, o):
        return self + o.scale(-1)

    def scale(self, s):
        return _Prod.combo({k: v * s for k, v in self.c.items()})

    def __neg__(self):
        return self.scale(-1)


class _Builder:
    def __init__(self):
        self.left = []
        self.right = []

    def mul(self, l: _Lin, r: _Lin) -> _Prod:
        self.left.append(l)
        self.right.append(r)
        return _Prod(len(self.left) - 1)

    def finish(self, outputs, s_left, s_right):
        k = len(self.left)
        A = np.zeros((k, s_left), dtype=np.int32)
        B = np.zeros((k, s_right), dtype=np.int32)
        C = np.zeros((len(outputs), k), dtype=np.int32)
        for i, lin in enumerate(self.left):
            for s, v in lin.c.items():
                A[i, s] = v
        for i, lin in enumerate(self.right):
            for s, v in lin.c.items():
                B[i, s] = v
        for o, prod in enumerate(outputs):
            for idx, v in prod.c.items():
                C[o, idx] = v
        # prune products with an all-zero operand (sparse programs): their
        # value is 0 mod p, so dropping the column is exact
        keep = [
            i
            for i in range(k)
            if A[i].any() and B[i].any() and C[:, i].any()
        ]
        return Program(A[keep], B[keep], C[:, keep])


class Program:
    def __init__(self, A, B, C):
        self.A, self.B, self.C = A, B, C

    @property
    def n_products(self):
        return self.A.shape[0]


# ---- symbolic tower formulas (mirroring ref_fields) ----


def _fp2_mul_sym(b, a, c):
    """a, c: 2-elem lists of _Lin (c0, c1). Returns 2 _Prod outputs.
    Karatsuba: t0 = a0 b0, t1 = a1 b1, t2 = (a0+a1)(b0+b1);
    out = (t0 - t1, t2 - t0 - t1)."""
    t0 = b.mul(a[0], c[0])
    t1 = b.mul(a[1], c[1])
    t2 = b.mul(a[0] + a[1], c[0] + c[1])
    return [t0 - t1, t2 - t0 - t1]


def _fp2_add(a, c):
    return [a[0] + c[0], a[1] + c[1]]


def _fp2_sub(a, c):
    return [a[0] - c[0], a[1] - c[1]]


def _fp2_mul_by_xi(a):
    # (c0 + c1 u)(1 + u) = (c0 - c1) + (c0 + c1) u
    return [a[0] - a[1], a[0] + a[1]]


def _fp6_mul_sym(b, a, c):
    """a, c: 3-elem lists of Fp2 (each 2 _Lin). Returns 3 Fp2 outputs
    (each 2 _Prod combos). Same 6-multiplication schedule as
    ref_fields.fp6_mul."""
    a0, a1, a2 = a
    c0, c1, c2 = c
    t0 = _fp2_mul_sym(b, a0, c0)
    t1 = _fp2_mul_sym(b, a1, c1)
    t2 = _fp2_mul_sym(b, a2, c2)
    m12 = _fp2_mul_sym(b, _fp2_add(a1, a2), _fp2_add(c1, c2))
    m01 = _fp2_mul_sym(b, _fp2_add(a0, a1), _fp2_add(c0, c1))
    m02 = _fp2_mul_sym(b, _fp2_add(a0, a2), _fp2_add(c0, c2))

    def sub2(x, y):
        return [x[0] - y[0], x[1] - y[1]]

    def add2(x, y):
        return [x[0] + y[0], x[1] + y[1]]

    def xi2(x):
        return [x[0] - x[1], x[0] + x[1]]

    out0 = add2(t0, xi2(sub2(sub2(m12, t1), t2)))
    out1 = add2(sub2(sub2(m01, t0), t1), xi2(t2))
    out2 = add2(sub2(sub2(m02, t0), t2), t1)
    return [out0, out1, out2]


def _fp6_add(a, c):
    return [_fp2_add(x, y) for x, y in zip(a, c)]


def _fp6_sub(a, c):
    return [_fp2_sub(x, y) for x, y in zip(a, c)]


def _fp6_mul_by_v(a):
    return [_fp2_mul_by_xi(a[2]), a[0], a[1]]


def _fp12_mul_sym(b, a, c):
    """Karatsuba over Fp6 pairs; 18 products total."""
    a0, a1 = a[:3], a[3:]
    c0, c1 = c[:3], c[3:]
    t0 = _fp6_mul_sym(b, a0, c0)
    t1 = _fp6_mul_sym(b, a1, c1)
    tx = _fp6_mul_sym(b, _fp6_add(a0, a1), _fp6_add(c0, c1))
    out0 = _fp6_add(t0, _fp6_mul_by_v(t1))
    out1 = _fp6_sub(_fp6_sub(tx, t0), t1)
    return out0 + out1


def _units(n, offset=0):
    return [_Lin.unit(offset + i) for i in range(n)]


def _flatten(nested):
    out = []
    for grp in nested:
        out.extend(grp)
    return out


def _build(symfn, s):
    b = _Builder()
    a = _units(s)
    c = _units(s)
    outs = symfn(b, a, c)
    return b.finish(_flatten_outputs(outs, s), s, s)


def _flatten_outputs(outs, s):
    # outputs arrive as nested lists mirroring the slot layout
    flat = []

    def rec(x):
        if isinstance(x, list):
            for y in x:
                rec(y)
        else:
            flat.append(x)

    rec(outs)
    assert len(flat) == s
    return flat


def _fp2_top(b, a, c):
    return _fp2_mul_sym(b, a, c)


FP2_MUL = _build(
    lambda b, a, c: _fp2_top(b, [a[0], a[1]], [c[0], c[1]]), 2
)
FP6_MUL = _build(
    lambda b, a, c: _fp6_mul_sym(
        b,
        [[a[0], a[1]], [a[2], a[3]], [a[4], a[5]]],
        [[c[0], c[1]], [c[2], c[3]], [c[4], c[5]]],
    ),
    6,
)


def _as6(v):
    return [[v[0], v[1]], [v[2], v[3]], [v[4], v[5]]]


FP12_MUL = _build(
    lambda b, a, c: _fp12_mul_sym(
        b,
        _as6(a[:6]) + _as6(a[6:]),
        _as6(c[:6]) + _as6(c[6:]),
    ),
    12,
)


def _fp12_sqr_sym(b, a):
    """Complex squaring over the Fp6 pair (w^2 = v): with t0 = a0 a1 and
    t1 = (a0 + a1)(a0 + v a1),
      (a0 + a1 w)^2 = (t1 - t0 - v t0) + (2 t0) w
    — 2 Fp6 multiplications (12 products) vs the generic mul's 18. The
    Miller loop squares f every iteration, so this is the hottest single
    op in the batch-verify kernel."""
    a0, a1 = a[:3], a[3:]
    t0 = _fp6_mul_sym(b, a0, a1)
    t1 = _fp6_mul_sym(
        b, _fp6_add(a0, a1), _fp6_add(a0, _fp6_mul_by_v(a1))
    )
    out0 = _fp6_sub(_fp6_sub(t1, t0), _fp6_mul_by_v(t0))
    out1 = _fp6_add(t0, t0)
    return out0 + out1


def _build_fp12_sqr():
    b = _Builder()
    x = _units(12)
    outs = _fp12_sqr_sym(b, _as6(x[:6]) + _as6(x[6:]))
    return b.finish(_flatten_outputs(outs, 12), 12, 12)


# bilinear(f, f, FP12_SQR): both operand matrices read the same bundle.
# 2 Fp6 muls = 12 Fp2 muls = 36 Fp products, vs FP12_MUL's 54.
FP12_SQR = _build_fp12_sqr()
assert FP12_SQR.n_products == 36, FP12_SQR.n_products

# Sparse line multiplication: f (12 slots) * line with only the w^0 (Fp2),
# w^2 (Fp2), w^3 (Fp2) tower slots nonzero. The line is presented as a
# 6-slot bundle [l0c0, l0c1, l2c0, l2c1, l3c0, l3c1]; as a full Fp12 its
# slot layout is: c0-part = (l0, l2, 0), c1-part = (0, l3, 0).


def _build_line_mul():
    b = _Builder()
    f = _units(12)
    line = _units(6)
    zero = _Lin()
    c_fp6_0 = [
        [line[0], line[1]],
        [line[2], line[3]],
        [zero, zero],
    ]
    c_fp6_1 = [
        [zero, zero],
        [line[4], line[5]],
        [zero, zero],
    ]
    outs = _fp12_mul_sym(
        b, _as6(f[:6]) + _as6(f[6:]), c_fp6_0 + c_fp6_1
    )
    prog = b.finish(_flatten_outputs(outs, 12), 12, 6)
    return prog


LINE_MUL = _build_line_mul()

# L1 sanity: apply_combo's offset covers rows up to L1 36
for _p in (FP2_MUL, FP6_MUL, FP12_MUL, LINE_MUL, FP12_SQR):
    assert np.abs(_p.A).sum(axis=1).max() <= 36
    assert np.abs(_p.B).sum(axis=1).max() <= 36
    assert np.abs(_p.C).sum(axis=1).max() <= 36
