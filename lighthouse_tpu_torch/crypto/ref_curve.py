"""Pure-Python reference implementation of the BLS12-381 groups G1 and G2.

Jacobian coordinates (X, Y, Z): affine (X/Z^2, Y/Z^3); infinity is Z == 0.
Generic over the coordinate field so the exact same formulas serve
G1 (over Fp) and G2 (over Fp2) — and, ported to limb arithmetic, the JAX
device kernels in `lighthouse_tpu_torch.ops.curve`.
"""

from . import ref_fields as ff
from .constants import P, B_G1, B_G2, G1_X, G1_Y, G2_X, G2_Y, R, H1, H2


class FpField:
    zero = 0
    one = 1
    add = staticmethod(ff.fp_add)
    sub = staticmethod(ff.fp_sub)
    mul = staticmethod(ff.fp_mul)
    neg = staticmethod(ff.fp_neg)
    inv = staticmethod(ff.fp_inv)

    @staticmethod
    def sqr(a):
        return a * a % P

    @staticmethod
    def is_zero(a):
        return a % P == 0

    @staticmethod
    def scalar(a, k):
        return a * k % P


class Fp2Field:
    zero = ff.FP2_ZERO
    one = ff.FP2_ONE
    add = staticmethod(ff.fp2_add)
    sub = staticmethod(ff.fp2_sub)
    mul = staticmethod(ff.fp2_mul)
    neg = staticmethod(ff.fp2_neg)
    inv = staticmethod(ff.fp2_inv)
    sqr = staticmethod(ff.fp2_sqr)
    scalar = staticmethod(ff.fp2_scalar)

    @staticmethod
    def is_zero(a):
        return a[0] % P == 0 and a[1] % P == 0


class CurveGroup:
    """Short-Weierstrass y^2 = x^3 + b over field F, Jacobian coordinates."""

    def __init__(self, field, b, gen_affine, name, cofactor):
        self.F = field
        self.b = b
        self.name = name
        self.cofactor = cofactor
        self.generator = (gen_affine[0], gen_affine[1], field.one)

    @property
    def infinity(self):
        return (self.F.one, self.F.one, self.F.zero)

    def is_infinity(self, pt):
        return self.F.is_zero(pt[2])

    def is_on_curve(self, pt):
        F = self.F
        if self.is_infinity(pt):
            return True
        x, y, z = pt
        # y^2 = x^3 + b z^6
        z2 = F.sqr(z)
        z6 = F.mul(F.sqr(z2), z2)
        return F.sub(F.sqr(y), F.add(F.mul(F.sqr(x), x), F.mul(self.b, z6))) == (
            F.zero
        )

    def to_affine(self, pt):
        F = self.F
        if self.is_infinity(pt):
            return None
        x, y, z = pt
        zinv = F.inv(z)
        zinv2 = F.sqr(zinv)
        return (F.mul(x, zinv2), F.mul(y, F.mul(zinv2, zinv)))

    def from_affine(self, aff):
        if aff is None:
            return self.infinity
        return (aff[0], aff[1], self.F.one)

    def double(self, pt):
        F = self.F
        x, y, z = pt
        if self.is_infinity(pt) or F.is_zero(y):
            return self.infinity
        a = F.sqr(x)
        b = F.sqr(y)
        c = F.sqr(b)
        # d = 2*((x+b)^2 - a - c)
        d = F.scalar(F.sub(F.sub(F.sqr(F.add(x, b)), a), c), 2)
        e = F.scalar(a, 3)
        f = F.sqr(e)
        x3 = F.sub(f, F.scalar(d, 2))
        y3 = F.sub(F.mul(e, F.sub(d, x3)), F.scalar(c, 8))
        z3 = F.scalar(F.mul(y, z), 2)
        return (x3, y3, z3)

    def add(self, p, q):
        F = self.F
        if self.is_infinity(p):
            return q
        if self.is_infinity(q):
            return p
        x1, y1, z1 = p
        x2, y2, z2 = q
        z1s = F.sqr(z1)
        z2s = F.sqr(z2)
        u1 = F.mul(x1, z2s)
        u2 = F.mul(x2, z1s)
        s1 = F.mul(y1, F.mul(z2s, z2))
        s2 = F.mul(y2, F.mul(z1s, z1))
        if u1 == u2:
            if s1 == s2:
                return self.double(p)
            return self.infinity
        h = F.sub(u2, u1)
        i = F.sqr(F.scalar(h, 2))
        j = F.mul(h, i)
        rr = F.scalar(F.sub(s2, s1), 2)
        v = F.mul(u1, i)
        x3 = F.sub(F.sub(F.sqr(rr), j), F.scalar(v, 2))
        y3 = F.sub(F.mul(rr, F.sub(v, x3)), F.scalar(F.mul(s1, j), 2))
        z3 = F.mul(F.scalar(F.mul(z1, z2), 2), h)
        return (x3, y3, z3)

    def neg(self, pt):
        return (pt[0], self.F.neg(pt[1]), pt[2])

    def mul_scalar(self, pt, k):
        if k < 0:
            return self.mul_scalar(self.neg(pt), -k)
        result = self.infinity
        addend = pt
        while k:
            if k & 1:
                result = self.add(result, addend)
            addend = self.double(addend)
            k >>= 1
        return result

    def in_subgroup(self, pt):
        """[r]P == inf — the deserialization-time subgroup policy check
        (blst.rs key_validate / sig subgroup). Routed through the native
        C ladder (native/g2decomp.c, ~40x the Python scalar mul) with
        this Python path as fallback and ground truth."""
        if self.is_infinity(pt):
            return True
        from lighthouse_tpu_torch.native import g2decomp

        if g2decomp.available():
            aff = self.to_affine(pt)
            got = (
                g2decomp.g1_in_subgroup(aff[0], aff[1])
                if self.name == "G1"
                else g2decomp.g2_in_subgroup(aff[0], aff[1])
            )
            if got is not None:
                return got
        return self.is_infinity(self.mul_scalar(pt, R))

    def clear_cofactor(self, pt):
        return self.mul_scalar(pt, self.cofactor)


G1 = CurveGroup(FpField, B_G1, (G1_X, G1_Y), "G1", H1)
G2 = CurveGroup(Fp2Field, B_G2, (G2_X, G2_Y), "G2", H2)
