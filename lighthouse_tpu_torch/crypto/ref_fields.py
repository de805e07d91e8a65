"""Pure-Python reference implementation of the BLS12-381 field tower.

Fp  : ints mod P
Fp2 : (c0, c1)            = c0 + c1*u,        u^2 = -1
Fp6 : (a0, a1, a2)        = a0 + a1*v + a2*v^2, v^3 = xi = 1+u, ai in Fp2
Fp12: (b0, b1)            = b0 + b1*w,        w^2 = v,          bi in Fp6

This is the ground truth used by tests to validate the JAX/TPU limb kernels
in `lighthouse_tpu_torch.ops`. It mirrors the semantics of the reference client's
`blst` backend (crypto/bls/src/impls/blst.rs) at the mathematical level; no
code is shared with it.

Functional style (plain tuples) so every operation has a 1:1 JAX analog.
"""

from .constants import P, XI, FROB_GAMMA

# ---------------------------------------------------------------- Fp


def fp_add(a, b):
    return (a + b) % P


def fp_sub(a, b):
    return (a - b) % P


def fp_mul(a, b):
    return (a * b) % P


def fp_neg(a):
    return (-a) % P


def fp_inv(a):
    return pow(a, -1, P)


# ---------------------------------------------------------------- Fp2

FP2_ZERO = (0, 0)
FP2_ONE = (1, 0)


def fp2_add(a, b):
    return ((a[0] + b[0]) % P, (a[1] + b[1]) % P)


def fp2_sub(a, b):
    return ((a[0] - b[0]) % P, (a[1] - b[1]) % P)


def fp2_neg(a):
    return ((-a[0]) % P, (-a[1]) % P)


def fp2_mul(a, b):
    a0, a1 = a
    b0, b1 = b
    return ((a0 * b0 - a1 * b1) % P, (a0 * b1 + a1 * b0) % P)


def fp2_sqr(a):
    a0, a1 = a
    # (a0 + a1 u)^2 = (a0+a1)(a0-a1) + 2 a0 a1 u
    return ((a0 + a1) * (a0 - a1) % P, 2 * a0 * a1 % P)


def fp2_scalar(a, k):
    return (a[0] * k % P, a[1] * k % P)


def fp2_conj(a):
    return (a[0], (-a[1]) % P)


def fp2_inv(a):
    a0, a1 = a
    norm_inv = pow(a0 * a0 + a1 * a1, -1, P)
    return (a0 * norm_inv % P, (-a1) * norm_inv % P)


def fp2_pow(a, e):
    result = FP2_ONE
    base = a
    while e > 0:
        if e & 1:
            result = fp2_mul(result, base)
        base = fp2_sqr(base)
        e >>= 1
    return result


def fp2_mul_by_xi(a):
    # (c0 + c1 u)(1 + u) = (c0 - c1) + (c0 + c1) u
    return ((a[0] - a[1]) % P, (a[0] + a[1]) % P)


def fp2_sqrt(a):
    """Square root in Fp2 via the p % 4 == 3 method. None if no root."""
    if a == FP2_ZERO:
        return FP2_ZERO
    cand = fp2_pow(a, (P * P + 7) // 16)
    # cand^2 = a * s where s^8 = 1; fix up by multiplying cand with an 8th
    # root of unity t such that (cand*t)^2 == a.
    roots = _eighth_roots_of_unity()
    for t in roots:
        r = fp2_mul(cand, t)
        if fp2_sqr(r) == (a[0] % P, a[1] % P):
            return r
    return None


_EIGHTH_ROOTS = None


def _eighth_roots_of_unity():
    global _EIGHTH_ROOTS
    if _EIGHTH_ROOTS is None:
        # u has order 4 (u^2 = -1); powers of u give the 4th roots of unity.
        roots = [FP2_ONE]
        for _ in range(3):
            roots.append(fp2_mul(roots[-1], (0, 1)))
        # An 8th root: sqrt(u) = (a, -a) with a^2 = -1/2. Since P % 8 == 3,
        # both -1 and 2 are non-residues in Fp, hence -1/2 IS a residue.
        a = pow((-pow(2, -1, P)) % P, (P + 1) // 4, P)
        assert a * a % P == (-pow(2, -1, P)) % P
        eighth = (a, P - a)
        assert fp2_sqr(eighth) == (0, 1)
        roots = roots + [fp2_mul(r, eighth) for r in roots]
        _EIGHTH_ROOTS = roots
    return _EIGHTH_ROOTS


# ---------------------------------------------------------------- Fp6

FP6_ZERO = (FP2_ZERO, FP2_ZERO, FP2_ZERO)
FP6_ONE = (FP2_ONE, FP2_ZERO, FP2_ZERO)


def fp6_add(a, b):
    return tuple(fp2_add(x, y) for x, y in zip(a, b))


def fp6_sub(a, b):
    return tuple(fp2_sub(x, y) for x, y in zip(a, b))


def fp6_neg(a):
    return tuple(fp2_neg(x) for x in a)


def fp6_mul(a, b):
    a0, a1, a2 = a
    b0, b1, b2 = b
    t0 = fp2_mul(a0, b0)
    t1 = fp2_mul(a1, b1)
    t2 = fp2_mul(a2, b2)
    # c0 = t0 + xi*((a1+a2)(b1+b2) - t1 - t2)
    c0 = fp2_add(
        t0,
        fp2_mul_by_xi(
            fp2_sub(fp2_sub(fp2_mul(fp2_add(a1, a2), fp2_add(b1, b2)), t1), t2)
        ),
    )
    # c1 = (a0+a1)(b0+b1) - t0 - t1 + xi*t2
    c1 = fp2_add(
        fp2_sub(fp2_sub(fp2_mul(fp2_add(a0, a1), fp2_add(b0, b1)), t0), t1),
        fp2_mul_by_xi(t2),
    )
    # c2 = (a0+a2)(b0+b2) - t0 - t2 + t1
    c2 = fp2_add(
        fp2_sub(fp2_sub(fp2_mul(fp2_add(a0, a2), fp2_add(b0, b2)), t0), t2), t1
    )
    return (c0, c1, c2)


def fp6_sqr(a):
    return fp6_mul(a, a)


def fp6_mul_by_v(a):
    # (a0 + a1 v + a2 v^2) * v = xi*a2 + a0 v + a1 v^2
    return (fp2_mul_by_xi(a[2]), a[0], a[1])


def fp6_inv(a):
    a0, a1, a2 = a
    c0 = fp2_sub(fp2_sqr(a0), fp2_mul_by_xi(fp2_mul(a1, a2)))
    c1 = fp2_sub(fp2_mul_by_xi(fp2_sqr(a2)), fp2_mul(a0, a1))
    c2 = fp2_sub(fp2_sqr(a1), fp2_mul(a0, a2))
    norm = fp2_add(
        fp2_mul(a0, c0),
        fp2_mul_by_xi(fp2_add(fp2_mul(a2, c1), fp2_mul(a1, c2))),
    )
    ninv = fp2_inv(norm)
    return (fp2_mul(c0, ninv), fp2_mul(c1, ninv), fp2_mul(c2, ninv))


# ---------------------------------------------------------------- Fp12

FP12_ZERO = (FP6_ZERO, FP6_ZERO)
FP12_ONE = (FP6_ONE, FP6_ZERO)


def fp12_mul(a, b):
    a0, a1 = a
    b0, b1 = b
    t0 = fp6_mul(a0, b0)
    t1 = fp6_mul(a1, b1)
    c0 = fp6_add(t0, fp6_mul_by_v(t1))
    c1 = fp6_sub(fp6_sub(fp6_mul(fp6_add(a0, a1), fp6_add(b0, b1)), t0), t1)
    return (c0, c1)


def fp12_sqr(a):
    return fp12_mul(a, a)


def fp12_conj(a):
    """Conjugation = Frobenius^6: negates the w-part."""
    return (a[0], fp6_neg(a[1]))


def fp12_inv(a):
    a0, a1 = a
    norm = fp6_sub(fp6_sqr(a0), fp6_mul_by_v(fp6_sqr(a1)))
    ninv = fp6_inv(norm)
    return (fp6_mul(a0, ninv), fp6_neg(fp6_mul(a1, ninv)))


def fp12_pow(a, e):
    if e < 0:
        return fp12_pow(fp12_inv(a), -e)
    result = FP12_ONE
    base = a
    while e > 0:
        if e & 1:
            result = fp12_mul(result, base)
        base = fp12_sqr(base)
        e >>= 1
    return result


def fp12_frobenius(a):
    """a^p on Fp12."""
    (a00, a01, a02), (a10, a11, a12) = a
    # Conjugate every Fp2 coefficient, then scale by gamma powers:
    # coefficient of v^i in c0-part picks up gamma[2i], in c1-part (w v^i)
    # picks up gamma[2i+1].
    c0 = (
        fp2_conj(a00),
        fp2_mul(fp2_conj(a01), FROB_GAMMA[2]),
        fp2_mul(fp2_conj(a02), FROB_GAMMA[4]),
    )
    c1 = (
        fp2_mul(fp2_conj(a10), FROB_GAMMA[1]),
        fp2_mul(fp2_conj(a11), FROB_GAMMA[3]),
        fp2_mul(fp2_conj(a12), FROB_GAMMA[5]),
    )
    return (c0, c1)
