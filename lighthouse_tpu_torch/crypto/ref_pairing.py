"""Pure-Python reference implementation of the optimal ate pairing on BLS12-381.

Miller loop over the twist E'(Fp2) with line evaluation at P in G1, followed
by the final exponentiation (easy part + x-addition-chain hard part).

Untwist convention: psi(x', y') = (x'/w^2, y'/w^3) maps E'(Fp2) -> E(Fp12)
with the tower w^2 = v, v^3 = xi = 1+u (so w^6 = xi and the twist equation
y^2 = x^3 + 4*xi maps onto y^2 = x^3 + 4). The tangent/chord line through
T = (a, b) on the twist, evaluated at affine P = (Px, Py) in G1, is (after
scaling by w^3, which lies in the proper subfield Fp4 and is therefore
annihilated by the final exponentiation):

    l(P) * w^3 = (lam*a - b)  -  (lam * Px) * w^2  +  Py * w^3

where lam in Fp2 is the twist-coordinate slope. w^2 = v is the (c0, v^1)
slot and w^3 = w*v the (c1, v^1) slot of Fp12 = Fp6 + Fp6*w.
"""

from . import ref_fields as ff
from .constants import BLS_X, BLS_X_ABS, P, R
from .ref_curve import G1 as G1_GROUP
from .ref_curve import G2 as G2_GROUP
from .ref_curve import Fp2Field

F2 = Fp2Field


def _line_to_fp12(w0_term, w2_term, py_term):
    """Build the sparse Fp12 line element.

    w0_term/w2_term in Fp2 (coefficients of w^0 and w^2); py_term in Fp
    (coefficient of w^3).
    """
    c0 = (w0_term, w2_term, ff.FP2_ZERO)
    c1 = (ff.FP2_ZERO, (py_term % P, 0), ff.FP2_ZERO)
    return (c0, c1)


def _dbl_step(t, p_affine):
    """Double T on the twist; return (2T, line_{T,T}(P)) as Fp12."""
    px, py = p_affine
    a, b = t  # affine twist coords in Fp2
    # lambda = 3a^2 / 2b
    lam = F2.mul(
        F2.scalar(F2.sqr(a), 3),
        F2.inv(F2.scalar(b, 2)),
    )
    a3 = F2.sub(F2.sqr(lam), F2.scalar(a, 2))
    b3 = F2.sub(F2.mul(lam, F2.sub(a, a3)), b)
    line = _line_to_fp12(
        F2.sub(F2.mul(lam, a), b),
        F2.neg(F2.scalar(lam, px)),
        py,
    )
    return (a3, b3), line


def _add_step(t, q, p_affine):
    """Add Q to T on the twist; return (T+Q, line_{T,Q}(P)) as Fp12."""
    px, py = p_affine
    ax, ay = t
    bx, by = q
    lam = F2.mul(F2.sub(by, ay), F2.inv(F2.sub(bx, ax)))
    cx = F2.sub(F2.sub(F2.sqr(lam), ax), bx)
    cy = F2.sub(F2.mul(lam, F2.sub(ax, cx)), ay)
    line = _line_to_fp12(
        F2.sub(F2.mul(lam, ax), ay),
        F2.neg(F2.scalar(lam, px)),
        py,
    )
    return (cx, cy), line


def miller_loop(pairs):
    """Product of Miller loops over [(P_affine_g1, Q_affine_g2), ...].

    P is an affine G1 point (x, y) ints; Q an affine twist point ((..),(..)).
    Pairs where either side is None (infinity) are skipped (contribute 1).
    """
    pairs = [(p, q) for p, q in pairs if p is not None and q is not None]
    if not pairs:
        return ff.FP12_ONE
    f = ff.FP12_ONE
    ts = [q for _, q in pairs]
    bits = bin(BLS_X_ABS)[3:]  # skip leading 1
    for bit in bits:
        f = ff.fp12_sqr(f)
        for i, (p, q) in enumerate(pairs):
            ts[i], line = _dbl_step(ts[i], p)
            f = ff.fp12_mul(f, line)
        if bit == "1":
            for i, (p, q) in enumerate(pairs):
                ts[i], line = _add_step(ts[i], q, p)
                f = ff.fp12_mul(f, line)
    if BLS_X < 0:
        f = ff.fp12_conj(f)
    return f


def _pow_x(f):
    """f^|x| over the fixed 64-bit parameter."""
    return ff.fp12_pow(f, BLS_X_ABS)


def _pow_neg_x(f):
    """f^x for the (negative) BLS parameter x."""
    return ff.fp12_conj(_pow_x(f))


def final_exponentiation(f):
    """f^((p^12-1)/r) — actually f^(3*(p^12-1)/r), equivalent for ==1 tests.

    Easy part: f^((p^6-1)(p^2+1)). Hard part via the decomposition
    3*(p^4-p^2+1)/r = (x-1)^2 * (x+p) * (x^2+p^2-1) + 3, verified
    programmatically in tests against the integer exponent.
    """
    # easy part
    f = ff.fp12_mul(ff.fp12_conj(f), ff.fp12_inv(f))  # f^(p^6 - 1)
    f = ff.fp12_mul(ff.fp12_frobenius(ff.fp12_frobenius(f)), f)  # ^(p^2 + 1)
    # hard part (3x multiple)
    t0 = ff.fp12_mul(_pow_neg_x(f), ff.fp12_conj(f))  # f^(x-1)
    t1 = ff.fp12_mul(_pow_neg_x(t0), ff.fp12_conj(t0))  # f^((x-1)^2)
    t2 = ff.fp12_mul(_pow_neg_x(t1), ff.fp12_frobenius(t1))  # ^(x+p)
    t3 = ff.fp12_mul(
        _pow_neg_x(_pow_neg_x(t2)),
        ff.fp12_mul(
            ff.fp12_frobenius(ff.fp12_frobenius(t2)), ff.fp12_conj(t2)
        ),
    )  # ^(x^2 + p^2 - 1)
    f3 = ff.fp12_mul(ff.fp12_mul(f, f), f)
    return ff.fp12_mul(t3, f3)


def pairing(p_g1, q_g2):
    """Full pairing e(P, Q) for affine P in G1, affine twist Q in G2."""
    return final_exponentiation(miller_loop([(p_g1, q_g2)]))


def multi_pairing_is_one(pairs):
    """Check prod e(P_i, Q_i) == 1 with a single shared final
    exponentiation. Staged under the tracer so every host-side pairing
    check attributes its Miller-loop vs final-exp wall time."""
    from lighthouse_tpu_torch.common.tracing import span

    with span("verify/miller_loop", n_pairs=len(pairs)):
        f = miller_loop(pairs)
    with span("verify/final_exp"):
        return final_exponentiation(f) == ff.FP12_ONE


def pairing_check_points(g1_jacobian_pts, g2_jacobian_pts):
    """Pairing product check over Jacobian inputs."""
    pairs = [
        (G1_GROUP.to_affine(p), G2_GROUP.to_affine(q))
        for p, q in zip(g1_jacobian_pts, g2_jacobian_pts, strict=True)
    ]
    return multi_pairing_is_one(pairs)
