"""Plain batched Miller loop on batch-last bundles.

The port of `lighthouse_tpu/ops/tpairing.py`: the inversion-free twist
Miller loop with fused double/line and add/line steps over the 63 bits of
|x| below its top bit, then a conjugate because x < 0. The step formulas
and the line layout are exactly the JAX package's, so f agrees bit for bit
before the final exponentiation. Stacked Fp2 values are (n, 2, NB, B).
"""

import numpy as np
import torch

from lighthouse_tpu_torch.crypto.constants import BLS_X, BLS_X_ABS
from lighthouse_tpu_torch.ops import field as fd
from lighthouse_tpu_torch.ops.programs import FP2_MUL, FP12_MUL, FP12_SQR, LINE_MUL

NB = fd.NB

X_BITS = [int(b) for b in bin(BLS_X_ABS)[3:]]  # MSB first, below the top bit


def fp12_sqr(f):
    return fd.bilinear(f, f, FP12_SQR)


def fp12_mul(a, b):
    return fd.bilinear(a, b, FP12_MUL)


def mul_by_line(f, line):
    """f (12, NB, B) times the sparse line (6, NB, B) = [l0, l2, l3]."""
    return fd.bilinear(f, line, LINE_MUL)


def _mul2(pairs):
    """One stacked Fp2 multiply over a list of ((2,NB,B), (2,NB,B))."""
    A = torch.stack([a for a, _ in pairs])
    B = torch.stack([b for _, b in pairs])
    return list(fd.bilinear(A, B, FP2_MUL).unbind(0))


def _combo2(vals, coeffs):
    """One combination over Fp2 values, `coeffs` (n_out, n_in) acting
    componentwise."""
    m = np.kron(np.asarray(coeffs, np.int64), np.eye(2, dtype=np.int64))
    y = fd.apply_combo(torch.cat(vals, dim=-3), m.astype(np.int32))
    return [y[..., 2 * i : 2 * i + 2, :, :] for i in range(len(coeffs))]


def _line_scale(ca, cb, px, py):
    """(ca * px, cb * py) as one 4-slot product (Fp acting on Fp2)."""
    lhs = torch.cat([ca, cb], dim=-3)
    rhs = torch.cat(
        [torch.broadcast_to(px, ca.shape), torch.broadcast_to(py, cb.shape)], dim=-3
    )
    out = fd.mul_lazy(lhs, rhs)
    return out[..., 0:2, :, :], out[..., 2:4, :, :]


def dbl_step(t, px, py):
    """Tangent line at T evaluated at P, and 2T (tpairing._dbl_step)."""
    X, Y, Z = t
    a, b, z2, yz = _mul2([(X, X), (Y, Y), (Z, Z), (Y, Z)])
    xb, e = _combo2([X, a, b], [[1, 0, 1], [0, 3, 0]])
    c, xb2, f, x3c, x2z2, yz3 = _mul2(
        [(b, b), (xb, xb), (e, e), (X, a), (a, z2), (yz, z2)]
    )
    x3, dmx, c0, m3xz, c3p, z3 = _combo2(
        [xb2, a, c, f, x3c, b, x2z2, yz3, yz],
        [
            [-4, 4, 4, 1, 0, 0, 0, 0, 0],
            [6, -6, -6, -1, 0, 0, 0, 0, 0],
            [0, 0, 0, 0, 3, -2, 0, 0, 0],
            [0, 0, 0, 0, 0, 0, -3, 0, 0],
            [0, 0, 0, 0, 0, 0, 0, 2, 0],
            [0, 0, 0, 0, 0, 0, 0, 0, 2],
        ],
    )
    (edmx,) = _mul2([(e, dmx)])
    c2, c3 = _line_scale(m3xz, c3p, px, py)
    (y3,) = _combo2([edmx, c], [[1, -8]])
    return (x3, y3, z3), torch.cat([c0, c2, c3], dim=-3)


def add_step(t, q_affine, px, py):
    """Chord line through T and Q evaluated at P, and T + Q
    (tpairing._add_step, mixed addition)."""
    X1, Y1, Z1 = t
    qx, qy = q_affine
    (z1s,) = _mul2([(Z1, Z1)])
    u2, z1c = _mul2([(qx, z1s), (z1s, Z1)])
    (gamma,) = _combo2([u2, X1], [[1, -1]])
    qyz, hh, z1gam = _mul2([(qy, z1c), (gamma, gamma), (Z1, gamma)])
    (theta,) = _combo2([qyz, Y1], [[1, -1]])
    tt, hhh, v, tqx, qyz3 = _mul2(
        [(theta, theta), (gamma, hh), (X1, hh), (theta, qx), (qy, z1gam)]
    )
    x3, vmx, c0, mtheta = _combo2(
        [tt, hhh, v, tqx, qyz3, theta],
        [
            [1, -1, -2, 0, 0, 0],
            [-1, 1, 3, 0, 0, 0],
            [0, 0, 0, 1, -1, 0],
            [0, 0, 0, 0, 0, -1],
        ],
    )
    tvmx, y1hhh = _mul2([(theta, vmx), (Y1, hhh)])
    c2, c3 = _line_scale(mtheta, z1gam, px, py)
    (y3,) = _combo2([tvmx, y1hhh], [[1, -1]])
    return (x3, y3, z1gam), torch.cat([c0, c2, c3], dim=-3)


def miller_loop_t(p_g1_affine, q_g2_affine, valid_mask=None):
    """p = (px, py) (1, NB, B), q = (qx, qy) (2, NB, B), Montgomery;
    masked pairs give f = 1. Returns f (12, NB, B)."""
    px, py = p_g1_affine
    qx, qy = q_g2_affine
    B, dev = qx.shape[-1], qx.device
    t = (qx, qy, fd.one_slot0(2, B, dev))
    f = fd.one_slot0(12, B, dev)
    for bit in X_BITS:
        f = fp12_sqr(f)
        t, line = dbl_step(t, px, py)
        f = mul_by_line(f, line)
        if bit:
            t, line = add_step(t, (qx, qy), px, py)
            f = mul_by_line(f, line)
    if BLS_X < 0:
        f = fd.apply_combo(f, np.diag([1] * 6 + [-1] * 6).astype(np.int32))
    if valid_mask is not None:
        f = fd.select(valid_mask, f, fd.one_slot0(12, B, dev))
    return f
