"""Plain product fold and final exponentiation on batch-last bundles.

The port of `lighthouse_tpu/ops/tfexp.py` (with the tower constants of
`ops/tower.py`): `fold_lanes` multiplies the per-pair Miller outputs down to
one Fp12 value along the lane-halving tree, and `final_exponentiation_t`
raises it to 3 (p^12 - 1) / r by the JAX package's addition chain (the same
exponent as `crypto/ref_pairing.final_exponentiation`, so values agree
exactly with both).
"""

import numpy as np
import torch

from lighthouse_tpu_torch.crypto.constants import BLS_X_ABS, FROB_GAMMA, P
from lighthouse_tpu_torch.ops import field as fd
from lighthouse_tpu_torch.ops import tpairing as tp
from lighthouse_tpu_torch.ops.programs import FP2_MUL, FP6_MUL

NB = fd.NB

_XI = np.array([[1, -1], [1, 1]], dtype=np.int32)
_FP2_CONJ = np.array([[1, 0], [0, -1]], dtype=np.int32)
_I2 = np.eye(2, dtype=np.int32)
_Z2 = np.zeros((2, 2), dtype=np.int32)
# (a0, a1, a2) * v = (xi a2, a0, a1)
_MUL_BY_V6 = np.block([[_Z2, _Z2, _XI], [_I2, _Z2, _Z2], [_Z2, _I2, _Z2]]).astype(np.int32)
_CONJ12 = np.diag([1] * 6 + [-1] * 6).astype(np.int32)
_CONJ_EACH = np.kron(np.eye(6, dtype=np.int32), _FP2_CONJ).astype(np.int32)

# Frobenius gammas and p^2 norms in slot order [g0, g2, g4, g1, g3, g5]
_ORDER = [0, 2, 4, 1, 3, 5]


def _mont_limbs(v: int) -> list:
    return fd._limbs((v % P << 384) % P, NB)


GAMMAS = np.array(
    [[_mont_limbs(FROB_GAMMA[i][0]), _mont_limbs(FROB_GAMMA[i][1])] for i in _ORDER],
    dtype=np.int32,
)  # (6, 2, NB)
NORMS = np.array(
    [
        _mont_limbs(FROB_GAMMA[i][0] ** 2 + FROB_GAMMA[i][1] ** 2)
        for i in _ORDER
        for _ in range(2)
    ],
    dtype=np.int32,
)  # (12, NB): each Fp2 coefficient scales by the norm of its gamma


def _const(arr, device):
    return fd.matrix(arr, device)[..., None]  # (..., NB, 1)


def fp12_conj(f):
    return fd.apply_combo(f, _CONJ12)


def fp12_frobenius(f):
    """f^p: conjugate each Fp2 coefficient and scale it by its gamma."""
    pairs = fd.apply_combo(f, _CONJ_EACH).reshape((6, 2) + f.shape[-2:])
    g = torch.broadcast_to(_const(GAMMAS, f.device), pairs.shape)
    return fd.bilinear(pairs, g, FP2_MUL).reshape(f.shape)


def fp12_frobenius2(f):
    """f^(p^2) for any Fp12 value: slot-wise scale by the Fp norms."""
    return fd.mul_lazy(f, torch.broadcast_to(_const(NORMS, f.device), f.shape))


def fp2_inv(a):
    """1/(c0 + c1 u) = conj(a) / (c0^2 + c1^2) on (..., 2, NB, B)."""
    sq = fd.sqr_lazy(a)
    ninv = fd.inv(fd.add(sq[..., 0:1, :, :], sq[..., 1:2, :, :]))
    conj = fd.apply_combo(a, _FP2_CONJ)
    return fd.mul_lazy(conj, torch.broadcast_to(ninv, conj.shape))


def _fp2_mul(a, b):
    return fd.bilinear(a, b, FP2_MUL)


def fp6_inv(a):
    """Tower inversion on (6, NB, B) (tower.fp6_inv)."""
    a0, a1, a2 = a.reshape((3, 2) + a.shape[-2:]).unbind(0)
    prods = _fp2_mul(torch.stack([a0, a1, a2, a0, a1, a0]), torch.stack([a0, a1, a2, a1, a2, a2]))
    sq0, sq1, sq2, p01, p12, p02 = prods.unbind(0)
    c0 = fd.sub(sq0, fd.apply_combo(p12, _XI))
    c1 = fd.sub(fd.apply_combo(sq2, _XI), p01)
    c2 = fd.sub(sq1, p02)
    pr = _fp2_mul(torch.stack([a0, a2, a1]), torch.stack([c0, c1, c2]))
    norm = fd.add(pr[0], fd.apply_combo(fd.add(pr[1], pr[2]), _XI))
    ninv = fp2_inv(norm)
    cs = torch.stack([c0, c1, c2])
    return _fp2_mul(cs, torch.broadcast_to(ninv, cs.shape)).reshape(a.shape)


def fp12_inv(a):
    """1/(b0 + b1 w) = (b0 - b1 w) / (b0^2 - v b1^2) on (12, NB, B)."""
    b = a.reshape((2, 6) + a.shape[-2:])
    sq = fd.bilinear(b, b, FP6_MUL)
    norm = fd.sub(sq[0], fd.apply_combo(sq[1], _MUL_BY_V6))
    ninv = fp6_inv(norm)
    scaled = fd.bilinear(b, torch.broadcast_to(ninv, b.shape), FP6_MUL)
    return torch.cat([scaled[0], fd.apply_combo(scaled[1], -np.eye(6, dtype=np.int32))])


def pow_x_abs(f):
    one = fd.one_slot0(12, f.shape[-1], f.device)
    return fd.pow_bits(tp.fp12_mul, tp.fp12_sqr, one, f, BLS_X_ABS)


def final_exponentiation_t(f):
    """f^(3 (p^12 - 1) / r) on (12, NB, B) (tfexp.final_exponentiation_t)."""

    def pow_neg_x(g):
        return fp12_conj(pow_x_abs(g))

    mul = tp.fp12_mul
    f = mul(fp12_conj(f), fp12_inv(f))
    f = mul(fp12_frobenius2(f), f)
    t0 = mul(pow_neg_x(f), fp12_conj(f))
    t1 = mul(pow_neg_x(t0), fp12_conj(t0))
    t2 = mul(pow_neg_x(t1), fp12_frobenius(t1))
    t3 = mul(pow_neg_x(pow_neg_x(t2)), mul(fp12_frobenius2(t2), fp12_conj(t2)))
    return mul(t3, mul(mul(f, f), f))


def fold_lanes(f):
    """Lane-halving tree product (12, NB, B) -> (12, NB, 1); an odd count
    carries its last lane (tfexp.fold_lanes)."""
    B = f.shape[-1]
    while B > 1:
        half = B // 2
        prod = tp.fp12_mul(f[..., :half], f[..., half : 2 * half])
        if B % 2:
            prod = torch.cat([prod, f[..., B - 1 :]], dim=-1)
        f = prod
        B = half + B % 2
    return f
