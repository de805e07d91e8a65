"""RFC 9380 hash-to-curve for BLS12-381 G2 (BLS12381G2_XMD:SHA-256_SSWU_RO_).

This is the message side of the signature plane — the reference client gets
it from blst's `hash_to_g2` inside signature verification
(crypto/bls/src/impls/blst.rs:69 Aggregate::hash_to_g2 path). Pipeline:

    expand_message_xmd(SHA-256) -> hash_to_field (2 Fp2 elements)
    -> simplified SWU on the 3-isogenous curve E'
    -> 3-isogeny to E -> point add -> clear cofactor (psi endomorphism)

Every non-trivially-derivable constant here is validated mathematically by
tests (tests/test_hash_to_curve.py): the SSWU output must satisfy E', the
isogeny must carry E' points onto E, psi must act as multiplication by the
curve parameter x on G2, and final outputs must be r-torsion. A wrong
constant cannot pass those identities.
"""

import hashlib

from lighthouse_tpu_torch.crypto import ref_fields as ff
from lighthouse_tpu_torch.crypto.constants import BLS_X, DST_G2, P, R
from lighthouse_tpu_torch.crypto.ref_curve import G2 as G2_GROUP

# ------------------------------------------------------ expand_message_xmd

B_IN_BYTES = 32  # SHA-256 output
R_IN_BYTES = 64  # SHA-256 block size
L = 64  # ceil((ceil(log2(p)) + k) / 8) = (381 + 128)/8 rounded up


def expand_message_xmd(msg: bytes, dst: bytes, len_in_bytes: int) -> bytes:
    if len(dst) > 255:
        dst = hashlib.sha256(b"H2C-OVERSIZE-DST-" + dst).digest()
    ell = (len_in_bytes + B_IN_BYTES - 1) // B_IN_BYTES
    if ell > 255:
        raise ValueError("expand_message_xmd: output too long")
    dst_prime = dst + bytes([len(dst)])
    z_pad = b"\x00" * R_IN_BYTES
    l_i_b_str = len_in_bytes.to_bytes(2, "big")
    b0 = hashlib.sha256(
        z_pad + msg + l_i_b_str + b"\x00" + dst_prime
    ).digest()
    b1 = hashlib.sha256(b0 + b"\x01" + dst_prime).digest()
    bs = [b1]
    for i in range(2, ell + 1):
        prev = bs[-1]
        xored = bytes(a ^ b for a, b in zip(b0, prev))
        bs.append(hashlib.sha256(xored + bytes([i]) + dst_prime).digest())
    return b"".join(bs)[:len_in_bytes]


def hash_to_field_fp2(msg: bytes, count: int, dst: bytes = DST_G2):
    """count Fp2 field elements from msg."""
    m = 2
    uniform = expand_message_xmd(msg, dst, count * m * L)
    out = []
    for i in range(count):
        comps = []
        for j in range(m):
            off = L * (j + i * m)
            comps.append(int.from_bytes(uniform[off : off + L], "big") % P)
        out.append(tuple(comps))
    return out


# ----------------------------------------------------------- SSWU on E2'

# E2': y^2 = x^3 + A*x + B over Fp2, the curve 3-isogenous to E2.
SSWU_A = (0, 240)
SSWU_B = (1012, 1012)
SSWU_Z = ((-2) % P, (-1) % P)  # Z = -(2 + I)


def _g_prime(x):
    """g'(x) = x^3 + A x + B on E'."""
    return ff.fp2_add(
        ff.fp2_add(
            ff.fp2_mul(ff.fp2_sqr(x), x), ff.fp2_mul(SSWU_A, x)
        ),
        SSWU_B,
    )


def _sgn0(x) -> int:
    """RFC 9380 sgn0 for Fp2 (m=2)."""
    sign_0 = x[0] % 2
    zero_0 = x[0] == 0
    sign_1 = x[1] % 2
    return sign_0 or (zero_0 and sign_1)


def map_to_curve_sswu(u):
    """Simplified SWU: Fp2 element -> point on E' (never fails)."""
    u2 = ff.fp2_sqr(u)
    tv1 = ff.fp2_mul(SSWU_Z, u2)  # Z u^2
    tv2 = ff.fp2_add(ff.fp2_sqr(tv1), tv1)  # Z^2 u^4 + Z u^2
    neg_b_over_a = ff.fp2_mul(
        ff.fp2_neg(SSWU_B), ff.fp2_inv(SSWU_A)
    )
    if tv2 == ff.FP2_ZERO:
        # exceptional case: x1 = B / (Z A)
        x1 = ff.fp2_mul(SSWU_B, ff.fp2_inv(ff.fp2_mul(SSWU_Z, SSWU_A)))
    else:
        x1 = ff.fp2_mul(
            neg_b_over_a, ff.fp2_add(ff.FP2_ONE, ff.fp2_inv(tv2))
        )
    gx1 = _g_prime(x1)
    y1 = ff.fp2_sqrt(gx1)
    if y1 is not None:
        x, y = x1, y1
    else:
        x2 = ff.fp2_mul(tv1, x1)  # Z u^2 x1
        gx2 = _g_prime(x2)
        y2 = ff.fp2_sqrt(gx2)
        assert y2 is not None, "SSWU: neither gx1 nor gx2 square"
        x, y = x2, y2
    if _sgn0(u) != _sgn0(y):
        y = ff.fp2_neg(y)
    return (x, y)


# ------------------------------------------------------------- 3-isogeny

# Coefficients of the 3-isogeny E' -> E (RFC 9380 appendix E.3). Validated
# in tests by mapping points of E' and checking the E equation.


def _fp2(c0, c1):
    return (c0 % P, c1 % P)


_ISO_XNUM = [
    _fp2(
        0x5C759507E8E333EBB5B7A9A47D7ED8532C52D39FD3A042A88B58423C50AE15D5C2638E343D9C71C6238AAAAAAAA97D6,
        0x5C759507E8E333EBB5B7A9A47D7ED8532C52D39FD3A042A88B58423C50AE15D5C2638E343D9C71C6238AAAAAAAA97D6,
    ),
    _fp2(
        0,
        0x11560BF17BAA99BC32126FCED787C88F984F87ADF7AE0C7F9A208C6B4F20A4181472AAA9CB8D555526A9FFFFFFFFC71A,
    ),
    _fp2(
        0x11560BF17BAA99BC32126FCED787C88F984F87ADF7AE0C7F9A208C6B4F20A4181472AAA9CB8D555526A9FFFFFFFFC71E,
        0x8AB05F8BDD54CDE190937E76BC3E447CC27C3D6FBD7063FCD104635A790520C0A395554E5C6AAAA9354FFFFFFFFE38D,
    ),
    _fp2(
        0x171D6541FA38CCFAED6DEA691F5FB614CB14B4E7F4E810AA22D6108F142B85757098E38D0F671C7188E2AAAAAAAA5ED1,
        0,
    ),
]

_ISO_XDEN = [
    _fp2(
        0,
        0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAA63,
    ),
    _fp2(
        0xC,
        0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAA9F,
    ),
    ff.FP2_ONE,  # monic x^2 term
]

_ISO_YNUM = [
    _fp2(
        0x1530477C7AB4113B59A4C18B076D11930F7DA5D4A07F649BF54439D87D27E500FC8C25EBF8C92F6812CFC71C71C6D706,
        0x1530477C7AB4113B59A4C18B076D11930F7DA5D4A07F649BF54439D87D27E500FC8C25EBF8C92F6812CFC71C71C6D706,
    ),
    _fp2(
        0,
        0x5C759507E8E333EBB5B7A9A47D7ED8532C52D39FD3A042A88B58423C50AE15D5C2638E343D9C71C6238AAAAAAAA97BE,
    ),
    _fp2(
        0x11560BF17BAA99BC32126FCED787C88F984F87ADF7AE0C7F9A208C6B4F20A4181472AAA9CB8D555526A9FFFFFFFFC71C,
        0x8AB05F8BDD54CDE190937E76BC3E447CC27C3D6FBD7063FCD104635A790520C0A395554E5C6AAAA9354FFFFFFFFE38F,
    ),
    _fp2(
        0x124C9AD43B6CF79BFBF7043DE3811AD0761B0F37A1E26286B0E977C69AA274524E79097A56DC4BD9E1B371C71C718B10,
        0,
    ),
]

_ISO_YDEN = [
    _fp2(
        0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFA8FB,
        0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFA8FB,
    ),
    _fp2(
        0,
        0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFA9D3,
    ),
    _fp2(
        0x12,
        0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAA99,
    ),
    ff.FP2_ONE,  # monic x^3 term
]


def _horner(coeffs, x):
    acc = coeffs[-1]
    for c in reversed(coeffs[:-1]):
        acc = ff.fp2_add(ff.fp2_mul(acc, x), c)
    return acc


def iso_map(pt):
    """3-isogeny E'(Fp2) -> E(Fp2), affine in/out."""
    x, y = pt
    x_num = _horner(_ISO_XNUM, x)
    x_den = _horner(_ISO_XDEN, x)
    y_num = _horner(_ISO_YNUM, x)
    y_den = _horner(_ISO_YDEN, x)
    out_x = ff.fp2_mul(x_num, ff.fp2_inv(x_den))
    out_y = ff.fp2_mul(y, ff.fp2_mul(y_num, ff.fp2_inv(y_den)))
    return (out_x, out_y)


# -------------------------------------------------- psi & cofactor clearing

# psi = twist^-1 . Frobenius . twist on E'(Fp2). With the tower w^2 = v,
# v^3 = xi: x picks up xi^((p-1)/3), y picks up xi^((p-1)/2) factors (up to
# inversion convention). The exact constants are FIXED by the validated
# identity psi(P) == [x]P on G2 (p == x mod r for BLS curves); tests assert
# it, and _PSI_CX/_PSI_CY below are derived, not quoted.

# xi^((p-1)/3) and xi^((p-1)/2) — derive both and invert as needed.
_XI = (1, 1)


def _fp2_pow(a, e):
    return ff.fp2_pow(a, e)


_PSI_CX = ff.fp2_inv(_fp2_pow(_XI, (P - 1) // 3))  # applied to conj(x)
_PSI_CY = ff.fp2_inv(_fp2_pow(_XI, (P - 1) // 2))  # applied to conj(y)


def psi(pt):
    """Untwist-Frobenius-twist endomorphism on affine E'(Fp2) points."""
    x, y = pt
    return (
        ff.fp2_mul(ff.fp2_conj(x), _PSI_CX),
        ff.fp2_mul(ff.fp2_conj(y), _PSI_CY),
    )


# psi^2 constants: x factor = (cx * conj(cx)), y factor = (cy * conj(cy))
_PSI2_CX = ff.fp2_mul(_PSI_CX, ff.fp2_conj(_PSI_CX))
_PSI2_CY = ff.fp2_mul(_PSI_CY, ff.fp2_conj(_PSI_CY))


def psi2(pt):
    x, y = pt
    return (ff.fp2_mul(x, _PSI2_CX), ff.fp2_mul(y, _PSI2_CY))


def _jac(aff):
    return G2_GROUP.from_affine(aff)


def _mul_by_x_abs(pt_jac):
    """[|x|] P via double-and-add on the 64-bit parameter."""
    return G2_GROUP.mul_scalar(pt_jac, abs(BLS_X))


def clear_cofactor(pt_affine):
    """Budroni-Pintore cofactor clearing:
    h_eff * P = [x^2 - x - 1]P + [x - 1]psi(P) + psi^2([2]P)
    computed as psi2(2P) + [x](P + psi(P)) - [x... via x-multiplications
    ([x] = -[|x|] since the BLS parameter is negative).
    Returns a Jacobian point in G2.
    """
    G = G2_GROUP
    p_jac = _jac(pt_affine)
    psi_p = _jac(psi(pt_affine))
    t1 = G.neg(_mul_by_x_abs(p_jac))  # [x] P
    t2 = G.neg(_mul_by_x_abs(t1))  # [x^2] P
    t3 = G.neg(_mul_by_x_abs(psi_p))  # [x] psi(P)
    psi2_2p = _jac(psi2(G.to_affine(G.double(p_jac))))
    acc = G.add(t2, G.neg(t1))  # [x^2 - x] P
    acc = G.add(acc, G.neg(p_jac))  # [x^2 - x - 1] P
    acc = G.add(acc, t3)  # + [x] psi(P)
    acc = G.add(acc, G.neg(psi_p))  # - psi(P)
    return G.add(acc, psi2_2p)  # + psi^2([2] P)


# --------------------------------------------------------------- entry point


def hash_to_g2(msg: bytes, dst: bytes = DST_G2):
    """Full hash_to_curve: message -> Jacobian point in G2."""
    u0, u1 = hash_to_field_fp2(msg, 2, dst)
    q0 = iso_map(map_to_curve_sswu(u0))
    q1 = iso_map(map_to_curve_sswu(u1))
    r = G2_GROUP.add(G2_GROUP.from_affine(q0), G2_GROUP.from_affine(q1))
    return clear_cofactor(G2_GROUP.to_affine(r))
