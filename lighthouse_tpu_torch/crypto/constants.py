"""BLS12-381 curve constants.

This module is the single source of truth for curve parameters used by both
the pure-Python reference implementation (`ref_fields`, `ref_curve`,
`ref_pairing`) and the JAX/TPU device kernels (`lighthouse_tpu_torch.ops`).

Parity note (vs reference implementation being replaced): the reference
client routes all BLS12-381 operations through the `blst` C library behind
`crypto/bls/src/impls/blst.rs`; the constants here correspond to the same
curve (draft-irtf-cfrg-pairing-friendly-curves BLS12-381) with the Ethereum
ciphersuite DST.

All derived constants (Frobenius coefficients, Montgomery parameters) are
computed at import time from first principles rather than embedded as magic
numbers, so they are self-auditing.
"""

# --- Base field / scalar field -------------------------------------------------

# Field modulus p (381 bits)
P = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB

# Subgroup order r (255 bits) — order of G1, G2, and GT
R = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001

# BLS curve parameter x (negative). p = (x-1)^2/3 * r + x, r = x^4 - x^2 + 1.
BLS_X = -0xD201000000010000
BLS_X_ABS = 0xD201000000010000

# Curve equations: E/Fp: y^2 = x^3 + 4;  E'/Fp2: y^2 = x^3 + 4(1+u)
B_G1 = 4
B_G2 = (4, 4)  # 4 + 4u in Fp2, represented as (c0, c1)

# Quadratic non-residue used to build Fp2 = Fp[u]/(u^2 + 1): -1.
# Sextic twist / tower constant: xi = 1 + u (Fp6 = Fp2[v]/(v^3 - xi)).
XI = (1, 1)

# --- Generators -----------------------------------------------------------------

G1_X = 0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB
G1_Y = 0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1

G2_X = (
    0x024AA2B2F08F0A91260805272DC51051C6E47AD4FA403B02B4510B647AE3D1770BAC0326A805BBEFD48056C8C121BDB8,
    0x13E02B6052719F607DACD3A088274F65596BD0D09920B61AB5DA61BBDC7F5049334CF11213945D57E5AC7D055D042B7E,
)
G2_Y = (
    0x0CE5D527727D6E118CC9CDC6DA2E351AADFD9BAA8CBDD3A76D429A695160D12C923AC9CC3BACA289E193548608B82801,
    0x0606C4A02EA734CC32ACD2B02BC28B99CB3E287E85A763AF267492AB572E99AB3F370D275CEC1DA1AAA9075FF05F79BE,
)

# --- Cofactors ------------------------------------------------------------------

# G1 cofactor h1 = (x-1)^2 / 3
H1 = (BLS_X - 1) ** 2 // 3
assert (P + 1 - (BLS_X + 1)) == H1 * R, "G1 order sanity: #E(Fp) = h1 * r"

# G2 cofactor (standard constant; sanity-checked in tests by [r]([h2]Q) = inf)
H2 = 0x5D543A95414E7F1091D50792876A202CD91DE4547085ABAA68A205B2E5A7DDFA628F1CB4D9E82EF21537E293A6691AE1616EC6E786F0C70CF1C38E31C7238E5

# Effective cofactor for G2 cofactor clearing via simple scalar multiplication.
# (RFC 9380 h_eff for BLS12-381 G2 uses the Budroni-Pintore method; plain
# multiplication by h2 also lands in the subgroup and is what we use for the
# reference path.)

# --- Ethereum BLS signature ciphersuite ----------------------------------------

# Domain separation tag used by Ethereum consensus (hash-to-G2, SSWU, XMD:SHA-256)
# Matches the DST in the reference client's blst backend.
DST_G2 = b"BLS_SIG_BLS12381G2_XMD:SHA-256_SSWU_RO_POP_"

# --- Derived: Frobenius coefficients (computed, not embedded) -------------------


def _fp2_mul(a, b):
    a0, a1 = a
    b0, b1 = b
    return ((a0 * b0 - a1 * b1) % P, (a0 * b1 + a1 * b0) % P)


def _fp2_pow(a, e):
    result = (1, 0)
    base = a
    while e > 0:
        if e & 1:
            result = _fp2_mul(result, base)
        base = _fp2_mul(base, base)
        e >>= 1
    return result


# xi^((p-1)/6) and its powers: used for Fp12 Frobenius and Fp6 Frobenius.
# gamma[i] = xi^(i*(p-1)/6) for i in 0..5
FROB_GAMMA = [_fp2_pow(XI, i * (P - 1) // 6) for i in range(6)]

# Fp6 Frobenius: v^p = gamma2 * v  (gamma2 = xi^((p-1)/3)),
#                v^2p = gamma4 * v^2 (gamma4 = xi^(2(p-1)/3))
FROB6_C1 = FROB_GAMMA[2]
FROB6_C2 = FROB_GAMMA[4]

# --- Montgomery parameters for the device limb representation -------------------

# Device representation: NLIMBS limbs of LIMB_BITS bits each, little-endian,
# held in int32 lanes. 32 limbs x 12 bits = 384 bits >= 381.
LIMB_BITS = 12
NLIMBS = 32
LIMB_MASK = (1 << LIMB_BITS) - 1
MONT_R = 1 << (LIMB_BITS * NLIMBS)  # 2^384
MONT_R_MOD_P = MONT_R % P
MONT_R2_MOD_P = (MONT_R * MONT_R) % P
# -p^-1 mod 2^LIMB_BITS (per-limb Montgomery factor)
MONT_N0_INV = (-pow(P, -1, 1 << LIMB_BITS)) % (1 << LIMB_BITS)

assert (P * pow(P, -1, MONT_R)) % MONT_R == 1
