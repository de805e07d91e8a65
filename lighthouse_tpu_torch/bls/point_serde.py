"""BLS12-381 point compression/decompression (ZCash serialization format).

The wire format of every pubkey (48 B) and signature (96 B) in the protocol
— the reference gets this from blst's serialize/deserialize behind
`GenericPublicKey::from_bytes` / `GenericSignature::serialize`
(crypto/bls/src/generic_public_key.rs, generic_signature.rs).

Flag bits in the top byte of the (first) x coordinate:
  0x80 compression flag (always set here)
  0x40 infinity flag
  0x20 sort flag: y is the lexicographically larger root
"""

from lighthouse_tpu_torch.crypto import ref_fields as ff
from lighthouse_tpu_torch.crypto.constants import B_G1, B_G2, P
from lighthouse_tpu_torch.crypto.ref_curve import G1 as G1_GROUP
from lighthouse_tpu_torch.crypto.ref_curve import G2 as G2_GROUP

COMPRESSION_FLAG = 0x80
INFINITY_FLAG = 0x40
SORT_FLAG = 0x20


class DecodeError(ValueError):
    pass


def _y_is_lexicographically_largest_fp(y: int) -> bool:
    return y > (P - 1) // 2


def _y_is_lexicographically_largest_fp2(y) -> bool:
    if y[1] != 0:
        return y[1] > (P - 1) // 2
    return y[0] > (P - 1) // 2


# ---------------------------------------------------------------------- G1


def g1_compress(pt_jacobian) -> bytes:
    aff = G1_GROUP.to_affine(pt_jacobian)
    if aff is None:
        return bytes([COMPRESSION_FLAG | INFINITY_FLAG]) + b"\x00" * 47
    x, y = aff
    flags = COMPRESSION_FLAG
    if _y_is_lexicographically_largest_fp(y):
        flags |= SORT_FLAG
    data = bytearray(x.to_bytes(48, "big"))
    data[0] |= flags
    return bytes(data)


def g1_decompress(data: bytes):
    """48 bytes -> Jacobian point (on-curve checked; NOT subgroup checked —
    callers apply subgroup policy, mirroring the reference's split between
    deserialization and `key_validate`)."""
    if len(data) != 48:
        raise DecodeError("G1: expected 48 bytes")
    flags = data[0]
    if not flags & COMPRESSION_FLAG:
        raise DecodeError("G1: uncompressed flag on compressed input")
    if flags & INFINITY_FLAG:
        if flags & SORT_FLAG or any(data[1:]) or (data[0] & 0x3F):
            raise DecodeError("G1: malformed infinity encoding")
        return G1_GROUP.infinity
    x = int.from_bytes(
        bytes([data[0] & 0x1F]) + data[1:], "big"
    )
    if x >= P:
        raise DecodeError("G1: x not canonical")
    y = _g1_solve_y(x)
    if y is None:
        raise DecodeError("G1: x not on curve")
    if bool(flags & SORT_FLAG) != _y_is_lexicographically_largest_fp(y):
        y = P - y
    return (x, y, 1)


def _sqrt_fp(a: int):
    root = pow(a, (P + 1) // 4, P)
    return root if root * root % P == a % P else None


def _g1_solve_y(x: int):
    """y with y^2 = x^3 + 4, preferring the native C path
    (native/g2decomp.c — ~13x the pure-Python exponentiation)."""
    from lighthouse_tpu_torch.native import g2decomp

    y = g2decomp.g1_sqrt_rhs(x)
    if y is None:  # no native library: Python fallback
        return _sqrt_fp((x * x % P * x + B_G1) % P)
    return None if y is False else y


def _g2_solve_y(x):
    """y with y^2 = x^3 + 4(1+u) over Fp2, native-first."""
    from lighthouse_tpu_torch.native import g2decomp

    y = g2decomp.g2_sqrt_rhs(x[0], x[1])
    if y is None:
        rhs = ff.fp2_add(ff.fp2_mul(ff.fp2_sqr(x), x), B_G2)
        return ff.fp2_sqrt(rhs)
    return None if y is False else y


# ---------------------------------------------------------------------- G2


def g2_compress(pt_jacobian) -> bytes:
    aff = G2_GROUP.to_affine(pt_jacobian)
    if aff is None:
        return bytes([COMPRESSION_FLAG | INFINITY_FLAG]) + b"\x00" * 95
    (x0, x1), y = aff
    flags = COMPRESSION_FLAG
    if _y_is_lexicographically_largest_fp2(y):
        flags |= SORT_FLAG
    data = bytearray(x1.to_bytes(48, "big") + x0.to_bytes(48, "big"))
    data[0] |= flags
    return bytes(data)


def g2_decompress(data: bytes):
    if len(data) != 96:
        raise DecodeError("G2: expected 96 bytes")
    flags = data[0]
    if not flags & COMPRESSION_FLAG:
        raise DecodeError("G2: uncompressed flag on compressed input")
    if flags & INFINITY_FLAG:
        if flags & SORT_FLAG or any(data[1:]) or (data[0] & 0x3F):
            raise DecodeError("G2: malformed infinity encoding")
        return G2_GROUP.infinity
    x1 = int.from_bytes(bytes([data[0] & 0x1F]) + data[1:48], "big")
    x0 = int.from_bytes(data[48:], "big")
    if x0 >= P or x1 >= P:
        raise DecodeError("G2: x not canonical")
    x = (x0, x1)
    y = _g2_solve_y(x)
    if y is None:
        raise DecodeError("G2: x not on curve")
    if bool(flags & SORT_FLAG) != _y_is_lexicographically_largest_fp2(y):
        y = ff.fp2_neg(y)
    return (x, y, ff.FP2_ONE)
