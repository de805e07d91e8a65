"""Scalar ladders: digit recoding and the plain ladders of K1's three forms.

The port of `lighthouse_tpu/ops/window_ladder.py`'s transposed plane: a
scalar < 2^nbits becomes W signed base-2^c digits d_w in
[-(2^(c-1) - 1), 2^(c-1)] (window-major magnitudes and sign flags), and the
ladder runs, MSB first, c doublings and one complete addition of
sign * table[|d|] per window. c = 4 throughout: a 64-bit RLC scalar has
W = 17 windows, a 255-bit KZG scalar (< r) W = 64. The per-bit chain
(`tcurve.mul_scalar_bits`) and the 2-bit unsigned window
(`tcurve.mul_scalar_bits_w2`) are K1's other two forms.
"""

import numpy as np
import torch
import torch.nn.functional as F

WINDOW_BITS = 4


def num_windows(nbits: int, c: int = WINDOW_BITS) -> int:
    """Windows for signed base-2^c digits of scalars < 2^nbits: one extra
    when the top window's digit plus its carry can exceed 2^(c-1)."""
    w0 = -(-nbits // c)
    top_bits = nbits - c * (w0 - 1)
    if (1 << top_bits) > (1 << (c - 1)):
        return w0 + 1
    return w0


def signed_digits(s: int, c: int = WINDOW_BITS, nbits: int | None = None) -> list:
    """One scalar in [0, 2^nbits) -> W signed digits, LSB first, with
    sum_w d_w 2^(c w) == s."""
    if nbits is None:
        nbits = max(1, s.bit_length())
    assert 0 <= s < (1 << nbits), (s, nbits)
    half, full = 1 << (c - 1), 1 << c
    out, carry = [], 0
    for _ in range(num_windows(nbits, c)):
        t = (s & (full - 1)) + carry
        s >>= c
        if t > half:
            out.append(t - full)
            carry = 1
        else:
            out.append(t)
            carry = 0
    assert carry == 0 and s == 0
    return out


def signed_digit_arrays(scalars, nbits: int = 64):
    """Host: scalars in [0, 2^nbits) -> ((W, N) int32 magnitudes, (W, N)
    bool signs), window-major: `signed_digits` of every scalar at c = 4, as
    one carry pass over the windows in numpy on the scalars' little-endian
    bytes, two windows a byte (a KZG MSM recodes 4,096 scalars of 255
    bits)."""
    c = WINDOW_BITS
    ints = [int(s) for s in scalars]
    if any(s < 0 or s >> nbits for s in ints):
        raise ValueError(f"signed_digit_arrays: a scalar outside [0, 2^{nbits})")
    W = num_windows(nbits, c)
    nbytes = -(-W // 2)
    raw = np.frombuffer(b"".join(s.to_bytes(nbytes, "little") for s in ints), np.uint8)
    raw = raw.reshape(-1, nbytes)
    u = np.empty((2 * nbytes, raw.shape[0]), np.int8)
    u[0::2] = (raw & 15).T
    u[1::2] = (raw >> 4).T
    half, full = 1 << (c - 1), 1 << c
    mags = np.empty((W, raw.shape[0]), np.int32)
    negs = np.empty((W, raw.shape[0]), bool)
    carry = np.zeros(raw.shape[0], np.int8)
    for w in range(W):
        t = u[w] + carry
        over = t > half
        mags[w] = np.where(over, full - t, t)
        negs[w] = over & (mags[w] > 0)  # a borrowed-to-zero digit is sign-free
        carry = over.view(np.int8)
    return mags, negs


def scalars_to_bits(scalars, nbits: int) -> np.ndarray:
    """Host: scalars -> (N, nbits) int32 LSB-first bits."""
    return np.array(
        [[(int(s) >> i) & 1 for i in range(nbits)] for s in scalars], dtype=np.int32
    ).reshape(-1, nbits)


def recode_bits(bits, c: int = WINDOW_BITS):
    """(..., nbits) 0/1 LSB-first bits -> window-major signed digits:
    ((W, ...) int32 magnitudes, (W, ...) bool signs), the `signed_digits`
    rule as one carry pass over the windows."""
    nbits = bits.shape[-1]
    W = num_windows(nbits, c)
    bits = F.pad(bits.to(torch.int32), (0, W * c - nbits))
    weights = 1 << torch.arange(c, dtype=torch.int32, device=bits.device)
    u = (bits.reshape(*bits.shape[:-1], W, c) * weights).sum(-1, dtype=torch.int32)
    u = u.movedim(-1, 0)
    half, full = 1 << (c - 1), 1 << c
    carry = torch.zeros_like(u[0])
    mags, negs = [], []
    for uw in u:
        t = uw + carry
        over = t > half
        mag = torch.where(over, full - t, t)
        # a borrowed-to-zero digit (t == 2^c) is sign-free, as on the host
        negs.append(over & (mag > 0))
        mags.append(mag)
        carry = over.to(torch.int32)
    return torch.stack(mags), torch.stack(negs)


def mul_digits_windowed_t(group, pt, mags, negs, c: int = WINDOW_BITS):
    """The plain window ladder on bundles: pt = (X, Y, Z) (w, NB, B),
    mags/negs (W, B) window-major digits, MSB first."""
    table = group.window_table(pt, c)
    acc = group.identity(pt[0].shape[-1], pt[0].device)
    for wi in range(mags.shape[0] - 1, -1, -1):
        acc = group.window_step(acc, table, mags[wi], negs[wi], c)
    return acc


def mul_scalar_bits_windowed_t(group, pt, bits, c: int = WINDOW_BITS):
    """The plain ladder from (nbits, B) LSB-first bits
    (window_ladder.mul_scalar_bits_windowed_t)."""
    mags, negs = recode_bits(bits.movedim(0, -1), c)
    return mul_digits_windowed_t(group, pt, mags, negs, c)


def digits_w2(bits):
    """(n_bits, B) 0/1 LSB-first bits -> (ceil(n_bits / 2), B) int32 2-bit
    digits, MSB first; an odd count gains a zero top bit
    (tcurve.mul_scalar_bits_w2)."""
    bits = bits.to(torch.int32)
    if bits.shape[0] % 2:
        bits = F.pad(bits, (0, 0, 0, 1))
    return (bits[0::2] + 2 * bits[1::2]).flip(0).contiguous()


def mul_scalar_bits_chain_t(group, pt, bits):
    """The plain double-add chain from (nbits, B) LSB-first bits
    (tcurve.mul_scalar_bits)."""
    acc = group.identity(pt[0].shape[-1], pt[0].device)
    addend = pt
    for bit in bits:
        acc, addend = group.ladder_step(acc, addend, bit)
    return acc


def mul_scalar_bits_w2_t(group, pt, bits):
    """The plain 2-bit window ladder from (nbits, B) LSB-first bits
    (tcurve.mul_scalar_bits_w2)."""
    table = group.window2_table(pt)
    acc = group.identity(pt[0].shape[-1], pt[0].device)
    for digit in digits_w2(bits):
        acc = group.window2_step(acc, table, digit)
    return acc
