"""Signed-digit window ladder: scalar recoding and the plain ladder.

The port of `lighthouse_tpu/ops/window_ladder.py`'s transposed plane: a
scalar < 2^nbits becomes W signed base-2^c digits d_w in
[-(2^(c-1) - 1), 2^(c-1)] (window-major magnitudes and sign flags), and the
ladder runs, MSB first, c doublings and one complete addition of
sign * table[|d|] per window. c = 4 throughout the verify path: a 64-bit
RLC scalar has W = 17 windows.
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


def signed_digit_arrays(scalars, c: int = WINDOW_BITS, nbits: int = 64):
    """Host: scalars -> ((W, N) int32 magnitudes, (W, N) bool signs)."""
    d = np.array([signed_digits(int(s), c, nbits) for s in scalars], np.int32).T
    return np.abs(d), d < 0


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
