"""The scalar field Fr (mod r) of the data-availability plane: the kernel's
word layout, its plain PyTorch arithmetic, and a word model of the kernel's
product.

The counterpart of `lighthouse_tpu/ops/rfield.py`. Blob polynomials have Fr
coefficients and are evaluated over roots-of-unity domains in Fr, so the
Reed-Solomon extension (`ops/rs_extend.py`, kernel `csrc/rs_extend.cu`) is
Fr arithmetic from end to end.

Layout. A value is 8 little-endian 32-bit words (`NW`), canonical (< r),
in Montgomery form with R = 2^256: r < 2^255, so 2^256 is the word
boundary just above it, and any value below 2r fits in the 8 words. The
reference keeps 23 relaxed 12-bit limbs with R = 2^264 instead (a TPU
layout: 2^264 is no word boundary). So the two agree on plain values and
not on Montgomery words: compare canonical plain integers
(`words_from_mont` here, `rf.unpack_ints(rf.from_mont(x))` there).

The plain operations take int32 word tensors (..., 8) on any device and
return canonical words. Inside, a value is 16 digits of 16 bits in int64,
the word size halved so that a digit product (< 2^32) and a column of them
stay far inside int64, and a product is the schoolbook product of the
digits followed by a Montgomery reduction over the whole low half (m = -t
r^-1 mod 2^256, then (t + m r) / 2^256), each step a few tensor operations
over every lane, as `field.mul_lazy` does for Fp (see `_mont_digits` for
the bounds).

`FR_PRODUCTS` counts the Fr products the plain operations perform, over
all lanes (the operation count behind the kernel's bound), as
`field.FP_PRODUCTS` does for Fp.

The kernel's steps are modelled in Python integers with their bounds
asserted: `mul_words` is the CIOS product as `csrc/rs_extend.cu` runs it,
four PTX carry chains a row with every carry flag;
`horner_step_words` is the kernel's step, `eval_words` an unsplit chain
and `split_eval_words` the kernel's split chain: S segment Horners,
y = x^L by squarings, the combine.
"""

from itertools import repeat

import numpy as np
import torch

from lighthouse_tpu_torch.crypto.constants import R

NW = 8  # 32-bit words per Fr element
MONT_R = 1 << 256
R_INV = pow(MONT_R, -1, R)
MONT_R2 = MONT_R * MONT_R % R
M32 = (1 << 32) - 1
N0 = -pow(R, -1, 1 << 32) % (1 << 32)  # -r^-1 mod 2^32, the kernel's
R_WORDS = [R >> (32 * k) & M32 for k in range(NW)]

# the plain versions' digits
_DB = 16
_DM = (1 << _DB) - 1
ND = 2 * NW  # 16-bit digits per element
_R_DIGITS = [R >> (_DB * k) & _DM for k in range(ND)]
_NPRIME = -pow(R, -1, MONT_R) % MONT_R

# Fr products performed by the plain operations, all lanes (module doc)
FR_PRODUCTS = 0

_CONSTS: dict = {}


def _const(name: str, device) -> torch.Tensor:
    key = (name, str(device))
    t = _CONSTS.get(key)
    if t is None:
        digits = {
            "r": _R_DIGITS,
            "nprime": [_NPRIME >> (_DB * k) & _DM for k in range(ND)],
            "r2": [MONT_R2 >> (_DB * k) & _DM for k in range(ND)],
            "one": [1] + [0] * (ND - 1),
        }[name]
        t = _CONSTS[key] = torch.tensor(digits, dtype=torch.int64, device=device)
    return t


# ------------------------------------------------------- host converters


def ints_to_words(values) -> np.ndarray:
    """ints in [0, 2^256) -> (N, 8) int32 little-endian words."""
    raw = b"".join(map(int.to_bytes, map(int, values), repeat(32), repeat("little")))
    return np.frombuffer(raw, dtype="<i4").astype(np.int32).reshape(-1, NW)


def words_to_ints(words) -> list:
    """(..., 8) int32 words -> ints, row-major."""
    arr = np.ascontiguousarray(np.asarray(words, dtype=np.int32)).reshape(-1, NW)
    raw = arr.astype("<i4").tobytes()
    return [int.from_bytes(raw[32 * i : 32 * i + 32], "little") for i in range(arr.shape[0])]


def pack_ints(values) -> np.ndarray:
    """ints -> (N, 8) canonical words, plain domain (values reduced mod r)."""
    return ints_to_words([int(v) % R for v in values])


def unpack_ints(words) -> list:
    """(..., 8) plain-domain words -> ints mod r."""
    return [v % R for v in words_to_ints(words)]


def mont_words(values) -> np.ndarray:
    """ints -> (N, 8) Montgomery-form canonical words."""
    return ints_to_words([(int(v) % R << 256) % R for v in values])


def words_from_mont(words) -> list:
    """(..., 8) Montgomery words -> plain ints mod r."""
    return [v * R_INV % R for v in words_to_ints(words)]


# ------------------------------------------------------ digits and words


def _digits(w) -> torch.Tensor:
    """(..., 8) int32 words -> (..., 16) int64 16-bit digits."""
    u = w.to(torch.int64) & M32
    return torch.stack([u & _DM, u >> _DB], dim=-1).reshape(*w.shape[:-1], ND)


def _words(d) -> torch.Tensor:
    """(..., 16) canonical digits -> (..., 8) int32 words."""
    d = d.reshape(*d.shape[:-1], NW, 2)
    u = d[..., 0] | (d[..., 1] << _DB)
    return torch.where(u >= 1 << 31, u - (1 << 32), u).to(torch.int32)


def _relax(d, passes: int) -> torch.Tensor:
    """Value-preserving carry passes over non-negative digits: every digit
    but the top keeps its low 16 bits and hands the rest up; the top one
    keeps all of it. A pass maps a digit bound 2^16 + e to 2^16 + e / 2^16."""
    for _ in range(passes):
        carry = d[..., :-1] >> _DB
        d = torch.cat([d[..., :-1] & _DM, d[..., -1:]], dim=-1)
        d[..., 1:] += carry
    return d


def _normalize(d) -> list:
    """Signed digits -> exact 16-bit digits, low to high, and the carry out
    of the top (negative when the value is): one carry chain."""
    out, c = [], 0
    for j in range(d.shape[-1]):
        v = d[..., j] + c
        out.append(v & _DM)
        c = v >> _DB
    return out, c


def _cond_sub(d, k: int) -> torch.Tensor:
    """Exact digits (..., n >= 16) of a value v -> v - k r where that is
    not negative, v otherwise."""
    kr = torch.tensor([(k * R) >> (_DB * j) & _DM for j in range(d.shape[-1])],
                      dtype=torch.int64, device=d.device)
    diff, c = _normalize(d - kr)
    return torch.where((c >= 0)[..., None], torch.stack(diff, dim=-1), d)


def _canon(d) -> torch.Tensor:
    """Relaxed non-negative digits (..., n) of a value below 4r ->
    canonical (..., 16) digits: one carry chain, then r subtracted twice
    at most (2r, then r)."""
    digits, c = _normalize(d)
    d = torch.stack(digits, dim=-1)
    if d.shape[-1] == ND:
        d = torch.cat([d, c[..., None]], dim=-1)
    d = _cond_sub(_cond_sub(d, 2), 1)
    return d[..., :ND]


def _conv(a, b, width: int) -> torch.Tensor:
    """The first `width` columns of the digit product a b: column k sums
    a_i b_j over i + j = k. The (..., K, J) outer product is padded by K
    on its last axis and read back in rows one shorter, which shifts row i
    right by i; the column sums are then one sum over the rows."""
    K, J = a.shape[-1], b.shape[-1]
    outer = a[..., :, None] * b[..., None, :]
    lead = outer.shape[:-2]
    flat = torch.constant_pad_nd(outer, (0, K)).reshape(lead + (K * (J + K),))
    cols = flat[..., : K * (J + K - 1)].reshape(lead + (K, J + K - 1)).sum(-2)
    if width > cols.shape[-1]:
        return torch.constant_pad_nd(cols, (0, width - cols.shape[-1]))
    return cols[..., :width]


def _mont_digits(a, b) -> torch.Tensor:
    """Montgomery product on digits, schoolbook then REDC: a (..., K)
    relaxed digits (each below 2^17 + 2^7, K = 16 or 17), b (..., 16)
    exact digits -> (..., K) relaxed digits (each at most 2^16 + 1 but the
    top) of (a b + m r) / 2^256, congruent to a b 2^-256 mod r.

    Bounds, every column in int64: the columns of t = a b are below 17
    (2^33 + 2^23) < 2^37.1; m = -t r^-1 mod 2^256 from t's low 16 columns
    and the digits of -r^-1 (columns below 16 2^37.1 2^16 = 2^57.1), three
    carry passes that drop what leaves digit 15 (mod 2^256) taking its
    digits to at most 2^16 + 2^9.2, so m < 1.01 2^256; u = t + m r has
    columns below 2^37.7 and is 0 mod 2^256. Three carry passes over u,
    its top digit keeping all, leave every digit at most 2^16 + 1, so u's
    low 16 digits are worth below 2^256 (1 + 2^-15): exactly 0 or 2^256,
    2^256 when any of them is not 0 -- the carry into the result. The value
    out is below a b / 2^256 + 1.01 r. Counts one Fr product a lane in
    FR_PRODUCTS."""
    global FR_PRODUCTS
    K = a.shape[-1]
    FR_PRODUCTS += torch.broadcast_shapes(a.shape[:-1], b.shape[:-1]).numel()
    t = _conv(a, b, K + ND)
    m = _conv(t[..., :ND], _const("nprime", a.device), ND)
    for _ in range(3):
        m = (m & _DM) + torch.constant_pad_nd((m >> _DB)[..., :-1], (1, 0))
    u = t + _conv(m, _const("r", a.device), K + ND)
    u = _relax(u, passes=3)
    out = u[..., ND:].clone()
    out[..., 0] += (u[..., :ND] != 0).any(-1)
    return out


# ------------------------------------------------------- plain operations
# canonical (..., 8) int32 words in, canonical words out, any device


def mul(a, b):
    """Montgomery product a b 2^-256 mod r."""
    return _words(_canon(_mont_digits(_digits(a), _digits(b))))


def add(a, b):
    return _words(_canon(_digits(a) + _digits(b)))


def sub(a, b):
    return _words(_canon(_digits(a) + (_const("r", a.device) - _digits(b))))


def neg(a):
    return sub(torch.zeros_like(a), a)


def to_mont(a):
    """Plain words -> Montgomery words: a R^2 2^-256 = a R mod r."""
    r2 = _const("r2", a.device).expand(*a.shape[:-1], ND)
    return _words(_canon(_mont_digits(_digits(a), r2)))


def from_mont(a):
    """Montgomery words -> plain words: a 2^-256 mod r."""
    one = _const("one", a.device).expand(*a.shape[:-1], ND)
    return _words(_canon(_mont_digits(_digits(a), one)))


# -------------------------------------------- the kernel's steps, modelled


def _madc(t: int, y: int, w: int, cf: int, hi: bool) -> tuple:
    """PTX mad{c}.{lo,hi}.cc.u32: t + (the low or high half of y w) + the
    carry flag -> (word, carry flag)."""
    half = (y * w) >> 32 if hi else (y * w) & M32
    v = t + half + cf
    return v & M32, v >> 32


def _chain_even(t: list, y: int, w, tail_zero: bool) -> None:
    """rs_extend.cu RS_EVEN on t[0..8]: y w_{2k} into words 2k and 2k + 1
    for k = 0..3 in one carry chain, then word 8: the flag alone
    ("addc.u32 %8, 0, 0", word 8 being 0) or word 8 plus the flag, which
    must not carry out."""
    cf = 0
    for k in (0, 2, 4, 6):
        t[k], cf = _madc(t[k], y, w[k], cf, False)
        t[k + 1], cf = _madc(t[k + 1], y, w[k], cf, True)
    if tail_zero:
        assert t[NW] == 0
        t[NW] = cf
    else:
        v = t[NW] + cf
        assert v <= M32, "RS_EVEN: a carry out of word 8"
        t[NW] = v


def _chain_odd(t: list, y: int, w) -> None:
    """rs_extend.cu RS_ODD on t[1..8]: y w_{2k+1} into words 2k + 1 and
    2k + 2, the last a madc.hi without a carry out, which must not carry."""
    cf = 0
    for k in (1, 3, 5, 7):
        t[k], cf = _madc(t[k], y, w[k], cf, False)
        t[k + 1], cf = _madc(t[k + 1], y, w[k], cf, True)
    assert cf == 0, "RS_ODD: a carry out of word 8"


def mul_words(a: int, b: int) -> int:
    """Word model of rs_extend.cu `fr_mul` for a < 2^256, b < r: 8 CIOS
    rows on 9 words, each row the chains RS_EVEN and RS_ODD of a_i b, then
    m = t_0 N0 mod 2^32 and the chains of m r, which zero word 0; the
    words shift down one. Word 8 is 0 at a row's start (t < b + r), no
    chain carries out of word 8, and the value out, (a b + M r) / 2^256
    with M = -a b r^-1 mod 2^256, is below b + r < 2r (asserted)."""
    assert 0 <= a < MONT_R and 0 <= b < R
    aw = [(a >> (32 * j)) & M32 for j in range(NW)]
    bw = [(b >> (32 * j)) & M32 for j in range(NW)]
    t = [0] * (NW + 1)
    for i in range(NW):
        _chain_even(t, aw[i], bw, tail_zero=True)
        _chain_odd(t, aw[i], bw)
        m = t[0] * N0 & M32
        _chain_even(t, m, R_WORDS, tail_zero=False)
        _chain_odd(t, m, R_WORDS)
        assert t[0] == 0
        t = t[1:] + [0]
    out = sum(w << (32 * k) for k, w in enumerate(t))
    assert out < b + R and (out * MONT_R - a * b) % R == 0
    return out


def _sub_r_select(s: int, top: int) -> int:
    """rs_extend.cu `sub_r_select`: s (8 words) and its carry top, the
    value below 3r; the borrow chain of s - r ends in top - borrow, 0
    (take s - r) or all ones (keep s)."""
    assert 0 <= s < MONT_R and top in (0, 1) and s + (top << 256) < 3 * R
    d = s - R
    borrow = int(d < 0)
    end = (top - borrow) & M32
    assert end in (0, M32)
    return s if end else d & (MONT_R - 1)


def canon_words(v: int) -> int:
    """rs_extend.cu `canon`: v < 2r -> v mod r."""
    assert 0 <= v < 2 * R
    return _sub_r_select(v, 0)


def horner_step_words(acc: int, x: int, c: int) -> int:
    """rs_extend.cu `horner_step` for acc < 2r, x, c < r: t = fr_mul(acc,
    x), the add chain t + c into 8 words and a carry, then
    `sub_r_select`. Returns the next acc, below 2r."""
    assert 0 <= acc < 2 * R and 0 <= x < R and 0 <= c < R
    s = mul_words(acc, x) + c
    out = _sub_r_select(s & (MONT_R - 1), s >> 256)
    assert out < 2 * R and out % R == s % R
    return out


def eval_words(coeffs, x: int, plain_out: bool = False) -> int:
    """One unsplit chain for one (point, blob) lane, step by step: Horner
    over `coeffs` (low degree first) at x, the final product by one when
    `plain_out`, then the last conditional subtraction."""
    acc = 0
    for c in reversed(coeffs):
        acc = horner_step_words(acc, x, c)
    if plain_out:
        acc = mul_words(acc, 1)
    return acc - R if acc >= R else acc


def split_length(n_coeff: int, segments: int) -> int:
    """L, the steps of a segment: ceil(n_coeff / segments)."""
    return -(-n_coeff // segments)


def pow_words(x: int, L: int) -> int:
    """rs_extend.cu `pow_mont`: y = X^L in Montgomery form for the
    canonical Montgomery word x of X, left to right over L's bits below
    the top, each square and product made canonical."""
    assert 0 <= x < R and L >= 1
    y = x
    for bit in range(L.bit_length() - 2, -1, -1):
        y = canon_words(mul_words(y, y))
        if (L >> bit) & 1:
            y = canon_words(mul_words(y, x))
    return y


def split_eval_words(coeffs, x: int, segments: int, plain_out: bool = False) -> int:
    """rs_extend.cu's chain split into S = `segments` lanes, for one
    (point, blob) pair: with L = split_length(n, S), segment s runs Horner
    over coefficients [s L, s L + L) at x (zero from n up), so that
    part_s = sum_k c_{sL+k} X^k; for S > 1 the parts are made canonical,
    y = X^L (`pow_words`) and a second Horner combines them, highest
    segment first: sum_s part_s y^s. Then the product by one when
    `plain_out`, and the value made canonical."""
    n = len(coeffs)
    L = split_length(n, segments)
    parts = []
    for s in range(segments):
        acc = 0
        for q in range(L):
            i = s * L + L - 1 - q
            acc = horner_step_words(acc, x, coeffs[i] if i < n else 0)
        parts.append(acc)
    acc = parts[0]
    if segments > 1:
        parts = [canon_words(p) for p in parts]
        y = pow_words(x, L)
        acc = parts[-1]
        for s in range(segments - 2, -1, -1):
            acc = horner_step_words(acc, y, parts[s])
    if plain_out:
        acc = mul_words(acc, 1)
    return canon_words(acc)
