"""Plain BLS12-381 field arithmetic on batch-last bundles, and the
converters to and from the kernel layout.

Two layouts meet here:

* **Bundles** (the plain PyTorch versions): int32 tensors `(..., S, NB, B)`
  of NB = 33 relaxed 12-bit limbs, Montgomery form with R = 2^384, batch
  last -- the JAX package's `ops.tfield` layout, with its relaxed-limb
  invariant (limbs in [0, 4097], values < 2.2p) and its bound chains
  (see `lighthouse_tpu/ops/fieldb.py`'s docstring; the arithmetic here is
  the same sequence of carry passes and quotient estimates).
* **Words** (the CUDA kernels): int32 tensors `(..., S, 12, B)` of 12
  little-endian 32-bit words, canonical (< p), Montgomery form with the
  same R, so converting is canonicalising and repacking bits.

Every function takes tensors on any device and keeps them there. Plain
operations count the Fp products they perform, over all lanes, in
`FP_PRODUCTS` (the operation count behind each kernel's bound).
"""

import numpy as np
import torch
import torch.nn.functional as F

from lighthouse_tpu_torch.crypto.constants import (
    LIMB_BITS,
    LIMB_MASK,
    MONT_R_MOD_P,
    MONT_R2_MOD_P,
    NLIMBS,
    P,
)

NB = NLIMBS + 1  # bundle limbs: one headroom limb beyond 384 bits
NW = 12  # kernel words per Fp element
LIMB_RELAX = LIMB_MASK + 2

R_INV = pow(1 << 384, -1, P)

# Fp products performed by the plain operations, all lanes (see module doc)
FP_PRODUCTS = 0


def _limbs(v: int, n: int) -> list:
    return [(v >> (LIMB_BITS * i)) & LIMB_MASK for i in range(n)]


_NPRIME = _limbs((-pow(P, -1, 1 << 384)) % (1 << 384), NLIMBS)
_PLIMBS = _limbs(P, NLIMBS)
ONE_MONT = _limbs(MONT_R_MOD_P, NB)
R2 = _limbs(MONT_R2_MOD_P, NB)
COMP_2P = _limbs((1 << (LIMB_BITS * NB)) - 2 * P, NB)  # 2^396 - 2p
COMP_P = _limbs((1 << (LIMB_BITS * NB)) - P, NB)

# Offset for signed combinations: value 368p with every limb but the top
# >= 37*4096 - 37 (covers rows of L1 norm <= 36 over relaxed limbs).
OFF_K = 36
OFF_CONST = _limbs(368 * P, NB)
for _i in range(NB - 1):
    OFF_CONST[_i] += 37 << LIMB_BITS
    OFF_CONST[_i + 1] -= 37
# Subtraction constant: value 32p, limbs spread by two units.
SPREAD_SUB = _limbs(32 * P, NB)
for _i in range(NB - 1):
    SPREAD_SUB[_i] += 2 << LIMB_BITS
    SPREAD_SUB[_i + 1] -= 2
assert min(OFF_CONST) >= 0 and min(OFF_CONST[:-1]) >= OFF_K * LIMB_RELAX
assert min(SPREAD_SUB) >= 0 and min(SPREAD_SUB[:-1]) >= LIMB_RELAX

_CONSTS: dict = {}


def const_col(name: str, device) -> torch.Tensor:
    """A named limb constant as a (len, 1) int32 column on `device`."""
    key = (name, str(device))
    t = _CONSTS.get(key)
    if t is None:
        vals = {
            "nprime": _NPRIME,
            "p": _PLIMBS,
            "one": ONE_MONT,
            "r2": R2,
            "comp_2p": COMP_2P,
            "comp_p": COMP_P,
            "off": OFF_CONST,
            "spread_sub": SPREAD_SUB,
        }[name]
        t = torch.tensor(vals, dtype=torch.int32, device=device)[:, None]
        _CONSTS[key] = t
    return t


def matrix(m, device) -> torch.Tensor:
    """A static small-integer matrix as an int32 tensor on `device`."""
    arr = np.asarray(m, dtype=np.int32)
    key = ("matrix", arr.shape, arr.tobytes(), str(device))
    t = _CONSTS.get(key)
    if t is None:
        t = _CONSTS[key] = torch.tensor(arr, device=device)
    return t


# ------------------------------------------------------------ carry passes


def _shift_down(c):
    """c[..., i-1, :] at limb i, zero at limb 0 (`constant_pad_nd` is
    F.pad without its Python dispatch: the plain versions call this ~10^5
    times per batch)."""
    return torch.constant_pad_nd(c[..., :-1, :], (0, 0, 1, 0))


def _partial_pass(x):
    return (x & LIMB_MASK) + _shift_down(x >> LIMB_BITS)


def _relax(x, out_len: int, passes: int = 3):
    """Value-preserving (mod 2^(12 out_len)) pass to limbs <= ~4096;
    carries beyond out_len drop on purpose (mod-R arithmetic)."""
    n = x.shape[-2]
    if n < out_len:
        x = F.pad(x, (0, 0, 0, out_len - n))
    elif n > out_len:
        x = x[..., :out_len, :]
    for _ in range(passes):
        x = _partial_pass(x)
    return x


def reduce_small(x):
    """Subtract q * 2p with q estimated from the top two limbs."""
    t2 = x[..., NB - 1, :] * (1 << LIMB_BITS) + x[..., NB - 2, :]
    q = torch.div(t2, 833, rounding_mode="floor")
    return _relax(x + q.unsqueeze(-2) * const_col("comp_2p", x.device), NB)


def _ks_resolve(x):
    """Kogge-Stone carry resolution of limbs < 2*4096 (unit carries):
    (canonical limbs, carry out of the top limb)."""
    g = (x > LIMB_MASK).to(torch.int32)
    p = (x == LIMB_MASK).to(torch.int32)
    n = x.shape[-2]
    shift = 1
    while shift < n:
        g_prev = F.pad(g[..., :-shift, :], (0, 0, shift, 0))
        p_prev = F.pad(p[..., :-shift, :], (0, 0, shift, 0))
        g = g | (p & g_prev)
        p = p & p_prev
        shift *= 2
    return (x + _shift_down(g)) & LIMB_MASK, g[..., -1, :]


def _cond_sub(x, comp_name: str):
    """Subtract the complement's value iff x >= it (exact compare)."""
    s = x + const_col(comp_name, x.device)
    c = s >> LIMB_BITS
    top1 = c[..., -1, :]
    out, top2 = _ks_resolve((s & LIMB_MASK) + _shift_down(c))
    ge = (top1 + top2) > 0
    return torch.where(ge.unsqueeze(-2), out, x)


def canon(x):
    """Relaxed bundle (< 2.5p) -> canonical limbs of the value mod p."""
    x, _ = _ks_resolve(x)
    return _cond_sub(_cond_sub(x, "comp_2p"), "comp_p")


# ---------------------------------------------------------------- products


def _conv(a, b):
    """Full limb convolution (..., I, B) x (..., J, B) -> (..., I+J-1, B),
    as an outer product summed along its anti-diagonals (the skew of a
    row-padded reshape)."""
    prod = a.unsqueeze(-2) * b.unsqueeze(-3)  # (..., I, J, B)
    lead, (I, J, B) = prod.shape[:-3], prod.shape[-3:]
    L = I + J
    flat = F.pad(prod, (0, 0, 0, I)).reshape(*lead, I * L, B)
    skew = flat[..., : I * (L - 1), :].reshape(*lead, I, L - 1, B)
    return skew.sum(-3, dtype=torch.int32)


def mul_lazy(a, b):
    """Stacked Montgomery product (..., S, NB, B) x (..., S, NB, B);
    inputs < 2.2p relaxed, output < 1.5p (tfield.mul_lazy)."""
    global FP_PRODUCTS
    a, b = torch.broadcast_tensors(a, b)
    FP_PRODUCTS += a.numel() // NB
    dev = a.device
    t = _relax(_conv(a, b), 2 * NB)
    m = _relax(_conv(t[..., :NLIMBS, :], const_col("nprime", dev)), NLIMBS)
    mp = _conv(m, const_col("p", dev))
    full = _relax(t + F.pad(mp, (0, 0, 0, 2 * NB - mp.shape[-2])), 2 * NB)
    # the low 32 limbs hold exactly 0 or R (see fieldb's docstring), so the
    # carry into the high half is whether any low limb is non-zero
    low_nonzero = (full[..., :NLIMBS, :] != 0).any(dim=-2)
    out = full[..., NLIMBS : NLIMBS + NB, :]
    bump = F.pad(low_nonzero.to(torch.int32).unsqueeze(-2), (0, 0, 0, NB - 1))
    return out + bump


def sqr_lazy(a):
    return mul_lazy(a, a)


# ------------------------------------------------------------ combinations


def apply_combo(x, m):
    """Slot recombination (..., S_in, NB, B) -> (..., S_out, NB, B) by a
    static integer matrix with rows of L1 norm <= 36, reduced twice."""
    arr = np.asarray(m)
    assert np.abs(arr).sum(axis=1).max() <= OFF_K, "combo L1 too large"
    mt = matrix(arr, x.device)[:, :, None, None]
    y = (mt * x.unsqueeze(-4)).sum(-3, dtype=torch.int32)
    y = _relax(y + const_col("off", x.device), NB, passes=2)
    return reduce_small(reduce_small(y))


def add(a, b):
    return reduce_small(_partial_pass(a + b))


def sub(a, b):
    s = a - b + const_col("spread_sub", a.device)
    return reduce_small(_relax(s, NB, passes=2))


def neg(a):
    return sub(torch.zeros_like(a), a)


def scalar_small(a, k: int):
    if k == 0:
        return torch.zeros_like(a)
    assert k <= 12
    return reduce_small(_relax(a * k, NB, passes=2))


def select(cond, a, b):
    """cond (..., B) broadcasting over (slots, limbs)."""
    return torch.where(cond[..., None, None, :], a, b)


def one_slot0(slots: int, batch: int, device):
    """Montgomery 1 in slot 0 and zero elsewhere, (slots, NB, batch)."""
    out = torch.zeros((slots, NB, batch), dtype=torch.int32, device=device)
    out[0] = const_col("one", device)
    return out


def pow_bits(mul_fn, sqr_fn, one, base, exponent: int):
    """base^exponent, LSB-first square-and-multiply (the multiply skipped
    on zero bits, as tfexp._pow_bits does under lax.cond)."""
    result = one
    for i in range(exponent.bit_length()):
        if (exponent >> i) & 1:
            result = mul_fn(result, base)
        base = sqr_fn(base)
    return result


_INV_WINDOW = 4


def inv(a):
    """Per-slot Fermat inverse a^(p-2); inv(0) == 0. MSB first over 4-bit
    windows of p - 2 with a table a^0 .. a^15: 380 squarings and ~100
    products, against ~190 products bit by bit."""
    one = torch.broadcast_to(const_col("one", a.device), a.shape)
    table = [one, a]
    for _ in range(2, 1 << _INV_WINDOW):
        table.append(mul_lazy(table[-1], a))
    e = P - 2
    acc = None
    for w in range(-(-e.bit_length() // _INV_WINDOW) - 1, -1, -1):
        digit = (e >> (_INV_WINDOW * w)) & ((1 << _INV_WINDOW) - 1)
        if acc is None:
            acc = table[digit]
            continue
        for _ in range(_INV_WINDOW):
            acc = sqr_lazy(acc)
        if digit:
            acc = mul_lazy(acc, table[digit])
    return acc


def to_mont(a):
    return mul_lazy(a, torch.broadcast_to(const_col("r2", a.device), a.shape))


def from_mont(a):
    one = torch.zeros_like(a)
    one[..., 0, :] = 1
    return canon(mul_lazy(a, one))


# ------------------------------------------------------ layout converters

def _bits_to_limbs(bits, width: int):
    """(..., n*width, B) 0/1 -> (..., n, width-bit limbs as int64, B)."""
    lead, (nbits, B) = bits.shape[:-2], bits.shape[-2:]
    grouped = bits.reshape(*lead, nbits // width, width, B).to(torch.int64)
    weights = (1 << torch.arange(width, dtype=torch.int64, device=bits.device))
    return (grouped * weights[:, None]).sum(-2)


def _limb_bits(x, width: int):
    """(..., n, B) limbs -> (..., n*width, B) 0/1 bits."""
    sh = torch.arange(width, dtype=x.dtype, device=x.device)
    bits = (x.unsqueeze(-2) >> sh[:, None]) & 1
    lead, (n, w, B) = bits.shape[:-3], bits.shape[-3:]
    return bits.reshape(*lead, n * w, B)


def _wrap_int32(w64):
    return torch.where(w64 >= (1 << 31), w64 - (1 << 32), w64).to(torch.int32)


def words_to_bundle(w):
    """Kernel words (..., 12, B) int32 -> bundle limbs (..., NB, B)."""
    bits = F.pad(_limb_bits(w, 32), (0, 0, 0, LIMB_BITS * NB - 32 * NW))
    return _bits_to_limbs(bits, LIMB_BITS).to(torch.int32)


def bundle_to_words(x):
    """Bundle (..., NB, B), any relaxed value -> canonical words (..., 12, B)."""
    bits = _limb_bits(canon(x), LIMB_BITS)[..., : 32 * NW, :]
    return _wrap_int32(_bits_to_limbs(bits, 32))


# ------------------------------------------------------- host converters


def ints_to_words(values) -> np.ndarray:
    """ints in [0, 2^384) -> (N, 12) int32 little-endian words."""
    raw = b"".join(int(v).to_bytes(48, "little") for v in values)
    return np.frombuffer(raw, dtype="<u4").astype(np.uint32).view(np.int32).reshape(-1, NW)


def words_to_ints(words) -> list:
    """(..., 12) int32 words -> list of ints, row-major."""
    arr = np.ascontiguousarray(np.asarray(words, dtype=np.int32)).reshape(-1, NW)
    raw = arr.astype("<i4").tobytes()
    return [int.from_bytes(raw[48 * i : 48 * i + 48], "little") for i in range(arr.shape[0])]


def mont_words(values) -> np.ndarray:
    """ints -> (N, 12) Montgomery-form canonical words."""
    return ints_to_words([(int(v) % P << 384) % P for v in values])


def words_from_mont(words) -> list:
    """(..., 12) Montgomery words -> plain ints mod p."""
    return [v * R_INV % P for v in words_to_ints(words)]


def pack_ints(values) -> np.ndarray:
    """ints -> (N, NB) canonical limb bundle, plain domain (fieldb.pack_ints)."""
    return np.array([_limbs(int(v) % P, NB) for v in values], dtype=np.int32)


def unpack_ints(bundle) -> list:
    arr = np.asarray(bundle)
    out = []
    for row in arr.reshape(-1, arr.shape[-1]):
        out.append(sum(int(l) << (LIMB_BITS * i) for i, l in enumerate(row)) % P)
    return out


def from_jax_bundle(x) -> np.ndarray:
    """A JAX bundle (..., S, 33) in Montgomery limbs (relaxed or canonical)
    -> the same values as canonical kernel words (..., S, 12) int32."""
    arr = np.asarray(x)
    vals = [
        sum(int(l) << (LIMB_BITS * i) for i, l in enumerate(row)) % P
        for row in arr.reshape(-1, arr.shape[-1])
    ]
    return ints_to_words(vals).reshape(arr.shape[:-1] + (NW,))


def to_jax_bundle(w) -> np.ndarray:
    """Canonical kernel words (..., S, 12) -> canonical JAX limbs (..., S, 33)."""
    arr = np.asarray(w)
    return pack_ints(words_to_ints(arr)).reshape(arr.shape[:-1] + (NB,))


_BLOCK_AB: dict = {}


def bilinear(x, y, prog):
    """A tower product as one stacked multiply between two recombinations:
    (A x) * (B y), recombined by C (ops.programs). x and y share their
    batch shape; both recombinations run as one, by the block-diagonal
    matrix diag(A, B) over the stacked slots -- a recombination works row
    by row, so the values are those of the two separate ones."""
    ab = _BLOCK_AB.get(prog)
    if ab is None:
        A, B = np.asarray(prog.A), np.asarray(prog.B)
        ab = np.zeros((A.shape[0] + B.shape[0], A.shape[1] + B.shape[1]), dtype=np.int32)
        ab[: A.shape[0], : A.shape[1]] = A
        ab[A.shape[0] :, A.shape[1] :] = B
        _BLOCK_AB[prog] = ab
    both = apply_combo(torch.cat([x, y], dim=-3), ab)
    n = prog.A.shape[0]
    return apply_combo(mul_lazy(both[..., :n, :, :], both[..., n:, :, :]), prog.C)
