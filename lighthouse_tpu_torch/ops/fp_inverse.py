"""Word-level models of the to-affine kernel's inversion
(`csrc/curve_helpers.cu` `affine_kernel`), in the way
`ops/fp_product.mul_words` models the product.

* `inv_words(a)` models `fp_reg.cuh` `fp_inv`: Kaliski's almost Montgomery
  inverse, several bits a step, on 12 words -- u, v, r, s with
  p = u s + v r -- then the division by the 2^k it leaves, 32 bits at a
  time, and one product by R^3. It returns a^-1 R^2 mod p: the Montgomery
  form of the inverse of a Montgomery value. 0 maps to 0.
* `tree_inverse(values, lanes)` models the kernel's block plan: each block
  of `lanes` values puts them (a zero replaced by the Montgomery one, and
  padding lanes the one) as the leaves of a product tree, inverts its root
  with `inv_words`, and hands each leaf its inverse on the way down; a
  zero's output is masked to 0.

Every step asserts the bounds the kernel relies on: no word overflows, r
and s stay below 2^384, the quotient steps stay exact.
"""

from lighthouse_tpu_torch.crypto.constants import P
from lighthouse_tpu_torch.ops.fp_product import mul_words

NW = 12
M32 = 0xFFFFFFFF
N0 = (-pow(P, -1, 1 << 32)) % (1 << 32)
R = 1 << 384
R2 = R * R % P
R3 = R * R * R % P
ONE = R % P


def _words(v: int) -> list:
    return [(v >> (32 * k)) & M32 for k in range(NW)]


def _value(w: list) -> int:
    return sum(x << (32 * k) for k, x in enumerate(w))


def _sub(a: list, b: list) -> tuple:
    """12-word a - b with the kernel's borrow chain: (words, borrow out)."""
    out, borrow = [], 0
    for x, y in zip(a, b):
        d = x - y - borrow
        borrow = 1 if d < 0 else 0
        out.append(d & M32)
    return out, borrow


def _add(a: list, b: list) -> list:
    out, c = [], 0
    for x, y in zip(a, b):
        c += x + y
        out.append(c & M32)
        c >>= 32
    assert c == 0, "r + s overflows 12 words"
    return out


def _ctz(a: list) -> int:
    for k, x in enumerate(a):
        if x:
            return 32 * k + ((x & -x).bit_length() - 1)
    raise AssertionError("ctz of zero")


def _shr(a: list, t: int) -> list:
    return _words(_value(a) >> t)


def _shl(a: list, t: int) -> list:
    v = _value(a) << t
    assert v < R, "a shifted value overflows 12 words"
    return _words(v)


def div_pow2(x: list, t: int) -> list:
    """x 2^-t mod p for x < p, 1 <= t <= 32: m = -x p^-1 mod 2^t from the
    low word, then (x + m p) >> t over 13 words."""
    assert 1 <= t <= 32 and _value(x) < P
    m = (x[0] * N0) & ((1 << t) - 1)
    w, c = [], 0
    for xk, pk in zip(x, _words(P)):
        c += m * pk + xk
        assert c < 1 << 64
        w.append(c & M32)
        c >>= 32
    w.append(c)
    v = _value(w)
    assert v % (1 << t) == 0 and v >> t < P
    return _words(v >> t)


def inv_words(a: int) -> int:
    """Model of fp_reg.cuh `fp_inv` for 0 <= a < p: a^-1 R^2 mod p."""
    assert 0 <= a < P
    if a == 0:
        return 0
    u, v, r, s = _words(P), _words(a), [0] * NW, _words(1)
    total = _ctz(v)
    v = _shr(v, total)
    while True:
        d, borrow = _sub(u, v)
        if not borrow and any(d):  # u > v
            u, r = d, _add(r, s)
            t = _ctz(u)
            u, s = _shr(u, t), _shl(s, t)
        else:  # v >= u
            v, _ = _sub([0] * NW, d)
            s = _add(s, r)
            if not any(v):
                r, total = _shl(r, 1), total + 1
                break
            t = _ctz(v)
            v, r = _shr(v, t), _shl(r, t)
        total += t
        assert _value(u) * _value(s) + _value(v) * _value(r) == P
    rv = _value(r)
    assert rv < 2 * P
    rv = rv - P if rv >= P else rv
    x = _words(P - rv)  # a^-1 2^total mod p
    assert 0 < P - rv < P
    while total >= 32:
        x, total = div_pow2(x, 32), total - 32
    if total:
        x = div_pow2(x, total)
    return mul_words(_value(x), R3)


def tree_inverse(values: list, lanes: int = 256) -> list:
    """Model of the kernel's block plan: blocks of `lanes` (a power of
    two) values; the heap tree's node i is the product of nodes 2i and
    2i + 1, leaves at lanes + t; one `inv_words` at the root; on the way
    down, a child's inverse is its parent's times its sibling. Returns the
    Montgomery inverse of each value, 0 for 0."""
    out = []
    for b0 in range(0, len(values), lanes):
        block = values[b0 : b0 + lanes]
        tree = [0] * lanes + [v if v else ONE for v in block] + [ONE] * (lanes - len(block))
        for i in range(lanes - 1, 0, -1):
            tree[i] = mul_words(tree[2 * i], tree[2 * i + 1])
        tree[1] = inv_words(tree[1])
        s = 1
        while s < lanes:  # level by level, every read before any write
            down = [mul_words(tree[c >> 1], tree[c ^ 1]) for c in range(2 * s, 4 * s)]
            tree[2 * s : 4 * s] = down
            s *= 2
        out += [tree[lanes + t] if v else 0 for t, v in enumerate(block)]
    return out
