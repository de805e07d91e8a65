"""The register-resident Fp product of `csrc/fp_reg.cuh`, measured alone.

`chain(x, y, length)`: for each column i of the (12, n) word operands,
`length` dependent Montgomery products x_i <- x_i y_i 2^-384 mod p, with
fp_reg.cuh's `fp_mul`, the product every field kernel runs; `mul_words`
models that product word for word (`mul_wide_words`, `reduce_words`).
CUDA tensors launch `csrc/fp_product.cu` (one chain a thread), CPU
tensors run `chain_plain`
(Python integers). `measure(device)` times one thread's chain (the
latency of one product, which sets K3's fold chain) and a card full of
chains (the product rate, beside the bound's derived 16.7 T int32
multiply-adds/s), and holds both against `chain_plain`. Not a kernel of
the main path: `chip_smoke.py` runs it as a phase of its own.
"""

import numpy as np
import torch

from lighthouse_tpu_torch.crypto.constants import P
from lighthouse_tpu_torch.ops import cuda_build

NW = 12
R_INV = pow(1 << 384, -1, P)
LATENCY_LEN = 4096  # products in the one-thread chain
RATE_LEN = 256  # products in each chain of the full card
RATE_CHAINS_PER_SM = 2048


def _ints(words) -> list:
    a = words.cpu().numpy().astype(np.int64) & 0xFFFFFFFF
    return [sum(int(a[j, i]) << (32 * j) for j in range(NW)) for i in range(a.shape[1])]


def _words(values) -> torch.Tensor:
    w = np.array([[(v >> (32 * j)) & 0xFFFFFFFF for v in values] for j in range(NW)], np.uint32)
    return torch.from_numpy(w.view(np.int32))


def random_words(n: int, seed: int, device="cpu") -> torch.Tensor:
    """(12, n) canonical words (the top word stays below p's)."""
    rng = np.random.default_rng(seed)
    w = rng.integers(0, 1 << 32, size=(NW, n), dtype=np.uint64)
    w[NW - 1] %= P >> 352
    return torch.from_numpy(w.astype(np.uint32).view(np.int32)).to(device)


M32 = (1 << 32) - 1
N0 = -pow(P, -1, 1 << 32) % (1 << 32)  # -p^-1 mod 2^32
P_WORDS = [P >> (32 * k) & M32 for k in range(NW)]


def _mads(w, at, x, y) -> int:
    """fp_reg.cuh `LH_MAD_CHAIN`'s multiply-adds on word list w: w[at +
    2k] += lo(x[2k] y) and w[at + 2k + 1] += hi(x[2k] y), k = 0..5, in one
    carry chain; returns the chain's carry out (0 or 1)."""
    c = 0
    for k in range(6):
        prod = x[2 * k] * y
        for off, part in ((0, prod & M32), (1, prod >> 32)):
            v = w[at + 2 * k + off] + part + c
            w[at + 2 * k + off], c = v & M32, v >> 32
    return c


def reduce_words(t: int) -> int:
    """Word-level model of fp_reg.cuh `mont_reduce` for 0 <= t < p 2^384:
    12 Montgomery rows, each two carry chains (p's even words into words i
    .. i + 11, its odd words into i + 1 .. i + 12), the even chain's carry
    added into word i + 12 and its carry out kept with the odd chain's
    from the row before, the odd chain's carry and those added into word i
    + 13; asserts that each row clears word i, that the carries stay in
    their bounds, and that the value before the last subtraction is below
    2p. Returns t 2^-384 mod p."""
    assert 0 <= t < P << 384
    w = [(t >> (32 * k)) & M32 for k in range(2 * NW + 1)]
    c = 0  # the carry into word i + 13
    for i in range(NW):
        m = w[i] * N0 & M32
        v = w[i + NW] + _mads(w, i, P_WORDS, m)
        w[i + NW], c = v & M32, c + (v >> 32)
        assert c <= 2
        v = w[i + NW + 1] + _mads(w, i + 1, P_WORDS[1:], m) + c
        w[i + NW + 1], c = v & M32, v >> 32
        assert c <= 1 and w[i] == 0
    assert c == 0 and w[2 * NW] == 0
    v = sum(w[NW + k] << (32 * k) for k in range(NW))
    assert v < 2 * P
    return v - P if v >= P else v


def mul_wide_words(a: int, b: int) -> list:
    """Word-level model of fp_reg.cuh `mul_wide` for a, b < 2p: the SOS
    product rows, each row's carry in a 64-bit register (no step
    overflows). Returns the 25 words of a b."""
    assert 0 <= a < 2 * P and 0 <= b < 2 * P
    aw = [(a >> (32 * j)) & M32 for j in range(NW)]
    bw = [(b >> (32 * j)) & M32 for j in range(NW)]
    t = [0] * (2 * NW + 1)
    for i in range(NW):
        c = 0
        for j in range(NW):
            c += aw[j] * bw[i] + t[i + j]
            assert c < 1 << 64
            t[i + j], c = c & M32, c >> 32
        t[i + NW] = c
    assert t[2 * NW] == 0
    return t


def mul_words(a: int, b: int) -> int:
    """Word-level model of fp_reg.cuh `fp_mul` for a, b < 2p:
    `mul_wide_words`, then `reduce_words`. Returns a b 2^-384 mod p."""
    return reduce_words(sum(v << (32 * k) for k, v in enumerate(mul_wide_words(a, b))))


def chain_plain(x, y, length: int) -> torch.Tensor:
    out = [a * pow(b * R_INV % P, length, P) % P for a, b in zip(_ints(x), _ints(y))]
    return _words(out).to(x.device)


def chain(x, y, length: int, require_kernel: bool = False) -> torch.Tensor:
    if not cuda_build.use_kernel(x, require_kernel):
        return chain_plain(x, y, length)
    n = x.shape[1]
    cuda_build.check(x, "x", (NW, n))
    cuda_build.check(y, "y", (NW, n), x.device)
    out = torch.empty_like(x)
    cuda_build.call("fp_product", "lh_fp_chain", x, y, n, length, out)
    return out


def measure(device, repeats: int = 3) -> dict:
    """Latency (ns a product, one thread) and rate (products/s, every SM
    full), each the best of `repeats` CUDA-event medians and held against
    `chain_plain` on sampled chains."""
    x1, y1 = random_words(1, 1, device), random_words(1, 2, device)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    n = sms * RATE_CHAINS_PER_SM
    xn, yn = random_words(n, 3, device), random_words(n, 4, device)
    cols = torch.arange(0, n, n // 64)
    want1 = chain_plain(x1.cpu(), y1.cpu(), LATENCY_LEN)
    wantn = chain_plain(xn[:, cols].cpu(), yn[:, cols].cpu(), RATE_LEN)
    lat_ms = min(cuda_build.time_ms(lambda: chain(x1, y1, LATENCY_LEN)) for _ in range(repeats))
    rate_ms = min(cuda_build.time_ms(lambda: chain(xn, yn, RATE_LEN)) for _ in range(repeats))
    return {
        "latency_products": LATENCY_LEN, "rate_chains": n, "rate_products_per_chain": RATE_LEN,
        "latency_exact": bool(torch.equal(chain(x1, y1, LATENCY_LEN).cpu(), want1)),
        "rate_exact": bool(torch.equal(chain(xn, yn, RATE_LEN)[:, cols].cpu(), wantn)),
        "latency_ns_per_product": lat_ms * 1e6 / LATENCY_LEN,
        "products_per_s": n * RATE_LEN / (rate_ms / 1e3),
    }
