"""K1: the windowed RLC scalar ladder -- wrapper and plain version.

Replaces the TPU kernel `lighthouse_tpu/ops/pallas_ladder.py`
`_ladder_kernel_w4` (kind "window"). The CUDA source is
`lighthouse_tpu_torch/csrc/ladder.cu`; the plain version is the port of
`window_ladder.mul_scalar_bits_windowed_t` over `ops/curve.py`.

Operands are kernel words: a point (X, Y, Z), each (w, 12, B) int32
canonical Montgomery words, w = 1 for G1 and 2 for G2; digits are the
window-major (W, B) magnitudes and 0/1 sign flags of `recode_bits`.
"""

import torch

from lighthouse_tpu_torch.ops import cuda_build, curve, field as fd
from lighthouse_tpu_torch.ops import window_ladder as wl


def ladder_plain(pt, mags, negs):
    """The same function on bundles, any device."""
    group = curve.group(pt[0].shape[0])
    bundles = tuple(fd.words_to_bundle(c) for c in pt)
    acc = wl.mul_digits_windowed_t(group, bundles, mags, negs.to(torch.bool))
    return tuple(fd.bundle_to_words(c) for c in acc)


def ladder(pt, mags, negs, require_kernel: bool = False):
    """Per-lane [k] P from signed window digits. CUDA tensors launch K1,
    CPU tensors run `ladder_plain`."""
    X = pt[0]
    if not cuda_build.use_kernel(X, require_kernel):
        return ladder_plain(pt, mags, negs)
    w, _, B = X.shape
    if w not in (1, 2):
        raise ValueError(f"ladder: coordinate width {w}, expected 1 or 2")
    for name, c in zip("XYZ", pt):
        cuda_build.check(c, name, (w, fd.NW, B), X.device)
    W = mags.shape[0]
    cuda_build.check(mags, "mags", (W, B), X.device)
    cuda_build.check(negs, "negs", (W, B), X.device)
    out = tuple(torch.empty_like(X) for _ in range(3))
    if B:
        cuda_build.launch(
            "ladder", f"lh_ladder_g{w}", f"ladder_g{w}", *pt, mags, negs, W, B, *out
        )
    return out
