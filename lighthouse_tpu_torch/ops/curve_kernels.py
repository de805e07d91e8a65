"""Helper kernels between the ladders and the Miller loop: the projective
lane-sum tree and the batched projective -> affine conversion, with their
plain versions.

On the TPU these steps are XLA outside any Pallas kernel
(`lighthouse_tpu/ops/curve.py` `_tree_fold_sum` / `to_affine`,
`ops/tcurve.py` `sum_lanes`); the CUDA source is
`lighthouse_tpu_torch/csrc/curve_helpers.cu`. Operands are kernel words
(w, 12, B), as in `ops/ladder.py`.
"""

import torch

from lighthouse_tpu_torch.ops import cuda_build, curve, field as fd


def lane_sum_plain(pt, seg: int):
    group = curve.group(pt[0].shape[0])
    bundles = tuple(fd.words_to_bundle(c) for c in pt)
    return tuple(fd.bundle_to_words(c) for c in group.sum_lanes(bundles, seg))


def lane_sum(pt, seg: int, require_kernel: bool = False):
    """Sum every run of `seg` consecutive lanes (a power of two dividing B)
    to one point: (w, 12, B) -> (w, 12, B / seg). One launch per level of
    the halving tree."""
    X = pt[0]
    if seg < 1 or seg & (seg - 1) or X.shape[-1] % seg:
        raise ValueError(f"lane_sum: segment {seg} must be a power of two dividing {X.shape[-1]}")
    if not cuda_build.use_kernel(X, require_kernel):
        return lane_sum_plain(pt, seg)
    w, _, B = X.shape
    for name, c in zip("XYZ", pt):
        cuda_build.check(c, name, (w, fd.NW, B), X.device)
    while seg > 1:
        out = tuple(
            torch.empty((w, fd.NW, B // 2), dtype=torch.int32, device=X.device)
            for _ in range(3)
        )
        cuda_build.launch(
            "curve_helpers", f"lh_lane_sum_level_g{w}", f"lane_sum_g{w}",
            *pt, B, seg, *out,
        )
        pt, B, seg = out, B // 2, seg // 2
    return pt


def to_affine_plain(pt):
    group = curve.group(pt[0].shape[0])
    x, y, inf = group.to_affine(tuple(fd.words_to_bundle(c) for c in pt))
    return fd.bundle_to_words(x), fd.bundle_to_words(y), inf


def to_affine(pt, require_kernel: bool = False):
    """(X, Y, Z) -> (x, y, is_identity): x = X/Z, y = Y/Z per lane, the
    identity as (0, 0) with its flag set."""
    X = pt[0]
    if not cuda_build.use_kernel(X, require_kernel):
        return to_affine_plain(pt)
    w, _, B = X.shape
    for name, c in zip("XYZ", pt):
        cuda_build.check(c, name, (w, fd.NW, B), X.device)
    x = torch.empty_like(X)
    y = torch.empty_like(X)
    inf = torch.empty((B,), dtype=torch.int32, device=X.device)
    if B:
        cuda_build.launch(
            "curve_helpers", f"lh_to_affine_g{w}", f"to_affine_g{w}", *pt, B, x, y, inf
        )
    return x, y, inf.to(torch.bool)
