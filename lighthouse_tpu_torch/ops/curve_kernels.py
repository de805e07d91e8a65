"""Helper kernels around the ladders: the projective lane-sum fold, the
batched projective -> affine conversion and its Jacobian entry for points
as the host holds them, with their plain versions.

On the TPU these steps are XLA outside any Pallas kernel
(`lighthouse_tpu/ops/curve.py` `_tree_fold_sum` / `to_affine` +
`inv_batched`, `ops/tcurve.py` `sum_lanes`), and the Jacobian conversion
is host Python (`bls/tpu_backend.py` `batch_to_affine_g2` +
`_pack_g2_affine`). The CUDA source is
`lighthouse_tpu_torch/csrc/curve_helpers.cu`. Operands are kernel words
(w, 12, B), as in `ops/ladder.py`.
"""

import torch

from lighthouse_tpu_torch.ops import cuda_build, curve, field as fd

# levels of the halving tree a launch of the fold takes at most: a block
# holds 2^8 points, and the last launch folds at most 2^7 a segment
FOLD_LEVELS = 8
LAST_FOLD_LEVELS = 7
FOLD_POINTS = 1 << FOLD_LEVELS  # csrc/curve_helpers.cu SUM_POINTS
AFFINE_LANES = 256  # csrc/curve_helpers.cu AFF_LANES: the leaves of a block's tree


def fold_shared_bytes(w: int) -> int:
    """Dynamic shared memory of a fold block (csrc/curve_helpers.cu
    `Fold<W>::BYTES`): its points, 3w Fp slots each, and the Fp products of
    its first level's additions, 6 Fp^w products each; 48 bytes a slot."""
    k = 1 if w == 1 else 3
    return (FOLD_POINTS * 3 * w + (FOLD_POINTS // 2) * 6 * k) * fd.NW * 4


def affine_products(w: int, jacobian: bool, B: int) -> int:
    """Fp products the to-affine kernel runs on B lanes, the count behind
    its bound: per lane the entry into Montgomery form (3w, Jacobian entry),
    Z's norm (2, G2), 1 / Z from the norm's inverse (2, G2) and the output
    products (2 Fp^w products, 4 for the Jacobian entry's Z^-2 and Z^-3;
    Karatsuba's 3 Fp products on G2); per block of 256 lanes the product
    tree, 255 products up and 510 down, and one product after the root's
    inversion, whose steps are shifts and additions."""
    k = 1 if w == 1 else 3
    per_lane = (3 * w if jacobian else 0) + (4 if w == 2 else 0) + (4 if jacobian else 2) * k
    blocks = -(-B // AFFINE_LANES)
    return B * per_lane + blocks * (3 * (AFFINE_LANES - 1) + 1)


def lane_sum_plain(pt, seg: int):
    group = curve.group(pt[0].shape[0])
    bundles = tuple(fd.words_to_bundle(c) for c in pt)
    return tuple(fd.bundle_to_words(c) for c in group.sum_lanes(bundles, seg))


def fold_plan(seg: int) -> list:
    """The levels of each launch that folds segments of `seg` lanes: the
    last takes up to 7, those before it up to 8 each (two launches up to
    2^15 lanes a segment)."""
    levels = seg.bit_length() - 1
    last = min(levels, LAST_FOLD_LEVELS)
    rest = levels - last
    plan = ([rest % FOLD_LEVELS] if rest % FOLD_LEVELS else []) + [FOLD_LEVELS] * (rest // FOLD_LEVELS)
    return plan + ([last] if last else [])


def lane_sum(pt, seg: int, require_kernel: bool = False):
    """Sum every run of `seg` consecutive lanes (a power of two dividing B)
    to one point: (w, 12, B) -> (w, 12, B / seg), by the halving tree of
    `Projective.sum_lanes` (projective words equal). One launch for each
    entry of `fold_plan(seg)`."""
    X = pt[0]
    if seg < 1 or seg & (seg - 1) or X.shape[-1] % seg:
        raise ValueError(f"lane_sum: segment {seg} must be a power of two dividing {X.shape[-1]}")
    if not cuda_build.use_kernel(X, require_kernel):
        return lane_sum_plain(pt, seg)
    w, _, B = X.shape
    for name, c in zip("XYZ", pt):
        cuda_build.check(c, name, (w, fd.NW, B), X.device)
    for L in fold_plan(seg):
        out = tuple(
            torch.empty((w, fd.NW, B >> L), dtype=torch.int32, device=X.device)
            for _ in range(3)
        )
        cuda_build.launch(
            "curve_helpers", f"lh_lane_fold_g{w}", f"lane_sum_g{w}", *pt, B, seg, L, *out,
        )
        pt, B, seg = out, B >> L, seg >> L
    return pt


def to_affine_plain(pt):
    group = curve.group(pt[0].shape[0])
    x, y, inf = group.to_affine(tuple(fd.words_to_bundle(c) for c in pt))
    return fd.bundle_to_words(x), fd.bundle_to_words(y), inf


def jacobian_to_affine_plain(pt):
    group = curve.group(pt[0].shape[0])
    x, y, inf = group.jacobian_to_affine(tuple(fd.words_to_bundle(c) for c in pt))
    return fd.bundle_to_words(x), fd.bundle_to_words(y), inf


def _affine(pt, entry: str, plain, require_kernel: bool):
    X = pt[0]
    if not cuda_build.use_kernel(X, require_kernel):
        return plain(pt)
    w, _, B = X.shape
    for name, c in zip("XYZ", pt):
        cuda_build.check(c, name, (w, fd.NW, B), X.device)
    x = torch.empty_like(X)
    y = torch.empty_like(X)
    inf = torch.empty((B,), dtype=torch.int32, device=X.device)
    if B:
        cuda_build.launch("curve_helpers", f"lh_{entry}_g{w}", f"{entry}_g{w}", *pt, B, x, y, inf)
    return x, y, inf.to(torch.bool)


def to_affine(pt, require_kernel: bool = False):
    """Projective (X, Y, Z), Montgomery words -> (x, y, is_identity): x =
    X/Z, y = Y/Z per lane, the identity as (0, 0) with its flag set."""
    return _affine(pt, "to_affine", to_affine_plain, require_kernel)


def jacobian_to_affine(pt, require_kernel: bool = False):
    """Jacobian (X, Y, Z) as plain canonical words, the host's coordinates
    (`fd.ints_to_words`, not Montgomery) -> (x, y, is_identity) as
    Montgomery words: x = X/Z^2, y = Y/Z^3; Z = 0 (a padding lane) maps to
    (0, 0) with its flag set."""
    return _affine(pt, "jacobian_to_affine", jacobian_to_affine_plain, require_kernel)
