"""Batched device multi-scalar multiplication (MSM) for BLS12-381 G1.

The port of `lighthouse_tpu/ops/msm.py`. The KZG producer path (blob ->
commitment, opening proofs) is one MSM a blob and one a proof:
C = sum_i [s_i] P_i over up to 4,096 points. Both forms return ONE
projective G1 point as kernel words (1, 12, 1); callers convert it with
`curve_kernels.to_affine`.

* **fixed base** (`msm_fixed_base`): the trusted setup's points are
  static, so their signed digit multiples [d] P_i, d in [-8, 8], are packed
  once a device (`pack_fixed_table`: 17 projective entries a point, the
  negative ones with Y negated, invalid rows the identity). A window's
  signed digits then select their entries by tensor indexing alone, with
  no field arithmetic in PyTorch; the W x N selected lanes (64 x 4,096 at
  mainnet width) fold to the W window sums T_w with `lane_sum(seg=N)`, and
  the Horner combine sum_w [2^(4w)] T_w is K1's window body on W lanes --
  lane w has the one digit 1 in window w -- then `lane_sum(seg=W)`. The
  reference scans the windows with an XLA graph of doublings and additions.

* **variable base** (`msm_variable`): arbitrary points. K1's window body
  on the N points with their own 255-bit digits, then `lane_sum(seg=N)`:
  the same sum as the reference's masked bucket folds (`msm_pippenger`),
  ~320 group operations a lane against its W * B = 512.

Digits are window-major signed base-16 digits of scalars < r
(`window_ladder.signed_digit_arrays(..., nbits=255)`, W = 64). Every step
runs where its tensors are: CUDA tensors launch the kernels, CPU tensors
run the plain versions.
"""

import torch

from lighthouse_tpu_torch.crypto.constants import P, R
from lighthouse_tpu_torch.ops import batch_verify as bv
from lighthouse_tpu_torch.ops import curve_kernels, field as fd
from lighthouse_tpu_torch.ops import ladder as k1
from lighthouse_tpu_torch.ops import window_ladder as wl

WINDOW_BITS = wl.WINDOW_BITS  # c; digits in [-2^(c-1), 2^(c-1)]
SCALAR_BITS = R.bit_length()  # 255
HALF = 1 << (WINDOW_BITS - 1)  # 8: the largest digit magnitude
ENTRIES = 2 * HALF + 1  # 17 table entries a point, d = -8 .. 8


def pack_fixed_table(rows, n_lanes: int):
    """Host: the setup's digit-multiple rows (`TrustedSetup.g1_window_table`:
    row i = (None, P_i, [2] P_i, ..., [8] P_i), affine int pairs, None the
    identity) -> (3, 12, 17, n_lanes) int32 projective Montgomery words,
    [coordinate][word][entry][lane]; entry e holds [e - 8] P_i, lanes past
    the rows are the identity (0 : 1 : 0)."""
    if any(len(r) != HALF + 1 for r in rows) or len(rows) > n_lanes:
        raise ValueError(f"pack_fixed_table: expected at most {n_lanes} rows of {HALF + 1}")
    xs, ys, zs = [], [], []
    for i in range(n_lanes):
        row = rows[i] if i < len(rows) else (None,) * (HALF + 1)
        for e in range(ENTRIES):
            d = e - HALF
            aff = row[abs(d)]
            x, y, z = (0, 1, 0) if aff is None else (aff[0], aff[1] if d > 0 else P - aff[1], 1)
            xs.append(x)
            ys.append(y)
            zs.append(z)
    words = fd.mont_words(xs + ys + zs).reshape(3, n_lanes, ENTRIES, fd.NW)
    return words.transpose(0, 3, 2, 1).copy()


def select_fixed(table, mags, negs):
    """The entries that a window's digits select, lane w * N + i holding
    [d_{w,i}] P_i: projective (X, Y, Z), each (1, 12, W * N). table is
    `pack_fixed_table`'s on the digits' device, mags and negs (W, N)."""
    mags = torch.as_tensor(mags, device=table.device).to(torch.int64)
    negs = torch.as_tensor(negs, device=table.device).to(torch.bool)
    W, N = mags.shape
    if table.shape != (3, fd.NW, ENTRIES, N):
        raise ValueError(f"select_fixed: table {tuple(table.shape)} for {N} lanes")
    idx = torch.where(negs, -mags, mags) + HALF
    sel = torch.gather(table, 2, idx.expand(3, fd.NW, W, N))
    return tuple(sel[c].reshape(1, fd.NW, W * N) for c in range(3))


def digit_tensors(mags, negs, device):
    """K1's window operands on `device`: int32 magnitudes and signs."""
    return tuple(torch.as_tensor(a, device=device).to(torch.int32).contiguous()
                 for a in (mags, negs))


def horner_digits(W: int, device):
    """K1's digits for sum_w [2^(4w)] T_w on W lanes: the one digit 1 of
    lane w in window w, (W, W) magnitudes and signs."""
    mags = torch.eye(W, dtype=torch.int32, device=device)
    return mags, torch.zeros_like(mags)


def msm_fixed_base(table, mags, negs):
    """Fixed-base MSM over a packed table (`pack_fixed_table`, N lanes, a
    power of two) with the scalars' digits mags and negs (W, N): one
    projective point (1, 12, 1)."""
    lanes = select_fixed(table, mags, negs)
    W, N = mags.shape
    windows = curve_kernels.lane_sum(lanes, N)
    acc = k1.ladder(windows, *horner_digits(W, table.device))
    return curve_kernels.lane_sum(acc, W)


def msm_variable(pts_x, pts_y, valid, mags, negs, device="cuda"):
    """Variable-base MSM: pts_x / pts_y (N, 1, 12) affine Montgomery words,
    valid (N,) bool (False = the identity), digits mags and negs (W, N); N
    a power of two. One projective point (1, 12, 1)."""
    pts = bv._from_affine(bv._lanes(pts_x, device), bv._lanes(pts_y, device),
                          bv._mask(valid, device))
    acc = k1.ladder(pts, *digit_tensors(mags, negs, device))
    return curve_kernels.lane_sum(acc, acc[0].shape[-1])
