"""Device data plane of batched KZG proof verification.

The port of `lighthouse_tpu/ops/kzg_verify.py`: N blob proof checks fold
into ONE two-pair multi-pairing through per-proof RLC scalars r_i,

    e( sum_i r_i C_i + sum_i [r_i z_i] W_i - [sum_i r_i y_i] G1,  G2 )
      * e( -sum_i r_i W_i,  [tau]G2 )  ==  1.

Every scalar-multiplied point of the identity goes through ONE launch of
K1's window body at 255 bits (64 windows), and ONE launch of the lane fold
gives both G1 points of the pairs. The lanes are four segments of b lanes,
b a power of two >= N + 1 (`lane_sum` folds power-of-two segments):

    [0, b)    : C_i with scalar r_i; lane N: G1 with -(sum_i r_i y_i) mod r
    [b, 2b)   : W_i with scalar r_i z_i mod r
    [2b, 3b)  : -W_i with scalar r_i (negated on the host while packing)
    [3b, 4b)  : the identity

so `lane_sum(seg=2b)` leaves lane 0 = the left pair's G1 point and lane 1
= -sum_i r_i W_i, the right pair's. The reference adds the auxiliary point
[-sum_i r_i y_i] G1, computed on the host, after its ladder; here it is one
more lane of the ladder, the same point. Then `to_affine` over the two
lanes, K2 at two pairs against (the G2 generator, [tau]G2) and K3's fold
entry. Masked lanes and padding ride as the identity, exact under
e(inf, .) == 1; the complete RCB formulas need the r-torsion precondition,
which the host's subgroup check at decompression gives.

Inputs are batch-leading kernel words as in `ops/batch_verify.py`: G1
affine Montgomery (4b, 1, 12) x and y, the lane mask (4b,), window-major
signed digits (64, 4b); [tau]G2 affine Montgomery (2, 12) x and y. Every
step runs where its tensors are: CUDA tensors launch the kernels, CPU
tensors run the plain versions.
"""

import torch

from lighthouse_tpu_torch.crypto.constants import G2_X, G2_Y
from lighthouse_tpu_torch.ops import batch_verify as bv
from lighthouse_tpu_torch.ops import curve_kernels, final_exp, miller
from lighthouse_tpu_torch.ops import field as fd, msm
from lighthouse_tpu_torch.ops import ladder as k1

# the G2 generator, affine Montgomery words (2, 12): the static right side
# of the first pair
G2_GEN_AFFINE = (fd.mont_words(G2_X), fd.mont_words(G2_Y))


def pair_points(pts_x, pts_y, lane_mask, mags, negs, device="cuda"):
    """The two G1 points of the pairs, affine (x, y, is_identity), each
    (1, 12, 2): lane 0 the left pair's, lane 1 -sum_i r_i W_i."""
    n = pts_x.shape[0]
    if n % 4 or (n // 4) & (n // 4 - 1):
        raise ValueError(f"kzg_verify: {n} lanes, expected four power-of-two segments")
    pts = bv._from_affine(bv._lanes(pts_x, device), bv._lanes(pts_y, device),
                          bv._mask(lane_mask, device))
    lanes = k1.ladder(pts, *msm.digit_tensors(mags, negs, device))
    return curve_kernels.to_affine(curve_kernels.lane_sum(lanes, n // 2))


def verify_kzg_proof_batch(pts_x, pts_y, lane_mask, mags, negs, tau_g2, device="cuda"):
    """0-d bool tensor: the folded batch identity over the lane layout of
    the module doc holds. tau_g2 = (x, y) of [tau]G2, each (2, 12) affine
    Montgomery words."""
    x, y, inf = pair_points(pts_x, pts_y, lane_mask, mags, negs, device)
    dev = x.device
    g2 = tuple(
        torch.stack([fd.matrix(gen, dev), torch.as_tensor(tau, device=dev)], dim=-1)
        for gen, tau in zip(G2_GEN_AFFINE, tau_g2)
    )
    f = miller.miller_loop((x, y), g2, ~inf)
    _, ok = final_exp.fold_final_exp(f)
    return ok
