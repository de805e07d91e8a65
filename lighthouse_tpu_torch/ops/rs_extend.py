"""Reed-Solomon blob extension on the card: batched Fr polynomial evaluation.

The port of `lighthouse_tpu/ops/rs_extend.py`. PeerDAS-shaped data
availability extends each blob polynomial (n Fr coefficients, kept in
coefficient form, see `kzg.api.blob_to_polynomial`) to 2n evaluations over
the 2n-th roots of unity, so that any n of them determine the polynomial.
The work is one Horner chain for every (point, blob) pair,

    acc[p, b] <- acc[p, b] x[p] 2^-256 + coeff[i, b]      (i = n-1 .. 0),

which the CUDA kernel `csrc/rs_extend.cu` runs (replacing the reference's
XLA `eval_poly_batch`), each pair's chain split into S segments of the
coefficient axis on S lanes and combined by a second Horner in y = x^L
(`rfield.split_eval_words` models it). CUDA tensors launch it, CPU tensors
run `eval_poly_batch_plain`.

Words, as in `ops/rfield.py`: coeffs (N_COEFF, BLOBS, 8), points (PTS, 8),
the result (PTS, BLOBS, 8), all int32 tensors of canonical words -- the
reference's shapes with its limb axis of 23 replaced by 8 words. With the
points in Montgomery form a chain's Montgomery product x 2^-256 multiplies
by the plain point, so the result is in the coefficients' domain:
Montgomery coefficients give the reference's Montgomery evaluations, plain
coefficients plain ones (what `da/gpu_backend.py` uploads: the extension
never converts a coefficient). `rs_extend_graph` is the reference's
evaluate-then-leave-Montgomery graph, the kernel's `plain_out` form: one
more product, by 1, at the end of every chain.
"""

import ctypes

import torch

from lighthouse_tpu_torch.ops import cuda_build
from lighthouse_tpu_torch.ops import rfield as rf

NW = rf.NW
THREADS = 128  # csrc/rs_extend.cu: a block, 128 / S points of one blob


def horner_products(n_coeff: int, pts: int, blobs: int) -> int:
    """Fr products of the chains: one a step, every (point, blob) pair."""
    return n_coeff * pts * blobs


def split_products(n_coeff: int, pts: int, blobs: int, segments: int) -> int:
    """Fr products the split adds to the function's `horner_products`, over
    all lanes: every lane of a chain runs the squarings and products of
    y = x^L and the S - 1 combine steps, and the S L steps of the segments
    exceed n_coeff by the top segment's leading zeros."""
    if segments == 1:
        return 0
    L = rf.split_length(n_coeff, segments)
    per_lane = L.bit_length() - 1 + bin(L).count("1") - 1 + segments - 1
    return pts * blobs * (segments * per_lane + segments * L - n_coeff)


def plan(n_coeff: int, blobs: int, pts: int, device) -> dict:
    """The kernel's launch plan on `device`, as its C entry makes it
    (`lh_rs_extend_plan`): the segments S (4 or 8), the resident blocks an
    SM that the CUDA runtime reports, the SMs, the blocks, the segment
    length L and the waves."""
    out = (ctypes.c_int * 6)()
    with torch.cuda.device(device):
        rc = cuda_build.library("rs_extend").lh_rs_extend_plan(
            n_coeff, blobs, pts, ctypes.addressof(out), None)
    if rc != 0:
        raise RuntimeError(f"lh_rs_extend_plan: CUDA error {rc}")
    S, per_sm, sms, _, blocks, L = list(out)
    return {"segments": S, "threads": THREADS, "blocks_per_sm": per_sm, "sms": sms,
            "blocks": blocks, "segment_length": L, "waves": blocks / (per_sm * sms)}


def horner_bytes(n_coeff: int, pts: int, blobs: int) -> int:
    """Bytes the extension must move: each coefficient and point read
    once, each evaluation written once."""
    return 4 * NW * (n_coeff * blobs + pts + pts * blobs)


def eval_poly_batch_plain(coeffs, points, plain_out: bool = False):
    """The kernel's function on any device, step by step on 16-bit digits
    (`rfield._mont_digits`). The accumulator is never reduced inside the
    loop: 17 relaxed digits whose value stays below 3.7r (a product maps
    a value below k r to one below 0.4534 k r + 1.01 r, and the coefficient
    adds r, so k stays below 2.01 / (1 - 0.4534)); one canonicalisation
    ends it."""
    n_coeff, n_blobs = int(coeffs.shape[0]), int(coeffs.shape[1])
    n_pts = int(points.shape[0])
    x = rf._digits(points)[:, None, :]
    c = rf._digits(coeffs)
    acc = torch.zeros((n_pts, n_blobs, rf.ND + 1), dtype=torch.int64, device=coeffs.device)
    for i in range(n_coeff - 1, -1, -1):
        acc = rf._mont_digits(acc, x)
        acc[..., : rf.ND] += c[i]
    if plain_out:
        acc = rf._mont_digits(acc, rf._const("one", acc.device))
    return rf._words(rf._canon(acc))


def eval_poly_batch(coeffs, points, plain_out: bool = False, require_kernel: bool = False):
    """(PTS, BLOBS, 8) canonical words: CUDA tensors launch the Horner
    kernel, CPU tensors run `eval_poly_batch_plain`."""
    if not cuda_build.use_kernel(coeffs, require_kernel):
        return eval_poly_batch_plain(coeffs, points, plain_out)
    n_coeff, n_blobs = int(coeffs.shape[0]), int(coeffs.shape[1])
    n_pts = int(points.shape[0])
    dev = coeffs.device
    cuda_build.check(coeffs, "coeffs", (n_coeff, n_blobs, NW), dev)
    cuda_build.check(points, "points", (n_pts, NW), dev)
    for name, t in (("coeffs", coeffs), ("points", points)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: the kernel reads 16-byte aligned rows")
    if n_coeff == 0:
        return torch.zeros((n_pts, n_blobs, NW), dtype=torch.int32, device=dev)
    out = torch.empty((n_pts, n_blobs, NW), dtype=torch.int32, device=dev)
    if n_pts and n_blobs:
        cuda_build.launch("rs_extend", "lh_rs_extend", "rs_extend", coeffs, points,
                          n_coeff, n_blobs, n_pts, int(plain_out), out)
    return out


def rs_extend_graph(coeffs, points, require_kernel: bool = False):
    """The reference's full graph: Montgomery coefficients and points ->
    (PTS, BLOBS, 8) plain canonical evaluations."""
    return eval_poly_batch(coeffs, points, plain_out=True, require_kernel=require_kernel)
