"""Device data plane of batched BLS signature-set verification.

The port of `lighthouse_tpu/ops/batch_verify.py`'s Pallas variants: S
signature sets -- a message point H(m) in G2, a signature in G2 and up to K
public keys in G1 -- checked with ONE multi-pairing over a random linear
combination (RLC) of the sets:

    prod_i e(r_i * agg_pk_i, H_i) * e(-G1, sum_i r_i * sig_i) == 1

The flat layout pairs every set with its own message (S + 1 Miller loops);
the grouped layout merges the sets that share a message (G + 1 Miller
loops: prod_g e(sum_{i in g} r_i * agg_pk_i, H_g)). On each path:

    [keys to affine] -> key aggregation (lane_sum over K) -> K1 ladder on
    G1 -> [group fold] -> to_affine ; signatures to affine -> K1 ladder on
    G2 -> lane fold -> to_affine ; pair assembly -> K2 Miller loop -> K3
    fold + final exponentiation

Inputs are batch-leading kernel words, shaped like the JAX functions'
bundles with 12 words in place of 33 limbs: G2 (..., 2, 12), G1 (..., 1,
12), masks bool, RLC bits (..., 64) int LSB first. Messages are affine
(x, y) Montgomery words. Signatures and pubkeys are either that, or
Jacobian (X, Y, Z) plain canonical words as the host holds them (the
gpu backend's signatures, and its pubkeys outside a table), which
`curve_kernels.jacobian_to_affine` turns into the affine words of the JAX
functions' inputs (`tpu_backend.batch_to_affine_g2` + `_pack_g2_affine`)
before K1 or K2. Every step runs where its tensors are: CUDA tensors
launch the kernels, CPU tensors run the plain versions.

Pair masks follow `_assemble_pairs`: a set whose RLC'd aggregate key is the
identity is masked (e(inf, H) == 1); padding sets enter as the identity and
pass; a forged signature still breaks the product through the signature
pair.

`ladder` picks K1's body for both RLC ladders ("window", the default;
"chain" and "w2", the A/B forms of `pallas_ladder.ladder_pallas`); the
bodies reach the same points by different projective representatives, so
the affine points and the verdict do not depend on it.

`verify_signature_sets_individual` is the per-set fallback after a failed
batch: no RLC and no ladder, 2 S Miller pairs (agg_pk_i, H_i) and
(-G1, sig_i), then K3's per-set entry -- one verdict per set in one device
call.
"""

import numpy as np
import torch

from lighthouse_tpu_torch.crypto.constants import G1_X, G1_Y, P
from lighthouse_tpu_torch.ops import curve_kernels, field as fd
from lighthouse_tpu_torch.ops import final_exp, miller
from lighthouse_tpu_torch.ops import ladder as k1
from lighthouse_tpu_torch.ops import window_ladder as wl

NW = fd.NW
RAND_BITS = 64  # >= 64-bit RLC scalars, as the reference

# -G1 generator, affine Montgomery words (the signature pair's G1 side)
NEG_G1_AFFINE = (fd.mont_words([G1_X])[0], fd.mont_words([(P - G1_Y) % P])[0])


def _lanes(c, device):
    """Batch-leading (..., w, 12) words -> batch-last (w, 12, N)."""
    c = torch.as_tensor(c, device=device)
    w = c.shape[-2]
    return c.reshape(-1, w, NW).permute(1, 2, 0).contiguous()


def _mask(m, device):
    return torch.as_tensor(m, device=device).reshape(-1).to(torch.bool)


def _affine(pt, device):
    """Affine Montgomery lanes (x, y) (w, 12, N): the (x, y) words as they
    are, or the Jacobian plain words (X, Y, Z) converted on `device`."""
    if len(pt) == 2:
        return tuple(_lanes(c, device) for c in pt)
    x, y, _ = curve_kernels.jacobian_to_affine(tuple(_lanes(c, device) for c in pt))
    return x, y


def _from_affine(x, y, valid):
    """Affine lanes + mask -> projective; masked lanes are the identity."""
    w, _, n = x.shape
    one = torch.zeros((w, NW, n), dtype=torch.int32, device=x.device)
    one[0] = torch.as_tensor(fd.mont_words([1])[0], device=x.device)[:, None]
    zero = torch.zeros_like(x)
    v = valid[None, None, :]
    return (
        torch.where(v, x, zero),
        torch.where(v, y, one),
        torch.where(v, one, zero),
    )


def _digits(rand_bits, device, form="window"):
    """(..., 64) RLC bits -> K1's operands for `form`: window-major int32
    digits (W, N) and signs (W, N) for "window", the (64, N) LSB-first bits
    for "chain" and "w2"."""
    bits = torch.as_tensor(rand_bits, device=device).reshape(-1, RAND_BITS)
    if form != "window":
        return (bits.t().to(torch.int32).contiguous(),)
    mags, negs = wl.recode_bits(bits)
    return mags.contiguous(), negs.to(torch.int32).contiguous()


def _pow2(n: int, what: str) -> int:
    if n < 1 or n & (n - 1):
        raise ValueError(f"{what} = {n}: the lane folds need a power of two")
    return n


def _assemble_pairs(msgs_x, msgs_y, set_mask, pk_aff, sig_aff):
    """The (n + 1)-pair multi-pairing inputs (batch_verify._assemble_pairs)."""
    pk_x, pk_y, pk_inf = pk_aff
    s_x, s_y, s_inf = sig_aff
    dev = pk_x.device
    ng = [torch.as_tensor(c, device=dev).reshape(1, NW, 1) for c in NEG_G1_AFFINE]
    g1 = (torch.cat([pk_x, ng[0]], dim=-1), torch.cat([pk_y, ng[1]], dim=-1))
    g2 = (torch.cat([msgs_x, s_x], dim=-1), torch.cat([msgs_y, s_y], dim=-1))
    mask = torch.cat([set_mask & ~pk_inf, ~s_inf])
    return g1, g2, mask


def _verdict(g1, g2, mask):
    f = miller.miller_loop(g1, g2, mask)
    _, ok = final_exp.fold_final_exp(f)
    return ok


def _signature_side(sigs, set_mask, digits, form, device):
    """sum_i r_i * sig_i as an affine point (x, y, is_identity)."""
    sig = _from_affine(*_affine(sigs, device), set_mask)
    sig_r = k1.ladder(sig, *digits, form=form)
    acc = curve_kernels.lane_sum(sig_r, _pow2(sig_r[0].shape[-1], "signature lanes"))
    return curve_kernels.to_affine(acc)


def _aggregate_keys(pubkeys, key_mask, device):
    """Per-set aggregate over the K key lanes s*K + k (K a power of two):
    projective (1, 12, S)."""
    K = np.shape(key_mask)[-1]
    km = _mask(key_mask, device)
    pk = _from_affine(*_affine(pubkeys, device), km)
    return curve_kernels.lane_sum(pk, _pow2(K, "K"))


def verify_signature_sets(
    msgs, sigs, pubkeys, key_mask, rand_bits, set_mask, device="cuda", ladder="window"
):
    """Flat layout: msgs (S, 2, 12) x and y, sigs (S, 2, 12) and pubkeys
    (S, K, 1, 12) x and y, or X, Y and Z (module doc), key_mask (S, K),
    rand_bits (S, 64), set_mask (S,). S and K powers of two. Returns a bool
    tensor: True iff every real set verifies."""
    sm = _mask(set_mask, device)
    digits = _digits(rand_bits, device, ladder)
    agg = _aggregate_keys(pubkeys, key_mask, device)
    pk_aff = curve_kernels.to_affine(k1.ladder(agg, *digits, form=ladder))
    sig_aff = _signature_side(sigs, sm, digits, ladder, device)
    g1, g2, mask = _assemble_pairs(
        _lanes(msgs[0], device), _lanes(msgs[1], device), sm, pk_aff, sig_aff
    )
    return _verdict(g1, g2, mask)


def verify_signature_sets_grouped(
    group_msgs, sigs, pubkeys, key_mask, rand_bits, set_mask, group_mask,
    device="cuda", ladder="window",
):
    """Message-grouped layout: group_msgs (G, 2, 12), sigs (G, Sg, 2, 12),
    pubkeys (G, Sg, K, 1, 12) (coordinates as in `verify_signature_sets`),
    key_mask (G, Sg, K), rand_bits (G, Sg, 64), set_mask (G, Sg),
    group_mask (G,); G, Sg and K powers of two."""
    Sg = np.shape(key_mask)[1]
    sm = _mask(set_mask, device)
    gm = _mask(group_mask, device)
    digits = _digits(rand_bits, device, ladder)
    pk_r = k1.ladder(_aggregate_keys(pubkeys, key_mask, device), *digits, form=ladder)
    # fold each group's RLC'd keys into one point per message
    grp = curve_kernels.lane_sum(pk_r, _pow2(Sg, "Sg"))
    pk_aff = curve_kernels.to_affine(grp)
    sig_aff = _signature_side(sigs, sm, digits, ladder, device)
    g1, g2, mask = _assemble_pairs(
        _lanes(group_msgs[0], device), _lanes(group_msgs[1], device), gm, pk_aff, sig_aff
    )
    return _verdict(g1, g2, mask)


def _individual_pairs(msgs, sigs, pubkeys, key_mask, set_mask, device):
    """The 2 S Miller pairs of the per-set check: (agg_pk_i, H_i) for
    i < S, then (-G1, sig_i); pair mask set_mask & ~pk_inf, then set_mask.
    Returns (g1, g2, pair mask, set mask)."""
    S = np.shape(key_mask)[0]
    sm = _mask(set_mask, device)
    pk_x, pk_y, pk_inf = curve_kernels.to_affine(_aggregate_keys(pubkeys, key_mask, device))
    dev = pk_x.device
    ng = [torch.as_tensor(c, device=dev).reshape(1, NW, 1).expand(1, NW, S) for c in NEG_G1_AFFINE]
    g1 = (torch.cat([pk_x, ng[0]], dim=-1), torch.cat([pk_y, ng[1]], dim=-1))
    s_x, s_y = _affine(sigs, device)
    g2 = (
        torch.cat([_lanes(msgs[0], device), s_x], dim=-1),
        torch.cat([_lanes(msgs[1], device), s_y], dim=-1),
    )
    # e(inf, .) == 1 exactly; a padding set contributes 1 to both its pairs
    return g1, g2, torch.cat([sm & ~pk_inf, sm]), sm


def verify_signature_sets_individual(msgs, sigs, pubkeys, key_mask, set_mask, device="cuda"):
    """Per-set verdicts in one device call (batch_verify.
    verify_signature_sets_individual): set i passes iff
    e(agg_pk_i, H_i) * e(-G1, sig_i) == 1. Flat inputs as in
    `verify_signature_sets` without the RLC bits; S any size, K a power of
    two. Returns (S,) bool, padding sets True."""
    g1, g2, mask, sm = _individual_pairs(msgs, sigs, pubkeys, key_mask, set_mask, device)
    _, ok = final_exp.pair_final_exp(miller.miller_loop(g1, g2, mask))
    return ok | ~sm
