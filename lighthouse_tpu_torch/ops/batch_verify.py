"""Device data plane of batched BLS signature-set verification.

The port of `lighthouse_tpu/ops/batch_verify.py`'s Pallas variants: S
signature sets -- a message point H(m) in G2, a signature in G2 and up to K
public keys in G1 -- checked with ONE multi-pairing over a random linear
combination (RLC) of the sets:

    prod_i e(r_i * agg_pk_i, H_i) * e(-G1, sum_i r_i * sig_i) == 1

The flat layout pairs every set with its own message (S + 1 Miller loops);
the grouped layout merges the sets that share a message (G + 1 Miller
loops: prod_g e(sum_{i in g} r_i * agg_pk_i, H_g)). On each path:

    key aggregation (lane_sum over K) -> K1 ladder on G1 -> [group fold] ->
    to_affine ; K1 ladder on G2 -> lane fold -> to_affine ;
    pair assembly -> K2 Miller loop -> K3 fold + final exponentiation

Inputs are batch-leading kernel words, shaped like the JAX functions'
bundles with 12 words in place of 33 limbs: G2 affine (..., 2, 12), G1
affine (..., 1, 12), masks bool, RLC bits (..., 64) int LSB first. Every
step runs where its tensors are: CUDA tensors launch the kernels, CPU
tensors run the plain versions.

Pair masks follow `_assemble_pairs`: a set whose RLC'd aggregate key is the
identity is masked (e(inf, H) == 1); padding sets enter as the identity and
pass; a forged signature still breaks the product through the signature
pair.
"""

import numpy as np
import torch

from lighthouse_tpu_torch.crypto.constants import G1_X, G1_Y, P
from lighthouse_tpu_torch.ops import curve_kernels, field as fd
from lighthouse_tpu_torch.ops import final_exp, ladder, miller
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


def _digits(rand_bits, device):
    """(..., 64) RLC bits -> window-major int32 digits (W, N)."""
    bits = torch.as_tensor(rand_bits, device=device).reshape(-1, RAND_BITS)
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


def _signature_side(sigs, set_mask, mags, negs, device):
    """sum_i r_i * sig_i as an affine point (x, y, is_identity)."""
    sig = _from_affine(_lanes(sigs[0], device), _lanes(sigs[1], device), set_mask)
    sig_r = ladder.ladder(sig, mags, negs)
    acc = curve_kernels.lane_sum(sig_r, _pow2(sig_r[0].shape[-1], "signature lanes"))
    return curve_kernels.to_affine(acc)


def verify_signature_sets(msgs, sigs, pubkeys, key_mask, rand_bits, set_mask, device="cuda"):
    """Flat layout: msgs/sigs (S, 2, 12) x and y, pubkeys (S, K, 1, 12) x and
    y, key_mask (S, K), rand_bits (S, 64), set_mask (S,). S and K powers of
    two. Returns a bool tensor: True iff every real set verifies."""
    S, K = np.shape(key_mask)
    km = _mask(key_mask, device)
    sm = _mask(set_mask, device)
    mags, negs = _digits(rand_bits, device)
    # per-set aggregate over the K key lanes s*K + k, then the G1 ladder
    pk = _from_affine(_lanes(pubkeys[0], device), _lanes(pubkeys[1], device), km)
    agg = curve_kernels.lane_sum(pk, _pow2(K, "K"))
    pk_aff = curve_kernels.to_affine(ladder.ladder(agg, mags, negs))
    sig_aff = _signature_side(sigs, sm, mags, negs, device)
    g1, g2, mask = _assemble_pairs(
        _lanes(msgs[0], device), _lanes(msgs[1], device), sm, pk_aff, sig_aff
    )
    return _verdict(g1, g2, mask)


def verify_signature_sets_grouped(
    group_msgs, sigs, pubkeys, key_mask, rand_bits, set_mask, group_mask, device="cuda"
):
    """Message-grouped layout: group_msgs (G, 2, 12), sigs (G, Sg, 2, 12),
    pubkeys (G, Sg, K, 1, 12), key_mask (G, Sg, K), rand_bits (G, Sg, 64),
    set_mask (G, Sg), group_mask (G,); G, Sg and K powers of two."""
    G, Sg, K = np.shape(key_mask)
    km = _mask(key_mask, device)
    sm = _mask(set_mask, device)
    gm = _mask(group_mask, device)
    mags, negs = _digits(rand_bits, device)
    pk = _from_affine(_lanes(pubkeys[0], device), _lanes(pubkeys[1], device), km)
    agg = curve_kernels.lane_sum(pk, _pow2(K, "K"))
    pk_r = ladder.ladder(agg, mags, negs)
    # fold each group's RLC'd keys into one point per message
    grp = curve_kernels.lane_sum(pk_r, _pow2(Sg, "Sg"))
    pk_aff = curve_kernels.to_affine(grp)
    sig_aff = _signature_side(sigs, sm, mags, negs, device)
    g1, g2, mask = _assemble_pairs(
        _lanes(group_msgs[0], device), _lanes(group_msgs[1], device), gm, pk_aff, sig_aff
    )
    return _verdict(g1, g2, mask)
