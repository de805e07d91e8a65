"""K3: final exponentiation, two entries -- wrappers and plain versions.

Replaces the TPU kernel `lighthouse_tpu/ops/pallas_tail.py` `_kernel`.
The CUDA source is `lighthouse_tpu_torch/csrc/final_exp.cu`.

  `fold_final_exp` -- the batch verdict: the product fold of the per-pair
      Miller values (the XLA lane fold that `fold_final_exp_pallas` puts in
      front of the kernel), then one exponentiation; plain version the port
      of `tfexp.fold_lanes` + `tfexp.final_exponentiation_t`.
  `pair_final_exp` -- per-set verdicts: set i's Miller values f[i] and
      f[S + i] multiplied and exponentiated, one value and verdict per set;
      plain version the port of the JAX per-set tail
      (`batch_verify.verify_signature_sets_individual`: `tower.fp12_mul`
      then `pairing.final_exponentiation`, the same exponent).

Operands are kernel words: Miller values f (12, 12, B) in; final-
exponentiated values (12, 12, 1) or (12, 12, S) and verdicts (value == 1)
out.
"""

import torch

from lighthouse_tpu_torch.ops import cuda_build, field as fd
from lighthouse_tpu_torch.ops import tfexp, tpairing as tp


def is_one(value):
    """(12, 12, B) words -> (B,) bool tensor: each Fp12 value equals 1."""
    one = torch.zeros_like(value)
    one[0] = torch.tensor(fd.mont_words([1])[0], device=value.device)[:, None]
    return (value == one).all(dim=0).all(dim=0)


def fold_final_exp_plain(f):
    res = tfexp.final_exponentiation_t(tfexp.fold_lanes(fd.words_to_bundle(f)))
    value = fd.bundle_to_words(res)
    return value, is_one(value)[0]


def fold_final_exp(f, require_kernel: bool = False):
    """(value, verdict) of prod_i f_i ^ (3 (p^12 - 1) / r). CUDA tensors
    launch K3, CPU tensors run `fold_final_exp_plain`."""
    if not cuda_build.use_kernel(f, require_kernel):
        return fold_final_exp_plain(f)
    B = f.shape[-1]
    if B < 1:
        raise ValueError("fold_final_exp: no Miller values")
    cuda_build.check(f, "f", (12, fd.NW, B))
    scratch = torch.empty((2, 12, fd.NW, B), dtype=torch.int32, device=f.device)
    value = torch.empty((12, fd.NW, 1), dtype=torch.int32, device=f.device)
    verdict = torch.empty((1,), dtype=torch.int32, device=f.device)
    cuda_build.launch(
        "final_exp", "lh_fold_final_exp", "fold_final_exp",
        f, B, scratch[0], scratch[1], value, verdict,
    )
    return value, verdict[0] == 1


def _split(f):
    B = f.shape[-1]
    if B < 2 or B % 2:
        raise ValueError(f"pair_final_exp: {B} Miller values, expected 2 S")
    return B // 2


def pair_final_exp_plain(f):
    S = _split(f)
    b = fd.words_to_bundle(f)
    res = tfexp.final_exponentiation_t(tp.fp12_mul(b[..., :S], b[..., S:]))
    value = fd.bundle_to_words(res)
    return value, is_one(value)


def pair_final_exp(f, require_kernel: bool = False):
    """(values (12, 12, S), verdicts (S,) bool) of (f_i f_{S+i}) ^
    (3 (p^12 - 1) / r) for the 2 S Miller values f. CUDA tensors launch
    K3's per-set entry, CPU tensors run `pair_final_exp_plain`."""
    if not cuda_build.use_kernel(f, require_kernel):
        return pair_final_exp_plain(f)
    S = _split(f)
    cuda_build.check(f, "f", (12, fd.NW, 2 * S))
    value = torch.empty((12, fd.NW, S), dtype=torch.int32, device=f.device)
    verdicts = torch.empty((S,), dtype=torch.int32, device=f.device)
    cuda_build.launch("final_exp", "lh_pair_final_exp", "pair_final_exp", f, S, value, verdicts)
    return value, verdicts == 1
