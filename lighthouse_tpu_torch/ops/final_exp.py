"""K3: product fold + final exponentiation -- wrapper and plain version.

Replaces the TPU kernel `lighthouse_tpu/ops/pallas_tail.py` `_kernel`
(with the XLA lane fold that `fold_final_exp_pallas` puts in front of it).
The CUDA source is `lighthouse_tpu_torch/csrc/final_exp.cu`; the plain
version is the port of `tfexp.fold_lanes` + `tfexp.final_exponentiation_t`.

Operands are kernel words: the per-pair Miller values f (12, 12, B) in; the
final-exponentiated product (12, 12, 1) and the verdict (value == 1) out.
"""

import torch

from lighthouse_tpu_torch.ops import cuda_build, field as fd
from lighthouse_tpu_torch.ops import tfexp


def is_one(value):
    """(12, 12, 1) words -> bool tensor: the Fp12 value equals 1."""
    one = torch.zeros_like(value)
    one[0, :, 0] = torch.tensor(fd.mont_words([1])[0], device=value.device)
    return (value == one).all()


def fold_final_exp_plain(f):
    res = tfexp.final_exponentiation_t(tfexp.fold_lanes(fd.words_to_bundle(f)))
    value = fd.bundle_to_words(res)
    return value, is_one(value)


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
