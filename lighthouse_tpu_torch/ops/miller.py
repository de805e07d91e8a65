"""K2: the batched Miller loop -- wrapper and plain version.

Replaces the TPU kernel `lighthouse_tpu/ops/pallas_miller.py` `_kernel`.
The CUDA source is `lighthouse_tpu_torch/csrc/miller.cu`; the plain version
is the port of `tpairing.miller_loop_t` (`ops/tpairing.py`).

Operands are kernel words: px, py (1, 12, B); qx, qy (2, 12, B); the pair
mask (B,); the result f is (12, 12, B), 1 for masked pairs.
"""

import torch

from lighthouse_tpu_torch.ops import cuda_build, field as fd
from lighthouse_tpu_torch.ops import tpairing as tp


def miller_loop_plain(p, q, mask):
    f = tp.miller_loop_t(
        tuple(fd.words_to_bundle(c) for c in p),
        tuple(fd.words_to_bundle(c) for c in q),
        mask.to(torch.bool),
    )
    return fd.bundle_to_words(f)


def miller_loop(p, q, mask, require_kernel: bool = False):
    """Per-pair Miller loop values. CUDA tensors launch K2, CPU tensors run
    `miller_loop_plain`."""
    px, py = p
    qx, qy = q
    if not cuda_build.use_kernel(qx, require_kernel):
        return miller_loop_plain(p, q, mask)
    B = qx.shape[-1]
    dev = qx.device
    cuda_build.check(px, "px", (1, fd.NW, B), dev)
    cuda_build.check(py, "py", (1, fd.NW, B), dev)
    cuda_build.check(qx, "qx", (2, fd.NW, B), dev)
    cuda_build.check(qy, "qy", (2, fd.NW, B), dev)
    mask = mask.to(torch.int32).contiguous()
    cuda_build.check(mask, "mask", (B,), dev)
    f = torch.empty((12, fd.NW, B), dtype=torch.int32, device=dev)
    if B:
        cuda_build.launch("miller", "lh_miller", "miller", px, py, qx, qy, mask, B, f)
    return f
