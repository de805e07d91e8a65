"""The G2 subgroup check: [r] P == O for each lane -- wrapper and plain
version.

Replaces `lighthouse_tpu/ops/batch_verify.py` `g2_points_in_subgroup`,
which is XLA on the TPU (a `lax.scan` over r's 255 bits, outside any
Pallas kernel). The CUDA source is `lighthouse_tpu_torch/csrc/subgroup.cu`:
four threads a lane, running the generated rows of `ops/subgroup_rows.py`.

The inputs are unchecked points -- gossip signatures before any check -- so
the ladder runs on the unified Jacobian group (`curve.Jacobian`, the port
of `JacobianGroup`), whose addition handles p == q, p == -q and the point
at infinity. A point of small order on the twist (E'(Fp2) has points of
order 13) meets those cases inside the ladder; the RCB formulas of K1 are
complete only on the odd-order r-torsion and may not be used here.

Operands are kernel words: affine x and y (2, 12, B) int32 canonical
Montgomery words and a (B,) bool mask; a masked lane passes. The result is
(B,) bool.
"""

import ctypes

import torch

from lighthouse_tpu_torch.crypto.constants import R
from lighthouse_tpu_torch.ops import cuda_build, curve, field as fd, subgroup_rows

# r's bits, LSB first: 255 bits, 134 of them set
R_BITS = tuple((R >> i) & 1 for i in range(R.bit_length()))

# Fp2 products of one doubling (dbl-2001-b) and one generic addition
DOUBLE_PRODUCTS = 7
ADD_PRODUCTS = 16


def ladder_step(acc, addend, bit: int):
    """One step of the JAX scan (batch_verify.py:457-463) on bundles:
    acc + addend where bit is 1, then the addend doubles. The bit is r's,
    the same for every lane, so a clear bit skips the addition that the
    scan computes and discards."""
    G = curve.J2
    if bit:
        acc = G.add(acc, addend)
    return acc, G.double(addend)


def g2_in_subgroup_plain(x, y, mask):
    """The same function on bundles, any device: the LSB-first double-add
    ladder over r from the point at infinity (1, 1, 0)."""
    G = curve.J2
    valid = mask.to(torch.bool)
    pt = G.from_affine(fd.words_to_bundle(x), fd.words_to_bundle(y), valid)
    acc = G.infinity_like(pt)
    for bit in R_BITS:
        acc, pt = ladder_step(acc, pt, bit)
    return G.is_infinity(acc) | ~valid


def kernel_products(lanes: int) -> int:
    """Fp products the kernel runs on `lanes` unmasked lanes: 254 doublings
    (the scan's last one is dead) and an addition on each of r's 134 set
    bits, Karatsuba's 3 Fp products an Fp2 product -- the count behind its
    bound. The scan's form, an addition and its inner doubling on all 255
    bits, runs 22,950 Fp2 products a lane (`jax_form_products`)."""
    per_lane = DOUBLE_PRODUCTS * (len(R_BITS) - 1) + ADD_PRODUCTS * sum(R_BITS)
    return 3 * per_lane * lanes


def row_products(lanes: int) -> float:
    """Fp products' worth of multiply-adds the kernel's rows run on `lanes`
    unmasked lanes: 3,922 Fp2 rows a lane (`subgroup_rows.lane_rows`), each
    three 24-word products and two reductions, 2.5 products (9,805 a
    lane)."""
    return subgroup_rows.lane_rows() * subgroup_rows.ROW_MADDS / 288 * lanes


def occupancy(lanes: int, device) -> dict:
    """The kernel's blocks an SM on `device`, as the CUDA runtime reports
    them (`lh_g2_subgroup_blocks_per_sm`), the lanes and warps an SM they
    hold, and the waves `lanes` lanes take on the device's SMs."""
    blocks = ctypes.c_int(0)
    with torch.cuda.device(device):
        rc = cuda_build.library("subgroup").lh_g2_subgroup_blocks_per_sm(ctypes.addressof(blocks), None)
    if rc != 0:
        raise RuntimeError(f"lh_g2_subgroup_blocks_per_sm: CUDA error {rc}")
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    per_sm = blocks.value * subgroup_rows.LANES
    return {"blocks_per_sm": blocks.value, "lanes_per_sm": per_sm,
            "warps_per_sm": blocks.value * subgroup_rows.BLOCK // 32, "sms": sms,
            "waves": lanes / (sms * per_sm)}


def jax_form_products(lanes: int) -> int:
    """Fp products of the JAX scan as it runs: every bit an addition with
    its inner doubling and the addend's doubling."""
    return 3 * (ADD_PRODUCTS + 2 * DOUBLE_PRODUCTS) * len(R_BITS) * lanes


def g2_in_subgroup(x, y, mask, require_kernel: bool = False):
    """(B,) bool: [r] (x, y) == O, or the lane is masked. CUDA tensors
    launch the subgroup kernel, CPU tensors run `g2_in_subgroup_plain`."""
    if not cuda_build.use_kernel(x, require_kernel):
        return g2_in_subgroup_plain(x, y, mask)
    B = x.shape[-1]
    dev = x.device
    cuda_build.check(x, "x", (2, fd.NW, B), dev)
    cuda_build.check(y, "y", (2, fd.NW, B), dev)
    m = mask.to(torch.int32).contiguous()
    cuda_build.check(m, "mask", (B,), dev)
    out = torch.empty((B,), dtype=torch.int32, device=dev)
    if B:
        cuda_build.launch("subgroup", "lh_g2_subgroup", "subgroup_g2", x, y, m, B, out)
    return out == 1
