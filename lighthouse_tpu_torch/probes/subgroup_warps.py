"""The subgroup kernel's device time against the warps it puts on an SM.

A block of `csrc/subgroup.cu` is one warp of 8 lanes. The probe launches
the kernel on SMs x 8 x k lanes for k = 1, 2, 4, 8, 12, 16 warps an SM and
prints one JSON line: the card's name and power limit, the blocks an SM
the CUDA runtime allows, and each k's lanes and device ms
(`cuda_build.time_ms`). The lanes are random canonical Fp2 words, points
off the curve: r's bits set the kernel's schedule, so every lane that
takes no select does the same work as a signature.

    python -m lighthouse_tpu_torch.probes.subgroup_warps
"""

import json
import subprocess
import sys

import torch

from lighthouse_tpu_torch.ops import cuda_build, fp_product, subgroup, subgroup_rows

WARPS_PER_SM = (1, 2, 4, 8, 12, 16)


def main() -> int:
    if not torch.cuda.is_available():
        print("subgroup_warps: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    n = sms * subgroup_rows.LANES * max(WARPS_PER_SM)
    x, y = (torch.stack([fp_product.random_words(n, seed + c) for c in (0, 1)]).to(dev) for seed in (11, 13))
    mask = torch.ones(n, dtype=torch.bool, device=dev)
    rows = []
    for k in WARPS_PER_SM:
        m = sms * subgroup_rows.LANES * k
        xk, yk, mk = x[..., :m].contiguous(), y[..., :m].contiguous(), mask[:m].contiguous()
        rows.append({"warps_per_sm": k, "lanes": m,
                     "ms": cuda_build.time_ms(lambda: subgroup.g2_in_subgroup(xk, yk, mk))})
    print(json.dumps({"card": card, "occupancy": subgroup.occupancy(n, dev), "sweep": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
