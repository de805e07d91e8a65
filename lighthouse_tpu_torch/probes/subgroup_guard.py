"""The signature subgroup check's host cost, with and without the guard.

`bls/gpu_backend.check_signature_subgroups` packs the list's Jacobian
words on the host, then crosses `GUARD.dispatch`, which runs the device
half (`_subgroup_verdicts`: the upload, the two launches, the verdicts'
read) on a watchdog thread. On one list of a slot's signatures (64
committees of 480, `testing.committee_sets`, the list of chip_smoke.py's
data phase) the probe makes one first guarded call (the process's first
launch of both kernels, `first_ms`), then times on the host clock, in
turn, REPS times each:

    guarded   check_signature_subgroups, the whole call
    direct    the packing and `_subgroup_verdicts` on this thread
    pack      the packing alone
    crossing  GUARD.dispatch of an attempt that does nothing
    host_ref  ref_curve's subgroup check of 16 signatures (the host's pace)

and prints one JSON line: the card's name and power limit, the list's
length, and each one's median ms, µs a signature and samples.

    python -m lighthouse_tpu_torch.probes.subgroup_guard
"""

import json
import statistics
import subprocess
import sys
import time

import torch

from lighthouse_tpu_torch import testing as T
from lighthouse_tpu_torch.bls import gpu_backend
from lighthouse_tpu_torch.crypto.ref_curve import G2 as RG2
from lighthouse_tpu_torch.device_plane import GUARD

COMMITTEES, PER_COMMITTEE = 64, 480
REPS = 9


def _ms(fn) -> float:
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def main() -> int:
    if not torch.cuda.is_available():
        print("subgroup_guard: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    pubkeys = T.validator_pubkeys(COMMITTEES * PER_COMMITTEE)
    sigs = [s.signature for s in T.committee_sets(pubkeys, COMMITTEES, PER_COMMITTEE, seed=1)]
    n = len(sigs)

    def pack():
        return gpu_backend._pack_jacobian([s.point for s in sigs], 2)

    first_ms = _ms(lambda: gpu_backend.check_signature_subgroups(sigs, device=dev))
    runs = {
        "guarded": lambda: gpu_backend.check_signature_subgroups(sigs, device=dev),
        "direct": lambda: gpu_backend._subgroup_verdicts(pack(), dev),
        "pack": pack,
        "crossing": lambda: GUARD.dispatch("bls", "probe", lambda plan: None),
        "host_ref": lambda: [RG2.in_subgroup(s.point) for s in sigs[:16]],
    }
    assert all(runs["guarded"]()) and all(runs["direct"]())
    samples = {k: [] for k in runs}
    for _ in range(REPS):
        for k, fn in runs.items():
            samples[k].append(_ms(fn))
    per = {"host_ref": 16}
    out = {k: {"median_ms": statistics.median(v),
               "us_per_sig": statistics.median(v) * 1e3 / per.get(k, n), "samples_ms": v}
           for k, v in samples.items()}
    print(json.dumps({"card": card, "signatures": n, "reps": REPS, "first_ms": first_ms,
                      "first_us_per_sig": first_ms * 1e3 / n, **out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
