"""The rewards kernel's two passes apart, beside other builds of it.

At 1,048,576 seeded validators (chip_smoke.py phase 7i's arrays), leak
off and on, the probe times `state_processing.epoch_kernel.rewards` on
the card (`cuda_build.time_ms`: the entry's two launches together) and
reads each pass's device time from a `torch.profiler` trace of 20 calls
(the sums pass with its last block, the elementwise pass). It also
times the same two kernels launched in stream order, the elementwise pass
not a programmatic dependent launch, from a build beside the port's
library whose entry `lh_epoch_rewards_in_order` includes the source
(IN_ORDER below). Given `--baseline PATH`, it does the same for an
earlier `epoch_rewards.cu` with the same C entry (`lh_epoch_rewards`,
reading the first 7 parameter words and using the workspace's first 3 as
its sums), its two passes apart too. Every output is held equal to the
plain version's. One JSON line, with the card's name and power limit.

    python -m lighthouse_tpu_torch.probes.epoch_passes [--baseline PATH]
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

from lighthouse_tpu_torch.ops import cuda_build
from lighthouse_tpu_torch.state_processing import epoch_kernel as ek

N = 1_048_576
INC = 10**9


def arrays(dev):
    rng = np.random.default_rng(14)
    eff = np.where(rng.random(N) < 0.97, 32, rng.integers(0, 33, N)) * INC
    active = rng.random(N) < 0.97
    slashed = rng.random(N) < 0.01
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in (
        eff, np.where(rng.random(N) < 0.9, 7, rng.integers(0, 8, N)).astype(np.uint8),
        np.where(rng.random(N) < 0.1, rng.integers(0, 100, N), 0),
        np.maximum(0, eff + rng.integers(-INC, INC, N)), active, slashed,
        active | (slashed & (rng.random(N) < 0.5)))]


def params(arrs, leak):
    total = max(INC, int(arrs[0][arrs[4]].sum()))
    return (INC * 64 // int(np.sqrt(total)), INC, total // INC, int(leak), 4, 16, 4 * 3 * 2**24)


def pass_ms(fn, calls=20) -> dict:
    """Device ms a call of each kernel, from a profiler trace."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        total_us = getattr(ev, "device_time_total", None) or getattr(ev, "cuda_time_total", 0)
        for name in ("sums_kernel", "rewards_kernel"):
            if name in ev.key:
                out[name] = out.get(name, 0.0) + total_us / 1e3 / calls
    return out


# the port's two kernels launched in stream order (aligned rows)
IN_ORDER = r"""
#include "%s"

extern "C" int lh_epoch_rewards_in_order(const void* eff, const void* part, const void* scores,
                                         const void* balances, const void* active,
                                         const void* slashed, const void* eligible, int n,
                                         const void* params, void* workspace, void* out_balances,
                                         void* out_scores, void* stream) {
  ep::Params p;
  if (n <= 0 || !ep::params_of(params, p)) return (int)cudaErrorInvalidValue;
  int sum_blocks = 0, reward_blocks = 0, occ[3];
  const cudaError_t rc = ep::grids<4>(n, sum_blocks, reward_blocks, occ);
  if (rc != cudaSuccess) return (int)rc;
  const cudaStream_t s = (cudaStream_t)stream;
  ep::sums_kernel<4><<<sum_blocks, ep::THREADS, 0, s>>>(
      (const int64_t*)eff, (const uint8_t*)part, (const uint8_t*)active, (const uint8_t*)slashed,
      n, p, (unsigned long long*)workspace);
  ep::rewards_kernel<<<reward_blocks, ep::THREADS, 0, s>>>(
      (const int64_t*)eff, (const uint8_t*)part, (const int64_t*)scores, (const int64_t*)balances,
      (const uint8_t*)active, (const uint8_t*)slashed, (const uint8_t*)eligible, n, p,
      (const unsigned long long*)workspace, (int64_t*)out_balances, (int64_t*)out_scores);
  return (int)cudaGetLastError();
}
"""


def build(name: str, source: str, entry: str):
    """`entry` of the CUDA file `source` (the C entry's arguments of
    `lh_epoch_rewards`), built with the port's nvcc flags beside its
    library as lib<name>.so."""
    out = os.path.join(cuda_build.BUILD, f"lib{name}.so")
    cmd = cuda_build._command("epoch_rewards", out)
    cmd[-1] = os.path.abspath(source)
    subprocess.run(cmd, check=True, capture_output=True, text=True)
    fn = getattr(ctypes.CDLL(out), entry)
    fn.argtypes = cuda_build.SOURCES["epoch_rewards"]["lh_epoch_rewards"]
    fn.restype = ctypes.c_int
    return fn


def in_order():
    src = os.path.join(cuda_build.BUILD, "epoch_rewards_in_order.cu")
    os.makedirs(cuda_build.BUILD, exist_ok=True)
    with open(src, "w") as f:
        f.write(IN_ORDER % os.path.join(cuda_build.CSRC, "epoch_rewards.cu"))
    return build("epoch_rewards_in_order", src, "lh_epoch_rewards_in_order")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", help="an earlier csrc/epoch_rewards.cu to time beside this one")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("epoch_passes: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    arrs = arrays(dev)
    builds = {"in_order": in_order()}
    if args.baseline:
        builds["baseline"] = build("epoch_rewards_baseline", args.baseline, "lh_epoch_rewards")
    rows = {}
    for leak in (False, True):
        prm = params(arrs, leak)
        want = ek.rewards_plain(*arrs, prm)
        got = ek.rewards(*arrs, prm)
        assert all(torch.equal(a, b) for a, b in zip(got, want)), leak
        row = {"ms": cuda_build.time_ms(lambda: ek.rewards(*arrs, prm)),
               "passes_ms": pass_ms(lambda: ek.rewards(*arrs, prm))}
        for name, fn in builds.items():
            ob, os_ = torch.empty_like(arrs[3]), torch.empty_like(arrs[2])
            words = torch.tensor(ek.kernel_params(prm), dtype=torch.int64)
            ws = torch.zeros(ek.WORKSPACE_WORDS, dtype=torch.int64, device=dev)

            def call():
                rc = fn(*(a.data_ptr() for a in arrs), N, words.data_ptr(), ws.data_ptr(),
                        ob.data_ptr(), os_.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
                assert rc == 0, rc

            call()
            torch.cuda.synchronize()
            assert torch.equal(ob, want[0]) and torch.equal(os_, want[1]), (leak, name)
            row[f"{name}_ms"] = cuda_build.time_ms(call)
            if name == "baseline":
                row["baseline_passes_ms"] = pass_ms(call)
        rows["leak" if leak else "no_leak"] = row
    print(json.dumps({"card": card, "validators": N, "plan": ek.plan(N, dev), "bound_ms":
                      ek.rewards_bytes(N) / 3.35e12 * 1e3, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
