"""Where the Horner kernel's time goes: padding, the product's form, the split.

At the mainnet extension (6 blobs x 8,192 points x 4,096 coefficients,
the domain of `da.domain.geometry(4096, 64)`, seeded coefficients) the
probe times `csrc/rs_extend.cu` (`cuda_build.time_ms`) on the 6 live blobs
and on a bucket of 8 (two zero blobs, as a padded call runs them): the
port's entry with its plan, and the kernel with the segments S forced to
1 (one thread a chain), 4 and 8, from a build beside the port's library
whose entry `lh_rs_extend_forced` includes the source and launches
`horner_kernel<S>` with `plan_for<S>` (FORCED below); and, given
`--baseline PATH`, an earlier `rs_extend.cu` with the same C entry
(`lh_rs_extend`), built with the same nvcc flags, on the same inputs.
Every output's live blobs are held equal to the port's. It prints one
JSON line: the card's name and power limit, and each case's device ms
with its plan (segments, resident blocks an SM, waves).

    python -m lighthouse_tpu_torch.probes.horner_split [--baseline PATH]
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

from lighthouse_tpu_torch.crypto.constants import R
from lighthouse_tpu_torch.da import gpu_backend as da_gpu
from lighthouse_tpu_torch.da.domain import geometry
from lighthouse_tpu_torch.ops import cuda_build, rfield, rs_extend

BLOBS, BUCKET, ELEMENTS, CELL = 6, 8, 4_096, 64

# the kernel at a forced S, with the plan it launched
FORCED = r"""
#include "%s"

extern "C" int lh_rs_extend_forced(const void* coeffs, const void* points, int n_coeff,
                                   int blobs, int pts, int segments, void* out, void* plan,
                                   void* stream) {
  rs::Plan pl;
  cudaError_t rc = segments == 1 ? rs::plan_for<1>(n_coeff, blobs, pts, pl)
                 : segments == 4 ? rs::plan_for<4>(n_coeff, blobs, pts, pl)
                 : segments == 8 ? rs::plan_for<8>(n_coeff, blobs, pts, pl)
                                 : cudaErrorInvalidValue;
  if (rc != cudaSuccess) return (int)rc;
  int* o = (int*)plan;
  o[0] = pl.segments; o[1] = pl.blocks_per_sm; o[2] = pl.sms;
  o[3] = pl.blocks_x; o[4] = pl.blocks; o[5] = pl.L;
  const cudaStream_t s = (cudaStream_t)stream;
  rc = segments == 1 ? rs::launch<1>(pl, coeffs, points, n_coeff, blobs, pts, 0, out, s)
     : segments == 4 ? rs::launch<4>(pl, coeffs, points, n_coeff, blobs, pts, 0, out, s)
                     : rs::launch<8>(pl, coeffs, points, n_coeff, blobs, pts, 0, out, s);
  return (int)rc;
}
"""


def _build(name: str, source: str, entry: str, argtypes):
    """`entry` of the CUDA file `source`, built with the port's nvcc flags
    beside its libraries as lib<name>.so."""
    out = os.path.join(cuda_build.BUILD, f"lib{name}.so")
    cmd = cuda_build._command("rs_extend", out)
    cmd[-1] = os.path.abspath(source)
    subprocess.run(cmd, check=True, capture_output=True, text=True)
    fn = getattr(ctypes.CDLL(out), entry)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def _forced():
    src = os.path.join(cuda_build.BUILD, "rs_extend_forced.cu")
    os.makedirs(cuda_build.BUILD, exist_ok=True)
    with open(src, "w") as f:
        f.write(FORCED % os.path.join(cuda_build.CSRC, "rs_extend.cu"))
    P, I = ctypes.c_void_p, ctypes.c_int
    return _build("rs_extend_forced", src, "lh_rs_extend_forced", [P, P, I, I, I, I, P, P, P])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", help="an earlier csrc/rs_extend.cu to time beside this one")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("horner_split: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    geo = geometry(ELEMENTS, CELL)
    rng = np.random.default_rng(15)
    polys = [[int.from_bytes(rng.bytes(32), "little") % R for _ in range(ELEMENTS)]
             for _ in range(BLOBS)]
    live = torch.from_numpy(da_gpu.pack_coefficients(polys, ELEMENTS, BLOBS)).to(dev)
    padded = torch.from_numpy(da_gpu.pack_coefficients(polys, ELEMENTS, BUCKET)).to(dev)
    points = da_gpu.domain_points(geo, dev)
    pts = int(points.shape[0])
    want = rs_extend.eval_poly_batch(live, points)
    forced = _forced()
    cases = {}
    for name, coeffs in (("live", live), ("bucket", padded)):
        blobs = int(coeffs.shape[1])
        out = rs_extend.eval_poly_batch(coeffs, points)
        assert torch.equal(out[:, :BLOBS], want), name
        cases[f"{name}_Splan"] = {
            "blobs": blobs, "ms": cuda_build.time_ms(lambda: rs_extend.eval_poly_batch(coeffs, points)),
            "plan": rs_extend.plan(ELEMENTS, blobs, pts, dev)}
        for S in (1, 4, 8):
            out = torch.empty((pts, blobs, rfield.NW), dtype=torch.int32, device=dev)
            plan = (ctypes.c_int * 6)()

            def call():
                rc = forced(coeffs.data_ptr(), points.data_ptr(), ELEMENTS, blobs, pts, S,
                            out.data_ptr(), ctypes.addressof(plan),
                            torch.cuda.current_stream(dev).cuda_stream)
                assert rc == 0, rc

            call()
            torch.cuda.synchronize()
            assert torch.equal(out[:, :BLOBS], want), (name, S)
            per_sm, sms, blocks = plan[1], plan[2], plan[4]
            cases[f"{name}_S{S}"] = {
                "blobs": blobs, "ms": cuda_build.time_ms(call),
                "plan": {"segments": S, "threads": rs_extend.THREADS, "blocks_per_sm": per_sm,
                         "sms": sms, "blocks": blocks, "segment_length": plan[5],
                         "waves": blocks / (per_sm * sms)}}
    if args.baseline:
        fn = _build("rs_extend_baseline", args.baseline, "lh_rs_extend",
                    cuda_build.SOURCES["rs_extend"]["lh_rs_extend"])
        for name, coeffs in (("live", live), ("bucket", padded)):
            out = torch.empty((pts, int(coeffs.shape[1]), rfield.NW), dtype=torch.int32, device=dev)

            def call():
                rc = fn(coeffs.data_ptr(), points.data_ptr(), ELEMENTS, int(coeffs.shape[1]), pts, 0,
                        out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
                assert rc == 0, rc

            call()
            torch.cuda.synchronize()
            assert torch.equal(out[:, :BLOBS], want), ("baseline", name)
            cases[f"baseline_{name}"] = {"blobs": int(coeffs.shape[1]), "ms": cuda_build.time_ms(call)}
    bound_ms = {name: rs_extend.horner_products(ELEMENTS, pts, b) * 256 / (132 * 64 * 1.98e9) * 1e3
                for name, b in (("live", BLOBS), ("bucket", BUCKET))}
    print(json.dumps({"card": card, "shape": [BLOBS, pts, ELEMENTS], "bound_ms": bound_ms,
                      "cases": cases}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
