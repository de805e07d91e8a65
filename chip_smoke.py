#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (lighthouse_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one JSON line each; any failure raises and the script exits
non-zero without its result line:

 1. the card's name and power limit (nvidia-smi, printed as is);
 2. build every CUDA kernel from lighthouse_tpu_torch/csrc (one nvcc per
    source, in parallel), with what ptxas reports per kernel (K1's six
    instantiations and the subgroup check, which must have no stack frame
    and no spills, and the helpers on lines of their own: registers, stack
    frame, spills, shared memory; the subgroup check's blocks an SM from
    the CUDA runtime, with the lanes an SM and the waves at 30,720 and
    1,024 lanes) and the dynamic shared memory of the
    lane-group kernels K2 and K3;
 2b. the register-resident Fp product of K1's window body, K2 and K3 alone
    (ops/fp_product.py): one thread's dependent chain (latency) and every
    SM full of chains (product rate), both exact against Python integers;
    with K3's fold chain profile, its floor = dependent product steps x
    that latency;
 3. one mainnet slot of attestations -- 64 committees x 480 single-key
    sets, every key in an on-card table of 32,768 validators -- and a flat
    batch of 1,024 sets with distinct messages and 1-4 untagged keys;
    every signature's subgroup memo filled on the card
    (gpu_backend.check_signature_subgroups: the Jacobian entry, then the
    subgroup kernel), the host's check on 512 sampled signatures agreeing,
    the card's and the host's us a signature;
 4. every kernel against its plain PyTorch version, on the card, on the
    inputs the main path gives it (the signatures' and the point path's
    keys' Jacobian words through the Jacobian entry of the to-affine
    kernel first), exact equality of canonical words;
    each kernel's device time (cuda_build.time_ms: calls queued behind a
    device-side sleep, so the host's wrapper work is not counted), the
    plain version's time and the bound (K1's window body: the products
    that the live lanes need at their scalars' widths,
    ops/ladder_rows.py `window_steps_needed`, with the rows every lane
    runs, `lane_products`, kept as bound_rows_ms); then K1's window body on
    an edge batch of 256 lanes a group (identity points, zero digits,
    every digit +8 or -8, the top window's carry, mixed signs); and the
    helpers on an edge batch (Jacobian Z != 1, Z = 1, identity and padding
    lanes; to_affine on Z = 1, identity and general lanes; the fold on
    P + P, P + (-P) and identity lanes, in one launch and in two);
 4b. the subgroup kernel against its plain version as exact bools, on a
    1,024-lane slice of the slot, two warps (one order-13 lane among slot
    signatures; eight lanes that all take the acc == addend branch) and an
    edge batch (Z != 1 signatures, their negations and rescaled copies, SSWU
    points before cofactor clearing, a point of order 13 on the twist, its
    negation and double, a subgroup point plus it, the point at infinity,
    masked lanes), all also against ref_curve; its device time at the
    slot's 30,720 lanes, on the 1,058-lane batch (the slice and the edge
    batch, without the two warps) and on the 1,024-lane slice, beside its
    bound (the products of the formulas), the rows' own bound
    (ops/subgroup_rows.py), the JAX form's and the bound at the product
    rate measured in 2b (on the `subgroup` line; the `kernels` line keeps
    the times and bound_ms);
 5. end to end through bls.api.verify_signature_sets(device="cuda"): the
    slot (grouped, indexed) and the flat batch verify True, a forged
    signature False, 4 sets cross-checked with the ref backend; launch
    counts are read around one run of each, with the host/device split
    (median of the timed runs); the slot once more with its signatures
    normalised to Z = 1 outside the timed region, as decompressed gossip
    carries them, and the decompression of 512 signatures timed alone;
 5b. the operation pool's gossip ingest (bench_oppool.py's phases, BASELINE
    config #4) at the slot's size: 30,720 attestations, attestation i of
    committee i % 64, compressed outside the timed region; timed:
    decompression, check_signature_subgroups, the streamed
    verify_signature_set_batches over 30 batches of 1,024 (seed 7, consumer
    "oppool", every batch True), per-committee aggregation (two committees
    held against H(m) times their keys' sum); the same 30 batches one call at
    a time, and overlap = (host + device - streamed wall) / host; one forged
    signature in batch 17 fails that batch alone; the card's fixed cost of
    one batch dispatch (a 4-set batch's device time, p50 of 5) beside the
    value in common/device_attribution.py;
 6. K1's chain and 2-bit window forms against their plain versions on
    the slot's and the flat batch's ladder inputs, their bounds from the rows a lane runs (the
    chain's on set bits only and in lockstep) and each form's device time
    per lane product row; then on an edge batch (identity lanes, zero,
    all-one and top-only bits, 63 bits and 1); and the flat batch end to
    end with ladder="chain" and ladder="w2" (valid True, forged False,
    device_ms of 3 timed runs);
 7. per-set verdicts after a failed batch: the slot with 3 forged
    signatures (committees 0, 31, 63) fails as a batch, then
    verify_signature_sets_individually flags exactly those 3 -- two device
    calls in all; K3's per-set entry against its plain version on a
    1,024-set slice; K2 and K3 timed at the per-set shapes; K2's 61,440-pair
    output held on a 2,048-pair slice against K2 run on the slice alone and
    against its plain version; the flat batch's per-set check (a forged
    set, an infinity signature, 4 sets against the ref backend);
 7b. the guarded executor (device_plane.GUARD) on the card: the startup
    self-test; the canary pair ([valid, invalid] sentinels through K2 and
    K3's per-set entry) giving [True, False], with its device time; a
    slot-sized dispatch under each injected fault kind at rate 1 (stall and
    error raise their classes before any launch, slow_compile gives the
    right verdict >= 50 ms later, a flip on the bus's canaried batch raises
    CanaryViolation and quarantines the plane); the dispatch after the
    quarantine refused with the call counts and launches still; the
    half-open probe after a 0.5 s cooldown closing the breaker; a real
    watchdog timeout (a 5 ms budget under the slot's wall) whose abandoned
    attempt the reaper counts, with right verdicts after it;
 7c. bus_slot: the slot's 64 committees as 64 submissions of 480 sets to
    one VerificationBus(backend="gpu") from 8 threads, canary on, all True;
    then with one forged signature in committee 31, which alone is False;
    walls, batches and triggers, mean live sets, fallback batches, canary
    calls, beside the slot's direct single-call p50 of phase 5;
 7d. bus_singles (bench_busmix.py's shape): 512 gossip singles one after
    another, then through the bus (30 ms hold) from 4 threads with its
    consumer cycle: both walls, the per-verification speedup, batches,
    mean live sets, the amortized fixed ms; then the wall model's per-set
    cost, (slot p50 - fixed dispatch cost) / 30,720, beside the constant in
    verification_bus/wall_model.py;
 7e. kzg: the KZG slice at mainnet width (4,096 field elements a blob, 6
    blobs a block): dev_setup(4096) and its packed window table (host
    seconds of each); six seeded blobs' commitments and proofs through
    backend="gpu", blob 0's byte-equal to backend="ref", the fixed-base
    MSM's device time; the variable-base MSM (kzg.gpu_backend.g1_msm_gpu)
    on tests/vectors/kzg/msm/full_4096.json equal to its output; the
    block's batch verify True, a tampered blob False, two swapped proofs
    False, one blob True, the ref backend True on the six, with the
    host/device split (challenges, evaluation, decompression with the
    subgroup checks, packing, device) and the host's decompression and
    subgroup check of one point; launches and the plain versions' Fp
    product count read around one verify and one MSM of each form (the
    exact launches of KZG_*_LAUNCHES, no plain product); K1 at 64 windows,
    the folds at seg 2b, 4,096 and 64, to_affine, K2 and K3's fold at 2
    pairs, each exactly against its plain version (the Horner ladder's
    bound one chain of 252 doublings and 63 additions); K1 at 255 bits on an
    edge batch (0, 1, r - 1, 2^254, 2^255 - 1, every digit -8 or +8,
    identity lanes) against its plain version and ref_curve; an injected
    error on the kzg plane raising before any launch, the next verify
    right, and the kzg self-test;
 7f. merkle: the Merkle-proof plane at the light-client finality depth
    (bench_lcserve.py's lcproof queries, depth 6) at 1,024 and 16,384
    queries: the SHA-256 fold kernel (csrc/sha256_fold.cu) word for word
    against its plain version, its device time beside its bound (bytes, and
    the fewest 32-bit instructions of its formulas; the formulas' own count
    beside) and hashlib's host time on the same queries; roots through
    batch_merkle_roots byte-equal to fold_branches_host, one launch; an edge
    batch in one call (depths 1, 3, 17 and 40; leaves and siblings of all
    0x00 and all 0xFF; all-left and all-right paths; 1, 7 and 1,025 lanes;
    one corrupted sibling whose verdict alone is False), each depth's
    kernel against its plain version; the committed state_proof vectors
    (valid True, corrupt False); the self-test over the three planes;
 7g. slot_program: one SlotProgram(...).run(backend="gpu") carrying the
    slot's 64 x 480 sets, phase 7e's six-blob settle and 1,024 depth-6
    Merkle queries: the verdicts (program True, settle delivered True,
    every query True), exactly one counted guarded dispatch, launches equal
    to the sum over the serial calls (the canary pair, the settle, the
    Merkle check, the fold with the sentinel riding it), the wall p50 of 3
    beside the serial calls' walls; a tampered blob (settle False, program
    True), a forged signature in committee 31 (program False, settle True),
    a corrupted sibling (that query alone False, program False); through
    the bus, 64 committee submissions from 8 threads, one staging the
    settle (all True, the settle delivered, its trigger bulk) and a
    settle-only submit_program; an injected stall reaching the program's
    submitter as DeviceFaultError with the work undelivered; a flip on the
    canaried program raising CanaryViolation;
 7h. da: the data-availability plane at mainnet width (types/spec.py:
    6 blobs of 4,096 elements, cells of 64, 128 columns on 128 subnets,
    custody 4; phase 7e's blobs and setup): the Fr Horner kernel
    (csrc/rs_extend.cu, each chain split into S segments) word for word
    against its plain version on the 6 live blobs x 8,192 points (no
    padding chains), its device time beside its bound (Fr products x 256
    multiply-adds) and the split's extra products, its plan (S, the
    resident blocks an SM the runtime reports, waves), ptxas's registers,
    stack frame and spills of its two instantiations (S = 4 and 8; none
    allowed), 64 seeded points of every blob against host Horner, its
    plain_out form on Montgomery coefficients equal to it; a kernel edge
    batch against the plain version, on two shapes, each with points 0, 1
    and r - 1 and a blob of all r - 1: 3 blobs x 256 points, where the plan
    takes S = 8, at n_coeff 1, 2, 3, 7, 8, 33, 4,095 and 4,097 (S dividing
    it or not, n below S), and 48 points x the fewest blobs (searched)
    where it takes S = 4, at n_coeff 1, 2, 3, 4, 5, 33 and 1,023); an
    extension edge batch (a zero blob, a blob of all r - 1; 1, 3 and 6
    blobs, one launch each on the live blobs alone);
    extend_blobs(backend="gpu") equal to the held output, wall p50 of 3;
    the six blobs' cells and proofs through
    "gpu" (one extension and 128 fixed-base MSMs a blob: its launches),
    cells 0, 1 and 127 of blob 0 against host Horner and their proofs
    against "ref"; the custody sample (custody_columns("node-0"): 24 cells)
    True with the KZG verify's launches, wall p50 of 3 with its host split;
    a flipped cell byte, a wrong index and a swapped proof False; "ref"
    True; the full block (768 cells) True with its split; K1, the lane
    fold, to-affine, K2 and K3 at the custody sample's shapes against their
    plain versions; reconstruction of a 1,024-element blob (32 columns: the
    host's O(n^2) interpolation cut from 4,096) from exactly half its
    columns, byte-equal, and DaError one column short; the bus: 128 column
    submissions of 6 cells from 8 threads, all True, then 8 with one
    corrupted column, which alone is False; an injected error on rs_extend
    and on da_cells raising before any launch, the next call right;
 7i. epoch: the altair rewards pass (csrc/epoch_rewards.cu) exactly
    against its plain version at 1,048,576 seeded validators, leak off and
    on, and on an edge batch of 4,608 lanes (every flag and mask
    combination, zero effective balance, scores at the int64 envelope's
    edge, balances driven below zero) and a wrapping batch of 4,099 seeded
    full-range int64 lanes under increments and inactivity denominators
    1, 2, 3, 63, 64, 65, 10^9, 2^31 - 1, 2^31 + 1, 2^62 and 2^63 - 1 and
    reward denominators that wrap (active_increments 1, 1,000, 2^57,
    2^57 + 5, 2^58 + 3), leak off and on, and once on rows one element
    off their vector alignment; its device time beside its byte bound,
    ptxas's report (no stack frame, no spill in any of its kernels) and
    its grids (the resident blocks an SM the runtime reports, waves);
    process_epoch(device="cuda") on a
    mainnet-spec altair state of 1,048,576 validators
    (testing.epoch_state, seeded; an epoch that rotates no sync committee)
    with its wall and its split (extraction, upload, kernel, read-back,
    write-back, the other passes), one launch; the same state rebuilt and
    run on "cpu", balances, scores and the registry equal; process_slots
    across one boundary at 16,384 validators on both, state roots equal;
 7j. slasher: the min/max-target update (csrc/slasher_update.cu) exactly
    against its plain version on a 65,536-row slice at H = 4,096 with
    32,768 lanes over a seeded prior (several lanes a row, duplicate
    pairs, s = 0 and H - 1, invalid lanes with garbage), and on 4,096-row
    slices at H = 37 and 4,095 (the element-wise merge); then in place at
    1,048,576 x 4,096 (32 GiB) over an honest history (testing.honest_prior):
    one slot's batch of 32,768 attesters and one epoch's of every validator
    (testing.slasher_batches) flag exactly the 64 planted votes, the slot's
    touched rows equal the plain version on those rows gathered, every
    untouched row's checksum is unchanged, every row after both equals the
    plain version run a chunk of rows at a time; the kernel's ms at both
    batches beside their byte bounds (the columns each touched row needs;
    whole rows as bound_rows_ms), the glue's and the peak memory;
 8. the tensor-core probe (lighthouse_tpu_torch.ops.mma_probe), int8 and
    bf16, exact against the probe's numpy check and the plain version,
    kernel and library call timed the same way (and each once more in one
    synchronised call, cuda_build.call_ms, which shows the host's share of
    a few-microsecond call); its launches are those of one `contract` call;
 9. the kernels line (the kernels of the kzg path carry a "kzg" record at
    its shapes, with its launches, and a "da" record at the cell verify's;
    every kernel its launches in phase 7g's program run; epoch_rewards its
    launches in 7i's process_epoch, slasher_update in 7j's two full-width
    batches), then {"ok": true,
    "device": {...}} as the last line.

The kernel records also go to chiprun_out/chip_smoke_records.json.

Without a CUDA device the script exits 2 and prints no result.
"""

import itertools
import json
import math
import os
import random
import statistics
import subprocess
import sys
import threading
import time

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "chiprun_out")

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
# 32-bit integer multiply-adds per second: 132 SMs x 64 INT32 lanes x 1.98 GHz
INT_OPS_PER_S = 132 * 64 * 1.98e9
# one 12-word CIOS product: 2 x 144 32x32->64 multiply-adds, lo and hi halves
IMAD_PER_FP_PRODUCT = 2 * 144 * 2
# one 8-word Fr product (csrc/rs_extend.cu): 2 x 64, lo and hi halves
IMAD_PER_FR_PRODUCT = 2 * 64 * 2

# the kernels of verify_signature_sets with the default window ladder; the
# flat batch's untagged keys also take the G1 Jacobian entry
BATCH_KERNELS = ("ladder_g1", "ladder_g2", "miller", "fold_final_exp",
                 "lane_sum_g1", "lane_sum_g2", "to_affine_g1", "to_affine_g2",
                 "jacobian_to_affine_g2")
POINT_PATH_KERNELS = ("jacobian_to_affine_g1",)
# one-key flat batches (gossip singles through the bus) fold no key lanes;
# the bus's canary pair runs K3's per-set entry
SINGLES_KERNELS = tuple(k for k in BATCH_KERNELS if k != "lane_sum_g1") + POINT_PATH_KERNELS + (
    "pair_final_exp",)

# the kzg slice's launches: a block's batch verify, one fixed-base MSM (a
# commitment or a proof: the fold of 64 x 4,096 lanes in two launches, the
# Horner ladder and its fold, the read's to-affine) and one variable-base MSM
KZG_VERIFY_LAUNCHES = {"ladder_g1": 1, "miller": 1, "fold_final_exp": 1, "lane_sum_g1": 1,
                       "to_affine_g1": 1}
KZG_FIXED_LAUNCHES = {"ladder_g1": 1, "lane_sum_g1": 3, "to_affine_g1": 1}
KZG_VARIABLE_LAUNCHES = {"ladder_g1": 1, "lane_sum_g1": 2, "to_affine_g1": 1}
# the slot program's kernels: the slot's fold, the settle's, the canary
# pair's per-set entry and the Merkle fold
PROGRAM_KERNELS = BATCH_KERNELS + ("pair_final_exp", "sha256_fold")
MERKLE_DEPTH = 6  # the light-client finality branch
# the column-sampling constants of lighthouse_tpu/types/spec.py:132-150
# (mainnet): 6 blobs of 4,096 elements, cells of 64, 128 columns on 128
# subnets, custody 4
MAINNET_DA = {"FIELD_ELEMENTS_PER_BLOB": 4_096, "FIELD_ELEMENTS_PER_CELL": 64,
              "NUMBER_OF_COLUMNS": 128, "DATA_COLUMN_SIDECAR_SUBNET_COUNT": 128,
              "CUSTODY_REQUIREMENT": 4, "MAX_BLOBS_PER_BLOCK": 6}

# a point of order 13 on the twist E'(Fp2), affine (x0, x1, y0, y1): [h2 r / 169]
# of an SSWU point (tests/test_torch_subgroup.py)
ORDER13 = (
    2836965131823123410263967203666700228366617764832011880822917003009180422710328672880982742971667089130324726186765,
    1493440553737758395317049093622249216134088697031662027075306454103180847581429911027814653483157864376196648859787,
    1883875369676256757931724051005444337857183088130947247092686437224487482716351955195424734420382938063040663037738,
    3553509992304783018100897154919395512649485085278091884435216652014597959035275330737888638199572964083532338401018,
)

N_VALIDATORS = 32_768
# the epoch plane: a mainnet registry's size, an epoch whose successor
# rotates no sync committee and appends no historical root, and one
# boundary through process_slots
EPOCH_V = 1_048_576
EPOCH_AT = 1_000
BOUNDARY_V = 16_384
# the rewards pass's integer operations a validator (two divisions by
# magic numbers, eight multiplications, the selects and sums), one each
EPOCH_INT_OPS = 64
# the slasher plane: ~1 M validators x SlasherConfig's history_length
# (lighthouse_tpu/slasher/slasher.py:42), one slot's attesters, the planted
# surround and surrounded votes
SLASHER_V = 1_048_576
SLASHER_H = 4_096
SLOT_ATTESTERS = 32_768
PLANTED = 64
N_COMMITTEES = 64
COMMITTEE = 480
N_FLAT = 1_024
REPS = 5


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


class SettleWork:
    """A block's pending KZG settle as a slot program takes it: a payload,
    and every delivered verdict recorded."""

    def __init__(self, blobs, commitments, proofs, backend="gpu"):
        self._payload = (blobs, commitments, proofs, backend)
        self.verdicts = []

    def payload(self):
        return self._payload

    def deliver(self, verdict):
        self.verdicts.append(verdict)


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from lighthouse_tpu_torch import testing as T
    from lighthouse_tpu_torch.bls import api, gpu_backend
    from lighthouse_tpu_torch.bls.device_pubkey_table import DevicePubkeyTable
    from lighthouse_tpu_torch.ops import batch_verify as bv
    from lighthouse_tpu_torch.ops import cuda_build, curve, curve_kernels, field as fd
    from lighthouse_tpu_torch.ops import final_exp, fp_product, lanes, ladder, ladder_rows, miller
    from lighthouse_tpu_torch.ops import mma_probe, subgroup, subgroup_rows
    from lighthouse_tpu_torch.ops import device_io, window_ladder
    from lighthouse_tpu_torch.bls.hash_to_curve import hash_to_field_fp2, iso_map, map_to_curve_sswu
    from lighthouse_tpu_torch.common import device_attribution
    from lighthouse_tpu_torch.common.events_journal import Journal
    from lighthouse_tpu_torch.device_plane import GUARD, INJECTOR, canary, executor
    from lighthouse_tpu_torch.device_plane.executor import (
        CanaryViolation, DeviceErrorInjected, DeviceFaultError, DeviceStallInjected, DeviceTimeout)
    from lighthouse_tpu_torch.verification_bus import VerificationBus, wall_model
    from lighthouse_tpu_torch.crypto.ref_curve import G1 as RG1
    from lighthouse_tpu_torch.crypto.ref_curve import G2 as RG2
    from lighthouse_tpu_torch.crypto.constants import R as R_ORDER
    from lighthouse_tpu_torch import kzg as pkzg
    from lighthouse_tpu_torch.bls import point_serde
    from lighthouse_tpu_torch.kzg import api as kzg_api, gpu_backend as kzg_gpu
    from lighthouse_tpu_torch.ops import kzg_verify, msm as kmsm
    from lighthouse_tpu_torch.ops import merkle_proof
    from lighthouse_tpu_torch.ops.slot_program import SlotProgram
    from lighthouse_tpu_torch.da import cells as da_cells, custody as da_custody
    from lighthouse_tpu_torch.da import erasure as da_erasure, gpu_backend as da_gpu
    from lighthouse_tpu_torch.da.domain import DaError, geometry, geometry_for_spec
    from lighthouse_tpu_torch.ops import rfield, rs_extend
    from lighthouse_tpu_torch.slasher import device as sd
    from lighthouse_tpu_torch.state_processing import epoch_kernel as ek
    from lighthouse_tpu_torch.state_processing.per_epoch import process_epoch
    from lighthouse_tpu_torch.state_processing.per_slot import process_slots
    from lighthouse_tpu_torch.types.spec import mainnet_spec

    os.makedirs(OUT, exist_ok=True)
    dev = torch.device("cuda")

    # ---------------------------------------------------------- 1. card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip()
    print(smi, flush=True)
    emit("card", name=torch.cuda.get_device_name(0), smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, count=torch.cuda.device_count())

    # --------------------------------------------------------- 2. build
    t0 = time.perf_counter()
    log = cuda_build.build_all(force=True)
    ptxas = {}
    for src, rec in log.items():
        with open(os.path.join(OUT, f"ptxas_{src}.txt"), "w") as f:
            f.write(rec["ptxas"])
        ptxas[src] = cuda_build.ptxas_summary(rec["ptxas"])
    k2, k3 = lanes.k2_tables(), lanes.k3_tables()
    lane_smem = {"miller": lanes.shared_bytes(k2, lanes.K2_THREADS),
                 "fold_final_exp": lanes.shared_bytes(k3, lanes.K3_FOLD_THREADS),
                 "pair_final_exp": lanes.shared_bytes(k3, lanes.K3_SET_THREADS,
                                                      lanes.K3_SET_LANES)}
    emit("build", seconds=time.perf_counter() - t0, nvcc=cuda_build.nvcc_version(), ptxas=ptxas,
         lane_shared_bytes=lane_smem)
    # K1: one body, six instantiations (window, chain, w2 on G1 and G2)
    k1_ptxas = {
        name: dict(rec, **ptxas["ladder"]["functions"].get(name, {}))
        for name, rec in ptxas["ladder"]["kernels"].items()
    }
    k1_frames = sorted(n for n, r in k1_ptxas.items()
                       if r["stack_bytes"] or r.get("stack_frame") or r.get("spill_stores"))
    emit("k1_ptxas", kernels=k1_ptxas, stack_frames_or_spills=k1_frames,
         spill_store_bytes=ptxas["ladder"]["spill_store_bytes"])
    assert len(k1_ptxas) == 6 and all("ladder_kernel" in n for n in k1_ptxas), "K1: expected 6 kernels"
    assert not k1_frames and not ptxas["ladder"]["spill_store_bytes"], f"K1: stack frame or spills {k1_frames}"
    # the helpers: registers, stack frame, spills, static and dynamic shared
    # memory (the fold's file is dynamic, curve_kernels.fold_shared_bytes)
    helpers_ptxas = {
        name: dict(rec, **ptxas["curve_helpers"]["functions"].get(name, {}),
                   dynamic_shared_bytes=(curve_kernels.fold_shared_bytes(2 if "ILi2" in name else 1)
                                         if "fold_kernel" in name else 0))
        for name, rec in ptxas["curve_helpers"]["kernels"].items()
    }
    emit("helpers_ptxas", kernels=helpers_ptxas,
         stack_frames=sorted(n for n, r in helpers_ptxas.items() if r["stack_bytes"]))
    assert len(helpers_ptxas) == 6, "helpers: expected 2 fold and 4 affine kernels"
    # the subgroup check on lane groups: registers, stack frame, spills and
    # shared memory, and the blocks an SM that the CUDA runtime reports with
    # the lanes an SM and the waves they give at the slot's 30,720 lanes and
    # a gossip batch's 1,024; no stack frame and no spill, as K1
    subgroup_ptxas = {
        name: dict(rec, **ptxas["subgroup"]["functions"].get(name, {}))
        for name, rec in ptxas["subgroup"]["kernels"].items()
    }
    emit("subgroup_ptxas", kernels=subgroup_ptxas,
         occupancy={n: subgroup.occupancy(n, dev) for n in (30_720, 1_024)},
         spill_store_bytes=ptxas["subgroup"]["spill_store_bytes"],
         spill_load_bytes=ptxas["subgroup"]["spill_load_bytes"])
    assert len(subgroup_ptxas) == 1, "subgroup: expected 1 kernel"
    assert not any(r["stack_bytes"] or r.get("stack_frame") for r in subgroup_ptxas.values()) \
        and not ptxas["subgroup"]["spill_store_bytes"], f"subgroup: stack frame or spills {subgroup_ptxas}"

    # ---------------------------------------- 2b. the Fp product alone
    prod = fp_product.measure(dev)
    fold_chain = lanes.chain_profile(k3, ["FEXP_A", "inv", "FEXP_B"])
    miller_chain = lanes.chain_profile(k2, ["LOOP"])
    dependent = fold_chain["product_steps"] + fold_chain["inv_products"]
    floor_ms = dependent * prod["latency_ns_per_product"] / 1e6
    emit("fp_product", **prod, imad_per_s=prod["products_per_s"] * IMAD_PER_FP_PRODUCT,
         derived_imad_per_s=INT_OPS_PER_S, fold_chain=fold_chain, miller_chain=miller_chain,
         fold_chain_dependent_products=dependent, fold_chain_floor_ms=floor_ms)
    assert prod["latency_exact"] and prod["rate_exact"], "fp_product: chain not exact"

    # ---------------------------------------------------------- 3. data
    t0 = time.perf_counter()
    pubkeys = T.validator_pubkeys(N_VALIDATORS)
    table = DevicePubkeyTable(dev)
    table.append(pubkeys)
    slot = T.committee_sets(pubkeys, N_COMMITTEES, COMMITTEE, seed=1)
    t1 = time.perf_counter()
    flat = T.flat_sets(pubkeys, N_FLAT, max_keys=4, seed=2)
    t2 = time.perf_counter()
    # the signature subgroup policy on the card, every signature's memo
    # filled; the host's check on a sample of 512 must agree
    slot_ok = gpu_backend.check_signature_subgroups([s.signature for s in slot], device="cuda")
    t3 = time.perf_counter()
    flat_ok = gpu_backend.check_signature_subgroups([s.signature for s in flat], device="cuda")
    t4 = time.perf_counter()
    assert all(slot_ok) and all(flat_ok), "data: a signature failed the card's subgroup check"
    assert all(api.signature_ok(s.signature) for s in slot + flat)
    sample = np.random.default_rng(8).choice(len(slot), 512, replace=False)
    t5 = time.perf_counter()
    host_ok = [RG2.in_subgroup(slot[i].signature.point) for i in sample]
    t6 = time.perf_counter()
    assert host_ok == [slot_ok[i] for i in sample], "data: card and host subgroup checks disagree"
    emit("data", slot_sets=len(slot), flat_sets=len(flat), validators=table.count,
         slot_build_s=t1 - t0, flat_build_s=t2 - t1,
         slot_subgroup_s=t3 - t2, flat_subgroup_s=t4 - t3,
         slot_subgroup_card_us_per_sig=(t3 - t2) / len(slot) * 1e6,
         host_subgroup_sample=len(sample), host_agrees=True,
         slot_subgroup_host_us_per_sig=(t6 - t5) / len(sample) * 1e6)

    # ------------------------------- 4. kernels against plain versions
    def stage_inputs(sets, seed):
        """The main path's kernel inputs for one batch (bls/gpu_backend +
        ops/batch_verify, step by step)."""
        m = gpu_backend._marshal(sets)
        bits = gpu_backend._scalar_bits(gpu_backend._rlc_scalars(m.s_bucket, seed))
        pk_words = table.gather(m.indices) if m.table is not None else m.pubkeys
        km = bv._mask(m.key_mask, dev)
        sm = bv._mask(m.set_mask, dev)
        mags, negs = bv._digits(bits, dev)
        pk = bv._from_affine(*bv._affine(pk_words, dev), km)
        sig = bv._from_affine(*bv._affine(m.sigs, dev), sm)
        return m, km, sm, mags, negs, pk, sig, bits, pk_words

    records = {}

    def hold(name, kernel_fn, plain_fn, inputs_bytes, reps=3, products=None, bound=None,
             rows=None, extra=None):
        """Kernel vs plain on the same inputs: exact equality, times, bound.
        `products` replaces the plain version's Fp product count where the
        kernel's work depends on the data; `bound` = (ms, by) replaces the
        Fp product bound for a kernel that is not field arithmetic; `rows`,
        the products of the rows the kernel runs where that is more than
        the function needs, is kept beside the bound as bound_rows_ms;
        `extra` goes into the record as it is."""
        out_k = kernel_fn()
        kernel_ms = cuda_build.time_ms(kernel_fn, reps)
        prod0 = fd.FP_PRODUCTS
        tp0 = time.perf_counter()
        out_p = plain_fn()
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - tp0) * 1e3
        if products is None:
            products = fd.FP_PRODUCTS - prod0
        flat_k = _flatten(out_k)
        flat_p = _flatten(out_p)
        assert len(flat_k) == len(flat_p)
        err = 0
        for a, b in zip(flat_k, flat_p):
            assert a.shape == b.shape, (name, a.shape, b.shape)
            err = max(err, int((a.to(torch.int64) - b.to(torch.int64)).abs().max()) if a.numel() else 0)
        out_bytes = sum(t.numel() * t.element_size() for t in flat_k)
        nbytes = inputs_bytes + out_bytes
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = products * IMAD_PER_FP_PRODUCT / INT_OPS_PER_S * 1e3
        rec = {
            "ms": kernel_ms, "plain_ms": plain_ms,
            "max_abs_err": err, "fp_products": products, "bytes": nbytes,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        }
        if bound is not None:
            rec["bound_ms"], rec["bound_by"] = bound
        if rows is not None:
            rec["fp_products_rows"] = rows
            rec["bound_rows_ms"] = rows * IMAD_PER_FP_PRODUCT / INT_OPS_PER_S * 1e3
        rec.update(extra or {})
        emit("kernel_vs_plain", kernel=name, held=err == 0, **rec)
        assert err == 0, f"{name}: kernel and plain version disagree"
        return rec

    def nb(*ts):
        return sum(t.numel() * t.element_size() for t in _flatten(ts))

    def k1_needed(w, mags, live):
        """The products K1's window form needs for the digits mags (W, L)
        on the lanes where `live` holds (ladder_rows.window_steps_needed):
        nothing for identity lanes or zero scalars."""
        keep = torch.as_tensor(live, device=mags.device).reshape(-1).to(torch.bool)
        assert keep.numel() == mags.shape[1], (keep.shape, mags.shape)
        return ladder_rows.step_products(w, *ladder_rows.window_steps_needed(mags[:, keep].cpu().numpy()))

    def hold_verify_path(label, affs, scalars, tau_g2, recs):
        """The kernels of `ops/kzg_verify.verify_kzg_proof_batch` step by
        step on one verify's lanes (affine int pairs and scalars, the
        second pair's G2 point `tau_g2`), each held against its plain
        version into recs; the verdict of the steps must be 1."""
        kx, ky, kmask = kzg_gpu._affine_words(affs)
        k_mags, k_negs = (torch.from_numpy(a).to(dev).to(torch.int32).contiguous()
                          for a in window_ladder.signed_digit_arrays(scalars, nbits=kmsm.SCALAR_BITS))
        L = len(affs)
        pts = bv._from_affine(bv._lanes(kx, dev), bv._lanes(ky, dev), bv._mask(kmask, dev))
        emit("shapes", batch=label, lanes=L, windows=int(k_mags.shape[0]))
        recs["ladder_g1"] = hold(
            "ladder_g1", lambda: ladder.ladder(pts, k_mags, k_negs),
            lambda: ladder.ladder_plain(pts, k_mags, k_negs), nb(pts, k_mags, k_negs),
            products=k1_needed(1, k_mags, kmask),
            rows=L * ladder_rows.lane_products(1, int(k_mags.shape[0])))
        lanes_r = ladder.ladder(pts, k_mags, k_negs)
        recs["lane_sum_g1"] = hold(
            "lane_sum_g1", lambda: curve_kernels.lane_sum(lanes_r, L // 2),
            lambda: curve_kernels.lane_sum_plain(lanes_r, L // 2), nb(lanes_r))
        sums = curve_kernels.lane_sum(lanes_r, L // 2)
        recs["to_affine_g1"] = hold(
            "to_affine_g1", lambda: curve_kernels.to_affine(sums),
            lambda: curve_kernels.to_affine_plain(sums), nb(sums),
            products=curve_kernels.affine_products(1, False, 2))
        px, py, pinf = curve_kernels.to_affine(sums)
        tau = [torch.from_numpy(fd.mont_words(c)).to(dev) for c in tau_g2]
        g2 = tuple(torch.stack([fd.matrix(gen, dev), t], dim=-1)
                   for gen, t in zip(kzg_verify.G2_GEN_AFFINE, tau))
        recs["miller"] = hold(
            "miller", lambda: miller.miller_loop((px, py), g2, ~pinf),
            lambda: miller.miller_loop_plain((px, py), g2, ~pinf), nb(px, py, g2, pinf))
        kf = miller.miller_loop((px, py), g2, ~pinf)
        recs["fold_final_exp"] = hold(
            "fold_final_exp", lambda: final_exp.fold_final_exp(kf),
            lambda: final_exp.fold_final_exp_plain(kf), nb(kf))
        assert bool(final_exp.fold_final_exp(kf)[1]), f"{label}: stage-by-stage verdict is not 1"

    ladder_inputs = {}
    for label, sets, seed in (("grouped", slot, 3), ("flat", flat, 4)):
        m, km, sm, mags, negs, pk, sig, bits, pk_words = stage_inputs(sets, seed)
        S = sm.numel()
        K = m.k_bucket
        emit("shapes", batch=label, lanes=S, keys=K, windows=int(mags.shape[0]))
        recs = records.setdefault(label, {})
        # the host's Jacobian words into affine Montgomery words: signatures,
        # and the keys of the point path
        jac = {2: tuple(bv._lanes(c, dev) for c in m.sigs)}
        if m.table is None:
            jac[1] = tuple(bv._lanes(c, dev) for c in pk_words)
        for w, pt in sorted(jac.items()):
            recs[f"jacobian_to_affine_g{w}"] = hold(
                f"jacobian_to_affine_g{w}", lambda: curve_kernels.jacobian_to_affine(pt),
                lambda: curve_kernels.jacobian_to_affine_plain(pt), nb(pt),
                products=curve_kernels.affine_products(w, True, pt[0].shape[-1]))
        if K > 1:
            recs["lane_sum_g1_keys" if m.grouped else "lane_sum_g1"] = hold(
                "lane_sum_g1", lambda: curve_kernels.lane_sum(pk, K),
                lambda: curve_kernels.lane_sum_plain(pk, K), nb(pk))
        agg = curve_kernels.lane_sum(pk, K)
        ladder_inputs[label] = {1: agg, 2: sig, "bits": bits}
        # the window body's products (a G2 row is an Fp2 product of 2.5
        # products' multiply-adds), not the plain version's: what the live
        # lanes need at their scalars' widths (the bound), and the rows every
        # lane runs, padding included (bound_rows_ms)
        k1_products = {w: k1_needed(w, mags, sm) for w in (1, 2)}
        k1_rows = {w: pt[0].shape[-1] * ladder_rows.lane_products(w, int(mags.shape[0]))
                   for w, pt in ((1, agg), (2, sig))}
        recs["ladder_g1"] = hold(
            "ladder_g1", lambda: ladder.ladder(agg, mags, negs),
            lambda: ladder.ladder_plain(agg, mags, negs), nb(agg, mags, negs),
            products=k1_products[1], rows=k1_rows[1])
        pk_r = ladder.ladder(agg, mags, negs)
        if m.grouped:
            Sg = m.set_mask.shape[1]
            recs["lane_sum_g1"] = hold(
                "lane_sum_g1", lambda: curve_kernels.lane_sum(pk_r, Sg),
                lambda: curve_kernels.lane_sum_plain(pk_r, Sg), nb(pk_r))
            pk_r = curve_kernels.lane_sum(pk_r, Sg)
        recs["to_affine_g1"] = hold(
            "to_affine_g1", lambda: curve_kernels.to_affine(pk_r),
            lambda: curve_kernels.to_affine_plain(pk_r), nb(pk_r),
            products=curve_kernels.affine_products(1, False, pk_r[0].shape[-1]))
        pk_aff = curve_kernels.to_affine(pk_r)
        recs["ladder_g2"] = hold(
            "ladder_g2", lambda: ladder.ladder(sig, mags, negs),
            lambda: ladder.ladder_plain(sig, mags, negs), nb(sig, mags, negs),
            products=k1_products[2], rows=k1_rows[2])
        sig_r = ladder.ladder(sig, mags, negs)
        recs["lane_sum_g2"] = hold(
            "lane_sum_g2", lambda: curve_kernels.lane_sum(sig_r, S),
            lambda: curve_kernels.lane_sum_plain(sig_r, S), nb(sig_r))
        sig_acc = curve_kernels.lane_sum(sig_r, S)
        recs["to_affine_g2"] = hold(
            "to_affine_g2", lambda: curve_kernels.to_affine(sig_acc),
            lambda: curve_kernels.to_affine_plain(sig_acc), nb(sig_acc),
            products=curve_kernels.affine_products(2, False, sig_acc[0].shape[-1]))
        sig_aff = curve_kernels.to_affine(sig_acc)
        pair_set_mask = bv._mask(m.group_mask, dev) if m.grouped else sm
        g1, g2, pmask = bv._assemble_pairs(
            bv._lanes(m.msgs[0], dev), bv._lanes(m.msgs[1], dev), pair_set_mask, pk_aff, sig_aff)
        emit("pairs", batch=label, pairs=int(pmask.numel()), live=int(pmask.sum()))
        recs["miller"] = hold(
            "miller", lambda: miller.miller_loop(g1, g2, pmask),
            lambda: miller.miller_loop_plain(g1, g2, pmask), nb(g1, g2, pmask))
        f = miller.miller_loop(g1, g2, pmask)
        recs["fold_final_exp"] = hold(
            "fold_final_exp", lambda: final_exp.fold_final_exp(f),
            lambda: final_exp.fold_final_exp_plain(f), nb(f))
        value, ok = final_exp.fold_final_exp(f)
        assert bool(ok), f"{label}: stage-by-stage verdict is not 1"

    # K1's window body on an edge batch: 128 live and 128 identity lanes (the
    # padding) of the slot's ladder inputs, digits by lane mod 8 (zero; +8;
    # -8; the recoding of 2^64 - 1, whose top window takes the carry; of
    # 0x88..88, every digit 8; random magnitudes and signs, signs on zero
    # digits too; +8 and -8 alternating; random scalars)
    W = window_ladder.num_windows(64)
    rng = np.random.default_rng(5)
    edge_bits = torch.from_numpy(rng.integers(0, 2, (256, 64)).astype(np.int32))
    edge_bits[3::8] = 1
    edge_bits[4::8] = torch.tensor([(0x8888888888888888 >> i) & 1 for i in range(64)], dtype=torch.int32)
    em, en = window_ladder.recode_bits(edge_bits)
    em, en = em.to(torch.int32), en.to(torch.int32)
    em[:, 0::8], en[:, 0::8] = 0, 0
    em[:, 1::8], en[:, 1::8] = 8, 0
    em[:, 2::8], en[:, 2::8] = 8, 1
    em[:, 5::8] = torch.from_numpy(rng.integers(0, 9, (W, 32)).astype(np.int32))
    en[:, 5::8] = torch.from_numpy(rng.integers(0, 2, (W, 32)).astype(np.int32))
    em[:, 6::8] = 8
    en[:, 6::8] = (torch.arange(W) % 2).to(torch.int32)[:, None]
    em, en = em.contiguous().to(dev), en.contiguous().to(dev)
    edge = {}
    for w in (1, 2):
        src = ladder_inputs["grouped"][w]
        at_inf = (src[2] == 0).all(dim=1).all(dim=0)
        inf_lanes, live_lanes = at_inf.nonzero().flatten(), (~at_inf).nonzero().flatten()
        assert len(inf_lanes) >= 128 and len(live_lanes) >= 128, f"edge batch G{w}: lanes"
        cols = torch.cat([live_lanes[:128], inf_lanes[:128]])[torch.from_numpy(rng.permutation(256)).to(dev)]
        pt = tuple(c[..., cols].contiguous() for c in src)
        identity = int((pt[2] == 0).all(dim=1).all(dim=0).sum())
        out_k = ladder.ladder(pt, em, en)
        out_p = ladder.ladder_plain(pt, em, en)
        err = max(int((a.to(torch.int64) - b.to(torch.int64)).abs().max()) for a, b in zip(out_k, out_p))
        edge[f"ladder_g{w}"] = {"lanes": 256, "identity_lanes": identity, "max_abs_err": err,
                                "held": err == 0}
        assert err == 0, f"K1 G{w}: the edge batch differs from the plain version"
    records["edge"] = edge
    emit("k1_edge", windows=W, top_window_digits=sorted(set(em[-1].tolist())), **edge)

    # the helpers on an edge batch, each against its plain version, exactly:
    # the Jacobian entry on Z != 1 (chained additions), Z = 1, the identity
    # and padding (Z = 0), 300 lanes (a part-filled second block); to_affine
    # on Z = 1, identity and general lanes; the fold on P + P, P + (-P) and
    # identity lanes in its first level, one launch (seg 128) and two (512)
    helper_edge = {}

    def exact(name, out_k, out_p, **info):
        err = max(int((a.to(torch.int64) - b.to(torch.int64)).abs().max())
                  for a, b in zip(_flatten(out_k), _flatten(out_p)))
        helper_edge[name] = dict(info, max_abs_err=err, held=err == 0)
        assert err == 0, f"{name}: the edge batch differs from the plain version"

    for w, G, pts in ((1, RG1, [p.point for p in pubkeys[1:121]]),
                      (2, RG2, [s.signature.point for s in slot[1:121]])):
        edge_pts = pts + [G.from_affine(G.to_affine(p)) for p in pts] + [G.infinity] * 8 + [None] * 52
        jl = tuple(bv._lanes(c, dev) for c in gpu_backend._pack_jacobian(edge_pts, w))
        out_k = curve_kernels.jacobian_to_affine(jl)
        exact(f"jacobian_to_affine_g{w}", out_k, curve_kernels.jacobian_to_affine_plain(jl),
              lanes=len(edge_pts), z_one=120, identity=8, padding=52,
              flagged=int(out_k[2].sum()))
        assert int(out_k[2].sum()) == 60, f"G{w}: the identity and padding lanes are not flagged"
        src = ladder_inputs["grouped"][w]  # Z = 1 lanes and the identity (padding)
        at_inf = (src[2] == 0).all(dim=1).all(dim=0)
        live, inf_l = (~at_inf).nonzero().flatten(), at_inf.nonzero().flatten()
        sel = tuple(c[..., torch.cat([live[:150], inf_l[:150]])].contiguous() for c in src)
        general = curve_kernels.lane_sum(tuple(c[..., live[:600]].contiguous() for c in src), 2)
        pt = tuple(torch.cat([a, b], dim=-1).contiguous() for a, b in zip(sel, general))
        exact(f"to_affine_g{w}", curve_kernels.to_affine(pt), curve_kernels.to_affine_plain(pt),
              lanes=600, z_one=150, identity=150)
        A = tuple(c[..., live[:64]] for c in src)
        A2 = tuple(c[..., live[64:128]] for c in src)
        I = tuple(c[..., inf_l[:64]] for c in src)
        dup = tuple(torch.cat([a, a], dim=-1) for a in A)
        neg = tuple(fd.bundle_to_words(c) for c in
                    curve.group(w).neg(tuple(fd.words_to_bundle(c) for c in dup)))
        pt = tuple(torch.cat(parts, dim=-1).contiguous() for parts in
                   zip(dup, A2, I, neg, tuple(c[..., :128] for c in general)))
        for seg in (128, 512):
            exact(f"lane_sum_g{w}_seg{seg}", curve_kernels.lane_sum(pt, seg),
                  curve_kernels.lane_sum_plain(pt, seg), lanes=512, seg=seg,
                  launches=len(curve_kernels.fold_plan(seg)))
    records["helper_edge"] = helper_edge
    emit("helpers_edge", **helper_edge)

    # ------------------------------------------ 4b. the subgroup check
    # the kernel against its plain version as exact bools, and against
    # ref_curve on the edge lanes; its device time on the slot's 30,720
    # lanes, against the bound of the products it runs there
    def sig_lanes(points):
        """Jacobian points -> the kernel's inputs through the Jacobian entry:
        affine (x, y) lanes and the mask (Z = 0 lanes masked)."""
        jac = tuple(bv._lanes(device_io.to_device(c, dev), dev)
                    for c in gpu_backend._pack_jacobian(points, 2))
        x, y, inf = curve_kernels.jacobian_to_affine(jac)
        return x, y, ~inf

    # a 1,024-lane slice of the slot, then the edge batch: two warps (the
    # kernel's blocks are 8 lanes, so each starts on a multiple of 8), one
    # with a single order-13 lane among slot signatures and one whose lanes
    # all take the acc == addend branch ([k] of the order-13 point); then
    # slot signatures (Z != 1), their negations and copies with another Z,
    # SSWU points before cofactor clearing, a point of order 13 on the
    # twist, its negation and double, a subgroup point plus it, the point at
    # infinity (Z = 0: masked by the Jacobian entry), and SSWU points under
    # an explicit mask; one plain run for all (its time is launches, not
    # lanes)
    q13 = RG2.from_affine(((ORDER13[0], ORDER13[1]), (ORDER13[2], ORDER13[3])))
    sswu = [RG2.from_affine(iso_map(map_to_curve_sswu(u))) for u in hash_to_field_fp2(b"edge", 8)]
    live = [s.signature.point for s in slot[:8]]
    rescaled = [(RG2.F.mul((9, 0), X), RG2.F.mul((27, 0), Y), RG2.F.mul((3, 0), Z)) for X, Y, Z in live[:4]]
    warps = [s.signature.point for s in slot[8:15]] + [q13] + [RG2.mul_scalar(q13, k) for k in range(1, 9)]
    edge_pts = (live + [RG2.neg(p) for p in live] + rescaled + sswu[:4]
                + [q13, RG2.neg(q13), RG2.add(q13, q13), RG2.add(live[0], q13)]
                + [RG2.infinity] * 2 + sswu[4:])
    SLICE_SG = 1_024
    assert SLICE_SG % 8 == 0 and len(warps) == 16
    x_s, y_s, m_s = sig_lanes([s.signature.point for s in slot[:SLICE_SG]] + warps + edge_pts)
    m_s[-4:] = False
    rec_slice = hold("subgroup_g2", lambda: subgroup.g2_in_subgroup(x_s, y_s, m_s),
                     lambda: subgroup.g2_in_subgroup_plain(x_s, y_s, m_s), nb(x_s, y_s, m_s),
                     products=subgroup.kernel_products(int(m_s.sum())))
    out_k = subgroup.g2_in_subgroup(x_s, y_s, m_s).tolist()
    want_warps = [RG2.in_subgroup(p) for p in warps]
    want = [RG2.in_subgroup(p) for p in edge_pts[:-4]] + [True] * 4
    assert all(out_k[:SLICE_SG]), "subgroup: a slot signature rejected"
    assert out_k[SLICE_SG:SLICE_SG + 16] == want_warps and want_warps == [True] * 7 + [False] * 9, \
        f"subgroup: the two warps {out_k[SLICE_SG:SLICE_SG + 16]}"
    assert out_k[SLICE_SG + 16:] == want and want.count(False) == 8, f"subgroup: edge batch {out_k[SLICE_SG + 16:]}"
    # the 1,058 lanes of the slice and the edge batch (no warps) and the
    # slice alone, timed as the batch a gossip burst gives the kernel
    keep = list(range(SLICE_SG)) + list(range(SLICE_SG + 16, x_s.shape[-1]))
    x_o, y_o, m_o = (t[..., keep].contiguous() for t in (x_s, y_s, m_s))
    x_k, y_k, m_k = (t[..., :SLICE_SG].contiguous() for t in (x_s, y_s, m_s))
    assert subgroup.g2_in_subgroup(x_o, y_o, m_o).tolist() == out_k[:SLICE_SG] + out_k[SLICE_SG + 16:]
    x_t, y_t, m_t = sig_lanes([s.signature.point for s in slot])
    n_t = int(m_t.sum())
    t_ops = subgroup.kernel_products(n_t) * IMAD_PER_FP_PRODUCT / INT_OPS_PER_S * 1e3
    records["subgroup"] = {
        "ms": cuda_build.time_ms(lambda: subgroup.g2_in_subgroup(x_t, y_t, m_t)),
        "ms_1058": cuda_build.time_ms(lambda: subgroup.g2_in_subgroup(x_o, y_o, m_o)),
        "ms_1024": cuda_build.time_ms(lambda: subgroup.g2_in_subgroup(x_k, y_k, m_k)),
        "lanes": n_t, "slice": dict(rec_slice, lanes=x_s.shape[-1]), "plain_ms": rec_slice["plain_ms"],
        "max_abs_err": rec_slice["max_abs_err"],
        "bound_ms": max(t_ops, nb(x_t, y_t, m_t) / HBM_BYTES_PER_S * 1e3), "bound_by": "operations",
        "bound_jax_form_ms": subgroup.jax_form_products(n_t) * IMAD_PER_FP_PRODUCT / INT_OPS_PER_S * 1e3,
        "bound_measured_rate_ms": subgroup.kernel_products(n_t) / prod["products_per_s"] * 1e3,
        # the rows' own count: 3,922 Fp2 products a lane at 2.5 products' multiply-adds
        "row_products": subgroup.row_products(n_t),
        "bound_rows_ms": subgroup.row_products(n_t) * IMAD_PER_FP_PRODUCT / INT_OPS_PER_S * 1e3,
        "lane_work": subgroup_rows.lane_work(),
        "fp_products": subgroup.kernel_products(n_t),
        "warps": {"order13_among_slot": out_k[SLICE_SG:SLICE_SG + 8],
                  "all_acc_equals_addend": out_k[SLICE_SG + 8:SLICE_SG + 16], "held": True},
        "edge": {"lanes": len(edge_pts), "rejected": want.count(False), "masked": 6, "held": True,
                 "agrees_with_ref_curve": True},
    }
    emit("subgroup", **records["subgroup"])

    # --------------------------------------------------- 5. end to end
    def e2e(label, sets, seed, probes=True, kernels=BATCH_KERNELS):
        cuda_build.reset_launches()
        t0 = time.perf_counter()
        ok = api.verify_signature_sets(sets, seed=seed, device="cuda")
        first_s = time.perf_counter() - t0
        launches = dict(cuda_build.LAUNCHES)
        assert ok is True, f"{label}: valid batch rejected"
        walls, host_stats = [], []
        for r in range(REPS):
            t0 = time.perf_counter()
            assert api.verify_signature_sets(sets, seed=seed + 1 + r, device="cuda")
            walls.append(time.perf_counter() - t0)
            host_stats.append(dict(gpu_backend.LAST_HOST_STATS))
        stats = host_stats[-1]
        split = {k: statistics.median(h[k] for h in host_stats)
                 for k in ("points_ms", "pack_ms", "host_ms", "device_ms")}
        missing = [k for k in kernels if launches[k] == 0]
        assert not missing, f"{label}: the path launched no {missing}"
        p50 = statistics.median(walls)
        e2e_p50_s[label] = p50
        if not probes:
            emit("end_to_end", batch=label, sets=len(sets), verdict=ok, first_call_s=first_s,
                 p50_s=p50, sets_per_s=len(sets) / p50, walls_s=walls, host_stats=stats,
                 host_split_p50=split, launches=launches)
            return launches
        forged = T.forge(sets, len(sets) // 2)
        assert forged[len(sets) // 2].signature.in_subgroup()
        bad = api.verify_signature_sets(forged, seed=seed, device="cuda")
        assert bad is False, f"{label}: forged batch accepted"
        ref_ok = api.verify_signature_sets(sets[:4], backend="ref")
        ref_bad = api.verify_signature_sets(forged[len(sets) // 2 : len(sets) // 2 + 4], backend="ref")
        gpu_small = api.verify_signature_sets(sets[:4], seed=seed, device="cuda")
        assert ref_ok and gpu_small and not ref_bad, f"{label}: ref cross-check failed"
        emit("end_to_end", batch=label, sets=len(sets), verdict=ok, forged_verdict=bad,
             ref_cross_check=True, first_call_s=first_s, p50_s=p50,
             sets_per_s=len(sets) / p50, walls_s=walls, host_stats=stats,
             host_split_p50=split, launches=launches)
        return launches

    e2e_p50_s = {}
    slot_launches = e2e("grouped", slot, 10)
    flat_launches = e2e("flat", flat, 20, kernels=BATCH_KERNELS + POINT_PATH_KERNELS)

    # the slot again with Z = 1 signatures, as decompressed gossip carries
    # them (bls/point_serde.py g2_decompress): the same points normalised
    # outside the timed region, each keeping its subgroup verdict (the
    # memo of the signature it copies); then the decompression itself,
    # sampled on 512 signatures
    t0 = time.perf_counter()
    slot_z1 = []
    for s in slot:
        sig = api.Signature(RG2.from_affine(RG2.to_affine(s.signature.point)))
        sig._subgroup_ok = s.signature.in_subgroup()
        slot_z1.append(api.SignatureSet(sig, s.pubkeys, s.message))
    normalise_s = time.perf_counter() - t0
    e2e("grouped_z1", slot_z1, 30, probes=False)
    raw = [s.signature.to_bytes() for s in slot[:512]]
    t0 = time.perf_counter()
    decoded = [api.Signature.from_bytes(b) for b in raw]
    decompress_s = time.perf_counter() - t0
    for d, s in zip(decoded, slot_z1[:512]):
        assert d.point == s.signature.point, "decompression: another point"
    emit("decompress", signatures=len(raw), normalise_s=normalise_s,
         slot_decompress_us_per_sig=decompress_s / len(raw) * 1e6, z_one=True)

    # ---------------------- 5b. operation-pool gossip ingest (config #4)
    # bench_oppool.py's phases on the port at the slot's size: 30,720
    # attestations of 64 committees, attestation i of committee i % 64,
    # compressed outside the timed region; timed: decompression, the card's
    # subgroup check, the streamed RLC verify of 30 batches of 1,024 (64
    # messages each), per-committee aggregation
    N_ING = N_COMMITTEES * COMMITTEE
    CHUNK = 1_024
    order = [(i % N_COMMITTEES) * COMMITTEE + i // N_COMMITTEES for i in range(N_ING)]
    atts = [slot[k] for k in order]
    t0 = time.perf_counter()
    raw = [s.signature.to_bytes() for s in atts]
    compress_s = time.perf_counter() - t0
    cuda_build.reset_launches()
    gpu_backend.CALL_COUNTS.update(batch=0, individual=0)
    t0 = time.perf_counter()
    sigs = [api.Signature.from_bytes(b) for b in raw]
    t1 = time.perf_counter()
    sub_ok = gpu_backend.check_signature_subgroups(sigs, device="cuda")
    t2 = time.perf_counter()
    batches = [[api.SignatureSet(sigs[i], atts[i].pubkeys, atts[i].message)
                for i in range(b, min(b + CHUNK, N_ING))] for b in range(0, N_ING, CHUNK)]
    streamed = api.verify_signature_set_batches(batches, seed=7, device="cuda", consumer="oppool")
    t3 = time.perf_counter()
    agg = [RG2.infinity] * N_COMMITTEES
    for i, sig in enumerate(sigs):
        agg[i % N_COMMITTEES] = RG2.add(agg[i % N_COMMITTEES], sig.point)
    t4 = time.perf_counter()
    ingest_launches = dict(cuda_build.LAUNCHES)
    stream_stats = dict(gpu_backend.LAST_STREAM_STATS)
    assert all(sub_ok) and len(sub_ok) == N_ING, "ingest: a signature failed the subgroup check"
    assert streamed == [True] * len(batches) and len(batches) == 30, f"ingest: {streamed}"
    assert gpu_backend.CALL_COUNTS["batch"] == 30, gpu_backend.CALL_COUNTS
    missing = [k for k in BATCH_KERNELS + ("subgroup_g2",) if ingest_launches[k] == 0]
    assert not missing, f"ingest: the path launched no {missing}"
    # committee g's aggregate is H_g times the sum of its secret keys
    for g in (0, N_COMMITTEES - 1):
        keys = sum(v + 1 for v in range(g * COMMITTEE, (g + 1) * COMMITTEE))
        h = T._h(slot[g * COMMITTEE].message)
        assert RG2.to_affine(agg[g]) == RG2.to_affine(RG2.mul_scalar(h, keys)), f"ingest: aggregate {g}"
    # the same batches one call at a time: the host and device times the
    # stream overlaps
    walls, host_ms, device_ms = [], [], []
    for bi, b in enumerate(batches):
        tb = time.perf_counter()
        assert api.verify_signature_sets(b, seed=7 + bi, device="cuda", consumer="oppool")
        walls.append(time.perf_counter() - tb)
        host_ms.append(gpu_backend.LAST_HOST_STATS["host_ms"])
        device_ms.append(gpu_backend.LAST_HOST_STATS["device_ms"])
    host_sum, device_sum = sum(host_ms), sum(device_ms)
    overlap = (host_sum + device_sum - stream_stats["wall_ms"]) / host_sum
    assert stream_stats["wall_ms"] < host_sum + device_sum, "ingest: the stream did not overlap"
    # one forged signature in batch 17: that batch alone fails
    bad = list(batches)
    bad[17] = T.forge(batches[17], 300)
    bad_verdicts = api.verify_signature_set_batches(bad, seed=7, device="cuda", consumer="oppool")
    assert [i for i, v in enumerate(bad_verdicts) if not v] == [17], bad_verdicts
    bad_stats = dict(gpu_backend.LAST_STREAM_STATS)
    # the card's fixed cost of one batch dispatch: the smallest bucket's
    # device time (4 sets), beside a 1,024-set ingest batch's
    small = []
    for r in range(REPS):
        assert api.verify_signature_sets(slot[:4], seed=60 + r, device="cuda", consumer="bench")
        small.append(gpu_backend.LAST_HOST_STATS["device_ms"])
    fixed_ms = statistics.median(small)
    total_s = t4 - t0
    records["ingest"] = {
        "attestations": N_ING, "committees": N_COMMITTEES, "batch": CHUNK, "batches": len(batches),
        "compress_s": compress_s,
        "phase_s": {"decompress": t1 - t0, "subgroup": t2 - t1, "verify": t3 - t2, "aggregate": t4 - t3},
        "total_s": total_s, "sigs_per_s": N_ING / total_s,
        "stream": stream_stats, "unstreamed_host_ms": host_sum, "unstreamed_device_ms": device_sum,
        "unstreamed_wall_ms": sum(walls) * 1e3, "overlap": overlap,
        "unstreamed_p50": {"host_ms": statistics.median(host_ms), "device_ms": statistics.median(device_ms),
                           "wall_ms": statistics.median(walls) * 1e3},
        "forged_batch": 17, "forged_verdicts_false": [17], "forged_stream": bad_stats,
        "fixed_dispatch_ms": fixed_ms, "fixed_dispatch_runs_ms": small,
        "fixed_device_cost_ms_in_code": device_attribution.FIXED_DEVICE_COST_MS,
        "launches": ingest_launches,
    }
    emit("ingest", **records["ingest"])

    # ------------------------------ 6. K1's chain and 2-bit window forms
    # the bound counts the products of the rows a lane runs
    # (ladder_rows.lane_products): w2's, and the chain's on set bits only
    # (bound_ms) and in lockstep, an addition on every bit (bound_lockstep_ms)
    def ops_ms(products):
        return products * IMAD_PER_FP_PRODUCT / INT_OPS_PER_S * 1e3

    rows_a_lane, ns_per_lane_row, form_shapes = {}, {}, {}
    for label in ("grouped", "flat"):  # the slot's ladder inputs, then the flat batch's
        inp = ladder_inputs[label]
        bits_t = torch.as_tensor(inp["bits"], device=dev).t().contiguous()  # (64, lanes)
        n_bits, n_lanes = bits_t.shape
        set_bits = int(bits_t.sum())
        form_shapes[label] = {"lanes": n_lanes, "n_bits": n_bits, "set_bits": set_bits}
        for form in ("chain", "w2"):
            n = n_bits if form == "chain" else -(-n_bits // 2)
            for w in (1, 2):
                name = f"ladder_g{w}_{form}"
                pt = inp[w]
                lanes_w = pt[0].shape[-1]
                products = lanes_w * ladder_rows.lane_products(w, n, form, set_bits / n_lanes if form == "chain" else None)
                rec = hold(name, lambda: ladder.ladder(pt, bits_t, form=form),
                           lambda: ladder.ladder_plain(pt, bits_t, form=form), nb(pt, bits_t),
                           products=products)
                if form == "chain":
                    rec["bound_lockstep_ms"] = ops_ms(lanes_w * ladder_rows.lane_products(w, n, form))
                if label == "grouped":
                    rows_a_lane[name] = ladder_rows.lane_products(w, n, form)
                records[label][name] = rec
    g = form_shapes["grouped"]
    # ms a lane's product row, all three forms at the slot's lanes: the
    # chain's and w2's extra scratch copies show as a higher figure
    for w in (1, 2):
        rows_a_lane[f"ladder_g{w}"] = ladder_rows.lane_products(w, window_ladder.num_windows(64))
    for name, rows in rows_a_lane.items():
        ns_per_lane_row[name] = records["grouped"][name]["ms"] * 1e6 / (g["lanes"] * rows)
    emit("ladder_forms", shapes=form_shapes, products_a_lane=rows_a_lane,
         products_a_lane_chain_set_bits={w: ladder_rows.lane_products(w, g["n_bits"], "chain", g["set_bits"] / g["lanes"])
                                         for w in (1, 2)},
         ns_per_lane_product=ns_per_lane_row)

    # the chain and w2 on an edge batch: 128 live and 128 identity lanes of
    # the slot's ladder inputs, bits by lane mod 4 (zero; all one; random;
    # the top bit alone), at 63 bits (w2 pads a zero top bit) and at 1 (the
    # chain runs no doubling); exact against the plain version
    forms_edge = {}
    rng = np.random.default_rng(6)
    for n_e in (63, 1):
        eb = torch.from_numpy(rng.integers(0, 2, (n_e, 256)).astype(np.int32))
        eb[:, 0::4] = 0
        eb[:, 1::4] = 1
        eb[:-1, 3::4] = 0
        eb[-1, 3::4] = 1
        eb = eb.contiguous().to(dev)
        for w in (1, 2):
            src = ladder_inputs["grouped"][w]
            at_inf = (src[2] == 0).all(dim=1).all(dim=0)
            inf_lanes, live_lanes = at_inf.nonzero().flatten(), (~at_inf).nonzero().flatten()
            cols = torch.cat([live_lanes[:128], inf_lanes[:128]])[torch.from_numpy(rng.permutation(256)).to(dev)]
            pt = tuple(c[..., cols].contiguous() for c in src)
            for form in ("chain", "w2"):
                out_k = ladder.ladder(pt, eb, form=form)
                out_p = ladder.ladder_plain(pt, eb, form=form)
                err = max(int((a.to(torch.int64) - b.to(torch.int64)).abs().max()) for a, b in zip(out_k, out_p))
                forms_edge[f"ladder_g{w}_{form}_bits{n_e}"] = {
                    "lanes": 256, "identity_lanes": int((pt[2] == 0).all(dim=1).all(dim=0).sum()),
                    "n_bits": n_e, "max_abs_err": err, "held": err == 0}
                assert err == 0, f"K1 {form} G{w}, {n_e} bits: the edge batch differs from the plain version"
    records["forms_edge"] = forms_edge
    emit("k1_forms_edge", **forms_edge)

    form_launches = {}
    for form in ("chain", "w2"):
        cuda_build.reset_launches()
        t0 = time.perf_counter()
        ok = api.verify_signature_sets(flat, seed=40, device="cuda", ladder=form)
        first_s = time.perf_counter() - t0
        form_launches[form] = dict(cuda_build.LAUNCHES)
        walls, device_ms = [], []
        for r in range(3):
            t0 = time.perf_counter()
            assert api.verify_signature_sets(flat, seed=41 + r, device="cuda", ladder=form) is True
            walls.append(time.perf_counter() - t0)
            device_ms.append(gpu_backend.LAST_HOST_STATS["device_ms"])
        forged = T.forge(flat, len(flat) // 2)
        bad = api.verify_signature_sets(forged, seed=40, device="cuda", ladder=form)
        emit("end_to_end_ladder_form", batch="flat", form=form, sets=len(flat), verdict=ok,
             forged_verdict=bad, first_call_s=first_s, p50_s=statistics.median(walls),
             device_ms_p50=statistics.median(device_ms), device_ms=device_ms,
             launches=form_launches[form])
        assert ok is True and bad is False, f"flat batch with ladder={form}: wrong verdict"
        missing = [f"ladder_g{w}_{form}" for w in (1, 2) if form_launches[form][f"ladder_g{w}_{form}"] == 0]
        assert not missing, f"ladder={form}: the path launched no {missing}"

    # ------------------------------- 7. per-set verdicts after a failure
    # one forged signature in each of committees 0, 31 and 63
    forged_at = [7, (N_COMMITTEES // 2 - 1) * COMMITTEE + COMMITTEE // 2,
                 (N_COMMITTEES - 1) * COMMITTEE + COMMITTEE - 1]
    bad_slot = slot
    for i in forged_at:
        bad_slot = T.forge(bad_slot, i)
    gpu_backend.CALL_COUNTS.update(batch=0, individual=0)
    t0 = time.perf_counter()
    batch_ok = api.verify_signature_sets(bad_slot, seed=50, device="cuda")
    batch_s = time.perf_counter() - t0
    assert batch_ok is False, "slot with 3 forged signatures accepted as a batch"
    cuda_build.reset_launches()
    t0 = time.perf_counter()
    verdicts = api.verify_signature_sets_individually(bad_slot, device="cuda")
    first_s = time.perf_counter() - t0
    per_set_launches = dict(cuda_build.LAUNCHES)
    calls = dict(gpu_backend.CALL_COUNTS)
    assert calls["batch"] + calls["individual"] == 2, calls
    flagged = [i for i, v in enumerate(verdicts) if not v]
    assert len(verdicts) == len(slot) and flagged == forged_at, flagged[:10]
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        assert api.verify_signature_sets_individually(bad_slot, device="cuda") == verdicts
        walls.append(time.perf_counter() - t0)
    per_set_stats = dict(gpu_backend.LAST_HOST_STATS)
    missing = [k for k in ("jacobian_to_affine_g2", "to_affine_g1", "miller", "pair_final_exp")
               if per_set_launches[k] == 0]
    assert not missing, f"per-set path launched no {missing}"
    # K2 and K3 at the per-set shapes, K3 held on a 1,024-set slice
    m = gpu_backend._marshal_flat(bad_slot, pow2=False)
    g1, g2, pmask, _ = bv._individual_pairs(
        m.msgs, m.sigs, gpu_backend._pubkeys(m, dev), m.key_mask, m.set_mask, dev)
    S = len(bad_slot)
    f = miller.miller_loop(g1, g2, pmask)
    miller_ms = cuda_build.time_ms(lambda: miller.miller_loop(g1, g2, pmask))
    pair_ms = cuda_build.time_ms(lambda: final_exp.pair_final_exp(f))
    _, ok_all = final_exp.pair_final_exp(f)
    assert (~ok_all).nonzero().flatten().tolist() == forged_at
    # K2's multi-wave launch held exactly: a 2,048-pair slice across both
    # halves of the 2 S pairs, from the full run, alone, and plain
    cols = slice(S - 1_024, S + 1_024)
    g1_s = tuple(t[..., cols].contiguous() for t in g1)
    g2_s = tuple(t[..., cols].contiguous() for t in g2)
    pmask_s = pmask[cols].contiguous()
    f_alone = miller.miller_loop(g1_s, g2_s, pmask_s)
    assert torch.equal(f[..., cols], f_alone), "K2 at 61,440 pairs differs from the slice alone"
    miller_slice = hold("miller", lambda: miller.miller_loop(g1_s, g2_s, pmask_s),
                        lambda: miller.miller_loop_plain(g1_s, g2_s, pmask_s),
                        nb(g1_s, g2_s, pmask_s))
    SLICE = 1_024
    f_slice = torch.cat([f[..., :SLICE], f[..., S:S + SLICE]], dim=-1).contiguous()
    rec = hold("pair_final_exp", lambda: final_exp.pair_final_exp(f_slice),
               lambda: final_exp.pair_final_exp_plain(f_slice), nb(f_slice))
    scale = S / SLICE  # one chain per set: work and bytes grow with S
    records["per_set"] = {
        "pair_final_exp_slice": rec,
        "pair_final_exp": dict(rec, ms=pair_ms, sets=S, bound_ms=rec["bound_ms"] * scale,
                               fp_products=rec["fp_products"] * scale, bytes=rec["bytes"] * scale,
                               plain_ms_at_sets=SLICE),
        "miller": {"ms": miller_ms, "pairs": 2 * S, "slice_pairs": 2_048,
                   "slice_same_as_full_run": True, "slice": miller_slice},
    }
    emit("per_set", sets=S, forged_at=forged_at, batch_verdict=batch_ok, batch_s=batch_s,
         flagged=flagged, device_calls=calls, first_call_s=first_s, walls_s=walls,
         p50_s=statistics.median(walls), host_stats=per_set_stats, launches=per_set_launches,
         miller_ms_at_pairs={2 * S: miller_ms}, pair_final_exp_ms_at_sets={S: pair_ms})

    flat_bad = T.forge(flat, 512)
    s100 = flat_bad[100]
    flat_bad[100] = api.SignatureSet(api.Signature(RG2.infinity), s100.pubkeys, s100.message)
    cuda_build.reset_launches()
    t0 = time.perf_counter()
    flat_verdicts = api.verify_signature_sets_individually(flat_bad, device="cuda")
    flat_wall = time.perf_counter() - t0
    flat_per_set_launches = dict(cuda_build.LAUNCHES)
    assert [i for i, v in enumerate(flat_verdicts) if not v] == [100, 512]
    ref = api.verify_signature_sets_individually(flat_bad[510:514], backend="ref")
    assert ref == flat_verdicts[510:514] == [True, True, False, True], ref
    emit("per_set", batch="flat", sets=len(flat_bad), flagged=[100, 512], ref_cross_check=True,
         wall_s=flat_wall, host_stats=dict(gpu_backend.LAST_HOST_STATS),
         launches=flat_per_set_launches)

    # ------------------------------------ 7b. the guarded executor (guard)
    # every device verify crosses device_plane.GUARD; on the card: the
    # startup self-test, the canary pair on K2 and K3's per-set entry, each
    # injected fault kind on a slot-sized dispatch, the quarantine that
    # keeps the card untouched, the half-open recovery, and a real watchdog
    # timeout whose abandoned attempt the reaper counts
    GUARD.reset()
    INJECTOR.reset()
    GUARD.configure(cooldown_s=0.5)
    journal = Journal()
    guard = {"selftest": GUARD.self_test(("bls",), journal=journal)}
    assert guard["selftest"] == {"bls": True}, guard
    cuda_build.reset_launches()
    pair = canary.check_pair("gpu")
    pair_launches = dict(cuda_build.LAUNCHES)
    assert pair == [True, False], pair
    missing = [k for k in ("miller", "pair_final_exp") if pair_launches[k] == 0]
    assert not missing, f"guard: the canary pair launched no {missing}"
    pair_walls, pair_device = [], []
    for _ in range(REPS):
        t0 = time.perf_counter()
        canary.check_pair("gpu")
        pair_walls.append((time.perf_counter() - t0) * 1e3)
        pair_device.append(gpu_backend.LAST_HOST_STATS["device_ms"])
    guard["canary_pair"] = {"verdicts": pair, "launches": pair_launches,
                            "wall_ms_p50": statistics.median(pair_walls),
                            "device_ms_p50": statistics.median(pair_device),
                            "device_ms": pair_device}
    assert api.verify_signature_sets(slot, seed=70, device="cuda")
    base_device_ms = gpu_backend.LAST_HOST_STATS["device_ms"]
    injected = {}
    for kind, exc in (("stall", DeviceStallInjected), ("error", DeviceErrorInjected)):
        INJECTOR.arm(kind, "bls", rate=1.0, seed=1)
        calls = dict(gpu_backend.CALL_COUNTS)
        try:
            api.verify_signature_sets(slot, seed=71, device="cuda")
            raise AssertionError(f"guard: {kind} injected, no fault raised")
        except exc as e:
            injected[kind] = {"raised": type(e).__name__, "card_untouched": gpu_backend.CALL_COUNTS == calls}
        INJECTOR.reset()
        assert injected[kind]["card_untouched"], injected
    INJECTOR.arm("slow_compile", "bls", rate=1.0, seed=1)
    t0 = time.perf_counter()
    ok = api.verify_signature_sets(slot, seed=72, device="cuda")
    slow_wall_ms = (time.perf_counter() - t0) * 1e3
    slow_device_ms = gpu_backend.LAST_HOST_STATS["device_ms"]
    INJECTOR.reset()
    injected["slow_compile"] = {"verdict": ok, "wall_ms": slow_wall_ms, "device_ms": slow_device_ms,
                                "device_ms_uninjected": base_device_ms}
    assert ok is True and slow_device_ms >= 50.0, injected
    # a flip on the bus's canaried batch: the pair comes back flipped
    INJECTOR.arm("flip", "bls", rate=1.0, seed=1)
    flip_bus = VerificationBus(backend="gpu", journal=journal)
    try:
        flip_bus.submit(slot, consumer="bench")
        raise AssertionError("guard: a flip on the canaried batch went unseen")
    except CanaryViolation as e:
        injected["flip"] = {"raised": type(e).__name__}
    INJECTOR.reset()
    guard["quarantined"] = GUARD.breaker.snapshot()
    assert guard["quarantined"].get("bls/*") == "open", guard
    injected["flip"]["quarantine"] = "open"
    guard["injected"] = injected
    # quarantined: the next dispatch of any bucket is refused untouched
    calls = dict(gpu_backend.CALL_COUNTS)
    cuda_build.reset_launches()
    try:
        api.verify_signature_sets(slot[:4], seed=73, device="cuda")
        raise AssertionError("guard: a quarantined plane reached the card")
    except DeviceFaultError as e:
        guard["after_quarantine"] = {"raised": type(e).__name__, "message": str(e),
                                     "call_counts_moved": gpu_backend.CALL_COUNTS != calls,
                                     "launches": sum(cuda_build.LAUNCHES.values())}
    assert not guard["after_quarantine"]["call_counts_moved"] and not guard["after_quarantine"]["launches"]
    # the cooldown (0.5 s here) turns the key half-open: one probe, which
    # succeeds and closes it
    time.sleep(0.6)
    assert api.verify_signature_sets(slot, seed=74, device="cuda") is True
    guard["recovered"] = {"state": GUARD.breaker.snapshot(),
                          "transitions": GUARD.stats()["transitions"]}
    assert guard["recovered"]["state"].get("bls/*") == "closed", guard["recovered"]
    assert GUARD.stats()["transitions"].get("bls:half_open") == 1
    # a real watchdog timeout: a 5 ms budget under the slot batch's wall
    GUARD.configure(base_timeout_s=0.005, timeout_factor=1.0, min_timeout_s=0.001)
    t0 = time.perf_counter()
    try:
        api.verify_signature_sets(slot, seed=75, device="cuda")
        raise AssertionError("guard: the slot finished inside 5 ms")
    except DeviceTimeout as e:
        guard["timeout"] = {"raised": type(e).__name__, "caller_s": time.perf_counter() - t0}
    GUARD.configure(base_timeout_s=executor.DEFAULT_BASE_TIMEOUT_S,
                    timeout_factor=executor.DEFAULT_TIMEOUT_FACTOR,
                    min_timeout_s=executor.DEFAULT_MIN_TIMEOUT_S)
    t0 = time.perf_counter()
    after = api.verify_signature_sets(slot, seed=76, device="cuda")
    guard["timeout"]["next_verdict"] = after
    guard["timeout"]["next_wall_s"] = time.perf_counter() - t0
    forged_after = api.verify_signature_sets(T.forge(slot, 100), seed=77, device="cuda")
    deadline = time.monotonic() + 30.0
    while GUARD.stats()["reaped"] < 1 and time.monotonic() < deadline:
        time.sleep(0.01)
    st = GUARD.stats()
    guard["timeout"].update(reaped=st["reaped"], abandoned=st["abandoned"], forged_after=forged_after)
    assert after is True and forged_after is False and st["reaped"] == 1 and st["abandoned"] == 0, guard
    guard["stats"] = st
    guard["journal"] = [(e["outcome"], e["attrs"].get("fault")) for e in journal.query(kind="device_fault")]
    print(smi, flush=True)
    emit("guard", **guard)
    GUARD.reset()

    # --------------------------------------- 7c. the bus on a full slot
    # the slot's 64 committees as 64 submissions of 480 sets (consumer
    # oppool) to one VerificationBus(backend="gpu") from 8 threads, canary
    # on; the sentinel pair's keys are registered in the table, so the
    # batches stay indexed
    table.append([s.pubkeys[0] for s in canary.bls_sentinels()])
    committees = [slot[g * COMMITTEE:(g + 1) * COMMITTEE] for g in range(N_COMMITTEES)]

    def bus_round(subs, threads=8):
        bus = VerificationBus(backend="gpu", journal=Journal())
        verdicts = [None] * len(subs)
        errors = []

        def worker(tid):
            for g in range(tid, len(subs), threads):
                try:
                    verdicts[g] = bus.submit(subs[g], consumer="oppool")
                except Exception as e:  # a fault fails the phase below
                    errors.append(repr(e))

        calls = dict(gpu_backend.CALL_COUNTS)
        cuda_build.reset_launches()
        t0 = time.perf_counter()
        ths = [threading.Thread(target=worker, args=(t,)) for t in range(threads)]
        for th in ths:
            th.start()
        for th in ths:
            th.join()
        wall = time.perf_counter() - t0
        launches = dict(cuda_build.LAUNCHES)
        st = bus.stats()
        return {"verdicts": verdicts, "errors": errors, "wall_s": wall, "launches": launches,
                "batches_formed": st["batches_formed"], "triggers": st["triggers"],
                "mean_live_per_batch": st["mean_live_per_batch"],
                "coalesced_batches": st["coalesced_batches"],
                "fallback_batches": st["fallback_batches"],
                "canary_calls": gpu_backend.CALL_COUNTS["individual"] - calls["individual"],
                "batch_calls": gpu_backend.CALL_COUNTS["batch"] - calls["batch"],
                "wall_model": st["wall_model"]}

    valid = bus_round(committees)
    assert not valid["errors"] and valid["verdicts"] == [True] * N_COMMITTEES, valid["errors"]
    missing = [k for k in BATCH_KERNELS + ("pair_final_exp",) if valid["launches"][k] == 0]
    assert not missing, f"bus_slot: the path launched no {missing}"
    bad_at = 31 * COMMITTEE + 123
    bad_committees = list(committees)
    bad_committees[31] = T.forge(slot, bad_at)[31 * COMMITTEE:32 * COMMITTEE]
    forged = bus_round(bad_committees)
    assert not forged["errors"], forged["errors"]
    assert [g for g, v in enumerate(forged["verdicts"]) if v is not True] == [31], forged["verdicts"]
    assert forged["verdicts"][31] is False
    for r in (valid, forged):
        r.pop("verdicts")
    records["bus_slot"] = {"submissions": N_COMMITTEES, "sets_each": COMMITTEE, "threads": 8,
                           "valid": valid, "forged_committee": 31, "forged": forged,
                           "direct_slot_p50_s": e2e_p50_s["grouped"]}
    print(smi, flush=True)
    emit("bus_slot", **records["bus_slot"])

    # ------------------------------ 7d. gossip singles (bench_busmix.py)
    # 512 singles over 8 interop keys: one after another, each its own
    # dispatch, then through the bus (bench_busmix's 30 ms hold) from 4
    # threads with its consumer cycle
    N_SINGLES, BUS_THREADS = 512, 4
    CONSUMER_CYCLE = ("gossip_single", "sidecar_header", "oppool")
    kps = api.interop_keypairs(8)
    singles = [api.SignatureSet(kp.sk.sign(f"busmix:{i}".encode()), [kp.pk], f"busmix:{i}".encode())
               for i, kp in enumerate(kps)]
    assert api.verify_signature_sets([singles[0]], device="cuda", consumer="bench")
    amort0 = device_attribution.amortized_totals()
    cuda_build.reset_launches()
    t0 = time.perf_counter()
    for i in range(N_SINGLES):
        assert api.verify_signature_sets([singles[i % 8]], device="cuda", consumer="bench")
    direct_wall = time.perf_counter() - t0
    direct_launches = dict(cuda_build.LAUNCHES)
    direct_amort = sum(v - amort0.get(k, 0.0) for k, v in device_attribution.amortized_totals().items()
                       if k[0] == "bench")
    bus = VerificationBus(backend="gpu", max_hold_ms=30.0)
    amort1 = device_attribution.amortized_totals()
    per_thread = N_SINGLES // BUS_THREADS
    results = []

    def single_worker(tid):
        for i in range(per_thread):
            results.append(bus.submit([singles[(tid * per_thread + i) % 8]],
                                      consumer=CONSUMER_CYCLE[(tid + i) % len(CONSUMER_CYCLE)]))

    cuda_build.reset_launches()
    t0 = time.perf_counter()
    ths = [threading.Thread(target=single_worker, args=(t,)) for t in range(BUS_THREADS)]
    for th in ths:
        th.start()
    for th in ths:
        th.join()
    bus_wall = time.perf_counter() - t0
    bus_launches = dict(cuda_build.LAUNCHES)
    assert results == [True] * N_SINGLES, results.count(False)
    missing = [k for k in SINGLES_KERNELS if bus_launches[k] == 0]
    assert not missing, f"bus_singles: the path launched no {missing}"
    bus_amort = sum(v - amort1.get(k, 0.0) for k, v in device_attribution.amortized_totals().items()
                    if k[0] in CONSUMER_CYCLE)
    st = bus.stats()
    records["bus_singles"] = {
        "singles": N_SINGLES, "threads": BUS_THREADS, "max_hold_ms": 30.0,
        "direct_wall_s": direct_wall, "bus_wall_s": bus_wall,
        "speedup_per_verification": (direct_wall / N_SINGLES) / (bus_wall / N_SINGLES),
        "direct_amortized_fixed_ms": direct_amort, "bus_amortized_fixed_ms": bus_amort,
        "batches_formed": st["batches_formed"], "mean_live_per_batch": st["mean_live_per_batch"],
        "coalesced_batches": st["coalesced_batches"], "triggers": st["triggers"],
        "deadline_misses": st["deadline_misses"], "wall_model": st["wall_model"],
        "direct_launches": direct_launches, "bus_launches": bus_launches,
    }
    print(smi, flush=True)
    emit("bus_singles", **records["bus_singles"])

    # the wall model's per-set cost on the card: the slot's single-call
    # wall p50 less the fixed cost of one dispatch, a set
    per_set_s = (e2e_p50_s["grouped"] - records["ingest"]["fixed_dispatch_ms"] / 1e3) / len(slot)
    records["wall_model"] = {"per_set_cost_s": per_set_s, "in_code_s": wall_model.PER_SET_COST_S,
                             "fixed_ms": records["ingest"]["fixed_dispatch_ms"],
                             "fixed_in_code_ms": device_attribution.FIXED_DEVICE_COST_MS,
                             "slot_p50_s": e2e_p50_s["grouped"], "sets": len(slot)}
    print(smi, flush=True)
    emit("wall_model", **records["wall_model"])

    # -------------------------------------------------- 7e. KZG (kzg)
    # the kzg slice at mainnet width (types/spec.py: 4,096 field elements a
    # blob, 6 blobs a block): the dev setup and its packed window table;
    # six seeded blobs' commitments and proofs through backend="gpu" (blob
    # 0's held byte-equal to "ref"); the variable-base MSM on the committed
    # 4,096-point vector; the block's batch verify (True), a tampered blob
    # and two swapped proofs (False), one blob (True), the ref backend on
    # the six (True); launches and the plain Fp product count read around
    # one verify and one MSM of each form (no plain version runs on the
    # card's path); every kernel at the KZG shapes held exactly against its
    # plain version; a 255-bit K1 edge batch; an injected error
    GUARD.reset()
    INJECTOR.reset()
    KZG_FE, KZG_BLOBS = 4_096, 6
    kz = {}
    t0 = time.perf_counter()
    setup = pkzg.dev_setup(KZG_FE)
    t1 = time.perf_counter()
    packed = kzg_gpu._host_table(setup, KZG_FE)
    t2 = time.perf_counter()
    kz["setup"] = {"powers": KZG_FE, "dev_setup_s": t1 - t0, "table_s": t2 - t1,
                   "table_mb": packed.nbytes / 1e6}
    rng = random.Random(4844)
    blobs = [b"".join(rng.randrange(R_ORDER).to_bytes(32, "big") for _ in range(KZG_FE))
             for _ in range(KZG_BLOBS)]
    emit("kzg_setup", **kz["setup"])

    # kzg_commit: one commitment's launches and plain products, then the
    # six commitments and proofs, blob 0's against "ref"
    prod0 = fd.FP_PRODUCTS
    cuda_build.reset_launches()
    t0 = time.perf_counter()
    comm0 = pkzg.blob_to_kzg_commitment(blobs[0], setup=setup, backend="gpu", device="cuda")
    first_commit_s = time.perf_counter() - t0
    fixed_launches = {k: v for k, v in cuda_build.LAUNCHES.items() if v}
    fixed_plain = fd.FP_PRODUCTS - prod0
    assert fixed_launches == KZG_FIXED_LAUNCHES and not fixed_plain, (fixed_launches, fixed_plain)
    t0 = time.perf_counter()
    comms = [comm0] + [pkzg.blob_to_kzg_commitment(b, setup=setup, backend="gpu", device="cuda")
                       for b in blobs[1:]]
    t1 = time.perf_counter()
    proofs = [pkzg.compute_blob_kzg_proof(b, c, setup=setup, backend="gpu", device="cuda")
              for b, c in zip(blobs, comms)]
    t2 = time.perf_counter()
    msm_stats = dict(kzg_gpu.LAST_MSM_STATS)
    t3 = time.perf_counter()
    ref_comm = pkzg.blob_to_kzg_commitment(blobs[0], setup=setup, backend="ref")
    ref_proof = pkzg.compute_blob_kzg_proof(blobs[0], comms[0], setup=setup, backend="ref")
    t4 = time.perf_counter()
    assert ref_comm == comms[0] and ref_proof == proofs[0], "kzg_commit: gpu and ref bytes differ"
    # the fixed-base MSM's device time alone, on blob 0's scalars
    kzg_table = kzg_gpu._device_table(setup, KZG_FE, packed, dev)
    poly = kzg_api.blob_to_polynomial(blobs[0])
    f_mags, f_negs = (torch.from_numpy(a).to(dev)
                      for a in window_ladder.signed_digit_arrays(poly, nbits=kmsm.SCALAR_BITS))
    fixed_ms = cuda_build.time_ms(lambda: kmsm.msm_fixed_base(kzg_table, f_mags, f_negs))
    kz["commit"] = {"blobs": KZG_BLOBS, "first_commit_s": first_commit_s,
                    "commit_s_each": (t1 - t0) / (KZG_BLOBS - 1),
                    "proof_s_each": (t2 - t1) / KZG_BLOBS, "last_proof_split": msm_stats,
                    "ref_commit_and_proof_s": t4 - t3, "ref_byte_equal": True,
                    "fixed_msm_device_ms": fixed_ms, "launches": fixed_launches,
                    "plain_fp_products": fixed_plain}
    print(smi, flush=True)
    emit("kzg_commit", **kz["commit"])

    # the variable-base MSM on the committed 4,096-point vector
    with open(os.path.join(HERE, "tests", "vectors", "kzg", "msm", "full_4096.json")) as f:
        case = json.load(f)
    v_pts = [None if p is None else (int(p["x"], 16), int(p["y"], 16)) for p in case["input"]["points"]]
    v_sc = [int(s, 16) for s in case["input"]["scalars"]]
    prod0 = fd.FP_PRODUCTS
    cuda_build.reset_launches()
    t0 = time.perf_counter()
    v_out = kzg_gpu.g1_msm_gpu(v_pts, v_sc, device="cuda")
    v_wall = time.perf_counter() - t0
    var_launches = {k: v for k, v in cuda_build.LAUNCHES.items() if v}
    var_plain = fd.FP_PRODUCTS - prod0
    assert var_launches == KZG_VARIABLE_LAUNCHES and not var_plain, (var_launches, var_plain)
    assert point_serde.g1_compress(v_out) == bytes.fromhex(case["output"][2:]), "kzg_msm: wrong point"
    vx, vy, vmask = kzg_gpu._affine_words(v_pts)
    v_mags, v_negs = window_ladder.signed_digit_arrays(v_sc, nbits=kmsm.SCALAR_BITS)
    v_in = [torch.from_numpy(a).to(dev) for a in (vx, vy, vmask, v_mags, v_negs)]
    var_ms = cuda_build.time_ms(lambda: kmsm.msm_variable(*v_in, device=dev))
    kz["variable_msm"] = {"points": len(v_pts), "matches_vector": True, "wall_s": v_wall,
                          "split": dict(kzg_gpu.LAST_MSM_STATS), "device_ms": var_ms,
                          "launches": var_launches, "plain_fp_products": var_plain}
    emit("kzg_msm", **kz["variable_msm"])

    # kzg_block: the six through backend="gpu"
    prod0 = fd.FP_PRODUCTS
    cuda_build.reset_launches()
    ok = pkzg.verify_blob_kzg_proof_batch(blobs, comms, proofs, backend="gpu", setup=setup,
                                          device="cuda")
    verify_launches = {k: v for k, v in cuda_build.LAUNCHES.items() if v}
    verify_plain = fd.FP_PRODUCTS - prod0
    assert ok is True, "kzg_block: the block's blobs were rejected"
    assert verify_launches == KZG_VERIFY_LAUNCHES and not verify_plain, (verify_launches, verify_plain)
    walls, splits = [], []
    for r in range(REPS):
        t0 = time.perf_counter()
        assert pkzg.verify_blob_kzg_proof_batch(blobs, comms, proofs, backend="gpu", setup=setup,
                                                seed=100 + r, device="cuda")
        walls.append(time.perf_counter() - t0)
        splits.append(dict(kzg_gpu.LAST_HOST_STATS))
    split = {k: statistics.median(s[k] for s in splits)
             for k in ("challenge_ms", "evaluate_ms", "decompress_ms", "pack_ms", "host_ms",
                       "device_ms")}
    tampered = list(blobs)
    tampered[2] = tampered[2][:64] + bytes([tampered[2][64] ^ 1]) + tampered[2][65:]
    bad_blob = pkzg.verify_blob_kzg_proof_batch(tampered, comms, proofs, backend="gpu",
                                                setup=setup, device="cuda")
    swapped = [proofs[1], proofs[0]] + proofs[2:]
    bad_swap = pkzg.verify_blob_kzg_proof_batch(blobs, comms, swapped, backend="gpu", setup=setup,
                                                device="cuda")
    one = pkzg.verify_blob_kzg_proof_batch(blobs[:1], comms[:1], proofs[:1], backend="gpu",
                                           setup=setup, device="cuda")
    t0 = time.perf_counter()
    ref_ok = pkzg.verify_blob_kzg_proof_batch(blobs, comms, proofs, backend="ref", setup=setup)
    ref_s = time.perf_counter() - t0
    assert bad_blob is False and bad_swap is False and one is True and ref_ok is True, \
        (bad_blob, bad_swap, one, ref_ok)
    # the host's decompression of one commitment, with and without its
    # subgroup check, a mean over the six
    t0 = time.perf_counter()
    c_pts = [point_serde.g1_decompress(c) for c in comms]
    t1 = time.perf_counter()
    assert all(RG1.in_subgroup(c) for c in c_pts)
    t2 = time.perf_counter()
    kz["block"] = {"blobs": KZG_BLOBS, "verdict": ok, "tampered_blob": bad_blob,
                   "swapped_proofs": bad_swap, "one_blob": one, "ref_agrees": ref_ok,
                   "ref_s": ref_s, "p50_s": statistics.median(walls), "walls_s": walls,
                   "host_split_p50": split,
                   "decompress_one_ms": (t1 - t0) / KZG_BLOBS * 1e3,
                   "subgroup_one_ms": (t2 - t1) / KZG_BLOBS * 1e3,
                   "launches": verify_launches, "plain_fp_products": verify_plain}
    print(smi, flush=True)
    emit("kzg_block", **kz["block"])

    # the kernels at the KZG shapes, step by step, each against its plain
    # version: the block's lanes (4b = 32), the fixed-base MSM's 64 x 4,096
    # selected lanes and its Horner lanes, the variable-base MSM's lanes
    recs = records.setdefault("kzg", {})
    _, zs, ys, cs, ws = kzg_api._batch_inputs(blobs, comms, proofs, setup)
    rs = kzg_api._rlc_scalars(KZG_BLOBS, 5)
    hold_verify_path("kzg_block", *kzg_gpu.verify_lanes(cs, ws, rs, zs, ys), setup.tau_g2, recs)
    # the fixed-base MSM: the selection (indexing, no kernel), the fold of
    # 64 x 4,096 lanes to the 64 window sums, the Horner ladder on 64 lanes
    # and its fold
    sel = kmsm.select_fixed(kzg_table, f_mags, f_negs)
    W = int(f_mags.shape[0])
    recs["lane_sum_g1_msm"] = hold(
        "lane_sum_g1", lambda: curve_kernels.lane_sum(sel, KZG_FE),
        lambda: curve_kernels.lane_sum_plain(sel, KZG_FE), nb(sel))
    wsum = curve_kernels.lane_sum(sel, KZG_FE)
    h_mags, h_negs = kmsm.horner_digits(W, dev)
    recs["ladder_g1_horner"] = hold(
        "ladder_g1", lambda: ladder.ladder(wsum, h_mags, h_negs),
        lambda: ladder.ladder_plain(wsum, h_mags, h_negs), nb(wsum, h_mags, h_negs),
        products=ladder_rows.step_products(1, window_ladder.WINDOW_BITS * (W - 1), W - 1),
        rows=W * ladder_rows.lane_products(1, W))
    hacc = ladder.ladder(wsum, h_mags, h_negs)
    recs["lane_sum_g1_horner"] = hold(
        "lane_sum_g1", lambda: curve_kernels.lane_sum(hacc, W),
        lambda: curve_kernels.lane_sum_plain(hacc, W), nb(hacc))
    # the variable-base MSM's ladder on its 4,096 points
    v_pt = bv._from_affine(bv._lanes(v_in[0], dev), bv._lanes(v_in[1], dev), bv._mask(v_in[2], dev))
    v_m, v_n = (t.to(torch.int32).contiguous() for t in v_in[3:])
    recs["ladder_g1_variable"] = hold(
        "ladder_g1", lambda: ladder.ladder(v_pt, v_m, v_n),
        lambda: ladder.ladder_plain(v_pt, v_m, v_n), nb(v_pt, v_m, v_n),
        products=k1_needed(1, v_m, v_in[2]), rows=len(v_pts) * ladder_rows.lane_products(1, W))
    # K1 at 255 bits on an edge batch: 0, 1, r - 1, 2^254, 2^255 - 1 (the
    # top window's 7 plus a carry: digit 8), every digit -8 / +8, random,
    # and identity lanes; against the plain version and ref_curve
    e_pts = [RG1.mul_scalar(RG1.generator, 3 + i) for i in range(12)] + [None] * 4
    e_sc = [0, 1, R_ORDER - 1, 2**254, 2**255 - 1, int("8" * 63, 16), int("9" * 63, 16),
            rng.randrange(R_ORDER), rng.randrange(R_ORDER), 2**252 * 7, 12345, 2**64 - 1,
            R_ORDER - 1, 5, 0, 2**255 - 1]
    ex, ey, emask = kzg_gpu._affine_words([None if p is None else RG1.to_affine(p) for p in e_pts])
    e_mags, e_negs = (torch.from_numpy(a).to(dev).to(torch.int32).contiguous()
                      for a in window_ladder.signed_digit_arrays(e_sc, nbits=255))
    e_pt = bv._from_affine(bv._lanes(ex, dev), bv._lanes(ey, dev), bv._mask(emask, dev))
    e_out = ladder.ladder(e_pt, e_mags, e_negs)
    e_plain = ladder.ladder_plain(e_pt, e_mags, e_negs)
    e_err = max(int((a.to(torch.int64) - b.to(torch.int64)).abs().max()) for a, b in zip(e_out, e_plain))
    ax, ay, ainf = (t.cpu() for t in curve_kernels.to_affine(e_out))
    e_ref = True
    for k, (p, s) in enumerate(zip(e_pts, e_sc)):
        want = RG1.infinity if p is None else RG1.mul_scalar(p, s)
        if RG1.is_infinity(want):
            e_ref &= bool(ainf[k])
        else:
            got = (fd.words_from_mont(ax[0, :, k][None])[0], fd.words_from_mont(ay[0, :, k][None])[0])
            e_ref &= got == RG1.to_affine(want)
    emit("kzg_k1_edge", lanes=len(e_pts), max_abs_err=e_err, ref_curve_agrees=e_ref,
         top_digit_8=bool(e_mags[63, 4] == 8))
    assert e_err == 0 and e_ref, "kzg: K1's 255-bit edge batch disagrees"

    # the guard: an injected error on the kzg plane raises a DeviceFaultError
    # before any launch; the next call is right; and the kzg self-test
    INJECTOR.arm("error", "kzg", rate=1.0, seed=1)
    cuda_build.reset_launches()
    try:
        pkzg.verify_blob_kzg_proof_batch(blobs, comms, proofs, backend="gpu", setup=setup,
                                         device="cuda")
        raise AssertionError("kzg: an injected error went unseen")
    except DeviceFaultError as e:
        kz["guard"] = {"raised": type(e).__name__, "launches": sum(cuda_build.LAUNCHES.values())}
    INJECTOR.reset()
    kz["guard"]["next_verdict"] = pkzg.verify_blob_kzg_proof_batch(
        blobs, comms, proofs, backend="gpu", setup=setup, device="cuda")
    kz["guard"]["selftest"] = GUARD.self_test(("kzg",))
    kz["guard"]["stats"] = GUARD.stats()["faults"]
    assert kz["guard"]["launches"] == 0 and kz["guard"]["next_verdict"] is True \
        and kz["guard"]["selftest"] == {"kzg": True}, kz["guard"]
    emit("kzg_guard", **kz["guard"])
    records["kzg_phase"] = kz
    kzg_launches = {"verify": verify_launches, "fixed": fixed_launches, "variable": var_launches}
    GUARD.reset()

    # ------------------------------------------ 7f. Merkle proofs (merkle)
    # the light-client finality branch (depth 6; bench_lcserve.py's lcproof
    # queries) at 1,024 and 16,384 queries: the SHA-256 fold against its
    # plain version, exact words, its device time, bound and hashlib's time;
    # then batch_merkle_roots (one launch) byte-equal to hashlib, its wall,
    # packing and guarded dispatch on the first call and two warm ones
    GUARD.reset()
    INJECTOR.reset()
    mk = {}
    merkle_q = {n: T.proof_queries(n, MERKLE_DEPTH) for n in (1_024, 16_384)}
    merkle_roots = {}
    recs = records.setdefault("merkle", {})

    def merkle_bound(lanes, depth):
        t_bytes = merkle_proof.fold_bytes(lanes, depth) / HBM_BYTES_PER_S * 1e3
        t_ops = merkle_proof.fold_ops(lanes, depth) / INT_OPS_PER_S * 1e3
        return (max(t_bytes, t_ops), "operations" if t_ops >= t_bytes else "bytes"), \
            merkle_proof.fold_ops(lanes, depth, merkle_proof.level_ops) / INT_OPS_PER_S * 1e3

    for n, q in merkle_q.items():
        ops = [torch.from_numpy(a).to(dev) for a in merkle_proof.pack_queries(q, MERKLE_DEPTH)]
        bound, formula_ms = merkle_bound(n, MERKLE_DEPTH)
        rec = hold("sha256_fold", lambda: merkle_proof.fold_branches(*ops),
                   lambda: merkle_proof.fold_branches_plain(*ops), nb(*ops), bound=bound)
        t0 = time.perf_counter()
        host = merkle_proof.fold_branches_host(q)
        hashlib_ms = (time.perf_counter() - t0) * 1e3
        cuda_build.reset_launches()
        roots = merkle_proof.batch_merkle_roots(q, consumer="light_client", device="cuda")
        launches = {k: v for k, v in cuda_build.LAUNCHES.items() if v}
        assert roots == host and launches == {"sha256_fold": 1}, ("merkle", n, launches)
        splits = [dict(merkle_proof.LAST_STATS)]
        for _ in range(2):  # warm calls
            assert merkle_proof.batch_merkle_roots(q, consumer="light_client", device="cuda") == host
            splits.append(dict(merkle_proof.LAST_STATS))
        merkle_roots[n] = host
        rec.update(lanes=n, depth=MERKLE_DEPTH, hashlib_ms=hashlib_ms,
                   batch_wall_ms=[x["wall_ms"] for x in splits],
                   batch_pack_ms=[x["pack_ms"] for x in splits],
                   batch_dispatch_ms=[x["dispatch_ms"] for x in splits],
                   launches=launches["sha256_fold"], bound_formula_ms=formula_ms,
                   instructions_a_level=merkle_proof.level_instructions(),
                   formula_ops_a_level=merkle_proof.level_ops(), library_ms=None)
        recs[n] = rec
        print(smi, flush=True)
        emit("merkle_fold", **rec)

    # the edge batch in one call: depths 1, 3, 17 and 40 with 7, 1, 1,025
    # and 7 lanes; by lane mod 7: zeros all-left, 0xFF all-right, zeros
    # all-right, 0xFF all-left, random bytes on a random path, all-left,
    # all-right; one corrupted sibling in the depth-17 group
    erng = random.Random(12)
    edge = []
    for depth, count in ((1, 7), (3, 1), (17, 1_025), (40, 7)):
        for i in range(count):
            kind = i % 7
            fill = {0: b"\x00" * 32, 1: b"\xff" * 32, 2: b"\x00" * 32, 3: b"\xff" * 32}.get(kind)
            leaf = fill or erng.randbytes(32)
            branch = [fill or erng.randbytes(32) for _ in range(depth)]
            path = {0: 0, 1: (1 << depth) - 1, 2: (1 << depth) - 1, 3: 0, 5: 0,
                    6: (1 << depth) - 1}.get(kind, erng.getrandbits(depth))
            edge.append((leaf, branch, (1 << depth) | path))
    edge_want = merkle_proof.fold_branches_host(edge)
    bad = 7 + 1 + 500
    leaf, branch, g = edge[bad]
    branch = list(branch)
    branch[9] = bytes([branch[9][0] ^ 1]) + branch[9][1:]
    corrupted = edge[:bad] + [(leaf, branch, g)] + edge[bad + 1:]
    cuda_build.reset_launches()
    verdicts = merkle_proof.batch_verify_branches(corrupted, edge_want, consumer="bench", device="cuda")
    edge_launches = cuda_build.LAUNCHES["sha256_fold"]
    edge_roots = merkle_proof.batch_merkle_roots(corrupted, consumer="bench", device="cuda")
    edge_err = 0
    for depth in (1, 3, 17, 40):
        group = [e for e in corrupted if len(e[1]) == depth]
        ops = [torch.from_numpy(a).to(dev) for a in merkle_proof.pack_queries(group, depth)]
        k, p = merkle_proof.fold_branches(*ops), merkle_proof.fold_branches_plain(*ops)
        edge_err = max(edge_err, int((k.to(torch.int64) - p.to(torch.int64)).abs().max()))
    mk["edge"] = {"queries": len(edge), "depths": [1, 3, 17, 40], "lanes": [7, 1, 1_025, 7],
                  "launches": edge_launches, "false_at": [i for i, v in enumerate(verdicts) if not v],
                  "corrupted_at": bad, "max_abs_err": edge_err,
                  "roots_eq_hashlib": edge_roots == merkle_proof.fold_branches_host(corrupted)}
    assert mk["edge"]["false_at"] == [bad] and edge_launches == 4 and edge_err == 0 \
        and mk["edge"]["roots_eq_hashlib"], mk["edge"]
    # the committed state_proof vectors, and the self-test over the planes
    vdir = os.path.join(HERE, "tests", "vectors", "merkle_proof", "state_proof")
    vq, vroots, vwant = [], [], []
    for name in sorted(os.listdir(vdir)):
        with open(os.path.join(vdir, name)) as f:
            case = json.load(f)
        i = case["input"]
        vq.append((bytes.fromhex(i["leaf"][2:]), [bytes.fromhex(b[2:]) for b in i["branch"]], i["gindex"]))
        vroots.append(bytes.fromhex(i["state_root"][2:]))
        vwant.append(case["output"])
    mk["vectors"] = {"cases": len(vq),
                     "verdicts": merkle_proof.batch_verify_branches(vq, vroots, consumer="bench",
                                                                    device="cuda")}
    mk["selftest"] = GUARD.self_test()
    assert mk["vectors"]["verdicts"] == vwant and vwant.count(True) == 3 \
        and mk["selftest"] == {"bls": True, "kzg": True, "merkle_proof": True}, mk
    emit("merkle", **mk)
    records["merkle_phase"] = mk
    GUARD.reset()

    # ----------------------------------------- 7g. the slot program (slot_program)
    # one program: the slot's 64 committee submissions (consumer oppool),
    # phase 7e's six-blob settle and 1,024 depth-6 Merkle queries, canary on
    # (the sentinel's key is in the table since 7c)
    sp = {}
    pq = merkle_q[1_024]

    def program(settle_blobs=blobs, subs=committees, queries=pq, seed=None):
        work = SettleWork(settle_blobs, comms, proofs)
        prog = SlotProgram(seed=seed).add_settle(work)
        for c in subs:
            prog.add_signatures(c, consumer="oppool")
        prog.add_merkle(queries, merkle_roots[1_024], consumer="light_client")
        return prog, work

    prog, work = program(seed=80)
    d0 = GUARD.stats()["dispatches"]
    cuda_build.reset_launches()
    t0 = time.perf_counter()
    ok, record = prog.run(backend="gpu", device="cuda")
    first_wall = time.perf_counter() - t0
    program_launches = dict(cuda_build.LAUNCHES)
    sp["dispatches"] = GUARD.stats()["dispatches"] - d0
    assert ok is True and work.verdicts == [True] and prog.merkle_results == [[True] * len(pq)], \
        (ok, work.verdicts)
    assert sp["dispatches"] == 1, sp
    missing = [k for k in PROGRAM_KERNELS if program_launches[k] == 0]
    assert not missing, f"slot_program: the program launched no {missing}"
    walls = [first_wall]
    for r in range(2):
        prog, work = program(seed=81 + r)
        t0 = time.perf_counter()
        assert prog.run(backend="gpu", device="cuda")[0] is True and work.verdicts == [True]
        walls.append(time.perf_counter() - t0)
    # the serial calls on the same inputs: the canary pair, the settle, the
    # Merkle check and the fold with the valid sentinel riding it
    serial = {}
    serial_launches = {}

    def serial_call(name, fn):
        ws = []
        for r in range(3):
            cuda_build.reset_launches()
            t0 = time.perf_counter()
            out = fn(r)
            ws.append(time.perf_counter() - t0)
            if r == 0:
                for k, v in cuda_build.LAUNCHES.items():
                    serial_launches[k] = serial_launches.get(k, 0) + v
        serial[name] = {"p50_s": statistics.median(ws), "walls_s": ws}
        return out

    serial_call("canary_pair", lambda r: canary.check_pair("gpu", device=dev))
    assert serial_call("settle", lambda r: pkzg.verify_blob_kzg_proof_batch(
        blobs, comms, proofs, backend="gpu", consumer="kzg", device="cuda")) is True
    assert serial_call("merkle", lambda r: merkle_proof.batch_verify_branches(
        pq, merkle_roots[1_024], consumer="light_client", device="cuda")) == [True] * len(pq)
    assert serial_call("fold", lambda r: api.verify_signature_sets_shared(
        [(c, "oppool") for c in committees], seed=90 + r,
        extra_sets=[canary.bls_sentinels()[0]], device="cuda"))[0] is True
    fused = {k: v for k, v in program_launches.items() if v}
    summed = {k: v for k, v in serial_launches.items() if v}
    assert fused == summed, ("slot_program: launches", fused, summed)
    sp.update({"sets": sum(len(c) for c in committees), "blobs": len(blobs), "queries": len(pq),
               "verdict": ok, "settle": True, "merkle_all_true": True, "launches": fused,
               "serial_launches_sum": summed, "wall_p50_s": statistics.median(walls),
               "walls_s": walls, "serial": serial,
               "serial_sum_p50_s": sum(serial[k]["p50_s"] for k in ("settle", "merkle", "fold")),
               "record": {k: record.get(k) for k in ("lanes", "live", "waste", "amortized_fixed_ms")}})
    # the verdict pattern: a tampered blob, a forged signature in committee
    # 31, a corrupted sibling of query 100
    prog, work = program(settle_blobs=tampered)
    sp["tampered_blob"] = {"program": prog.run(backend="gpu", device="cuda")[0], "settle": work.verdicts}
    prog, work = program(subs=bad_committees)
    sp["forged_committee_31"] = {"program": prog.run(backend="gpu", device="cuda")[0],
                                 "settle": work.verdicts}
    leaf, branch, g = pq[100]
    bad_q = pq[:100] + [(leaf, [branch[0], bytes([branch[1][0] ^ 1]) + branch[1][1:]] + branch[2:], g)] \
        + pq[101:]
    prog, work = program(queries=bad_q)
    ok_bad = prog.run(backend="gpu", device="cuda")[0]
    sp["corrupted_sibling"] = {"program": ok_bad, "settle": work.verdicts,
                               "false_at": [i for i, v in enumerate(prog.merkle_results[0]) if not v]}
    assert sp["tampered_blob"] == {"program": True, "settle": [False]}, sp["tampered_blob"]
    assert sp["forged_committee_31"] == {"program": False, "settle": [True]}, sp["forged_committee_31"]
    assert sp["corrupted_sibling"] == {"program": False, "settle": [True], "false_at": [100]}, \
        sp["corrupted_sibling"]

    # through the bus: 64 committee submissions from 8 threads; thread 0
    # stages the settle and submits committee 0 first, the others start once
    # that submission's flush has formed its batch
    bus = VerificationBus(backend="gpu", journal=Journal())
    work = SettleWork(blobs, comms, proofs)
    bus_verdicts = [None] * N_COMMITTEES
    bus_errors = []

    def bus_worker(tid):
        try:
            for g in range(tid, N_COMMITTEES, 8):
                if g == 0:
                    bus.stage_program_work(work)
                    bus_verdicts[g] = bus.submit(committees[g], consumer="oppool",
                                                 journal_attrs={"program": 1})
                    continue
                while bus.stats()["batches_formed"] < 1:
                    time.sleep(0.001)
                bus_verdicts[g] = bus.submit(committees[g], consumer="oppool")
        except Exception as e:  # a fault fails the phase below
            bus_errors.append(repr(e))

    cuda_build.reset_launches()
    t0 = time.perf_counter()
    ths = [threading.Thread(target=bus_worker, args=(t,)) for t in range(8)]
    for th in ths:
        th.start()
    for th in ths:
        th.join()
    bus_wall = time.perf_counter() - t0
    st = bus.stats()
    staged_ev = [e for e in bus.journal.query(kind="signature_batch") if e["attrs"].get("program")]
    only = SettleWork(blobs, comms, proofs)
    settle_only = bus.submit_program(only)
    sp["bus"] = {"submissions": N_COMMITTEES, "threads": 8, "wall_s": bus_wall,
                 "errors": bus_errors, "settle": work.verdicts, "triggers": st["triggers"],
                 "staged_trigger": [e["attrs"]["trigger"] for e in staged_ev],
                 "batches_formed": st["batches_formed"], "launches": dict(cuda_build.LAUNCHES),
                 "settle_only": {"program": settle_only, "settle": only.verdicts}}
    assert not bus_errors and bus_verdicts == [True] * N_COMMITTEES, bus_errors
    assert work.verdicts == [True] and sp["bus"]["staged_trigger"] == ["bulk"], sp["bus"]
    assert settle_only is True and only.verdicts == [True], sp["bus"]["settle_only"]
    # an injected stall reaches the program's submitter, the work
    # undelivered; a flip on the canaried program raises CanaryViolation
    GUARD.reset()
    INJECTOR.arm("stall", "bls", rate=1.0, seed=3)
    stalled = SettleWork(blobs, comms, proofs)
    bus2 = VerificationBus(backend="gpu")
    bus2.stage_program_work(stalled)
    try:
        bus2.submit(committees[0], consumer="oppool")
        raise AssertionError("slot_program: an injected stall went unseen")
    except DeviceFaultError as e:
        sp["stall"] = {"raised": type(e).__name__, "settle": stalled.verdicts}
    INJECTOR.reset()
    GUARD.reset()
    INJECTOR.arm("flip", "bls", rate=1.0, seed=9)
    prog, work = program()
    try:
        prog.run(backend="gpu", device="cuda")
        raise AssertionError("slot_program: a flip went unseen")
    except CanaryViolation as e:
        sp["flip"] = {"raised": type(e).__name__, "settle": work.verdicts,
                      "merkle_results": prog.merkle_results}
    INJECTOR.reset()
    GUARD.reset()
    assert sp["stall"] == {"raised": "DeviceStallInjected", "settle": []}, sp["stall"]
    assert sp["flip"] == {"raised": "CanaryViolation", "settle": [], "merkle_results": []}, sp["flip"]
    records["slot_program"] = sp
    print(smi, flush=True)
    emit("slot_program", **sp)

    # ------------------------------------------ 7h. data availability (da)
    # the DA plane at mainnet width (MAINNET_DA; phase 7e's six blobs and
    # setup): the Horner kernel against its plain version on the 6 live
    # blobs x 8,192 points, exact; 64 seeded points of every blob against
    # host Horner; its plain_out form (rs_extend_graph) on Montgomery
    # coefficients equal to it; the kernel's edge batch (n_coeff that S
    # divides or not, every S); an extension edge batch (a zero blob, a
    # blob of all r - 1, blob counts 1, 3 and 6); extend_blobs p50; the six blobs' cells
    # and proofs, three of blob 0 against "ref"; cell verifies (the custody
    # sample, the full block, three tampered batches, "ref"); reconstruction
    # at 1,024 elements; the bus; the guard
    GUARD.reset()
    INJECTOR.reset()
    dspec = type("MainnetDA", (), MAINNET_DA)()
    dgeo = geometry_for_spec(dspec)
    dn = len(blobs)
    dm = dgeo.cell_elements
    da = {"geometry": {"blob_elements": dgeo.blob_elements, "points": dgeo.ext_elements,
                       "cell_elements": dm, "columns": dgeo.num_cells, "blobs": dn}}
    drecs = records.setdefault("da", {})
    dpolys = [da_erasure.blob_to_ints(b, dgeo) for b in blobs]
    d_coeffs = torch.from_numpy(da_gpu.pack_coefficients(dpolys, dgeo.blob_elements, dn)).to(dev)
    d_points = da_gpu.domain_points(dgeo, dev)

    def horner_bound(blob_lanes):
        t_ops = (rs_extend.horner_products(dgeo.blob_elements, dgeo.ext_elements, blob_lanes)
                 * IMAD_PER_FR_PRODUCT / INT_OPS_PER_S * 1e3)
        t_bytes = rs_extend.horner_bytes(dgeo.blob_elements, dgeo.ext_elements, blob_lanes) \
            / HBM_BYTES_PER_S * 1e3
        return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"

    # the kernel's two instantiations (S = 4, 8): no stack frame, no spill
    rs_ptxas = {name: dict(rec, **ptxas["rs_extend"]["functions"].get(name, {}))
                for name, rec in ptxas["rs_extend"]["kernels"].items()}
    assert len(rs_ptxas) == 2 and not ptxas["rs_extend"]["spill_store_bytes"] \
        and not any(r["stack_bytes"] or r.get("stack_frame") for r in rs_ptxas.values()), \
        f"rs_extend: stack frame or spills {rs_ptxas}"
    rs_plan = rs_extend.plan(dgeo.blob_elements, dn, dgeo.ext_elements, dev)
    fr0 = rfield.FR_PRODUCTS
    drecs["rs_extend"] = hold(
        "rs_extend", lambda: rs_extend.eval_poly_batch(d_coeffs, d_points),
        lambda: rs_extend.eval_poly_batch_plain(d_coeffs, d_points), nb(d_coeffs, d_points),
        bound=horner_bound(dn),
        extra={"fr_products": rs_extend.horner_products(dgeo.blob_elements, dgeo.ext_elements, dn),
               "split_products": rs_extend.split_products(dgeo.blob_elements, dgeo.ext_elements, dn,
                                                          rs_plan["segments"]),
               "lanes": [dgeo.ext_elements, dn], "live_blobs": dn, "plan": rs_plan,
               "ptxas": rs_ptxas})
    drecs["rs_extend"]["fr_products_plain"] = rfield.FR_PRODUCTS - fr0
    d_out = rs_extend.eval_poly_batch(d_coeffs, d_points).cpu().numpy()
    d_flat = rfield.words_to_ints(d_out)
    d_evals = [d_flat[b::dn] for b in range(dn)]

    def host_horner(poly, x):
        acc = 0
        for c in reversed(poly):
            acc = (acc * x + c) % R_ORDER
        return acc

    drng = random.Random(13)
    d_sample = drng.sample(range(dgeo.ext_elements), min(64, dgeo.ext_elements))
    t0 = time.perf_counter()
    sample_ok = all(d_evals[b][p] == host_horner(dpolys[b], dgeo.ext_points[p])
                    for p in d_sample for b in range(dn))
    host_sample_s = time.perf_counter() - t0
    # the plain_out form on Montgomery coefficients gives the same plain values
    mont = torch.from_numpy(rfield.mont_words(
        [dpolys[b][i] for i in range(dgeo.blob_elements) for b in range(dn)]).reshape(
            dgeo.blob_elements, dn, rfield.NW)).to(dev)
    graph_eq = bool(torch.equal(rs_extend.rs_extend_graph(mont, d_points).cpu(), torch.from_numpy(d_out)))
    da["kernel"] = {"sampled_points": len(d_sample), "sample_eq_host": sample_ok,
                    "host_sample_s": host_sample_s, "blob_lanes": int(d_coeffs.shape[1]),
                    "rs_extend_graph_eq": graph_eq, "plan": rs_plan}
    assert sample_ok and da["kernel"]["blob_lanes"] == dn and graph_eq, da["kernel"]
    # the kernel's edge batch against the plain version: points 0, 1 and
    # r - 1 among seeded ones, blob 1 all r - 1, n_coeff that S divides or
    # not and below S; 3 blobs x 256 points, where the plan takes S = 8,
    # and 48 points x the fewest blobs where it takes S = 4 (48 points are
    # 2 blocks of 32 at S = 4 and 3 of 16 at S = 8, so some blob count
    # fills S = 4's last wave better)
    erng_d = np.random.default_rng(15)

    def rand_mont(n):
        return rfield.mont_words([int.from_bytes(erng_d.bytes(32), "little") % R_ORDER
                                  for _ in range(n)])

    def edge_points(n):
        return torch.from_numpy(np.concatenate(
            [rfield.mont_words([0, 1, R_ORDER - 1]), rand_mont(n - 3)])).to(dev)

    s4_blobs = next((b for b in range(1, 8_192) if rs_extend.plan(33, b, 48, dev)["segments"] == 4),
                    None)
    assert s4_blobs is not None, "rs_extend: no blob count at 48 points where the plan takes S = 4"
    k_edge = {}
    for blobs_e, pts_e, n_cs in ((3, 256, (1, 2, 3, 7, 8, 33, 4_095, 4_097)),
                                 (s4_blobs, 48, (1, 2, 3, 4, 5, 33, 1_023))):
        e_pts = edge_points(pts_e)
        for n_c in n_cs:
            cw = rand_mont(blobs_e * n_c).reshape(n_c, blobs_e, rfield.NW)
            cw[:, 1] = rfield.mont_words([R_ORDER - 1] * n_c)
            cw = torch.from_numpy(cw).to(dev)
            row = {"blobs": blobs_e, "points": pts_e,
                   "segments": rs_extend.plan(n_c, blobs_e, pts_e, dev)["segments"],
                   "eq": bool(torch.equal(rs_extend.eval_poly_batch(cw, e_pts),
                                          rs_extend.eval_poly_batch_plain(cw, e_pts)))}
            if n_c < 100:
                row["plain_out"] = bool(torch.equal(
                    rs_extend.eval_poly_batch(cw, e_pts, plain_out=True),
                    rs_extend.eval_poly_batch_plain(cw, e_pts, True)))
            k_edge[f"{blobs_e}x{pts_e}_n{n_c}"] = row
    da["kernel_edge"] = k_edge
    assert all(r["eq"] and r.get("plain_out", True) for r in k_edge.values()), k_edge
    assert {r["segments"] for r in k_edge.values()} == {4, 8} and all(
        r["segments"] == (4 if r["points"] == 48 else 8) for r in k_edge.values()), k_edge
    # the edge batch: blob counts 1, 3 and 6 through extend_blobs, a zero
    # blob and a blob of all r - 1 among them
    zero_blob = bytes(dgeo.blob_bytes)
    rm1_blob = (R_ORDER - 1).to_bytes(32, "big") * dgeo.blob_elements
    rm1_poly = [R_ORDER - 1] * dgeo.blob_elements
    edge = {}
    for count, bl in ((1, [zero_blob]), (3, [zero_blob, rm1_blob, blobs[0]]),
                      (6, [zero_blob, rm1_blob] + blobs[:4])):
        cuda_build.reset_launches()
        ev = da_erasure.extend_blobs(bl, dgeo, backend="gpu", device="cuda")
        launches = {k: v for k, v in cuda_build.LAUNCHES.items() if v}
        ok = ev[0] == [0] * dgeo.ext_elements and launches == {"rs_extend": 1}
        ok &= da_gpu.LAST_EXTEND_STATS["lanes"] == count  # no padding chains
        if count > 1:
            ok &= all(ev[1][p] == host_horner(rm1_poly, dgeo.ext_points[p]) for p in d_sample)
            ok &= ev[2:] == d_evals[: count - 2]
        edge[count] = {"ok": ok, "lanes": da_gpu.LAST_EXTEND_STATS["lanes"],
                       "bucket": da_gpu.LAST_EXTEND_STATS["bucket"], "launches": launches}
    da["edge"] = edge
    assert all(e["ok"] for e in edge.values()), edge
    # extend_blobs on the six: equal to the held kernel (so to the plain path)
    walls, splits = [], []
    for _ in range(3):
        cuda_build.reset_launches()
        t0 = time.perf_counter()
        ev = da_erasure.extend_blobs(blobs, dgeo, backend="gpu", device="cuda")
        walls.append(time.perf_counter() - t0)
        splits.append(dict(da_gpu.LAST_EXTEND_STATS))
        assert ev == d_evals, "da: extend_blobs differs from the kernel's held output"
        assert splits[-1]["lanes"] == dn, splits[-1]
    extend_launches = {k: v for k, v in cuda_build.LAUNCHES.items() if v}
    assert extend_launches == {"rs_extend": 1}, extend_launches
    da["extend"] = {"p50_s": statistics.median(walls), "walls_s": walls, "splits": splits,
                    "launches": extend_launches, "eq_kernel": True}
    print(smi, flush=True)
    emit("da_extend", **da["kernel"], edge=edge, **da["extend"])

    # cells and proofs of the six blobs through "gpu"; cells 0, 1 and 127 of
    # blob 0 against host Horner and their proofs against "ref"
    d_cells, d_proofs, proof_splits = [], [], []
    t0 = time.perf_counter()
    for i, b in enumerate(blobs):
        cuda_build.reset_launches()
        cs_i, ps_i = da_cells.compute_cells_and_kzg_proofs(b, dgeo, setup=setup, backend="gpu",
                                                          device="cuda")
        if i == 0:
            proof_launches = {k: v for k, v in cuda_build.LAUNCHES.items() if v}
        d_cells.append(cs_i)
        d_proofs.append(ps_i)
        proof_splits.append(dict(da_cells.LAST_PROOF_STATS))
    proofs_s = time.perf_counter() - t0
    want_launches = {"rs_extend": 1} | {k: v * dgeo.num_cells for k, v in KZG_FIXED_LAUNCHES.items()}
    assert proof_launches == want_launches, (proof_launches, want_launches)
    t0 = time.perf_counter()
    ref_ok = []
    for k in (0, 1, dgeo.num_cells - 1):
        want_cell = b"".join(host_horner(dpolys[0], dgeo.ext_points[i]).to_bytes(32, "big")
                             for i in dgeo.cell_indices(k))
        q, _ = da_cells._divide_by_vanishing(dpolys[0], dm, dgeo.vanishing_const(k))
        ref_proof = point_serde.g1_compress(kzg_api._msm_backend(q, setup, "ref"))
        ref_ok.append(d_cells[0][k] == want_cell and d_proofs[0][k] == ref_proof)
    ref_s = time.perf_counter() - t0
    da["proofs"] = {"blobs": dn, "cells_a_blob": dgeo.num_cells, "wall_s": proofs_s,
                    "split_ms_sum": {k: sum(x[k] for x in proof_splits)
                                     for k in ("extend_ms", "divide_ms", "msm_ms")},
                    "launches_a_blob": proof_launches, "ref_cells": [0, 1, dgeo.num_cells - 1],
                    "ref_byte_equal": ref_ok, "ref_s": ref_s}
    assert all(ref_ok), da["proofs"]
    print(smi, flush=True)
    emit("da_proofs", **da["proofs"])

    def cell_item(i, k):
        return (comms[i], k, d_cells[i][k], d_proofs[i][k])

    def cell_split():
        return {k: v for k, v in da_gpu.LAST_CELL_STATS.items()}

    # the custody sample: node-0's 4 columns x 6 blobs = 24 cells
    columns = da_custody.custody_columns("node-0", dspec)
    sample_items = [cell_item(i, k) for k in columns for i in range(dn)]
    cuda_build.reset_launches()
    ok = da_cells.verify_cell_proof_batch(sample_items, dgeo, backend="gpu", setup=setup, device="cuda")
    verify_launches_da = {k: v for k, v in cuda_build.LAUNCHES.items() if v}
    # a cell verify runs the KZG verify's kernels
    assert ok is True and verify_launches_da == KZG_VERIFY_LAUNCHES, (ok, verify_launches_da)
    walls, splits = [], []
    for r in range(3):
        t0 = time.perf_counter()
        assert da_cells.verify_cell_proof_batch(sample_items, dgeo, backend="gpu", setup=setup,
                                                seed=200 + r, device="cuda")
        walls.append(time.perf_counter() - t0)
        splits.append(cell_split())
    da["custody"] = {"node": "node-0", "columns": list(columns), "cells": len(sample_items),
                     "verdict": ok, "p50_s": statistics.median(walls), "walls_s": walls,
                     "split_p50": {k: statistics.median(s[k] for s in splits) for k in splits[0]},
                     "launches": verify_launches_da}
    # tampered: a flipped cell byte, a wrong index, a swapped proof; "ref"
    comm, k, cell, proof = sample_items[5]
    flipped = sample_items[:5] + [(comm, k, cell[:70] + bytes([cell[70] ^ 1]) + cell[71:], proof)] \
        + sample_items[6:]
    wrong = [(sample_items[0][0], (sample_items[0][1] + 1) % dgeo.num_cells) + sample_items[0][2:]] \
        + sample_items[1:]
    swapped = [sample_items[0][:3] + (sample_items[1][3],), sample_items[1][:3] + (sample_items[0][3],)] \
        + sample_items[2:]
    da["tampered"] = {
        name: da_cells.verify_cell_proof_batch(batch, dgeo, backend="gpu", setup=setup, device="cuda")
        for name, batch in (("flipped_byte", flipped), ("wrong_index", wrong), ("swapped_proof", swapped))}
    t0 = time.perf_counter()
    da["custody"]["ref_verdict"] = da_cells.verify_cell_proof_batch(sample_items, dgeo, backend="ref",
                                                                    setup=setup)
    da["custody"]["ref_s"] = time.perf_counter() - t0
    assert da["tampered"] == {"flipped_byte": False, "wrong_index": False, "swapped_proof": False} \
        and da["custody"]["ref_verdict"] is True, (da["tampered"], da["custody"])
    # the full block: 128 columns x 6 blobs
    block_items = [cell_item(i, k) for k in range(dgeo.num_cells) for i in range(dn)]
    t0 = time.perf_counter()
    ok = da_cells.verify_cell_proof_batch(block_items, dgeo, backend="gpu", setup=setup, device="cuda")
    da["block"] = {"cells": len(block_items), "verdict": ok, "wall_s": time.perf_counter() - t0,
                   "split": cell_split()}
    assert ok is True, "da: the full block's cells were rejected"
    print(smi, flush=True)
    emit("da_verify", custody=da["custody"], tampered=da["tampered"], block=da["block"])

    # the kernels at the custody sample's shapes (24 cells: b = 32, 128
    # lanes), each against its plain version
    rs_, cs_, ws_, rzs_, acc_ = da_cells._fold_inputs(sample_items, dgeo, seed=5)
    interp = kzg_api._g1_lincomb(setup.g1_powers[:dm], acc_)
    hold_verify_path("da_custody", *da_gpu.cell_verify_lanes(rs_, cs_, ws_, rzs_, interp),
                     setup.tau_g2_power(dm), drecs)

    # reconstruction at 1,024 elements (cells of 64, 32 columns): the host's
    # O(n^2) interpolation, ~16x longer at 4,096
    rgeo = geometry(1_024, dm)
    rblob = b"".join(drng.randrange(R_ORDER).to_bytes(32, "big") for _ in range(rgeo.blob_elements))
    rcells = da_cells.compute_cells(rblob, rgeo, backend="gpu", device="cuda")
    half = sorted(drng.sample(range(rgeo.num_cells), rgeo.num_cells // 2))
    t0 = time.perf_counter()
    rebuilt = da_erasure.reconstruct_blob({k: rcells[k] for k in half}, rgeo)
    recon_s = time.perf_counter() - t0
    try:
        da_erasure.reconstruct_blob({k: rcells[k] for k in half[:-1]}, rgeo)
        short = "accepted"
    except DaError:
        short = "DaError"
    da["reconstruct"] = {"blob_elements": rgeo.blob_elements, "columns": rgeo.num_cells,
                         "from_columns": half, "byte_equal": rebuilt == rblob, "seconds": recon_s,
                         "one_short": short}
    assert rebuilt == rblob and short == "DaError", da["reconstruct"]
    emit("da_reconstruct", **da["reconstruct"])

    # the bus: 128 column submissions of 6 cells from 8 threads, then 8
    # columns with one corrupted cell in column 3
    def bus_round(bus, cols):
        out, errors = {}, []

        def worker(tid):
            try:
                for k, col in cols[tid::8]:
                    out[k] = bus.submit_cells(col, dgeo, setup=setup)
            except Exception as e:  # a fault fails the phase below
                errors.append(repr(e))

        t0 = time.perf_counter()
        ths = [threading.Thread(target=worker, args=(t,)) for t in range(8)]
        for th in ths:
            th.start()
        for th in ths:
            th.join()
        return out, errors, time.perf_counter() - t0

    cbus = VerificationBus(backend="gpu", journal=Journal())
    all_cols = [(k, [cell_item(i, k) for i in range(dn)]) for k in range(dgeo.num_cells)]
    verdicts, errors, wall = bus_round(cbus, all_cols)
    st = cbus.stats()
    da["bus"] = {"submissions": len(all_cols), "threads": 8, "wall_s": wall, "errors": errors,
                 "all_true": verdicts == {k: True for k in range(dgeo.num_cells)},
                 "batches_formed": st["batches_formed"], "triggers": st["triggers"],
                 "mean_live_per_batch": st["mean_live_per_batch"],
                 "cell_batch_events": len(cbus.journal.query(kind="cell_batch"))}
    bad_cols = [(k, col) for k, col in all_cols[:8]]
    comm, k, cell, proof = bad_cols[3][1][2]
    bad_cols[3] = (3, bad_cols[3][1][:2] + [(comm, k, bytes([cell[0] ^ 1]) + cell[1:], proof)]
                   + bad_cols[3][1][3:])
    bbus = VerificationBus(backend="gpu")
    verdicts, errors2, wall2 = bus_round(bbus, bad_cols)
    da["bus"]["corrupted"] = {"wall_s": wall2, "errors": errors2,
                              "false_at": sorted(k for k, v in verdicts.items() if not v),
                              "triggers": bbus.stats()["triggers"],
                              "fallback_batches": bbus.stats()["fallback_batches"]}
    assert not errors and da["bus"]["all_true"], da["bus"]
    assert not errors2 and da["bus"]["corrupted"]["false_at"] == [3], da["bus"]["corrupted"]
    print(smi, flush=True)
    emit("da_bus", **da["bus"])

    # the guard: an injected error on each plane raises before any launch;
    # the next call is right
    guard = {}
    for plane, call in (
        ("rs_extend", lambda: da_erasure.extend_blobs(blobs, dgeo, backend="gpu", device="cuda")),
        ("da_cells", lambda: da_cells.verify_cell_proof_batch(sample_items, dgeo, backend="gpu",
                                                              setup=setup, device="cuda")),
    ):
        GUARD.reset()
        INJECTOR.arm("error", plane, rate=1.0, seed=1)
        cuda_build.reset_launches()
        try:
            call()
            raise AssertionError(f"da: an injected error on {plane} went unseen")
        except DeviceErrorInjected as e:
            guard[plane] = {"raised": type(e).__name__, "launches": sum(cuda_build.LAUNCHES.values())}
        INJECTOR.reset()
        out = call()
        guard[plane]["next_right"] = out == d_evals if plane == "rs_extend" else out is True
    GUARD.reset()
    da["guard"] = guard
    assert all(g["launches"] == 0 and g["next_right"] for g in guard.values()), guard
    emit("da_guard", **guard)
    da_launches = {"extend": extend_launches, "verify": verify_launches_da, "proofs": proof_launches}
    records["da_phase"] = da

    # ---------------------------------------------- 7i. the epoch plane (epoch)
    # the altair rewards pass (csrc/epoch_rewards.cu) exactly against its
    # plain version at V = 1,048,576 on seeded arrays, leak off and on, and
    # on an edge batch; process_epoch on a mainnet-spec altair state of
    # 1,048,576 validators (testing.epoch_state) on the card, then on the
    # CPU from the same seed, balances and scores equal; process_slots
    # across one boundary at 16,384 validators on both, state roots equal
    t_phase = time.perf_counter()
    ep = {}
    espec = mainnet_spec(ALTAIR_FORK_EPOCH=0)
    einc = espec.EFFECTIVE_BALANCE_INCREMENT
    equot = espec.INACTIVITY_SCORE_BIAS * espec.inactivity_penalty_quotient_for("altair")

    def epoch_params(arrs, leak):
        total = max(einc, int(arrs[0][arrs[4]].sum()))
        return (einc * espec.BASE_REWARD_FACTOR // math.isqrt(total), einc, total // einc, int(leak),
                espec.INACTIVITY_SCORE_BIAS, espec.INACTIVITY_SCORE_RECOVERY_RATE, equot)

    def epoch_bound(n):
        t_bytes = ek.rewards_bytes(n) / HBM_BYTES_PER_S * 1e3
        t_ops = n * EPOCH_INT_OPS / INT_OPS_PER_S * 1e3
        return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"

    erng = np.random.default_rng(14)
    n = EPOCH_V
    eff = np.where(erng.random(n) < 0.97, 32, erng.integers(0, 33, n)) * einc
    active = erng.random(n) < 0.97
    slashed = erng.random(n) < 0.01
    e_arrs = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in (
        eff, np.where(erng.random(n) < 0.9, 7, erng.integers(0, 8, n)).astype(np.uint8),
        np.where(erng.random(n) < 0.1, erng.integers(0, 100, n), 0),
        np.maximum(0, eff + erng.integers(-einc, einc, n)), active, slashed,
        active | (slashed & (erng.random(n) < 0.5)))]
    e_in = nb(*e_arrs)
    ek.rewards_plain(*e_arrs, epoch_params(e_arrs, False))  # the plain ops' first use, untimed
    torch.cuda.synchronize()
    erecs = {}
    for leak in (False, True):
        prm = epoch_params(e_arrs, leak)
        erecs[leak] = hold(f"epoch_rewards{'_leak' if leak else ''}",
                           lambda: ek.rewards(*e_arrs, prm), lambda: ek.rewards_plain(*e_arrs, prm),
                           e_in, bound=epoch_bound(n), extra={"validators": n, "leak": leak})
    # the edge batch: every flag byte and mask combination, zero / one
    # increment / 17 / 32 ETH effective, scores 0, 1, 15-17 and at the
    # envelope's edge (eff * (score + bias) just under 2**62), balances 0, 1
    # and 32 ETH (driven below zero)
    edge_score = (2**62 - 1) // (32 * einc) - espec.INACTIVITY_SCORE_BIAS
    combos = np.array(list(itertools.product(
        range(8), range(8), (0, einc, 17 * einc, 32 * einc), (0, 1, 15, 16, 17, edge_score),
        (0, 1, 32 * einc))), dtype=np.int64)
    edge = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in (
        combos[:, 2], combos[:, 0].astype(np.uint8), combos[:, 3], combos[:, 4], (combos[:, 1] & 1) > 0,
        (combos[:, 1] & 2) > 0, (combos[:, 1] & 4) > 0)]
    edge_ok = {}
    for leak in (False, True):
        prm = (357, einc, 1_000_000, int(leak), espec.INACTIVITY_SCORE_BIAS,
               espec.INACTIVITY_SCORE_RECOVERY_RATE, equot)
        got, want = ek.rewards(*edge, prm), ek.rewards_plain(*edge, prm)
        edge_ok[leak] = all(torch.equal(a, b) for a, b in zip(got, want))
    ep["edge"] = {"lanes": len(combos), "exact_no_leak": edge_ok[False], "exact_leak": edge_ok[True],
                  "clamped_to_zero": int((edge[3] > 0).sum())}
    assert all(edge_ok.values()), ep["edge"]
    # the wrapping batch: full-range int64 lanes, so products, sums and
    # quotients wrap and dividends go negative, under the divisors that the
    # kernel's magic numbers must floor exactly; reward denominators that
    # wrap (2**57: INT64_MIN, 2**57 + 5: below 0, 2**58 + 3: 192); and once
    # on rows one element off their vector alignment (4,098 lanes)
    m_w = 4_099
    wrng = np.random.default_rng(16)
    wrap = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in (
        wrng.integers(-2**63, 2**63 - 1, m_w, dtype=np.int64, endpoint=True),
        wrng.integers(0, 256, m_w).astype(np.uint8),
        wrng.integers(-2**63, 2**63 - 1, m_w, dtype=np.int64, endpoint=True),
        wrng.integers(-2**63, 2**63 - 1, m_w, dtype=np.int64, endpoint=True),
        wrng.random(m_w) < 0.7, wrng.random(m_w) < 0.2, wrng.random(m_w) < 0.8)]
    wrap_ok, wrap_cases = {}, 0
    for d in (1, 2, 3, 63, 64, 65, 10**9, 2**31 - 1, 2**31 + 1, 2**62, 2**63 - 1):
        for ai in (1, 1_000, 2**57, 2**57 + 5, 2**58 + 3):
            for leak in (0, 1):
                prm = (2**40 + 7, d, ai, leak, 2**62, 3, d)
                got, want = ek.rewards(*wrap, prm), ek.rewards_plain(*wrap, prm)
                wrap_ok[f"{d}/{ai}/{leak}"] = all(torch.equal(a, b) for a, b in zip(got, want))
                wrap_cases += 1
        off = [t[1:] for t in wrap]
        prm = (2**40 + 7, d, 1_000, 0, 2**62, 3, d)
        wrap_ok[f"{d}/unaligned"] = all(torch.equal(a, b) for a, b in zip(
            ek.rewards(*off, prm), ek.rewards_plain(*off, prm)))
    ep["wrap"] = {"lanes": m_w, "cases": wrap_cases + 11, "exact": all(wrap_ok.values()),
                  "failed": [k for k, v in wrap_ok.items() if not v]}
    assert ep["wrap"]["exact"], ep["wrap"]
    ep_ptxas = {name: dict(rec, **ptxas["epoch_rewards"]["functions"].get(name, {}))
                for name, rec in ptxas["epoch_rewards"]["kernels"].items()}
    assert len(ep_ptxas) == 3 and not ptxas["epoch_rewards"]["spill_store_bytes"] \
        and not any(r["stack_bytes"] or r.get("stack_frame") for r in ep_ptxas.values()), \
        f"epoch_rewards: stack frame or spills {ep_ptxas}"
    ep_plan = ek.plan(n, dev)
    ep["kernel"] = {"ptxas": ep_ptxas, "plan": ep_plan, "leak_ms": erecs[True]["ms"],
                    "leak_plain_ms": erecs[True]["plain_ms"]}
    print(smi, flush=True)
    emit("epoch_kernel", **ep["kernel"], edge=ep["edge"], wrap=ep["wrap"])
    records["epoch_rewards"] = dict(erecs[False], ptxas=ep_ptxas, plan=ep_plan, leak_ms=erecs[True]["ms"])
    del e_arrs, edge, wrap, off

    # the path: process_epoch at 1,048,576 validators on the card, then the
    # same state on the CPU (the plain version; the spec's Python passes
    # cannot run at this size)
    t0 = time.perf_counter()
    est = T.epoch_state(espec, EPOCH_V, EPOCH_AT, seed=21)
    build_s = time.perf_counter() - t0
    cuda_build.reset_launches()
    t0 = time.perf_counter()
    process_epoch(est, espec, device="cuda")
    wall = time.perf_counter() - t0
    epoch_launches = {k: v for k, v in cuda_build.LAUNCHES.items() if v}
    split = dict(ek.LAST_EPOCH_STATS)
    est_cpu = T.epoch_state(espec, EPOCH_V, EPOCH_AT, seed=21)
    t0 = time.perf_counter()
    process_epoch(est_cpu, espec, device="cpu")
    cpu_wall = time.perf_counter() - t0
    cpu_split = dict(ek.LAST_EPOCH_STATS)
    same = (list(est.balances) == list(est_cpu.balances)
            and list(est.inactivity_scores) == list(est_cpu.inactivity_scores))
    registry_same = all(
        (a.effective_balance, a.exit_epoch, a.activation_epoch, a.activation_eligibility_epoch)
        == (b.effective_balance, b.exit_epoch, b.activation_epoch, b.activation_eligibility_epoch)
        for a, b in zip(est.validators, est_cpu.validators))
    rewards_s = sum(split[k] for k in ("extract_s", "upload_s", "kernel_s", "readback_s",
                                       "writeback_s"))
    ep["path"] = {"validators": EPOCH_V, "epoch": EPOCH_AT, "build_s": build_s, "wall_s": wall,
                  "split": split, "other_passes_s": wall - rewards_s, "cpu_wall_s": cpu_wall,
                  "cpu_split": cpu_split, "balances_and_scores_equal": same,
                  "registry_equal": registry_same, "launches": epoch_launches}
    print(smi, flush=True)
    emit("epoch", **ep["path"])
    assert same and registry_same, "epoch: the card and the CPU disagree"
    assert epoch_launches == {"epoch_rewards": 1}, epoch_launches
    del est, est_cpu

    # one boundary through process_slots at 16,384 validators
    roots, walls_b = {}, {}
    for where in ("cuda", "cpu"):
        bst = T.epoch_state(espec, BOUNDARY_V, EPOCH_AT, seed=22)
        bst.slot -= 1
        t0 = time.perf_counter()
        bst = process_slots(bst, (EPOCH_AT + 1) * espec.SLOTS_PER_EPOCH + 1, espec, device=where)
        walls_b[where] = time.perf_counter() - t0
        roots[where] = type(bst).hash_tree_root(bst).hex()
    ep["boundary"] = {"validators": BOUNDARY_V, "slots": 3, "roots_equal": roots["cuda"] == roots["cpu"],
                      "root": roots["cuda"], "wall_s": walls_b, "phase_s": time.perf_counter() - t_phase}
    emit("epoch_boundary", **ep["boundary"])
    assert ep["boundary"]["roots_equal"], roots
    records["epoch_phase"] = ep

    # ------------------------------------------ 7j. the slasher plane (slasher)
    # the min/max-target update (csrc/slasher_update.cu) exactly against its
    # plain version on a 65,536-row slice at H = 4,096 (SlasherConfig's
    # history_length) with N = 32,768 lanes over a seeded prior, and at
    # H = 37 and 4,095 on 4,096 rows; then in place at 1,048,576 x 4,096
    # (32 GiB) over an honest history: one slot's batch and one epoch's,
    # exactly the 64 planted verdicts, the touched rows against the plain
    # version on those rows, the untouched rows' checksums unchanged
    t_phase = time.perf_counter()
    sl = {}
    H = SLASHER_H
    srng = np.random.default_rng(15)

    def lanes_on(*arrs):
        return [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrs]

    def slasher_bound(lanes, h=H):
        # the columns the lanes' rows need (max from a row's smallest
        # source up, min to its largest), read and written once
        return sd.update_bytes(lanes[0], lanes[1], lanes[3], h) / HBM_BYTES_PER_S * 1e3

    def slasher_rows_bound(rows, n_lanes, h=H):
        return sd.row_bytes(rows, h, n_lanes) / HBM_BYTES_PER_S * 1e3

    def slice_run(SV, h, SN, rows_hot):
        """A seeded prior over SV x h, then a batch of SN lanes: several
        lanes on a row (a quarter of them on `rows_hot` rows), duplicate
        (v, s) pairs, s = 0 and s = h - 1, 10 % invalid lanes with garbage
        v, s and t; the kernel against the plain version on clones."""
        smn = torch.full((SV, h), sd.NO_TARGET_MIN, dtype=torch.int32, device=dev)
        smx = torch.full((SV, h), sd.NO_TARGET_MAX, dtype=torch.int32, device=dev)
        ps = srng.integers(0, h - 1, SV)
        prior = lanes_on(srng.integers(0, SV, SV).astype(np.int32), ps.astype(np.int32),
                         np.minimum(ps + srng.integers(1, 64, SV), h - 1).astype(np.int32),
                         np.ones(SV, bool))
        sd.batch_update_plain(smn, smx, *prior)
        bv = srng.integers(0, SV, SN)
        bv[: SN // 4] = srng.integers(0, rows_hot, SN // 4)
        bs = srng.integers(0, h, SN)
        bt = np.minimum(bs + srng.integers(0, 512, SN), h - 1)
        edge = SN // 64
        bs[SN // 4: SN // 4 + edge], bs[SN // 4 + edge: SN // 4 + 2 * edge] = 0, h - 1
        bt[SN // 4 + edge: SN // 4 + 2 * edge] = h - 1
        bv[SN // 2: SN // 2 + 64], bs[SN // 2: SN // 2 + 64] = bv[0], bs[0]
        bvalid = srng.random(SN) >= 0.1
        bad = ~bvalid
        for a in (bv, bs, bt):
            a[bad] = srng.integers(-2**31, 2**31 - 1, int(bad.sum()))
        batch = lanes_on(bv.astype(np.int32), bs.astype(np.int32), bt.astype(np.int32), bvalid)
        kmn, kmx = smn.clone(), smx.clone()
        got = sd.batch_update(kmn, kmx, *batch)
        torch.cuda.synchronize()
        tp0 = time.perf_counter()
        want = sd.batch_update_plain(smn, smx, *batch)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - tp0) * 1e3
        err = max(int((a.to(torch.int64) - b.to(torch.int64)).abs().max()) for a, b in zip(got, want))
        rows = int(torch.unique(batch[0][batch[3]]).numel())
        rec = {"rows": SV, "H": h, "lanes": SN, "touched_rows": rows, "valid_lanes": int(bvalid.sum()),
               "max_abs_err": err, "plain_ms": plain_ms, "bound_ms": slasher_bound(batch, h),
               "bound_rows_ms": slasher_rows_bound(rows, SN, h),
               "surrounded": int(got[2].sum()), "surrounds": int(got[3].sum())}
        return rec, (kmn, kmx, sd.group_lanes(*batch[:2], batch[3], SV, h), batch)

    SV, SN = 65_536, 32_768
    sl["slice"], (kmn, kmx, groups, batch) = slice_run(SV, H, SN, 1_024)
    so, ss = (torch.zeros(SN, dtype=torch.bool, device=dev) for _ in range(2))
    sl["slice"]["ms"] = cuda_build.time_ms(
        lambda: sd.launch_rows(kmn, kmx, groups, batch[1], batch[2], so, ss))
    slice_plain_ms, slice_err = sl["slice"]["plain_ms"], sl["slice"]["max_abs_err"]
    emit("slasher_slice", **sl["slice"])
    assert slice_err == 0, "slasher: kernel and plain version disagree on the slice"
    del kmn, kmx, groups, batch
    # history lengths that are not a multiple of 4 take the kernel's
    # element-wise merge (SlasherConfig's history_length is configurable)
    sl["odd_h"] = [slice_run(4_096, h, 8_192, 64)[0] for h in (37, 4_095)]
    emit("slasher_odd_h", slices=sl["odd_h"])
    assert all(r["max_abs_err"] == 0 for r in sl["odd_h"]), "slasher: odd H disagrees"
    torch.cuda.empty_cache()

    # full width, in place
    torch.cuda.reset_peak_memory_stats()
    min_row, max_row = (torch.from_numpy(r).to(dev) for r in T.honest_prior(H))
    fmn = torch.empty((SLASHER_V, H), dtype=torch.int32, device=dev)
    fmx = torch.empty((SLASHER_V, H), dtype=torch.int32, device=dev)
    fmn.copy_(min_row.expand(SLASHER_V, H))
    fmx.copy_(max_row.expand(SLASHER_V, H))
    slot_b, slot_planted, epoch_b, epoch_planted = T.slasher_batches(
        SLASHER_V, H, SLOT_ATTESTERS, PLANTED // 2, seed=16)
    slot_l = lanes_on(*slot_b, np.ones(len(slot_b[0]), bool))
    epoch_l = lanes_on(*epoch_b, np.ones(SLASHER_V, bool))
    weights = torch.arange(1, H + 1, dtype=torch.int64, device=dev)

    def row_sums():
        out = torch.empty((2, SLASHER_V), dtype=torch.int64, device=dev)
        for c0 in range(0, SLASHER_V, 32_768):
            for k, arr in enumerate((fmn, fmx)):
                out[k, c0:c0 + 32_768] = (arr[c0:c0 + 32_768].to(torch.int64) * weights).sum(1)
        return out

    sums_before = row_sums()
    rows = torch.unique(slot_l[0])
    pre = fmn[rows].clone(), fmx[rows].clone()
    cuda_build.reset_launches()
    t0 = time.perf_counter()
    _, _, s_sed, s_sds = sd.batch_update(fmn, fmx, *slot_l)
    torch.cuda.synchronize()
    slot_wall = time.perf_counter() - t0
    slot_verdicts = (s_sed.cpu().numpy(), s_sds.cpu().numpy())
    # the touched rows against the plain version on those rows, gathered
    held = sd.batch_update_plain(*pre, torch.searchsorted(rows, slot_l[0]).to(torch.int32),
                                 *slot_l[1:])
    touched_ok = (torch.equal(held[0], fmn[rows]) and torch.equal(held[1], fmx[rows])
                  and torch.equal(held[2], s_sed) and torch.equal(held[3], s_sds))
    untouched = torch.ones(SLASHER_V, dtype=torch.bool, device=dev)
    untouched[rows] = False
    sums_after = row_sums()
    untouched_ok = bool(torch.equal(sums_before[:, untouched], sums_after[:, untouched]))
    del pre, held, sums_before, sums_after
    t0 = time.perf_counter()
    _, _, e_sed, e_sds = sd.batch_update(fmn, fmx, *epoch_l)
    torch.cuda.synchronize()
    epoch_wall = time.perf_counter() - t0
    slasher_launches = {k: v for k, v in cuda_build.LAUNCHES.items() if v}
    epoch_verdicts = (e_sed.cpu().numpy(), e_sds.cpu().numpy())
    planted_ok = (not slot_verdicts[0].any()
                  and np.nonzero(slot_verdicts[1])[0].tolist() == slot_planted.tolist()
                  and np.nonzero(epoch_verdicts[0])[0].tolist() == epoch_planted.tolist()
                  and not epoch_verdicts[1].any())
    # every row after both batches against the plain version, a chunk of
    # rows at a time, from the honest rows and the chunk's lanes
    chunk_ok = True
    ev_sed = torch.zeros(SLASHER_V, dtype=torch.bool, device=dev)
    ev_sds = torch.zeros(SLASHER_V, dtype=torch.bool, device=dev)
    for c0 in range(0, SLASHER_V, 65_536):
        c1 = c0 + 65_536
        cmn = min_row.expand(c1 - c0, H).clone()
        cmx = max_row.expand(c1 - c0, H).clone()
        for lanes, out in ((slot_l, None), (epoch_l, (ev_sed, ev_sds))):
            sel = (lanes[0] >= c0) & (lanes[0] < c1)
            r = sd.batch_update_plain(cmn, cmx, lanes[0][sel] - c0, lanes[1][sel], lanes[2][sel],
                                      lanes[3][sel])
            if out is not None:
                idx = torch.nonzero(sel)[:, 0]
                out[0][idx], out[1][idx] = r[2], r[3]
        chunk_ok &= torch.equal(cmn, fmn[c0:c1]) and torch.equal(cmx, fmx[c0:c1])
        del cmn, cmx
    chunk_ok &= torch.equal(ev_sed, e_sed) and torch.equal(ev_sds, e_sds)
    peak = torch.cuda.max_memory_allocated()
    g_slot = sd.group_lanes(slot_l[0], slot_l[1], slot_l[3], SLASHER_V, H)
    g_epoch = sd.group_lanes(epoch_l[0], epoch_l[1], epoch_l[3], SLASHER_V, H)
    so, ss = (torch.zeros(len(slot_b[0]), dtype=torch.bool, device=dev) for _ in range(2))
    eo, es = (torch.zeros(SLASHER_V, dtype=torch.bool, device=dev) for _ in range(2))
    slot_ms = cuda_build.time_ms(lambda: sd.launch_rows(fmn, fmx, g_slot, slot_l[1], slot_l[2], so, ss))
    epoch_ms = cuda_build.time_ms(lambda: sd.launch_rows(fmn, fmx, g_epoch, epoch_l[1], epoch_l[2], eo, es))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sd.group_lanes(slot_l[0], slot_l[1], slot_l[3], SLASHER_V, H)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    sd.group_lanes(epoch_l[0], epoch_l[1], epoch_l[3], SLASHER_V, H)
    torch.cuda.synchronize()
    glue_s = (t1 - t0, time.perf_counter() - t1)
    sl["full"] = {
        "rows": SLASHER_V, "H": H, "array_gib": 2 * SLASHER_V * H * 4 / 2**30,
        "max_memory_allocated_gib": peak / 2**30, "launches": slasher_launches,
        "slot": {"lanes": len(slot_b[0]), "touched_rows": int(rows.numel()), "ms": slot_ms,
                 "bound_ms": slasher_bound(slot_l),
                 "bound_rows_ms": slasher_rows_bound(int(rows.numel()), len(slot_b[0])),
                 "wall_s": slot_wall, "glue_s": glue_s[0], "surrounds_at": len(slot_planted)},
        "epoch": {"lanes": SLASHER_V, "touched_rows": SLASHER_V, "ms": epoch_ms,
                  "bound_ms": slasher_bound(epoch_l),
                  "bound_rows_ms": slasher_rows_bound(SLASHER_V, SLASHER_V),
                  "wall_s": epoch_wall, "glue_s": glue_s[1], "surrounded_at": len(epoch_planted)},
        "planted_exact": planted_ok, "touched_rows_equal_plain": touched_ok,
        "untouched_checksums_equal": untouched_ok, "every_row_equal_plain": bool(chunk_ok),
        "phase_s": time.perf_counter() - t_phase}
    print(smi, flush=True)
    emit("slasher", **sl["full"])
    assert planted_ok and touched_ok and untouched_ok and chunk_ok, sl["full"]
    assert slasher_launches == {"slasher_update": 2}, slasher_launches
    sl_ptxas = {name: dict(rec, **ptxas["slasher_update"]["functions"].get(name, {}))
                for name, rec in ptxas["slasher_update"]["kernels"].items()}
    records["slasher_update"] = {
        "ms": slot_ms, "plain_ms": slice_plain_ms, "bound_ms": sl["full"]["slot"]["bound_ms"],
        "bound_by": "bytes", "max_abs_err": slice_err,
        "bound_rows_ms": sl["full"]["slot"]["bound_rows_ms"], "ms_epoch_batch": epoch_ms,
        "bound_ms_epoch_batch": sl["full"]["epoch"]["bound_ms"],
        "bound_rows_ms_epoch_batch": sl["full"]["epoch"]["bound_rows_ms"],
        "ms_slice": sl["slice"]["ms"], "bound_ms_slice": sl["slice"]["bound_ms"],
        "max_abs_err_odd_h": max(r["max_abs_err"] for r in sl["odd_h"]), "ptxas": sl_ptxas}
    records["slasher_phase"] = sl
    del fmn, fmx, slot_l, epoch_l, g_slot, g_epoch
    torch.cuda.empty_cache()

    # ------------------------------------------- 8. tensor-core probe
    probe = {form: mma_probe.probe(form, dev) for form in mma_probe.FORMS}
    probe_launches = {}
    for form, prec in probe.items():
        M, X = mma_probe.operands(*mma_probe.probe_inputs(), form, dev)
        cuda_build.reset_launches()
        mma_probe.contract(M, X, form, require_kernel=True)
        probe_launches[f"mma_probe_{form}"] = cuda_build.LAUNCHES[f"mma_probe_{form}"]
        emit("mma_probe", **prec, launches=probe_launches[f"mma_probe_{form}"])
        assert prec["exact"], f"mma_probe {form}: not exact"
        rec = hold(f"mma_probe_{form}", lambda: mma_probe.contract(M, X, form, require_kernel=True),
                   lambda: mma_probe.contract_plain(M, X), nb(M, X), bound=mma_probe.bound(form))
        records.setdefault("probe", {})[f"mma_probe_{form}"] = dict(
            rec, library_ms=prec["library_ms"], library_call_ms=prec["library_call_ms"])

    # --------------------------------------------------- 9. kernels line
    csrc = "lighthouse_tpu_torch/csrc/"
    helper = "a step that is XLA on the TPU, outside any Pallas kernel"
    host = "a step that is host Python in the JAX package (affine conversion and packing)"
    forms_note = "slot ladder inputs, flat batch's under flat; launches from the flat batch with ladder={}"
    meta = {  # name -> (source, what it replaces, note)
        "ladder_g1": (csrc + "ladder.cu", "lighthouse_tpu/ops/pallas_ladder.py:101", None),
        "ladder_g2": (csrc + "ladder.cu", "lighthouse_tpu/ops/pallas_ladder.py:101", None),
        "miller": (csrc + "miller.cu", "lighthouse_tpu/ops/pallas_miller.py:32", None),
        "fold_final_exp": (csrc + "final_exp.cu", "lighthouse_tpu/ops/pallas_tail.py:58", None),
        "lane_sum_g1": (csrc + "curve_helpers.cu", "lighthouse_tpu/ops/curve.py:116", helper),
        "lane_sum_g2": (csrc + "curve_helpers.cu", "lighthouse_tpu/ops/tcurve.py:201", helper),
        "to_affine_g1": (csrc + "curve_helpers.cu", "lighthouse_tpu/ops/curve.py:630", helper),
        "to_affine_g2": (csrc + "curve_helpers.cu", "lighthouse_tpu/ops/curve.py:630", helper),
        "jacobian_to_affine_g1": (csrc + "curve_helpers.cu", "lighthouse_tpu/bls/tpu_backend.py:310",
                                  host + "; the flat batch's untagged keys at 4,096 lanes"),
        "jacobian_to_affine_g2": (csrc + "curve_helpers.cu", "lighthouse_tpu/bls/tpu_backend.py:282",
                                  host),
        "ladder_g1_chain": (csrc + "ladder.cu", "lighthouse_tpu/ops/pallas_ladder.py:59",
                            forms_note.format("chain")),
        "ladder_g2_chain": (csrc + "ladder.cu", "lighthouse_tpu/ops/pallas_ladder.py:59",
                            forms_note.format("chain")),
        "ladder_g1_w2": (csrc + "ladder.cu", "lighthouse_tpu/ops/pallas_ladder.py:77",
                         forms_note.format("w2")),
        "ladder_g2_w2": (csrc + "ladder.cu", "lighthouse_tpu/ops/pallas_ladder.py:77",
                         forms_note.format("w2")),
        "pair_final_exp": (csrc + "final_exp.cu", "lighthouse_tpu/ops/pallas_tail.py:58",
                           "per-set entry at the slot's sets; held and plain_ms on a 1,024-set slice"),
        "mma_probe_i8": (csrc + "mma_probe.cu", "scripts/probe_mxu_forms.py:67", None),
        "mma_probe_bf16": (csrc + "mma_probe.cu", "scripts/probe_mxu_forms.py:67", None),
        "subgroup_g2": (csrc + "subgroup.cu", "lighthouse_tpu/ops/batch_verify.py:428",
                        "XLA on the TPU (a lax.scan, no Pallas kernel); ms at the slot's 30,720 "
                        "lanes (ms_1058, ms_1024: the slice and the edge batch, the 1,024-lane slice); "
                        "held and plain_ms on the slice plus two 8-lane warps and a 34-lane edge "
                        "batch; launches from the ingest run"),
        "sha256_fold": (csrc + "sha256_fold.cu", "lighthouse_tpu/ops/merkle_proof.py:130",
                        "XLA on the TPU, no Pallas kernel (_fold_kernel); ms at 16,384 depth-6 "
                        "lanes (ms_1024 at 1,024); launches from one batch_merkle_roots call at "
                        "16,384; hashlib_ms the host oracle on the same queries"),
        "rs_extend": (csrc + "rs_extend.cu", "lighthouse_tpu/ops/rs_extend.py:36",
                      "XLA on the TPU, no Pallas kernel (eval_poly_batch's fori_loop over "
                      "rfield.mul_lazy and add); the 6 live blobs (no padding chains) x 8,192 "
                      "points x 4,096 coefficients, each chain split into plan.segments lanes; "
                      "bound_ms the function's products (split_products: the split's extra, "
                      "apart); launches from one extend_blobs call"),
        "epoch_rewards": (csrc + "epoch_rewards.cu", "lighthouse_tpu/state_processing/epoch_kernel.py:37",
                          "XLA on the TPU, no Pallas kernel (_kernel: one jitted elementwise pass "
                          "with three (V,) sums); one C entry, two launches (the sums with the "
                          "epoch's scalars in its last block, the pass as a programmatic dependent "
                          "launch), counted as one; no 64-bit division (magic numbers); ms, "
                          "plain_ms and bound at 1,048,576 seeded validators, leak off (leak_ms "
                          "on); launches from one process_epoch call at 1,048,576"),
        "slasher_update": (csrc + "slasher_update.cu", "lighthouse_tpu/slasher/device.py:39",
                           "XLA on the TPU, no Pallas kernel (batch_update and _gather_checks); ms "
                           "and bound_ms: one slot's batch (32,800 lanes) in place at 1,048,576 x "
                           "4,096; ms_epoch_batch at 1,048,576 lanes; bound_ms counts the columns "
                           "each touched row needs, bound_rows_ms whole rows; plain_ms, max_abs_err "
                           "and ms_slice on the 65,536-row slice (max_abs_err_odd_h at H = 37 and "
                           "4,095); launches from the two batches"),
    }
    # the kzg block's shapes (32 lanes at 64 windows, a fold of 32 -> 2, two
    # pairs) and the MSMs' (the fold of 64 x 4,096 lanes, the Horner ladder
    # on 64 lanes and its fold, the variable-base ladder on 4,096 lanes)
    REDESIGNED = {  # PERF.md's kernel table names the change that made each design
        "rs_extend": "redesigned: live blobs only, chains split into segments, PTX carry chains",
        "epoch_rewards": "redesigned: no 64-bit division, the epoch's scalars once, one dependent launch"}
    kzg_extra = {"ladder_g1": ("ladder_g1_horner", "ladder_g1_variable"),
                 "lane_sum_g1": ("lane_sum_g1_msm", "lane_sum_g1_horner")}

    def pick(r):
        return {k: r[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err")}

    kernels = []
    for name, (source, replaces, note) in meta.items():
        entry = {"name": name, "route": "cuda", "source": source, "replaces": replaces}
        if name in REDESIGNED:
            entry["status"] = REDESIGNED[name]
        if name == "jacobian_to_affine_g1":  # the point path: the flat batch alone
            rec, launches = records["flat"][name], flat_launches[name]
        elif name in records["grouped"] and not name.endswith(("_chain", "_w2")):
            rec, launches = records["grouped"][name], slot_launches[name]
            entry["flat"] = {k: records["flat"][name][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")} | {
                "launches": flat_launches[name]}
        elif name.endswith(("_chain", "_w2")):
            form = name.rsplit("_", 1)[1]
            rec, launches = records["grouped"][name], form_launches[form][name]
            entry["flat"] = {k: records["flat"][name][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")}
        elif name == "pair_final_exp":
            rec, launches = records["per_set"][name], per_set_launches[name]
            entry["slice"] = records["per_set"]["pair_final_exp_slice"]
        elif name == "subgroup_g2":
            rec, launches = records["subgroup"], ingest_launches[name]
            entry.update({k: rec[k] for k in ("lanes", "ms_1058", "ms_1024")})
        elif name == "rs_extend":
            rec, launches = records["da"][name], da_launches["extend"][name]
            entry.update({k: rec[k] for k in ("lanes", "live_blobs", "fr_products", "split_products",
                                              "plan", "ptxas")})
            entry["launches_a_blob_proofs"] = da_launches["proofs"][name]
        elif name == "sha256_fold":
            rec, launches = records["merkle"][16_384], records["merkle"][16_384]["launches"]
            entry.update(lanes=16_384, depth=MERKLE_DEPTH, ms_1024=records["merkle"][1_024]["ms"],
                         bound_ms_1024=records["merkle"][1_024]["bound_ms"],
                         hashlib_ms=rec["hashlib_ms"], hashlib_ms_1024=records["merkle"][1_024]["hashlib_ms"],
                         bound_formula_ms=rec["bound_formula_ms"])
        elif name in ("epoch_rewards", "slasher_update"):
            rec = records[name]
            launches = (epoch_launches if name == "epoch_rewards" else slasher_launches).get(name, 0)
            entry.update({k: v for k, v in rec.items() if k not in (
                "ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err", "fp_products", "leak")})
        else:
            rec, launches = records["probe"][name], probe_launches[name]
        entry.update({
            "launches": launches, "max_abs_err": rec["max_abs_err"],
            "ms": rec["ms"], "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec.get("library_ms"), "held": True,
            "note": note, "slot_program_launches": program_launches.get(name, 0),
        })
        if name == "miller":
            entry["per_set"] = records["per_set"]["miller"] | {"launches": per_set_launches[name]}
        if name in records["kzg"]:  # the same kernel at the kzg slice's shapes
            entry["kzg"] = pick(records["kzg"][name]) | {
                "launches": kzg_launches["verify"].get(name, 0),
                "launches_fixed_msm": kzg_launches["fixed"].get(name, 0),
                "launches_variable_msm": kzg_launches["variable"].get(name, 0)}
            for extra in kzg_extra.get(name, ()):
                entry["kzg"][extra] = pick(records["kzg"][extra])
        if name in records["da"] and name != "rs_extend":  # at the cell verify's shapes
            entry["da"] = pick(records["da"][name]) | {
                "launches": da_launches["verify"].get(name, 0),
                "launches_a_blob_proofs": da_launches["proofs"].get(name, 0)}
        kernels.append(entry)
    with open(os.path.join(OUT, "chip_smoke_records.json"), "w") as f:
        json.dump({"records": records, "kernels": kernels, "smi": smi}, f, indent=1)
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def _flatten(x):
    import torch

    if isinstance(x, torch.Tensor):
        return [x.reshape(-1)] if x.dim() == 0 else [x]
    out = []
    for y in x:
        out += _flatten(y)
    return out


if __name__ == "__main__":
    sys.exit(main())
