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
 7k. block: BASELINE config #3 -- a mainnet-spec altair chain of 262,144
    validators (testing.chain_keypairs / chain_harness), the block after a
    skipped slot (128 attestations, the 512-seat sync aggregate, proposal
    and RANDAO: 131 sets, 16,898 keys) through Harness.import_block with
    VERIFY_BULK: one device call on the pubkey cache's table, the verdict
    and post-state root, the split (copy, process_slots, per-block host,
    the batch: marshalling and device, state root), launches, lanes and
    key padding; every kernel step by step on the sets that import
    verified against its plain version; block_forged: the block with
    attestation 9 carrying another committee's aggregate, refused by
    VERIFY_BULK (one call, the state unchanged) and by VERIFY_INDIVIDUAL
    at that attestation (12 calls);
 7l. replay: BASELINE config #5 (bench_replay.py's loop) -- 32 slots over
    the first epoch boundary at 65,536 validators, built unmeasured with
    NO_VERIFICATION, imported by two fresh replayers: VERIFY_BULK per block
    over the last 8 slots from the built state at slot 24 (8 device calls)
    and Harness.import_segment over all 32 (one collector, one call of 608
    sets before anything is committed); slots/s, the split (the boundary
    block's per-block host time beside the median), each block's verdict,
    equal final roots; every kernel at the segment's shapes against its
    plain version;
 7m. chain: BeaconChain (beacon_chain/chain.py) with backend="gpu" on the
    card, its store, fork choice, pools, bus, DA checker and light-client
    producer. First the bus's canary pair (a per-set call on every
    dispatch, its keys as points): each of its kernels held at its
    shapes, its verdicts [True, False]. chain_block: 7k's genesis with 7k's filled pubkey cache
    (construction timed), 7k's block through process_block: one batch call
    (and the bus's canary pair, a per-set call), the sets 7k's collector
    verified byte for byte, head and fork choice's head the block, the
    post-state root 7k's, the batch on the pubkey table (the bus's sentinel
    rides it as the table's extra row); its split from the chain's own
    spans (the state copy, the hashing to G2, the hot-state write, fork
    choice, the import hooks), the backend's marshalling and device times,
    the slot-budget stages; every kernel held at the batch's shapes (the
    131 sets and the sentinel). chain_gossip: for the head's slot, 64 singles (one member of
    each committee, sk = index + 1) through
    process_unaggregated_attestations: all accepted, their votes in fork
    choice, 64 aggregates in the naive pool; 64 more with one forged:
    that one refused alone, the batch and the per-set call (and the
    canary); 64 aggregates (3 sets each) through
    process_aggregated_attestations into the op pool; every kernel held at
    the singles' shapes; the bus's hold beside each wall. chain_segment:
    7l's 32 blocks through process_chain_segment on a fresh chain on 7l's
    genesis, the light-client hook off (chain_lc measures it once): one
    bulk call on the table, head at slot 32, 7l's final root, slots/s
    beside the harness's, every kernel held at the batch's shapes; a
    segment of the first SEGMENT_FORGED_LEN blocks with the last one's
    first attestation forged (the proposal re-signed): refused at the
    batch, nothing stored, fork choice at genesis. chain_lc: a light-client
    producer with device_check on the segment chain's last import: its
    branch folded on csrc/sha256_fold.cu, on the attested state root. chain_blobs: a mainnet-spec chain with
    bellatrix at epoch 1 at BLOB_V validators (32 slots built unverified;
    the chains from that checkpoint), the slot-33 block carrying 7e's six
    blobs, make_blob_sidecars's proofs equal to 7e's; the six sidecars
    first (one header check), then the block: fused, one slot_program
    dispatch; serial, the KZG settle then the fold; equal heads and roots;
    every kernel of the fused program held at its own inputs (the block's
    sets and the sentinel, the six blobs' KZG lanes);
    then the slot-34 block held ("data unavailable") until its last
    sidecar imports it; the segment's chain is the chain of node S, which
    7n's late node syncs from;
 7n. the node (lighthouse_tpu_torch/node.py BeaconNode over network/):
    node_snappy, the native snappy library built; node_gossip: nodes A and
    B on one GossipHub at 7k's genesis with 7m's filled cache, B's timer at
    slot 1 (the head advanced ahead of the block); A publishes 7k's block,
    B decodes it (the `gossip/decode` span) and its processor imports it:
    B's head 7k's root, its post-state root 7k's, the sets 7k's, A's score
    up by SCORE_VALID; then, B subscribed for the head slot's 64 duties,
    7m's 64 singles, 64 with one forged and 64 aggregates on their subnet
    and aggregate topics, each queue drained in one batch (the forged one
    alone refused: the batch, the canary pair and the per-set call); a
    frame that is not snappy (SCORE_INVALID_MESSAGE) and the block's frame
    again (SCORE_DUPLICATE); indexed_path on every batch (the
    `verify/device` spans); the split from the spans and the processor's
    queue histograms. node_sync: a late node C at 7l's genesis adds peers
    F (S's status, 7m's forged 4-block segment as its blocks_by_range
    answer) and S, and run_range_sync: F asked first, its batch refused on
    the card, F quarantined and scored, nothing of it stored; then S's 32
    blocks in one segment batch: C on 7l's final root; the split from the
    sync spans (`sync/batch`, `sync/blocks_by_range` a peer: the RPC's
    store reads, `sync/import_segment`) and the frame codec on the 32
    blocks timed apart; every kernel held at the batches 7m did not (the
    forged batch's per-set call, the aggregates, F's segment);
 8. the tensor-core probe (lighthouse_tpu_torch.ops.mma_probe), int8 and
    bf16, exact against the probe's numpy check and the plain version,
    kernel and library call timed the same way (and each once more in one
    synchronised call, cuda_build.call_ms, which shows the host's share of
    a few-microsecond call); its launches are those of one `contract` call;
 9. the kernels line (the kernels of the kzg path carry a "kzg" record at
    its shapes, with its launches, and a "da" record at the cell verify's;
    every kernel its launches in phase 7g's program run; epoch_rewards its
    launches in 7i's process_epoch, slasher_update in 7j's two full-width
    batches; a "block" and a "segment" record for the kernels of 7k and
    7l, with their launches there; a "chain" record with every kernel's
    launches in each arm of 7m and its times at the shapes of 7m's
    batches: canary_pair, gossip, chain_block, chain_segment, chain_blobs
    and chain_blobs_kzg; a "node" record with its launches in each arm of
    7n and its times at node_forged_per_set, node_aggregates and
    node_forged_segment),
    then {"ok": true,
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
# block processing (BASELINE config #3): a mainnet-spec altair chain cut
# from ~1.05 M validators to 262,144 (64 committees a slot of 128, where
# mainnet's hold ~512: the host's deep state copies and first state root);
# the block after a skipped slot: 2 x 64 attestations, the 512-seat sync
# aggregate, the proposal and the RANDAO reveal; the forged block's bad
# attestation
BLOCK_V = 262_144
BLOCK_COMMITTEES = 64
BLOCK_SETS = 2 * BLOCK_COMMITTEES + 3
BLOCK_KEYS = 2 * BLOCK_COMMITTEES * 128 + 512 + 2
FORGED_AT = 9
# the chain (phase 7m): a gossip batch of 64 singles (ATTESTATION_BATCH_MAX,
# lighthouse_tpu/network/beacon_processor.py:94), the forged one's index; the
# blob chain's validators (its genesis cannot start at bellatrix, so it runs
# 32 slots to reach it: cut from BLOCK_V)
GOSSIP_FORGED = 17
BLOB_V = 16_384
# the forged segment: 7l's first 4 blocks, the fourth forged (the batch fails
# before anything is committed, as it would at 32)
SEGMENT_FORGED_LEN = 4
# the 32-slot replay (BASELINE config #5), cut to 65,536 validators (16
# committees a slot): the build signs an aggregate a committee and copies
# the state a block
REPLAY_V = 65_536
REPLAY_SLOTS = 32
# the per-block replayer's depth: the last 8 slots (25-32, the epoch
# boundary's block last), cut from 32 to keep the script's time with the
# chain's phase; the segment replays all 32
REPLAY_PER_BLOCK = 8
REPLAY_COMMITTEES = 16
N_COMMITTEES = 64
COMMITTEE = 480
N_FLAT = 1_024
REPS = 5


T_START = time.monotonic()


def emit(phase: str, **kw) -> None:
    """One phase line; t_s, the script's seconds so far."""
    print(json.dumps({"phase": phase, "t_s": time.monotonic() - T_START, **kw}), flush=True)


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
    from lighthouse_tpu_torch.common import device_attribution, tracing
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
    from lighthouse_tpu_torch.ssz.cached_hash import cached_state_root, carry_tree_cache
    from lighthouse_tpu_torch.state_processing.per_block import (
        BlockProcessingError, BlockSignatureStrategy, SignatureCollector)

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
        pk_words = m.table.gather(m.indices) if m.table is not None else m.pubkeys
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

    def hold_batch(label, sets, seed, verdict=True):
        """Every kernel of one verify_signature_sets batch, step by step on
        the inputs the main path gives it, each held against its plain
        version into records[label]; the steps' verdict must be `verdict`
        (False for a batch carrying a forged signature)."""
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
        assert bool(ok) is verdict, f"{label}: stage-by-stage verdict is not {int(verdict)}"

    for label, sets, seed in (("grouped", slot, 3), ("flat", flat, 4)):
        hold_batch(label, sets, seed)

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
    # on; the valid sentinel rides each batch as the table's extra row, so
    # the batches stay indexed
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
    # (the sentinel rides as the table's extra row)
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
        extra_sets=[canary.riding_sentinel(st for c in committees for st in c)], device="cuda"))[0] is True
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

    # ------------------------------------ 7k. block processing (block)
    # BASELINE config #3 at mainnet width: mainnet spec, altair from
    # genesis, BLOCK_V validators (64 committees a slot of 128), secret key
    # i + 1 (testing.chain_keypairs), the pubkey cache filled from the
    # keypairs' points, its table on the card; slot 1 is skipped, so the
    # block at slot 2 carries the 128 attestations of slots 0 and 1, the
    # 512-seat sync aggregate, the proposal and the RANDAO reveal: 131 sets
    # and 16,898 keys (16,896 in the committees and the sync aggregate) in
    # one verify_signature_sets call on "gpu", through the table. Built
    # unmeasured; measured: Harness.import_block with VERIFY_BULK into a
    # collector of the script's (seeded slot + 1, as the harness's own),
    # its split, its launches and its batch's lanes; the sets it verified
    # are then held kernel by kernel
    t_phase = time.perf_counter()
    bk = {}
    bspec = mainnet_spec(ALTAIR_FORK_EPOCH=0)
    t0 = time.perf_counter()
    chain_keys = T.chain_keypairs(BLOCK_V)
    t1 = time.perf_counter()
    bh = T.chain_harness(bspec, chain_keys, backend="gpu", device="cuda")
    t2 = time.perf_counter()
    block_atts = bh.make_attestations(bh.state, 0)
    skipped = bh.state.copy()
    carry_tree_cache(skipped, bh.state)
    block_atts += bh.make_attestations(process_slots(skipped, 1, bspec, device="cuda"), 1)
    del skipped
    t3 = time.perf_counter()
    block = bh.produce_block(2, block_atts)
    t4 = time.perf_counter()
    # the forged block: attestation FORGED_AT carries another committee's
    # aggregate, in a block the proposer signed whole (its state root too)
    forged_atts = list(block_atts)
    forged_atts[FORGED_AT] = forged_atts[FORGED_AT].copy()
    forged_atts[FORGED_AT].signature = block_atts[FORGED_AT + 1].signature
    forged_block = bh.produce_block(2, forged_atts)
    t5 = time.perf_counter()
    body = block.message.body
    n_keys = 2 + sum(sum(a.aggregation_bits) for a in body.attestations) + sum(
        body.sync_aggregate.sync_committee_bits)
    bk["build"] = {"validators": BLOCK_V, "keys_s": t1 - t0, "genesis_and_cache_s": t2 - t1,
                   "attestations_s": t3 - t2, "produce_s": t4 - t3, "forged_produce_s": t5 - t4,
                   "attestations": len(body.attestations), "keys": n_keys}
    assert len(body.attestations) == 2 * BLOCK_COMMITTEES and n_keys == BLOCK_KEYS, bk["build"]
    pre_state = bh.state
    gpu_backend._MSG_CACHE.clear()  # the block's messages hashed in its import
    calls0 = dict(gpu_backend.CALL_COUNTS)
    cuda_build.reset_launches()
    block_coll = SignatureCollector(BlockSignatureStrategy.VERIFY_BULK, seed=3, consumer="bench",
                                    slot=2, device="cuda")
    t0 = time.perf_counter()
    post_root = bh.import_block(block, collector=block_coll)
    wall = time.perf_counter() - t0
    block_launches = {k: v for k, v in cuda_build.LAUNCHES.items() if v}
    calls = {k: gpu_backend.CALL_COUNTS[k] - calls0[k] for k in calls0}
    host = dict(gpu_backend.LAST_HOST_STATS)
    # copy_s is the state.copy() (with its tree cache), per_block_s the
    # host work, verify_s the one batch: marshalling and device
    split = dict(bh.last_import_stats)
    split["marshal_s"] = host["host_ms"] / 1e3
    split["device_s"] = host["device_ms"] / 1e3
    bk["block"] = {
        "validators": BLOCK_V, "sets": host["n_sets"], "keys": n_keys,
        "verdict": post_root == bytes(block.message.state_root), "post_root": post_root.hex(),
        "wall_s": wall, "split": split, "host_stats": host, "device_calls": calls,
        "indexed": host["indexed_path"], "lanes": host["s_bucket"], "key_lanes": host["s_bucket"] * host["k_bucket"],
        "k_bucket": host["k_bucket"], "key_padding": 1 - n_keys / (host["s_bucket"] * host["k_bucket"]),
        "launches": block_launches}
    print(smi, flush=True)
    emit("block", **bk["block"])
    assert bk["block"]["verdict"], "block: the post-state root differs from the block's"
    assert host["n_sets"] == BLOCK_SETS and host["indexed_path"] and not host["grouped"], host
    assert calls == {"batch": 1, "individual": 0}, calls
    missing = [k for k in BATCH_KERNELS if not block_launches.get(k)]
    assert not missing, f"block: the path launched no {missing}"
    # the sets the import verified, through every kernel step by step
    # against its plain version
    assert len(block_coll.sets) == BLOCK_SETS and sum(len(s.pubkeys) for s in block_coll.sets) == n_keys
    hold_batch("block", block_coll.sets, 41)
    records["block_launches"] = block_launches

    # ------------------------------ the forged block (block_forged)
    # VERIFY_BULK raises and leaves the harness's state as it was;
    # VERIFY_INDIVIDUAL raises at the forged attestation: the proposal, the
    # RANDAO reveal and attestations 0 .. FORGED_AT, one device call each
    bh.state = pre_state
    root_before = cached_state_root(pre_state)
    fg = {"forged_attestation": FORGED_AT}
    for strategy in (BlockSignatureStrategy.VERIFY_BULK, BlockSignatureStrategy.VERIFY_INDIVIDUAL):
        calls0 = dict(gpu_backend.CALL_COUNTS)
        t0 = time.perf_counter()
        try:
            bh.import_block(forged_block, strategy=strategy, consumer="bench")
            raised = None
        except BlockProcessingError as e:
            raised = str(e)
        fg[strategy.value] = {
            "raised": raised, "wall_s": time.perf_counter() - t0,
            "device_calls": {k: gpu_backend.CALL_COUNTS[k] - calls0[k] for k in calls0},
            "state_unchanged": bh.state is pre_state and cached_state_root(bh.state) == root_before}
    print(smi, flush=True)
    emit("block_forged", **fg)
    bulk, indiv = fg["verify_bulk"], fg["verify_individual"]
    assert bulk["raised"] and bulk["state_unchanged"] and bulk["device_calls"]["batch"] == 1, bulk
    assert indiv["raised"] and indiv["state_unchanged"] and \
        indiv["device_calls"]["batch"] == FORGED_AT + 3, indiv
    bk["forged"] = fg
    bk["phase_s"] = time.perf_counter() - t_phase
    records["block_phase"] = bk
    # what phase 7m's chain starts from: 7k's genesis, its filled cache, the
    # block with its root and post-state root, the sets its import verified
    chain_genesis, chain_cache = pre_state, bh.pubkey_cache
    block_root_7k = type(block.message).hash_tree_root(block.message)
    block_post_root = post_root
    block_sets_fp = [set_fp(s) for s in block_coll.sets]
    del bh, pre_state, block_coll

    # -------------------------- 7l. a 32-slot replay (replay, config #5)
    # lighthouse_tpu/bench_replay.py's loop on the port: 32 slots from
    # genesis across the first epoch boundary at REPLAY_V validators (16
    # committees a slot of 128; the first REPLAY_V of the block's keys);
    # every block carries the previous slot's 16 attestations, the sync
    # aggregate, the proposal and the RANDAO reveal: 19 sets, 2,562 keys.
    # Built unmeasured with NO_VERIFICATION (each block's post-state the
    # one production computed its root on); then replayed by two fresh
    # replayers: import_block with VERIFY_BULK per block over the last
    # REPLAY_PER_BLOCK slots, the epoch boundary's block among them, from
    # the built state before them (one device call a block), and
    # Harness.import_segment over all 32, one collector and one finish()
    # before anything is committed (one device call of 608 sets)
    t_phase = time.perf_counter()
    rp = {}
    rkeys = chain_keys[:REPLAY_V]
    t0 = time.perf_counter()
    producer = T.chain_harness(bspec, rkeys, backend="gpu", device="cuda")
    genesis = producer.state.copy()
    producer.pending_attestations = producer.make_attestations(producer.state, 0)
    blocks = []
    for s in range(1, REPLAY_SLOTS + 1):
        blocks.append(producer.advance_slot_with_block(s, strategy=BlockSignatureStrategy.NO_VERIFICATION))
        if s == REPLAY_SLOTS - REPLAY_PER_BLOCK:
            per_block_base = producer.state.copy()
    producer_root = cached_state_root(producer.state)
    rp["build_s"] = time.perf_counter() - t0
    per_block_sets = [3 + len(b.message.body.attestations) for b in blocks]
    assert per_block_sets == [3 + REPLAY_COMMITTEES] * REPLAY_SLOTS, per_block_sets

    def replayer(base):
        return T.chain_harness(bspec, rkeys, backend="gpu", device="cuda", genesis=base)

    r1 = replayer(per_block_base)
    gpu_backend._MSG_CACHE.clear()
    calls0 = dict(gpu_backend.CALL_COUNTS)
    cuda_build.reset_launches()
    splits, accepted1, n_sets, n_keys_r = [], [], 0, 0
    t0 = time.perf_counter()
    for b in blocks[-REPLAY_PER_BLOCK:]:
        accepted1.append(r1.import_block(b, consumer="bench") == bytes(b.message.state_root))
        host = dict(gpu_backend.LAST_HOST_STATS)
        splits.append(dict(r1.last_import_stats, marshal_s=host["host_ms"] / 1e3,
                           device_s=host["device_ms"] / 1e3, lanes=host["s_bucket"],
                           k_bucket=host["k_bucket"]))
        n_sets += host["n_sets"]
    wall1 = time.perf_counter() - t0
    per_block_launches = {k: v for k, v in cuda_build.LAUNCHES.items() if v}
    calls1 = {k: gpu_backend.CALL_COUNTS[k] - calls0[k] for k in calls0}
    for b in blocks:
        body = b.message.body
        n_keys_r += 2 + sum(sum(a.aggregation_bits) for a in body.attestations) + sum(
            body.sync_aggregate.sync_committee_bits)
    root1 = cached_state_root(r1.state)
    del r1, per_block_base

    r2 = replayer(genesis)
    gpu_backend._MSG_CACHE.clear()
    calls0 = dict(gpu_backend.CALL_COUNTS)
    cuda_build.reset_launches()
    segment = SignatureCollector(BlockSignatureStrategy.VERIFY_BULK, seed=51, consumer="bench",
                                 device="cuda")
    t0 = time.perf_counter()
    roots2 = r2.import_segment(blocks, collector=segment)
    wall2 = time.perf_counter() - t0
    accepted2 = [r == bytes(b.message.state_root) for r, b in zip(roots2, blocks)]
    seg_stats = r2.last_import_stats
    seg_host = dict(gpu_backend.LAST_HOST_STATS)
    segment_launches = {k: v for k, v in cuda_build.LAUNCHES.items() if v}
    calls2 = {k: gpu_backend.CALL_COUNTS[k] - calls0[k] for k in calls0}
    root2 = cached_state_root(r2.state)

    def med(key):
        return statistics.median(s[key] for s in splits)

    # the block at slot 32 crosses into epoch 1 and carries slot 31's
    # attestations, of the previous epoch
    boundary = splits[-1]
    rp.update({
        "validators": REPLAY_V, "slots": REPLAY_SLOTS, "sets": len(segment.sets), "keys": n_keys_r,
        "accepted": {"per_block": sum(accepted1), "segment": sum(accepted2)},
        "every_block_accepted": len(accepted1) == REPLAY_PER_BLOCK and len(accepted2) == REPLAY_SLOTS
        and all(accepted1) and all(accepted2) and r2.state.slot == REPLAY_SLOTS,
        "roots_equal": root1 == root2 == producer_root,
        "final_root": producer_root.hex(),
        "per_block": {"slots": REPLAY_PER_BLOCK, "wall_s": wall1, "slots_per_s": REPLAY_PER_BLOCK / wall1,
                      "device_calls": calls1,
                      "split_median": {k: med(k) for k in ("copy_s", "process_slots_s", "per_block_s",
                                                           "verify_s", "state_root_s", "marshal_s",
                                                           "device_s")},
                      "boundary_per_block_s": boundary["per_block_s"],
                      "lanes": splits[0]["lanes"], "k_bucket": splits[0]["k_bucket"],
                      "launches": per_block_launches},
        "segment": {"wall_s": wall2, "slots_per_s": REPLAY_SLOTS / wall2, "device_calls": calls2,
                    "copy_s": seg_stats["copy_s"],
                    "imports_s": wall2 - seg_stats["copy_s"] - seg_stats["verify_s"],
                    "finish_s": seg_stats["verify_s"],
                    "per_block_s_median": statistics.median(x["per_block_s"] for x in seg_stats["blocks"]),
                    "boundary_per_block_s": seg_stats["blocks"][REPLAY_SLOTS - 1]["per_block_s"],
                    "sets": len(segment.sets), "keys": sum(len(s.pubkeys) for s in segment.sets),
                    "marshal_s": seg_host["host_ms"] / 1e3, "device_s": seg_host["device_ms"] / 1e3,
                    "lanes": seg_host["s_bucket"], "k_bucket": seg_host["k_bucket"],
                    "launches": segment_launches},
        "epoch_boundary": {"slot": REPLAY_SLOTS, "process_slots_s": boundary["process_slots_s"],
                           "device": "cuda"},
    })
    print(smi, flush=True)
    emit("replay", **rp)
    assert rp["every_block_accepted"], rp["accepted"]
    assert rp["roots_equal"], (root1.hex(), root2.hex(), producer_root.hex())
    assert n_sets == REPLAY_PER_BLOCK * (3 + REPLAY_COMMITTEES), n_sets
    assert len(segment.sets) == REPLAY_SLOTS * (3 + REPLAY_COMMITTEES), len(segment.sets)
    assert calls1 == {"batch": REPLAY_PER_BLOCK, "individual": 0}, calls1
    assert calls2 == {"batch": 1, "individual": 0}, calls2
    for lbl, launches in (("per_block", per_block_launches), ("segment", segment_launches)):
        missing = [k for k in BATCH_KERNELS if not launches.get(k)]
        assert not missing, f"replay {lbl}: the path launched no {missing}"
    hold_batch("segment", segment.sets, 52)
    rp["phase_s"] = time.perf_counter() - t_phase
    records["replay_phase"] = rp
    records["replay_launches"] = {"per_block": per_block_launches, "segment": segment_launches}
    del r2, segment

    # ------------------------------------------- 7m. the beacon chain (chain)
    # BeaconChain (lighthouse_tpu_torch/beacon_chain/chain.py) on the card,
    # with its store, fork choice, pools, bus, DA checker and light-client
    # producer: a. 7k's genesis and filled pubkey cache (BLOCK_V), 7k's
    # block through process_block; b. gossip batches for the head's slot:
    # 64 singles, 64 singles with one forged, 64 aggregates; c. 7l's 32
    # blocks as one segment on a fresh chain on 7l's genesis (REPLAY_V), and
    # again with the last block's first attestation forged; d. a blob block
    # carrying 7e's six blobs on a mainnet-spec chain with bellatrix at
    # epoch 1 (BLOB_V validators), sidecars first, fused and serial, then a
    # block held until its last sidecar; e. the light-client producer with
    # device_check on the segment chain's last import
    from lighthouse_tpu_torch import bls as pbls
    from lighthouse_tpu_torch import ssz as pssz
    from lighthouse_tpu_torch.beacon_chain import BeaconChain
    from lighthouse_tpu_torch.beacon_chain.attestation_verification import VerifiedAttestation
    from lighthouse_tpu_torch.beacon_chain.chain import BlockError
    from lighthouse_tpu_torch.light_client import LightClientUpdateProducer
    from lighthouse_tpu_torch.network.gossip import GossipHub
    from lighthouse_tpu_torch.node import BeaconNode
    from lighthouse_tpu_torch.state_processing.helpers import get_domain
    from lighthouse_tpu_torch.store.hot_cold import COL_BLOCK
    from lighthouse_tpu_torch.types.helpers import compute_signing_root
    from lighthouse_tpu_torch.verification_bus.bus import DEFAULT_GPU_HOLD_MS

    t_phase = time.perf_counter()
    GUARD.reset()
    INJECTOR.reset()
    ch, chain_launches = {}, {}

    def calls_since(c0):
        return {k: gpu_backend.CALL_COUNTS[k] - c0[k] for k in c0}

    def launched():
        return {k: v for k, v in cuda_build.LAUNCHES.items() if v}

    # the split of an import, from the chain's and the bus's own spans
    SPLIT_SPANS = {"import/state_copy": "copy_s", "verify/hash_to_g2": "hash_to_g2_s",
                   "import/hot_state_write": "hot_state_write_s",
                   "import/fork_choice_on_block": "fork_choice_on_block_s",
                   "import/fork_choice_get_head": "fork_choice_get_head_s", "import/hooks": "import_hooks_s"}
    tracing.configure(enabled=True, capacity=16_384)

    def span_split():
        """Seconds by SPLIT_SPANS over the span trees completed since the
        tracer's last reset; the tracer is reset."""
        total = {}

        def walk(d):
            total[d["name"]] = total.get(d["name"], 0.0) + d["duration_s"]
            for c in d["children"]:
                walk(c)
        for d in tracing.TRACER.recent():
            walk(d)
        tracing.TRACER.reset()
        return {key: total.get(name, 0.0) for name, key in SPLIT_SPANS.items()}

    def keep_submissions(c, submitted):
        """The chain's bus submissions kept, each as its list of sets."""
        real_submit = c.verification_bus.submit

        def submit(sets, *a, **kw):
            sets = list(sets)
            submitted.append(sets)
            return real_submit(sets, *a, **kw)
        c.verification_bus.submit = submit

    def budget(c):
        """The chain's last slot-budget record: its stages and dispatches."""
        rec = c.slot_budget.recent(1)[-1]
        stages = {}
        for name, s, e in rec["stages"]:
            stages[name] = stages.get(name, 0.0) + e - s
        return {"wall_s": rec["wall_s"], "stages_s": stages, "unattributed_s": rec["unattributed_s"],
                "serial_dispatches": rec["serial_dispatches"], "device_s": rec["device_s"],
                "bus_wait_s": rec["bus_wait_s"],
                "dispatches": [(d["label"], d["kind"]) for d in rec["dispatches"]]}

    def hold_per_set(label, sets):
        """Every kernel of one per-set call (gpu_backend.
        verify_signature_sets_gpu_individual), step by step on its inputs,
        each held against its plain version into records[label]; returns
        the stage-by-stage verdicts. Keys in a table arrive affine; others
        as points, through the Jacobian entry."""
        pm = gpu_backend._marshal_flat(list(sets), pow2=False)
        prec = records.setdefault(label, {})
        emit("shapes", batch=label, lanes=pm.s_bucket, keys=pm.k_bucket, indexed=pm.table is not None)
        for w, words in ((1, pm.pubkeys), (2, pm.sigs)) if pm.table is None else ((2, pm.sigs),):
            pt = tuple(bv._lanes(c, dev) for c in words)
            prec[f"jacobian_to_affine_g{w}"] = hold(
                f"jacobian_to_affine_g{w}", lambda: curve_kernels.jacobian_to_affine(pt),
                lambda: curve_kernels.jacobian_to_affine_plain(pt), nb(pt),
                products=curve_kernels.affine_products(w, True, pt[0].shape[-1]))
        agg_p = bv._aggregate_keys(gpu_backend._pubkeys(pm, dev), pm.key_mask, dev)
        prec["to_affine_g1"] = hold(
            "to_affine_g1", lambda: curve_kernels.to_affine(agg_p), lambda: curve_kernels.to_affine_plain(agg_p),
            nb(agg_p), products=curve_kernels.affine_products(1, False, agg_p[0].shape[-1]))
        g1p, g2p, pmask_p, _ = bv._individual_pairs(pm.msgs, pm.sigs, gpu_backend._pubkeys(pm, dev),
                                                    pm.key_mask, pm.set_mask, dev)
        prec["miller"] = hold("miller", lambda: miller.miller_loop(g1p, g2p, pmask_p),
                              lambda: miller.miller_loop_plain(g1p, g2p, pmask_p), nb(g1p, g2p, pmask_p))
        f_pair = miller.miller_loop(g1p, g2p, pmask_p)
        prec["pair_final_exp"] = hold("pair_final_exp", lambda: final_exp.pair_final_exp(f_pair),
                                      lambda: final_exp.pair_final_exp_plain(f_pair), nb(f_pair))
        return final_exp.pair_final_exp(f_pair)[1].tolist()[:len(sets)]

    # the bus's canary pair, a per-set call on every chain dispatch: its two
    # sets' keys are in no table (the point path); each of its kernels held
    # at its shapes, and its verdicts [True, False]
    pair_ok = hold_per_set("canary_pair", canary.bls_sentinels())
    assert pair_ok == [True, False], f"canary pair: stage-by-stage verdicts {pair_ok}"

    # ---- a. the block (chain_block)
    submitted = []
    t0 = time.perf_counter()
    chain = BeaconChain(chain_genesis, bspec, backend="gpu", device="cuda", pubkey_cache=chain_cache)
    construct_s = time.perf_counter() - t0
    keep_submissions(chain, submitted)
    gpu_backend._MSG_CACHE.clear()  # the block's messages hashed in its import, as in 7k
    c0 = dict(gpu_backend.CALL_COUNTS)
    b0 = chain.verification_bus.stats()["batches_formed"]
    cuda_build.reset_launches()
    tracing.TRACER.reset()
    t0 = time.perf_counter()
    root_a = chain.process_block(block)
    wall_a = time.perf_counter() - t0
    split = span_split()
    chain_launches["block"] = launched()
    host = dict(gpu_backend.LAST_HOST_STATS)
    calls = calls_since(c0)
    canaries = chain.verification_bus.stats()["batches_formed"] - b0
    fc_head = chain.fork_choice.get_head(chain._justified_balances)
    post_a = cached_state_root(chain.head_state)
    same_sets = len(submitted) == 1 and [set_fp(s) for s in submitted[0]] == block_sets_fp
    ch["block"] = {
        "validators": BLOCK_V, "construct_s": construct_s, "wall_s": wall_a, "sets": len(submitted[0]),
        "same_sets_as_7k": same_sets, "head_is_block": chain.head_root == root_a == block_root_7k,
        "fork_choice_head_equal": fc_head == chain.head_root, "post_root": post_a.hex(),
        "post_root_equal_7k": post_a == block_post_root, "device_calls": calls, "canary_calls": canaries,
        "split": dict(split, marshal_s=host["host_ms"] / 1e3, device_s=host["device_ms"] / 1e3,
                      batch_sets=host["n_sets"], indexed=host["indexed_path"]),
        "slot_budget": budget(chain), "launches": chain_launches["block"]}
    print(smi, flush=True)
    emit("chain_block", **ch["block"])
    assert same_sets and ch["block"]["head_is_block"] and ch["block"]["fork_choice_head_equal"], ch["block"]
    assert ch["block"]["post_root_equal_7k"], "chain_block: post-state root differs from 7k's"
    # one batch on the card; the bus's canary pair is a per-set call of its own
    assert calls == {"batch": 1, "individual": canaries} and canaries == 1, (calls, canaries)
    # the sentinel rides as the table's extra row: the batch stays indexed
    assert ch["block"]["split"]["indexed"], "chain_block: the batch left the pubkey table"
    missing = [k for k in BATCH_KERNELS if not chain_launches["block"].get(k)]
    assert not missing, f"chain_block: the path launched no {missing}"
    # every kernel at the batch's own inputs: the block's sets and the
    # sentinel as the bus adds it
    hold_batch("chain_block", submitted[0] + [canary.riding_sentinel(submitted[0])], 71)

    # ---- b. gossip (chain_gossip): the head's slot, one member of each of
    # its 64 committees a single (sk = index + 1); then the second members
    # with one forged; then 64 aggregates, the third member the aggregator
    gs = {"hold_ms": DEFAULT_GPU_HOLD_MS}
    hslot = int(chain.head_state.slot)
    hepoch = bspec.slot_to_epoch(hslot)
    att_domain = get_domain(chain.head_state, bspec.DOMAIN_BEACON_ATTESTER, hepoch, bspec)
    datas = [chain.produce_attestation_data(hslot, k) for k in range(BLOCK_COMMITTEES)]
    committees = [chain.committee_for(d) for d in datas]
    roots_g = [compute_signing_root(type(d).hash_tree_root(d), att_domain) for d in datas]

    def singles(member):
        out = []
        for d, com, r in zip(datas, committees, roots_g):
            v = com[member]
            out.append(chain.t.Attestation(
                aggregation_bits=[j == member for j in range(len(com))], data=d,
                signature=chain_keys[v].sk.sign(r).to_bytes()))
        return out

    t0 = time.perf_counter()
    batch1, batch2 = singles(0), singles(1)
    batch2[GOSSIP_FORGED].signature = batch2[GOSSIP_FORGED + 1].signature
    sel_domain = get_domain(chain.head_state, bspec.DOMAIN_SELECTION_PROOF, hepoch, bspec)
    agg_domain = get_domain(chain.head_state, bspec.DOMAIN_AGGREGATE_AND_PROOF, hepoch, bspec)
    sel_root = compute_signing_root(pssz.uint64.hash_tree_root(hslot), sel_domain)
    aggregates = []
    for d, com, r in zip(datas, committees, roots_g):
        agg = chain.t.Attestation(aggregation_bits=[True] * len(com), data=d, signature=pbls.SecretKey(
            sum(v + 1 for v in com) % R_ORDER).sign(r).to_bytes())
        a_idx = com[2]
        msg = chain.t.AggregateAndProof(aggregator_index=a_idx, aggregate=agg,
                                        selection_proof=chain_keys[a_idx].sk.sign(sel_root).to_bytes())
        aggregates.append(chain.t.SignedAggregateAndProof(message=msg, signature=chain_keys[a_idx].sk.sign(
            compute_signing_root(type(msg).hash_tree_root(msg), agg_domain)).to_bytes()))
    gs["sign_s"] = time.perf_counter() - t0

    def gossip(label, fn, items):
        del submitted[:]
        gpu_backend._MSG_CACHE.clear()
        c0 = dict(gpu_backend.CALL_COUNTS)
        s0 = chain.verification_bus.stats()
        cuda_build.reset_launches()
        tracing.TRACER.reset()
        t0 = time.perf_counter()
        res = fn(items)
        wall = time.perf_counter() - t0
        hash_s = span_split()["hash_to_g2_s"]
        host = dict(gpu_backend.LAST_HOST_STATS)
        chain_launches[f"gossip_{label}"] = launched()
        s1 = chain.verification_bus.stats()
        ok = [isinstance(r, VerifiedAttestation) for r in res]
        gs[label] = {"n": len(items), "accepted": sum(ok), "refused_at": [i for i, g in enumerate(ok) if not g],
                     "wall_s": wall, "hash_to_g2_s": hash_s, "indexed": host["indexed_path"],
                     "marshal_s": host["host_ms"] / 1e3, "device_s": host["device_ms"] / 1e3,
                     "device_calls": calls_since(c0),
                     "canary_calls": s1["batches_formed"] - s0["batches_formed"],
                     "triggers": {k: v - s0["triggers"].get(k, 0) for k, v in s1["triggers"].items()
                                  if v != s0["triggers"].get(k, 0)},
                     "sets": sum(len(s) for s in submitted), "launches": chain_launches[f"gossip_{label}"]}
        return res

    gossip("singles", chain.process_unaggregated_attestations, batch1)
    singles_sets = list(submitted[0])
    voted = all(chain.fork_choice.votes[com[0]].next_root == chain.head_root for com in committees)
    pooled = len(chain.naive_pool.aggregates_at_slot(hslot))
    gossip("forged", chain.process_unaggregated_attestations, batch2)
    gossip("aggregates", chain.process_aggregated_attestations, aggregates)
    gs.update(votes_in_fork_choice=voted, naive_pool_aggregates=pooled,
              naive_pool_after_forged=len(chain.naive_pool.aggregates_at_slot(hslot)),
              op_pool_attestations=chain.op_pool.num_attestations())
    print(smi, flush=True)
    emit("chain_gossip", **gs)
    s1, fg, ag = gs["singles"], gs["forged"], gs["aggregates"]
    assert s1["accepted"] == BLOCK_COMMITTEES and voted and pooled == BLOCK_COMMITTEES, s1
    assert s1["indexed"] and fg["indexed"] and ag["indexed"], "chain_gossip: a batch left the pubkey table"
    assert s1["device_calls"] == {"batch": 1, "individual": s1["canary_calls"]} and s1["canary_calls"] == 1, s1
    assert fg["refused_at"] == [GOSSIP_FORGED] and fg["accepted"] == BLOCK_COMMITTEES - 1, fg
    # batch, then per-set verdicts: two calls, and the batch's canary pair
    assert fg["device_calls"] == {"batch": 1, "individual": 1 + fg["canary_calls"]} and fg["canary_calls"] == 1, fg
    assert ag["accepted"] == BLOCK_COMMITTEES and gs["op_pool_attestations"] == BLOCK_COMMITTEES, ag
    assert ag["device_calls"]["batch"] == 1 and ag["sets"] == 3 * BLOCK_COMMITTEES, ag
    # the singles' kernels at the gossip batch's shapes: the 64 sets and the
    # bus's valid sentinel riding them as the table's extra row
    hold_batch("gossip", singles_sets + [canary.riding_sentinel(singles_sets)], 61)
    ch["gossip"] = gs

    # ---- c. the segment (chain_segment): 7l's 32 blocks on the chain of a
    # fresh node, S, which serves them to 7n's late node C over its RPC
    seg_cache = T.chain_pubkey_cache(genesis, rkeys, "cuda")
    sync_hub = GossipHub()
    t0 = time.perf_counter()
    node_s = BeaconNode("S", genesis, bspec, hub=sync_hub, backend="gpu", device="cuda", pubkey_cache=seg_cache)
    seg_construct_s = time.perf_counter() - t0
    seg_chain = node_s.chain
    # the light-client producer's hook off here: chain_lc measures it once
    seg_chain.import_hooks.remove(seg_chain.light_client_producer.on_import)
    seg_submitted = []
    keep_submissions(seg_chain, seg_submitted)
    gpu_backend._MSG_CACHE.clear()
    c0 = dict(gpu_backend.CALL_COUNTS)
    cuda_build.reset_launches()
    tracing.TRACER.reset()
    t0 = time.perf_counter()
    seg_roots = seg_chain.process_chain_segment(blocks)
    wall_c = time.perf_counter() - t0
    seg_split = span_split()
    chain_launches["segment"] = launched()
    seg_host = dict(gpu_backend.LAST_HOST_STATS)
    seg_calls = calls_since(c0)
    seg_root = cached_state_root(seg_chain.head_state)
    # the forged segment: the first SEGMENT_FORGED_LEN blocks, the last one's
    # first attestation carrying the second's signature, the proposal
    # re-signed: the one batch fails before anything is committed
    forged_last = blocks[SEGMENT_FORGED_LEN - 1].copy()
    fbody = forged_last.message.body
    assert len(fbody.attestations) >= 2, "chain_segment: the forged block has too few attestations"
    fbody.attestations[0].signature = bytes(fbody.attestations[1].signature)
    prop_domain = get_domain(genesis, bspec.DOMAIN_BEACON_PROPOSER,
                             bspec.slot_to_epoch(int(forged_last.message.slot)), bspec)
    forged_last.signature = rkeys[forged_last.message.proposer_index].sk.sign(compute_signing_root(
        type(forged_last.message).hash_tree_root(forged_last.message), prop_domain)).to_bytes()
    f_chain = BeaconChain(genesis.copy(), bspec, backend="gpu", device="cuda", pubkey_cache=seg_cache)
    c0 = dict(gpu_backend.CALL_COUNTS)
    t0 = time.perf_counter()
    try:
        f_chain.process_chain_segment(blocks[:SEGMENT_FORGED_LEN - 1] + [forged_last])
        f_raised = None
    except BlockError as e:
        f_raised = str(e)
    f_wall = time.perf_counter() - t0
    f_calls = calls_since(c0)
    ch["segment"] = {
        "validators": REPLAY_V, "slots": REPLAY_SLOTS, "construct_s": seg_construct_s, "wall_s": wall_c,
        "slots_per_s": REPLAY_SLOTS / wall_c, "harness_segment_slots_per_s": rp["segment"]["slots_per_s"],
        "imported": len(seg_roots), "head_slot": int(seg_chain.head_state.slot),
        "final_root": seg_root.hex(), "final_root_equal_7l": seg_root == producer_root,
        "device_calls": seg_calls, "split": dict(seg_split, marshal_s=seg_host["host_ms"] / 1e3,
                                                 device_s=seg_host["device_ms"] / 1e3,
                                                 batch_sets=seg_host["n_sets"],
                                                 indexed=seg_host["indexed_path"]),
        "launches": chain_launches["segment"],
        "forged": {"blocks": SEGMENT_FORGED_LEN, "raised": f_raised, "wall_s": f_wall, "device_calls": f_calls,
                   "blocks_stored": len(f_chain.store.kv.keys(COL_BLOCK)),
                   "fork_choice_nodes": len(f_chain.fork_choice.proto.nodes),
                   "head_is_genesis": f_chain.head_root == f_chain.genesis_root}}
    print(smi, flush=True)
    emit("chain_segment", **ch["segment"])
    sg = ch["segment"]
    assert sg["imported"] == REPLAY_SLOTS and sg["head_slot"] == REPLAY_SLOTS and sg["final_root_equal_7l"], sg
    assert seg_calls == {"batch": 1, "individual": 1}, seg_calls  # one bulk call and its canary pair
    assert sg["split"]["indexed"], "chain_segment: the batch left the pubkey table"
    fs = sg["forged"]
    assert fs["raised"] == "segment signature batch failed" and fs["blocks_stored"] == 0 and \
        fs["fork_choice_nodes"] == 1 and fs["head_is_genesis"], fs
    assert f_calls == {"batch": 1, "individual": 1}, f_calls
    del f_chain
    (seg_sets,) = seg_submitted
    hold_batch("chain_segment", seg_sets + [canary.riding_sentinel(seg_sets)], 72)
    seg_sets_fp = [set_fp(s) for s in seg_sets]
    del seg_sets, seg_submitted

    # ---- e. the light-client producer with device_check (chain_lc): the
    # segment chain's last import through a producer whose branches fold
    # on the card (ops/merkle_proof, csrc/sha256_fold.cu)
    lc = LightClientUpdateProducer(seg_chain, device_check=True, device="cuda")
    cuda_build.reset_launches()
    t0 = time.perf_counter()
    lc.on_import(seg_roots[-1])
    lc_s = time.perf_counter() - t0
    chain_launches["lc"] = launched()
    period = lc._period_at_slot(REPLAY_SLOTS - 1)
    upd = lc.best_updates.get(period)
    lc_rec = {"wall_s": lc_s, "launches": chain_launches["lc"], "produced": upd is not None}
    if upd is not None:
        attested_root = bytes(upd.attested_header.beacon.state_root)
        leaf = type(upd.next_sync_committee).hash_tree_root(upd.next_sync_committee)
        query = [(leaf, [bytes(b) for b in upd.next_sync_committee_branch], seg_chain.t.NEXT_SYNC_COMMITTEE_GINDEX)]
        lc_rec.update(attested_slot=int(upd.attested_header.beacon.slot),
                      branch_on_state_root=merkle_proof.batch_verify_branches(query, [attested_root],
                                                                              device="cpu") == [True],
                      attested_root_equal=attested_root == bytes(blocks[-2].message.state_root))
    print(smi, flush=True)
    emit("chain_lc", **lc_rec)
    assert lc_rec["produced"] and lc_rec["branch_on_state_root"] and lc_rec["attested_root_equal"], lc_rec
    assert chain_launches["lc"].get("sha256_fold", 0) >= 1, chain_launches["lc"]
    ch["lc"] = lc_rec
    del seg_chain, lc

    # ---- d. the blob block (chain_blobs): a mainnet-spec chain with
    # bellatrix at epoch 1 (the port's genesis cannot start at bellatrix), cut
    # to BLOB_V validators; 32 slots built unverified; the chains start at
    # slot 32 from that checkpoint (from_checkpoint); the block at slot 33
    # carries 7e's six blobs (4,096 elements each, seed 4844)
    dspec = mainnet_spec(ALTAIR_FORK_EPOCH=0, BELLATRIX_FORK_EPOCH=1)
    dkeys = chain_keys[:BLOB_V]
    t0 = time.perf_counter()
    dh = T.chain_harness(dspec, dkeys, backend="gpu", device="cuda")
    dh.pending_attestations = dh.make_attestations(dh.state, 0)
    for s in range(1, dspec.SLOTS_PER_EPOCH + 1):
        anchor_block = dh.advance_slot_with_block(s, strategy=BlockSignatureStrategy.NO_VERIFICATION)
    anchor_state = dh.state
    bl = {"validators": BLOB_V, "blobs": KZG_BLOBS, "field_elements": KZG_FE, "build_s": time.perf_counter() - t0,
          "anchor_fork": dspec.fork_name_at_epoch(1)}
    blob_block, post33 = dh._produce(dspec.SLOTS_PER_EPOCH + 1, dh.pending_attestations[:dspec.MAX_ATTESTATIONS],
                                     blob_kzg_commitments=comms)
    t0 = time.perf_counter()
    sidecars = dh.make_blob_sidecars(blob_block, blobs)
    bl["make_blob_sidecars_s"] = time.perf_counter() - t0
    assert [bytes(sc.kzg_proof) for sc in sidecars] == proofs, "make_blob_sidecars: proofs differ from 7e's"
    root33 = type(blob_block.message).hash_tree_root(blob_block.message)

    def blob_chain(fuse):
        c = BeaconChain.from_checkpoint(anchor_state, anchor_block, dspec, backend="gpu", device="cuda",
                                        pubkey_cache=dh.pubkey_cache)
        c.slot_fuse = fuse
        return c

    arms = {}
    for arm, fuse in (("fused", True), ("serial", False)):
        c = blob_chain(fuse)
        gpu_backend._MSG_CACHE.clear()
        c0 = dict(gpu_backend.CALL_COUNTS)
        g0 = GUARD.stats()["dispatches"]
        cuda_build.reset_launches()
        t0 = time.perf_counter()
        early = [c.process_blob_sidecar(sc) for sc in sidecars]  # candidates, header checked once
        t1 = time.perf_counter()
        header_calls = calls_since(c0)
        c0 = dict(gpu_backend.CALL_COUNTS)
        g1 = GUARD.stats()["dispatches"]
        launches0 = launched()
        blob_submitted = []
        keep_submissions(c, blob_submitted)
        cuda_build.reset_launches()
        t2 = time.perf_counter()
        imported = c.process_block(blob_block)
        t3 = time.perf_counter()
        chain_launches[f"blobs_{arm}"] = launched()
        arms[arm] = {
            "sidecars_s": t1 - t0, "sidecar_results": early, "header_device_calls": header_calls,
            "headers_verified": len(c._verified_sidecar_headers), "header_launches": launches0,
            "import_s": t3 - t2, "imported": imported == root33, "head": c.head_root.hex(),
            "post_root": cached_state_root(c.head_state).hex(),
            "stored_sidecars": len(c.store.get_blob_sidecars(root33)),
            "device_calls": calls_since(c0), "guard_dispatches": GUARD.stats()["dispatches"] - g1,
            "guard_dispatches_headers": g1 - g0, "slot_budget": budget(c),
            "launches": chain_launches[f"blobs_{arm}"]}
        arms[arm]["sidecar_results"] = [list(r) for r in early]
        if arm == "fused":
            fused_chain = c
            (fused_sets,) = blob_submitted
        else:
            del c
    # the next block, held until its last sidecar (the same blobs, so the
    # same proofs, under block 34's header)
    dh.state = post33
    block34 = dh.produce_block(dspec.SLOTS_PER_EPOCH + 2, dh.make_attestations(post33, dspec.SLOTS_PER_EPOCH + 1),
                               blob_kzg_commitments=comms)
    root34 = type(block34.message).hash_tree_root(block34.message)
    m34 = block34.message
    header34 = dh.t.SignedBeaconBlockHeader(
        message=dh.t.BeaconBlockHeader(slot=m34.slot, proposer_index=m34.proposer_index,
                                       parent_root=bytes(m34.parent_root), state_root=bytes(m34.state_root),
                                       body_root=type(m34.body).hash_tree_root(m34.body)),
        signature=bytes(block34.signature))
    sidecars34 = []
    for sc in sidecars:
        sc = sc.copy()
        sc.signed_block_header = header34
        sidecars34.append(sc)
    held = []
    try:
        fused_chain.process_block(block34)
        held.append(None)
    except BlockError as e:
        held.append(str(e))
    t0 = time.perf_counter()
    released = [fused_chain.process_blob_sidecar(sc) for sc in sidecars34[:-1]]
    try:
        fused_chain.process_block(block34)
        held.append(None)
    except BlockError as e:
        held.append(str(e))
    released.append(fused_chain.process_blob_sidecar(sidecars34[-1]))
    release_s = time.perf_counter() - t0
    bl.update(arms=arms, hold={"held": held, "released": [[r.hex() for r in x] for x in released],
                               "head_is_34": fused_chain.head_root == root34, "wall_s": release_s,
                               "stored_sidecars": len(fused_chain.store.get_blob_sidecars(root34))})
    print(smi, flush=True)
    emit("chain_blobs", **bl)
    fa, sa = arms["fused"], arms["serial"]
    for a in (fa, sa):
        assert a["sidecar_results"] == [[]] * KZG_BLOBS and a["headers_verified"] == 1, a
        assert a["header_device_calls"]["batch"] == 1, a  # the header signature once for its 6 sidecars
        assert a["imported"] and a["stored_sidecars"] == KZG_BLOBS, a
    assert fa["head"] == sa["head"] == root33.hex() and fa["post_root"] == sa["post_root"], (fa, sa)
    # fused: the fold and the KZG settle in one slot_program dispatch;
    # serial: the settle (kzg plane), then the fold (the bus)
    assert fa["guard_dispatches"] == 1 and fa["slot_budget"]["serial_dispatches"] == 1, fa
    assert sa["guard_dispatches"] == 2 and sa["slot_budget"]["serial_dispatches"] == 2, sa
    assert all(h and h.startswith("data unavailable") for h in held), held
    assert released[:-1] == [[]] * (KZG_BLOBS - 1) and released[-1] == [root34], released
    assert bl["hold"]["head_is_34"] and bl["hold"]["stored_sidecars"] == KZG_BLOBS, bl["hold"]
    missing = [k for k in PROGRAM_KERNELS if k != "sha256_fold" and not fa["launches"].get(k)]
    assert not missing, f"chain_blobs fused: the path launched no {missing}"
    # every kernel of the fused program at its own inputs: the block's sets
    # and the sentinel as the program adds it, then the settle's six blobs
    # (the sidecars' own bytes) on the KZG lanes, the DA checker's setup
    hold_batch("chain_blobs", fused_sets + [canary.riding_sentinel(fused_sets)], 73)
    _, zs_b, ys_b, cs_b, ws_b = kzg_api._batch_inputs(
        [bytes(sc.blob) for sc in sidecars], [bytes(sc.kzg_commitment) for sc in sidecars],
        [bytes(sc.kzg_proof) for sc in sidecars], None)
    hold_verify_path("chain_blobs_kzg", *kzg_gpu.verify_lanes(cs_b, ws_b, kzg_api._rlc_scalars(KZG_BLOBS, 74),
                                                              zs_b, ys_b),
                     kzg_api._setup_for(KZG_FE, None).tau_g2, records.setdefault("chain_blobs_kzg", {}))
    del fused_sets
    ch["blobs"] = bl
    del fused_chain, dh, anchor_state, post33

    ch["phase_s"] = time.perf_counter() - t_phase
    records["chain_phase"] = ch
    records["chain_launches"] = chain_launches
    del chain

    # ------------------------------------------------- 7n. the node (node)
    # BeaconNode (lighthouse_tpu_torch/node.py) with the network layer
    # (network/: snappy, gossip, the RPC, the beacon processor, subnets,
    # range sync). a. node_gossip: two nodes, A and B, on one GossipHub at
    # 7k's genesis with 7m's filled cache; A publishes 7k's block and 7m's
    # signed gossip objects, B decodes and queues them, and its processor
    # drains each queue in one batch through its chain and bus; a frame
    # that is not snappy and a republished one score A. b. node_sync: a
    # late node C at 7l's genesis range-syncs from S (7m's segment node)
    # and from a peer F that forwards S's status and answers with 7m's
    # forged 4-block segment: a consistent hash chain, so its batch is
    # refused on the card, not by response checks; then S's 32 blocks
    from lighthouse_tpu_torch.network import beacon_processor as bproc
    from lighthouse_tpu_torch.network import snappy_codec
    from lighthouse_tpu_torch.network.gossip import (
        SCORE_DUPLICATE, SCORE_INVALID_MESSAGE, SCORE_VALID, topic)

    t_phase = time.perf_counter()
    nd, node_launches = {"native_snappy": snappy_codec.native_available()}, {}
    emit("node_snappy", native_available=nd["native_snappy"])
    assert nd["native_snappy"], "node: the native snappy library did not build"

    def spans_by_name():
        """Every span completed since the tracer's last reset, by name (a
        list of (duration_s, attrs) each); the tracer is reset."""
        out = {}

        def walk(d):
            out.setdefault(d["name"], []).append((d["duration_s"], d.get("attrs", {})))
            for c in d["children"]:
                walk(c)
        for d in tracing.TRACER.recent():
            walk(d)
        tracing.TRACER.reset()
        return out

    def device_batches(sp):
        """The bus's device crossings in `sp`: (lanes, indexed, per-set)."""
        return [(a.get("s_bucket"), a.get("indexed"), bool(a.get("individual")))
                for _, a in sp.get("verify/device", [])]

    def queue_totals():
        """The beacon processor's wait and handler seconds by kind (its own
        histograms)."""
        return {k: (bproc._QUEUE_WAIT_SECONDS.labels(k).total, bproc._WORK_SECONDS.labels(k).total)
                for k in ("gossip_block", "gossip_attestation", "gossip_aggregate")}

    # ---- a. node_gossip
    hub = GossipHub()
    t0 = time.perf_counter()
    node_a = BeaconNode("A", chain_genesis, bspec, hub=hub, backend="gpu", device="cuda", pubkey_cache=chain_cache)
    node_b = BeaconNode("B", chain_genesis, bspec, hub=hub, backend="gpu", device="cuda", pubkey_cache=chain_cache)
    ng = {"validators": BLOCK_V, "construct_s": time.perf_counter() - t0}
    b_submitted = []
    keep_submissions(node_b.chain, b_submitted)
    # B's timer at the skipped slot 1: the head state advanced to slot 2
    # ahead of the block (the node's pre-slot advance)
    t0 = time.perf_counter()
    node_b.on_slot(1)
    ng["tick_1_s"] = time.perf_counter() - t0

    def score(pid):
        return hub.peers[pid].score

    def drain(label, publish):
        """Publish through A, drain B's processor: walls, device calls,
        batches, launches, the spans' split and the processor's queueing."""
        del b_submitted[:]
        gpu_backend._MSG_CACHE.clear()
        c0 = dict(gpu_backend.CALL_COUNTS)
        q0 = queue_totals()
        cuda_build.reset_launches()
        tracing.TRACER.reset()
        t0 = time.perf_counter()
        publish()
        t1 = time.perf_counter()
        n = node_b.processor.process_pending()
        t2 = time.perf_counter()
        node_launches[label] = launched()
        sp = spans_by_name()
        q1 = queue_totals()
        batches = device_batches(sp)
        rec = {"publish_s": t1 - t0, "drain_s": t2 - t1, "drained_batches": n,
               "device_calls": calls_since(c0), "device_batches": batches,
               "decode_s": sum(d for d, _ in sp.get("gossip/decode", [])),
               "decoded": len(sp.get("gossip/decode", [])),
               "queue_wait_s": {k: q1[k][0] - q0[k][0] for k in q0 if q1[k][0] != q0[k][0]},
               "handler_s": {k: q1[k][1] - q0[k][1] for k in q0 if q1[k][1] != q0[k][1]},
               "hash_to_g2_s": sum(d for d, _ in sp.get("verify/hash_to_g2", [])),
               "launches": node_launches[label]}
        assert all(ix for _, ix, ind in batches if not ind), f"node {label}: a batch left the pubkey table"
        return rec

    score0 = score("A")
    ng["block"] = drain("block", lambda: node_a.publish_block(block))
    ng["block"].update(head_is_7k=node_b.chain.head_root == block_root_7k,
                       post_root_equal_7k=cached_state_root(node_b.chain.head_state) == block_post_root,
                       pre_advance_hits=node_b.chain.metrics["pre_advance_hits"],
                       score_delta=score("A") - score0,
                       same_sets_as_7k=len(b_submitted) == 1 and [set_fp(x) for x in b_submitted[0]] == block_sets_fp)
    # slot 2 begins on B's clock; its pre-slot advance (for a slot-3 block
    # this phase does not have) is left out
    node_b.clock.set_slot(hslot)
    ng["subnets"] = sorted({node_b.subscribe_for_attestation_duty(hslot, k) for k in range(BLOCK_COMMITTEES)})

    def votes(member):
        return [node_b.chain.fork_choice.votes.get(com[member]) is not None and
                node_b.chain.fork_choice.votes[com[member]].next_root == node_b.chain.head_root
                for com in committees]

    def batch_events():
        return [e["attrs"] for e in node_b.chain.journal.query(kind="attestation_batch")]

    ng["singles"] = drain("singles", lambda: [node_a.publish_attestation(a) for a in batch1])
    ng["singles"].update(votes=sum(votes(0)), same_sets_as_7m=len(b_submitted) == 1 and [
        set_fp(x) for x in b_submitted[0]] == [set_fp(x) for x in singles_sets],
        naive_pool=len(node_b.chain.naive_pool.aggregates_at_slot(hslot)))
    ng["forged"] = drain("forged", lambda: [node_a.publish_attestation(a) for a in batch2])
    forged_sets = list(b_submitted[0])
    ng["forged"].update(refused_at=[i for i, v in enumerate(votes(1)) if not v])
    ng["aggregates"] = drain("aggregates", lambda: [node_a.publish_aggregate(a) for a in aggregates])
    agg_sets = list(b_submitted[0])
    ng["aggregates"].update(op_pool=node_b.chain.op_pool.num_attestations(), sets=len(agg_sets))
    ng["attestation_batches"] = [{k: e[k] for k in ("n", "accepted", "aggregated")} for e in batch_events()]
    # a frame that is not valid snappy, then the block's frame again
    s0 = score("A")
    hub.publish("A", topic(node_a.fork_digest, "beacon_block"), b"\x0a\x01\x00")
    s1 = score("A")
    node_a.publish_block(block)
    ng["scores"] = {"valid": ng["block"]["score_delta"], "invalid_frame": s1 - s0, "duplicate": score("A") - s1,
                    "A": score("A"), "queued_after": sum(node_b.processor.queue_depths().values())}
    print(smi, flush=True)
    emit("node_gossip", **ng)
    bk_n, s1n, fgn, agn = ng["block"], ng["singles"], ng["forged"], ng["aggregates"]
    assert bk_n["head_is_7k"] and bk_n["post_root_equal_7k"] and bk_n["same_sets_as_7k"], bk_n
    assert bk_n["score_delta"] == SCORE_VALID and bk_n["decoded"] == 1, bk_n
    # one batch on the card and the bus's canary pair
    assert bk_n["device_calls"] == {"batch": 1, "individual": 1}, bk_n["device_calls"]
    assert s1n["decoded"] == BLOCK_COMMITTEES and s1n["drained_batches"] == 1 and s1n["same_sets_as_7m"], s1n
    assert s1n["votes"] == BLOCK_COMMITTEES and s1n["naive_pool"] == BLOCK_COMMITTEES, s1n
    assert s1n["device_calls"] == {"batch": 1, "individual": 1}, s1n["device_calls"]
    # the forged single alone refused: the batch, the canary pair, the per-set call
    assert fgn["drained_batches"] == 1 and fgn["refused_at"] == [GOSSIP_FORGED], fgn
    assert fgn["device_calls"] == {"batch": 1, "individual": 2}, fgn["device_calls"]
    assert agn["drained_batches"] == 1 and agn["op_pool"] == BLOCK_COMMITTEES and \
        agn["sets"] == 3 * BLOCK_COMMITTEES, agn
    assert agn["device_calls"] == {"batch": 1, "individual": 1}, agn["device_calls"]
    n_c = BLOCK_COMMITTEES
    assert ng["attestation_batches"] == [{"n": n_c, "accepted": n_c, "aggregated": False},
                                         {"n": n_c, "accepted": n_c - 1, "aggregated": False},
                                         {"n": n_c, "accepted": n_c, "aggregated": True}], ng["attestation_batches"]
    assert ng["scores"]["invalid_frame"] == SCORE_INVALID_MESSAGE and \
        ng["scores"]["duplicate"] == SCORE_DUPLICATE and ng["scores"]["queued_after"] == 0, ng["scores"]
    # one-key batches fold no key lanes (SINGLES_KERNELS, the canary pair's
    # per-set entry and its keys' Jacobian entry with them)
    for label, need in (("block", BATCH_KERNELS), ("singles", SINGLES_KERNELS), ("forged", SINGLES_KERNELS),
                        ("aggregates", BATCH_KERNELS)):
        missing = [k for k in need if not node_launches[label].get(k)]
        assert not missing, f"node_gossip {label}: the path launched no {missing}"
    # every kernel at the node's batches: the block's and the singles' sets
    # are 7m's chain_block and gossip holds' (byte-equal, asserted above);
    # the forged batch's per-set call and the aggregates' batch here
    per_set_ok = hold_per_set("node_forged_per_set", forged_sets)
    assert per_set_ok == [i != GOSSIP_FORGED for i in range(BLOCK_COMMITTEES)], per_set_ok
    hold_batch("node_aggregates", agg_sets + [canary.riding_sentinel(agg_sets)], 81)
    nd["gossip"] = ng
    del node_a, node_b, hub, b_submitted, forged_sets, agg_sets

    # ---- b. node_sync
    class ForgedPeer:
        """A peer that forwards an honest peer's Status and answers
        blocks_by_range with a forged segment: its blocks in the range."""

        def __init__(self, honest, segment):
            self.honest, self.segment, self.served = honest, segment, 0

        def status(self, caller):
            return self.honest.status(caller)

        def blocks_by_range(self, caller, req):
            self.served += 1
            lo, hi = int(req.start_slot), int(req.start_slot) + int(req.count)
            return [b for b in self.segment if lo <= int(b.message.slot) < hi]

    forged_segment = blocks[:SEGMENT_FORGED_LEN - 1] + [forged_last]
    forged_root = type(forged_last.message).hash_tree_root(forged_last.message)
    t0 = time.perf_counter()
    node_c = BeaconNode("C", genesis, bspec, hub=sync_hub, backend="gpu", device="cuda", pubkey_cache=seg_cache)
    ns = {"validators": REPLAY_V, "construct_s": time.perf_counter() - t0}
    # the light-client hook off, as on S (chain_lc measures it once)
    node_c.chain.import_hooks.remove(node_c.chain.light_client_producer.on_import)
    c_submitted = []
    keep_submissions(node_c.chain, c_submitted)
    sync_hub.join("F", lambda *a: None)  # F's score entry on the hub
    peer_f = ForgedPeer(node_s.rpc, forged_segment)
    for n in (node_s, node_c):  # the wall clock at the head's slot
        n.clock.set_slot(REPLAY_SLOTS)
    # F first: equal advertised heads keep insertion order
    node_c.sync.add_peer("F", peer_f)
    node_c.sync.add_peer("S", node_s.rpc)
    gpu_backend._MSG_CACHE.clear()
    c0 = dict(gpu_backend.CALL_COUNTS)
    cuda_build.reset_launches()
    tracing.TRACER.reset()
    t0 = time.perf_counter()
    imported = node_c.sync.run_range_sync()
    wall = time.perf_counter() - t0
    node_launches["sync"] = launched()
    sp = spans_by_name()
    c_root = cached_state_root(node_c.chain.head_state)
    events = [(e.get("peer"), e["kind"], e.get("outcome"), e.get("attrs", {}).get("n_blocks"))
              for e in node_c.chain.journal.query() if e["kind"] in ("sync_batch", "peer_quarantine")]
    # the socket transport's frame codec on the 32 served blocks, timed
    # apart (the in-process peers hand objects over)
    t1 = time.perf_counter()
    frames = [snappy_codec.frame_compress(b.to_bytes()) for b in blocks]
    t2 = time.perf_counter()
    back = [snappy_codec.frame_decompress(f) for f in frames]
    t3 = time.perf_counter()

    def by_peer(name):
        out = {}
        for d, a in sp.get(name, []):
            out[a.get("peer")] = out.get(a.get("peer"), 0.0) + d
        return out

    imports = sp.get("sync/import_segment", [])
    ns.update({
        "imported": imported, "wall_s": wall, "slots_per_s": REPLAY_SLOTS / wall,
        "head_slot": int(node_c.chain.head_state.slot), "final_root": c_root.hex(),
        "final_root_equal_7l": c_root == producer_root, "head_equal_s": node_c.chain.head_root == node_s.chain.head_root,
        "quarantined": sorted(node_c.sync.quarantined), "scores": {p: sync_hub.peers[p].score for p in ("F", "S")},
        "forged_served": peer_f.served, "forged_block_stored": node_c.chain.store.get_block(forged_root) is not None,
        "blocks_stored": sum(node_c.chain.store.get_block(type(b.message).hash_tree_root(b.message)) is not None
                             for b in blocks),
        "device_calls": calls_since(c0), "device_batches": device_batches(sp), "events": events,
        "split": {"batches_s": sum(d for d, _ in sp.get("sync/batch", [])),
                  "rpc_store_reads_s": by_peer("sync/blocks_by_range"),
                  "import_segment_s": [d for d, _ in imports],
                  "import_segment_blocks": [a.get("blocks") for _, a in imports],
                  "hash_to_g2_s": sum(d for d, _ in sp.get("verify/hash_to_g2", [])),
                  "frame_encode_s": t2 - t1, "frame_decode_s": t3 - t2,
                  "frame_bytes": sum(len(f) for f in frames), "ssz_bytes": sum(len(b.to_bytes()) for b in blocks)},
        "launches": node_launches["sync"]})
    ns["same_sets_as_7m_segment"] = len(c_submitted) == 2 and [set_fp(x) for x in c_submitted[1]] == seg_sets_fp
    print(smi, flush=True)
    emit("node_sync", **ns)
    assert back == [b.to_bytes() for b in blocks], "node_sync: a frame did not decode to its block"
    assert ns["imported"] == REPLAY_SLOTS and ns["head_slot"] == REPLAY_SLOTS and ns["final_root_equal_7l"] and \
        ns["head_equal_s"], ns
    assert ns["quarantined"] == ["F"] and ns["forged_served"] == 1 and not ns["forged_block_stored"], ns
    assert ns["scores"] == {"F": SCORE_INVALID_MESSAGE, "S": SCORE_VALID}, ns["scores"]
    assert ns["blocks_stored"] == REPLAY_SLOTS and ns["same_sets_as_7m_segment"], ns
    # F's batch refused on the card, then S's segment: each a batch and the
    # bus's canary pair
    assert ns["device_calls"] == {"batch": 2, "individual": 2}, ns["device_calls"]
    assert [ix for _, ix, ind in ns["device_batches"] if not ind] == [True, True], ns["device_batches"]
    assert ns["split"]["import_segment_blocks"] == [SEGMENT_FORGED_LEN, REPLAY_SLOTS], ns["split"]
    missing = [k for k in BATCH_KERNELS if not node_launches["sync"].get(k)]
    assert not missing, f"node_sync: the path launched no {missing}"
    # every kernel at C's batches: S's segment is 7m's chain_segment hold's
    # (byte-equal, asserted above); F's refused batch here
    f_sets = c_submitted[0]
    hold_batch("node_forged_segment", f_sets + [canary.riding_sentinel(f_sets)], 82, verdict=False)
    nd["sync"] = ns
    nd["phase_s"] = time.perf_counter() - t_phase
    records["node_phase"] = nd
    records["node_launches"] = node_launches
    del node_c, node_s, sync_hub, peer_f, c_submitted, f_sets, frames, back
    del chain_genesis, chain_cache, blocks, genesis, chain_keys, producer, seg_cache

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
        for label, launches_at in (("block", records["block_launches"]),
                                   ("segment", records["replay_launches"]["segment"])):
            if name in records[label]:  # at the block's and the replay segment's shapes
                entry[label] = pick(records[label][name]) | {"launches": launches_at.get(name, 0)}
                if label == "segment":
                    entry[label]["launches_per_block_replay"] = \
                        records["replay_launches"]["per_block"].get(name, 0)
        # the chain's launches in each arm of phase 7m, and the kernel at the
        # gossip batch's shapes
        entry["chain"] = {arm: launches_at.get(name, 0) for arm, launches_at in records["chain_launches"].items()}
        for label in ("canary_pair", "gossip", "chain_block", "chain_segment", "chain_blobs", "chain_blobs_kzg"):
            if name in records[label]:
                entry["chain"][f"{label}_shapes"] = pick(records[label][name])
        # the node's launches in each arm of phase 7n, and the kernel at the
        # shapes of its batches that 7m did not hold
        entry["node"] = {arm: launches_at.get(name, 0) for arm, launches_at in records["node_launches"].items()}
        for label in ("node_forged_per_set", "node_aggregates", "node_forged_segment"):
            if name in records[label]:
                entry["node"][f"{label}_shapes"] = pick(records[label][name])
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


def set_fp(s):
    """A SignatureSet as bytes: its signature, its keys, its message."""
    return (s.signature.to_bytes(), tuple(p.to_bytes() for p in s.pubkeys), bytes(s.message))


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
