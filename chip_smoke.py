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
    plain version's time and the bound (K1's window body: the products of
    the rows its lanes run, ops/ladder_rows.py `lane_products`); then K1's window body on
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
 8. the tensor-core probe (lighthouse_tpu_torch.ops.mma_probe), int8 and
    bf16, exact against the probe's numpy check and the plain version,
    kernel and library call timed the same way (and each once more in one
    synchronised call, cuda_build.call_ms, which shows the host's share of
    a few-microsecond call); its launches are those of one `contract` call;
 9. the kernels line, then {"ok": true, "device": {...}} as the last line.

The kernel records also go to chiprun_out/chip_smoke_records.json.

Without a CUDA device the script exits 2 and prints no result.
"""

import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "chiprun_out")

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
# 32-bit integer multiply-adds per second: 132 SMs x 64 INT32 lanes x 1.98 GHz
INT_OPS_PER_S = 132 * 64 * 1.98e9
# one 12-word CIOS product: 2 x 144 32x32->64 multiply-adds, lo and hi halves
IMAD_PER_FP_PRODUCT = 2 * 144 * 2

# the kernels of verify_signature_sets with the default window ladder; the
# flat batch's untagged keys also take the G1 Jacobian entry
BATCH_KERNELS = ("ladder_g1", "ladder_g2", "miller", "fold_final_exp",
                 "lane_sum_g1", "lane_sum_g2", "to_affine_g1", "to_affine_g2",
                 "jacobian_to_affine_g2")
POINT_PATH_KERNELS = ("jacobian_to_affine_g1",)

# a point of order 13 on the twist E'(Fp2), affine (x0, x1, y0, y1): [h2 r / 169]
# of an SSWU point (tests/test_torch_subgroup.py)
ORDER13 = (
    2836965131823123410263967203666700228366617764832011880822917003009180422710328672880982742971667089130324726186765,
    1493440553737758395317049093622249216134088697031662027075306454103180847581429911027814653483157864376196648859787,
    1883875369676256757931724051005444337857183088130947247092686437224487482716351955195424734420382938063040663037738,
    3553509992304783018100897154919395512649485085278091884435216652014597959035275330737888638199572964083532338401018,
)

N_VALIDATORS = 32_768
N_COMMITTEES = 64
COMMITTEE = 480
N_FLAT = 1_024
REPS = 5


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


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
    from lighthouse_tpu_torch.ops import window_ladder
    from lighthouse_tpu_torch.bls.hash_to_curve import hash_to_field_fp2, iso_map, map_to_curve_sswu
    from lighthouse_tpu_torch.common import device_attribution
    from lighthouse_tpu_torch.crypto.ref_curve import G1 as RG1
    from lighthouse_tpu_torch.crypto.ref_curve import G2 as RG2

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

    def hold(name, kernel_fn, plain_fn, inputs_bytes, reps=3, products=None, bound=None):
        """Kernel vs plain on the same inputs: exact equality, times, bound.
        `products` replaces the plain version's Fp product count where the
        kernel's work depends on the data; `bound` = (ms, by) replaces the
        Fp product bound for a kernel that is not field arithmetic."""
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
        emit("kernel_vs_plain", kernel=name, held=err == 0, **rec)
        assert err == 0, f"{name}: kernel and plain version disagree"
        return rec

    def nb(*ts):
        return sum(t.numel() * t.element_size() for t in _flatten(ts))

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
        # the window body's products: those of the rows its lanes run (a G2
        # row is an Fp2 product of 2.5 products' multiply-adds), not the
        # plain version's
        k1_products = {w: pt[0].shape[-1] * ladder_rows.lane_products(w, int(mags.shape[0]))
                       for w, pt in ((1, agg), (2, sig))}
        recs["ladder_g1"] = hold(
            "ladder_g1", lambda: ladder.ladder(agg, mags, negs),
            lambda: ladder.ladder_plain(agg, mags, negs), nb(agg, mags, negs),
            products=k1_products[1])
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
            products=k1_products[2])
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
        jac = tuple(bv._lanes(gpu_backend._to_device(c, dev), dev)
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
    }
    kernels = []
    for name, (source, replaces, note) in meta.items():
        entry = {"name": name, "route": "cuda", "source": source, "replaces": replaces}
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
        else:
            rec, launches = records["probe"][name], probe_launches[name]
        entry.update({
            "launches": launches, "max_abs_err": rec["max_abs_err"],
            "ms": rec["ms"], "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec.get("library_ms"), "held": True,
            "note": note,
        })
        if name == "miller":
            entry["per_set"] = records["per_set"]["miller"] | {"launches": per_set_launches[name]}
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
