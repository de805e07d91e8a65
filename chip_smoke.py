#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (lighthouse_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one JSON line each; any failure raises and the script exits
non-zero without its result line:

 1. the card's name and power limit (nvidia-smi, printed as is);
 2. build every CUDA kernel from lighthouse_tpu_torch/csrc (one nvcc per
    source, in parallel), with what ptxas reports per kernel (K1's window
    body and the helpers on lines of their own: registers, stack frame,
    spills, shared memory) and the dynamic shared memory of the lane-group
    kernels K2 and K3;
 2b. the register-resident Fp product of K1's window body, K2 and K3 alone
    (ops/fp_product.py): one thread's dependent chain (latency) and every
    SM full of chains (product rate), both exact against Python integers;
    with K3's fold chain profile, its floor = dependent product steps x
    that latency;
 3. one mainnet slot of attestations -- 64 committees x 480 single-key
    sets, every key in an on-card table of 32,768 validators -- and a flat
    batch of 1,024 sets with distinct messages and 1-4 untagged keys;
    the signature subgroup policy runs once per signature (memoized);
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
 5. end to end through bls.api.verify_signature_sets(device="cuda"): the
    slot (grouped, indexed) and the flat batch verify True, a forged
    signature False, 4 sets cross-checked with the ref backend; launch
    counts are read around one run of each, with the host/device split
    (median of the timed runs); the slot once more with its signatures
    normalised to Z = 1 outside the timed region, as decompressed gossip
    carries them, and the decompression of 512 signatures timed alone;
 6. K1's chain and 2-bit window bodies against their plain versions on
    the slot's ladder inputs, and the flat batch end to end with
    ladder="chain" and ladder="w2" (valid True, forged False);
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
    from lighthouse_tpu_torch.ops import mma_probe
    from lighthouse_tpu_torch.ops import window_ladder
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
    k1_ptxas = {
        name: dict(rec, **ptxas["ladder"]["functions"].get(name, {}))
        for name, rec in ptxas["ladder"]["kernels"].items() if "window_kernel" in name
    }
    emit("k1_ptxas", kernels=k1_ptxas)
    assert len(k1_ptxas) == 2, "K1's window body: expected a G1 and a G2 kernel"
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
    assert all(api.signature_ok(s.signature) for s in slot)
    t3 = time.perf_counter()
    assert all(api.signature_ok(s.signature) for s in flat)
    t4 = time.perf_counter()
    emit("data", slot_sets=len(slot), flat_sets=len(flat), validators=table.count,
         slot_build_s=t1 - t0, flat_build_s=t2 - t1,
         slot_subgroup_s=t3 - t2, flat_subgroup_s=t4 - t3,
         slot_subgroup_us_per_sig=(t3 - t2) / len(slot) * 1e6)

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

    # ------------------------------ 6. K1's chain and 2-bit window forms
    group_cost = {}
    for w in (1, 2):  # Fp products of one complete addition / doubling
        one = curve.group(w).identity(1, dev)
        p0 = fd.FP_PRODUCTS
        curve.group(w).add(one, one)
        p1 = fd.FP_PRODUCTS
        curve.group(w).double(one)
        group_cost[w] = {"add": p1 - p0, "dbl": fd.FP_PRODUCTS - p1}
    inp = ladder_inputs["grouped"]
    bits_t = torch.as_tensor(inp["bits"], device=dev).t().contiguous()  # (64, lanes)
    n_bits, lanes = bits_t.shape
    set_bits = int(bits_t.sum())
    for form in ("chain", "w2"):
        for w in (1, 2):
            name = f"ladder_g{w}_{form}"
            pt = inp[w]
            # the chain adds only on set bits: count what these bits need
            chain_products = (set_bits * group_cost[w]["add"]
                              + lanes * (n_bits - 1) * group_cost[w]["dbl"])
            records["grouped"][name] = hold(
                name, lambda: ladder.ladder(pt, bits_t, form=form),
                lambda: ladder.ladder_plain(pt, bits_t, form=form), nb(pt, bits_t),
                products=chain_products if form == "chain" else None)
    emit("ladder_forms", lanes=lanes, n_bits=n_bits, set_bits=set_bits, group_cost=group_cost)

    form_launches = {}
    for form in ("chain", "w2"):
        cuda_build.reset_launches()
        t0 = time.perf_counter()
        ok = api.verify_signature_sets(flat, seed=40, device="cuda", ladder=form)
        wall = time.perf_counter() - t0
        form_launches[form] = dict(cuda_build.LAUNCHES)
        forged = T.forge(flat, len(flat) // 2)
        bad = api.verify_signature_sets(forged, seed=40, device="cuda", ladder=form)
        emit("end_to_end_ladder_form", batch="flat", form=form, sets=len(flat), verdict=ok,
             forged_verdict=bad, wall_s=wall, launches=form_launches[form])
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
    forms_note = "slot ladder inputs; launches from the flat batch with ladder={}"
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
        elif name == "pair_final_exp":
            rec, launches = records["per_set"][name], per_set_launches[name]
            entry["slice"] = records["per_set"]["pair_final_exp_slice"]
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
