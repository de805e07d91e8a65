#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (lighthouse_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one JSON line each; any failure raises and the script exits
non-zero without its result line:

 1. the card's name and power limit (nvidia-smi, printed as is);
 2. build every CUDA kernel from lighthouse_tpu_torch/csrc (one nvcc per
    source, in parallel), with what ptxas reports per kernel;
 3. one mainnet slot of attestations -- 64 committees x 480 single-key
    sets, every key in an on-card table of 32,768 validators -- and a flat
    batch of 1,024 sets with distinct messages and 1-4 untagged keys;
    the signature subgroup policy runs once per signature (memoized);
 4. every kernel against its plain PyTorch version, on the card, on the
    inputs the main path gives it, exact equality of canonical words;
    each kernel's median time, the plain version's time and the bound;
 5. end to end through bls.api.verify_signature_sets(device="cuda"): the
    slot (grouped, indexed) and the flat batch verify True, a forged
    signature False, 4 sets cross-checked with the ref backend; launch
    counts are read around one run of each;
 6. the kernels line, then {"ok": true, "device": {...}} as the last line.

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

N_VALIDATORS = 32_768
N_COMMITTEES = 64
COMMITTEE = 480
N_FLAT = 1_024
REPS = 5


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from lighthouse_tpu_torch import testing as T
    from lighthouse_tpu_torch.bls import api, gpu_backend
    from lighthouse_tpu_torch.bls.device_pubkey_table import DevicePubkeyTable
    from lighthouse_tpu_torch.ops import batch_verify as bv
    from lighthouse_tpu_torch.ops import cuda_build, curve_kernels, field as fd
    from lighthouse_tpu_torch.ops import final_exp, ladder, miller

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
    emit("build", seconds=time.perf_counter() - t0, nvcc=cuda_build.nvcc_version(), ptxas=ptxas)

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
        pk = bv._from_affine(bv._lanes(pk_words[0], dev), bv._lanes(pk_words[1], dev), km)
        sig = bv._from_affine(bv._lanes(m.sigs[0], dev), bv._lanes(m.sigs[1], dev), sm)
        return m, km, sm, mags, negs, pk, sig

    records = {}

    def hold(name, kernel_fn, plain_fn, inputs_bytes, reps=3):
        """Kernel vs plain on the same inputs: exact equality, times, bound."""
        out_k = kernel_fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            kernel_fn()
            e.record()
            torch.cuda.synchronize()
            times.append(s.elapsed_time(e))
        prod0 = fd.FP_PRODUCTS
        tp0 = time.perf_counter()
        out_p = plain_fn()
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - tp0) * 1e3
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
            "ms": statistics.median(times), "plain_ms": plain_ms,
            "max_abs_err": err, "fp_products": products, "bytes": nbytes,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        }
        emit("kernel_vs_plain", kernel=name, held=err == 0, **rec)
        assert err == 0, f"{name}: kernel and plain version disagree"
        return rec

    def nb(*ts):
        return sum(t.numel() * t.element_size() for t in _flatten(ts))

    for label, sets, seed in (("grouped", slot, 3), ("flat", flat, 4)):
        m, km, sm, mags, negs, pk, sig = stage_inputs(sets, seed)
        S = sm.numel()
        K = m.k_bucket
        emit("shapes", batch=label, lanes=S, keys=K, windows=int(mags.shape[0]))
        recs = records.setdefault(label, {})
        if K > 1:
            recs["lane_sum_g1_keys" if m.grouped else "lane_sum_g1"] = hold(
                "lane_sum_g1", lambda: curve_kernels.lane_sum(pk, K),
                lambda: curve_kernels.lane_sum_plain(pk, K), nb(pk))
        agg = curve_kernels.lane_sum(pk, K)
        recs["ladder_g1"] = hold(
            "ladder_g1", lambda: ladder.ladder(agg, mags, negs),
            lambda: ladder.ladder_plain(agg, mags, negs), nb(agg, mags, negs))
        pk_r = ladder.ladder(agg, mags, negs)
        if m.grouped:
            Sg = m.set_mask.shape[1]
            recs["lane_sum_g1"] = hold(
                "lane_sum_g1", lambda: curve_kernels.lane_sum(pk_r, Sg),
                lambda: curve_kernels.lane_sum_plain(pk_r, Sg), nb(pk_r))
            pk_r = curve_kernels.lane_sum(pk_r, Sg)
        recs["to_affine_g1"] = hold(
            "to_affine_g1", lambda: curve_kernels.to_affine(pk_r),
            lambda: curve_kernels.to_affine_plain(pk_r), nb(pk_r))
        pk_aff = curve_kernels.to_affine(pk_r)
        recs["ladder_g2"] = hold(
            "ladder_g2", lambda: ladder.ladder(sig, mags, negs),
            lambda: ladder.ladder_plain(sig, mags, negs), nb(sig, mags, negs))
        sig_r = ladder.ladder(sig, mags, negs)
        recs["lane_sum_g2"] = hold(
            "lane_sum_g2", lambda: curve_kernels.lane_sum(sig_r, S),
            lambda: curve_kernels.lane_sum_plain(sig_r, S), nb(sig_r))
        sig_acc = curve_kernels.lane_sum(sig_r, S)
        recs["to_affine_g2"] = hold(
            "to_affine_g2", lambda: curve_kernels.to_affine(sig_acc),
            lambda: curve_kernels.to_affine_plain(sig_acc), nb(sig_acc))
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

    # --------------------------------------------------- 5. end to end
    def e2e(label, sets, seed):
        cuda_build.reset_launches()
        t0 = time.perf_counter()
        ok = api.verify_signature_sets(sets, seed=seed, device="cuda")
        first_s = time.perf_counter() - t0
        launches = dict(cuda_build.LAUNCHES)
        assert ok is True, f"{label}: valid batch rejected"
        walls = []
        for r in range(REPS):
            t0 = time.perf_counter()
            assert api.verify_signature_sets(sets, seed=seed + 1 + r, device="cuda")
            walls.append(time.perf_counter() - t0)
        stats = dict(gpu_backend.LAST_HOST_STATS)
        forged = T.forge(sets, len(sets) // 2)
        assert forged[len(sets) // 2].signature.in_subgroup()
        bad = api.verify_signature_sets(forged, seed=seed, device="cuda")
        assert bad is False, f"{label}: forged batch accepted"
        ref_ok = api.verify_signature_sets(sets[:4], backend="ref")
        ref_bad = api.verify_signature_sets(forged[len(sets) // 2 : len(sets) // 2 + 4], backend="ref")
        gpu_small = api.verify_signature_sets(sets[:4], seed=seed, device="cuda")
        assert ref_ok and gpu_small and not ref_bad, f"{label}: ref cross-check failed"
        p50 = statistics.median(walls)
        emit("end_to_end", batch=label, sets=len(sets), verdict=ok, forged_verdict=bad,
             ref_cross_check=True, first_call_s=first_s, p50_s=p50,
             sets_per_s=len(sets) / p50, walls_s=walls, host_stats=stats,
             launches=launches)
        missing = [k for k, v in launches.items() if v == 0]
        assert not missing, f"{label}: the path launched no {missing}"
        return launches

    slot_launches = e2e("grouped", slot, 10)
    flat_launches = e2e("flat", flat, 20)

    # --------------------------------------------------- 6. kernels line
    csrc = "lighthouse_tpu_torch/csrc/"
    helper = "a step that is XLA on the TPU, outside any Pallas kernel"
    meta = {  # name -> (source, what it replaces, note)
        "ladder_g1": (csrc + "ladder.cu", "lighthouse_tpu/ops/pallas_ladder.py:101", None),
        "ladder_g2": (csrc + "ladder.cu", "lighthouse_tpu/ops/pallas_ladder.py:101", None),
        "miller": (csrc + "miller.cu", "lighthouse_tpu/ops/pallas_miller.py:32", None),
        "fold_final_exp": (csrc + "final_exp.cu", "lighthouse_tpu/ops/pallas_tail.py:58", None),
        "lane_sum_g1": (csrc + "curve_helpers.cu", "lighthouse_tpu/ops/curve.py:116", helper),
        "lane_sum_g2": (csrc + "curve_helpers.cu", "lighthouse_tpu/ops/tcurve.py:201", helper),
        "to_affine_g1": (csrc + "curve_helpers.cu", "lighthouse_tpu/ops/curve.py:630", helper),
        "to_affine_g2": (csrc + "curve_helpers.cu", "lighthouse_tpu/ops/curve.py:630", helper),
    }
    kernels = []
    for name, (source, replaces, note) in meta.items():
        rec = records["grouped"][name]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": slot_launches[name], "max_abs_err": rec["max_abs_err"],
            "ms": rec["ms"], "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": None, "held": True, "note": note,
            "flat": {k: records["flat"][name][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")}
            | {"launches": flat_launches[name]},
        })
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
