"""The port's data-availability plane (`lighthouse_tpu_torch/da`,
`ops/rs_extend.py`) against the reference's (`lighthouse_tpu/da`,
`lighthouse_tpu/ops/rs_extend.py`), on the CPU, at one small geometry (8
elements a blob, cells of 4: 16 domain points, 4 cells):

* the extension: the port's `rs_extend_graph` (the plain version of the
  Horner kernel) equals the reference's jitted JAX graph (compiled once,
  at 4 blob lanes) and the host oracle on 1, 3 (padded to the bucket of
  4) and 4 blobs, a zero blob among them that evaluates to zero
  everywhere; `extend_blobs` on "gpu" (device="cpu"), on "ref" and the
  reference's "ref" give the same evaluations;
* the cells: `cells_from_evals`, `cell_to_ints`, `_divide_by_vanishing`,
  reconstruction from every exactly-50% subset of cells (byte-equal),
  and `DaError` below 50%, on a wrong cell or blob length and on a
  non-canonical element, as the reference;
* the proofs: "ref" byte-equal to the reference's "ref"; one blob's
  proofs through "gpu" on the plain fixed-base MSM equal to them (at
  n = 2m every cell's quotient is the blob's top half, so the test runs
  the plain MSM once and checks that the other cells ask for the same
  scalars);
* the verify: "gpu" (the plain KZG device path) True on an honest batch
  and False on a flipped cell byte, as the reference's "ref"; the port's
  "ref" and "fake" as the reference's on a wrong index, a swapped proof,
  an empty batch and a malformed item;
* custody and the spec's geometry as the reference's, mainnet and minimal;
* the guard: injected stalls and errors on the `rs_extend` and `da_cells`
  planes raise before any device work, no fallback, and a quarantined
  plane runs nothing; a flip leaves an extension's data as it is and
  flips a verify's verdict;
* the bus's `submit_cells` on "fake" and "ref", against the reference's
  bus: coalescing, a bad submission failing alone, the `cell_batch`
  events, and cells never in a batch with signature sets.

Plain device work here: two verifies and one fixed-base MSM (each some
2 s on one core) and the Horner chains of the small geometry.
"""

import functools
import itertools
import threading
import time

import numpy as np
import pytest
import torch

import lighthouse_tpu.bls as rbls
from lighthouse_tpu.common.events_journal import Journal as RJournal
from lighthouse_tpu.da import cells as rcells
from lighthouse_tpu.da import custody as rcustody
from lighthouse_tpu.da import erasure as rerasure
from lighthouse_tpu.da.domain import geometry as rgeometry
from lighthouse_tpu.da.domain import geometry_for_spec as rgeometry_for_spec
from lighthouse_tpu.device_plane import GUARD as RGUARD
from lighthouse_tpu.device_plane import INJECTOR as RINJECTOR
from lighthouse_tpu.ops import rfield as jrf
from lighthouse_tpu.ops import rs_extend as jrs
from lighthouse_tpu.types.spec import mainnet_spec, minimal_spec
from lighthouse_tpu.verification_bus import bus as rbus
import lighthouse_tpu_torch.bls as pbls
from lighthouse_tpu_torch.common.events_journal import Journal as PJournal
from lighthouse_tpu_torch.crypto.constants import R
from lighthouse_tpu_torch.da import cells, custody, erasure, gpu_backend
from lighthouse_tpu_torch.da.domain import DaError, geometry, geometry_for_spec
from lighthouse_tpu_torch.device_plane import GUARD, INJECTOR
from lighthouse_tpu_torch.device_plane import executor as pexec
from lighthouse_tpu_torch.kzg import gpu_backend as kzg_gpu
from lighthouse_tpu_torch.ops import cuda_build, kzg_verify, rs_extend
from lighthouse_tpu_torch.ops import rfield as rf
from lighthouse_tpu_torch.verification_bus import bus as pbus

torch.set_num_threads(1)

N, M = 8, 4
GEO = geometry(N, M)
RGEO = rgeometry(N, M)


@pytest.fixture(autouse=True)
def clean_guard():
    for g, i in ((GUARD, INJECTOR), (RGUARD, RINJECTOR)):
        g.reset()
        i.reset()
    yield
    for g, i in ((GUARD, INJECTOR), (RGUARD, RINJECTOR)):
        g.reset()
        i.reset()


def _blob(seed: int) -> bytes:
    rng = np.random.default_rng(seed)
    return b"".join(
        (int.from_bytes(rng.bytes(32), "big") % R).to_bytes(32, "big") for _ in range(N)
    )


ZERO = b"\x00" * GEO.blob_bytes
BLOBS = [_blob(s) for s in (1, 2, 3)]


def _flip(b: bytes, at: int = 0) -> bytes:
    return b[:at] + bytes([b[at] ^ 1]) + b[at + 1:]


@functools.cache
def _proofs(i: int):
    """Blob i's commitment, cells and proofs, all on the reference's
    "ref" backend."""
    blob = BLOBS[i]
    comm = rbls_kzg().blob_to_kzg_commitment(blob, backend="ref")
    cs, ps = rcells.compute_cells_and_kzg_proofs(blob, RGEO, backend="ref")
    return comm, cs, ps


def rbls_kzg():
    from lighthouse_tpu import kzg as rkzg

    return rkzg


def _items(i: int, ks=None):
    comm, cs, ps = _proofs(i)
    return [(comm, k, cs[k], ps[k]) for k in (range(GEO.num_cells) if ks is None else ks)]


# ------------------------------------------------------------ extension


@functools.cache
def _jax_graph():
    import jax

    return jax.jit(jrs.rs_extend_graph)


@pytest.mark.parametrize("n_blobs", [1, 3, 4])
def test_rs_extend_graph_matches_the_reference(n_blobs):
    """4 lanes (the bucket of 3; the JAX graph compiled once), the zero
    blob in lane 0 and zero polynomials in the padding."""
    polys = [erasure.blob_to_ints(b, GEO) for b in [ZERO] + BLOBS[: n_blobs - 1]]
    padded = polys + [[0] * N] * (4 - n_blobs)
    flat = [c for i in range(N) for poly in padded for c in [poly[i]]]
    jc = jrf.to_mont(jrf.pack_ints(flat).reshape(N, 4, jrf.NB))
    jp = jrf.to_mont(jrf.pack_ints(GEO.ext_points))
    want = jrf.unpack_ints(np.asarray(_jax_graph()(jc, jp)))
    pc = torch.from_numpy(rf.mont_words(flat).reshape(N, 4, rf.NW))
    pp = torch.from_numpy(rf.mont_words(GEO.ext_points))
    got = rf.unpack_ints(rs_extend.rs_extend_graph(pc, pp).numpy())
    assert got == want
    oracle = erasure._extend_ref(padded, GEO)
    assert got == [oracle[b][p] for p in range(2 * N) for b in range(4)]
    assert oracle[0] == [0] * (2 * N)


@pytest.mark.parametrize("n_blobs", [1, 3, 4])
def test_extend_blobs_backends_agree(n_blobs):
    blobs = [ZERO] + BLOBS[: n_blobs - 1]
    gpu = erasure.extend_blobs(blobs, GEO, backend="gpu", device="cpu")
    assert gpu == erasure.extend_blobs(blobs, GEO, backend="ref")
    assert gpu == erasure.extend_blobs(blobs, GEO, backend="fake")
    assert gpu == rerasure.extend_blobs(blobs, RGEO, backend="ref")
    assert gpu[0] == [0] * (2 * N)
    # the kernel runs the live blobs alone; the bucket is the metric's label
    assert gpu_backend.LAST_EXTEND_STATS["lanes"] == n_blobs
    assert gpu_backend.LAST_EXTEND_STATS["bucket"] == max(2, 1 << (n_blobs - 1).bit_length())
    assert erasure.extend_blobs([], GEO, backend="gpu", device="cpu") == []


def test_extension_packs_plain_coefficients_and_montgomery_points():
    polys = [erasure.blob_to_ints(b, GEO) for b in BLOBS]
    packed = gpu_backend.pack_coefficients(polys, N, 4)
    assert rf.words_to_ints(packed[:, 1]) == polys[1]
    assert not packed[:, 3].any()
    pts = gpu_backend.domain_points(GEO, torch.device("cpu"))
    assert rf.words_from_mont(pts.numpy()) == GEO.ext_points


# ---------------------------------------------------------------- cells


def test_cell_helpers_match_the_reference():
    evals = rerasure.extend_blobs([BLOBS[0]], RGEO)[0]
    cs = cells.cells_from_evals(evals, GEO)
    assert cs == rcells.cells_from_evals(evals, RGEO)
    poly = erasure.blob_to_ints(BLOBS[0], GEO)
    for k in range(GEO.num_cells):
        assert cells.cell_to_ints(cs[k], GEO) == rcells.cell_to_ints(cs[k], RGEO)
        c_k = GEO.vanishing_const(k)
        assert cells._divide_by_vanishing(poly, M, c_k) == rcells._divide_by_vanishing(poly, M, c_k)
    assert cells.compute_cells(BLOBS[0], GEO, device="cpu") == cs
    with pytest.raises(DaError):
        cells.cells_from_evals(evals[:-1], GEO)


def test_reconstruction_at_the_50_percent_boundary():
    cs = cells.compute_cells(BLOBS[1], GEO, backend="ref")
    half = GEO.num_cells // 2
    for subset in itertools.combinations(range(GEO.num_cells), half):
        got = erasure.reconstruct_blob({k: cs[k] for k in subset}, GEO)
        assert got == BLOBS[1] == rerasure.reconstruct_blob({k: cs[k] for k in subset}, RGEO)
    for subset in itertools.combinations(range(GEO.num_cells), half - 1):
        with pytest.raises(DaError):
            erasure.reconstruct_blob({k: cs[k] for k in subset}, GEO)
    with pytest.raises(DaError):
        erasure.reconstruct_blob({0: cs[0][:-1], 1: cs[1]}, GEO)


@pytest.mark.parametrize("case", ["short_blob", "non_canonical_blob", "short_cell",
                                  "non_canonical_cell"])
def test_malformed_data_raises_like_the_reference(case):
    bad = (R + 1).to_bytes(32, "big")
    for mod_cells, mod_erasure, geo in ((cells, erasure, GEO), (rcells, rerasure, RGEO)):
        with pytest.raises(Exception) as info:
            if case == "short_blob":
                mod_erasure.blob_to_ints(BLOBS[0][:-32], geo)
            elif case == "non_canonical_blob":
                mod_erasure.blob_to_ints(bad + BLOBS[0][32:], geo)
            elif case == "short_cell":
                mod_cells.cell_to_ints(bytes(geo.cell_bytes - 1), geo)
            else:
                mod_cells.cell_to_ints(bad + bytes(geo.cell_bytes - 32), geo)
        assert type(info.value).__name__ == "DaError", info.value


# --------------------------------------------------------------- proofs


def test_cell_proofs_ref_match_the_reference():
    for i in (0, 1):
        cs, ps = cells.compute_cells_and_kzg_proofs(BLOBS[i], GEO, backend="ref")
        _, rcs, rps = _proofs(i)
        assert (cs, ps) == (rcs, rps)
    fcs, fps = cells.compute_cells_and_kzg_proofs(BLOBS[0], GEO, backend="fake")
    assert (fcs, fps) == rcells.compute_cells_and_kzg_proofs(BLOBS[0], RGEO, backend="fake")


def test_cell_proofs_gpu_on_the_plain_msm(monkeypatch):
    real = kzg_gpu.g1_msm_fixed_base_gpu
    calls = []

    def once(scalars, setup, consumer=None, device="cuda"):
        # n = 2m: every cell's quotient is the blob's top half
        if calls:
            assert list(scalars) == calls[0][0]
            calls.append((list(scalars), None))
            return calls[0][1]
        calls.append((list(scalars), real(scalars, setup, consumer=consumer, device=device)))
        return calls[0][1]

    monkeypatch.setattr(kzg_gpu, "g1_msm_fixed_base_gpu", once)
    got = cells.compute_cells_and_kzg_proofs(BLOBS[0], GEO, backend="gpu", device="cpu")
    _, rcs, rps = _proofs(0)
    assert got == (rcs, rps)
    assert len(calls) == GEO.num_cells and calls[0][0] == erasure.blob_to_ints(BLOBS[0], GEO)[M:]
    assert set(cells.LAST_PROOF_STATS) == {"cells", "extend_ms", "divide_ms", "msm_ms"}


# --------------------------------------------------------------- verify


def test_cell_verify_gpu_on_the_plain_versions():
    """Two cells of two blobs (b = 4, 16 lanes): honest True, one cell
    byte flipped False, as the reference's "ref"."""
    items = _items(0, [3]) + _items(1, [2])
    comm, k, cell, proof = items[1]
    bad = items[:1] + [(comm, k, _flip(cell, 40), proof)]
    for batch, want in ((items, True), (bad, False)):
        got = cells.verify_cell_proof_batch(batch, GEO, backend="gpu", seed=5, device="cpu")
        assert got is want is rcells.verify_cell_proof_batch(batch, RGEO, backend="ref", seed=5)
    st = gpu_backend.LAST_CELL_STATS
    assert st["n_cells"] == 2 and st["lanes"] == 16


def test_cell_verify_lanes_fold_to_the_reference_identity():
    """The lane layout folds, on the host, to the reference's two G1 pair
    points."""
    from lighthouse_tpu_torch.crypto.ref_curve import G1
    from lighthouse_tpu_torch.kzg import api

    items = _items(0, [0, 3])
    rs, cs, ws, rzs, acc = cells._fold_inputs(items, GEO, seed=9)
    setup = api._setup_for(N, None)
    interp = api._g1_lincomb(setup.g1_powers[:M], acc)
    affs, scalars = gpu_backend.cell_verify_lanes(rs, cs, ws, rzs, interp)
    b = len(affs) // 4
    assert b == 4 and scalars[2] == R - 1 and not any(scalars[3 * b:])

    def fold(lo, hi):
        acc_pt = G1.infinity
        for a, s in zip(affs[lo:hi], scalars[lo:hi]):
            if a is not None:
                acc_pt = G1.add(acc_pt, G1.mul_scalar(G1.from_affine(a), s))
        return G1.to_affine(acc_pt)

    lhs, w_sum = G1.infinity, G1.infinity
    for r, rz, c, w in zip(rs, rzs, cs, ws):
        lhs = G1.add(G1.add(lhs, G1.mul_scalar(c, r)), G1.mul_scalar(w, rz))
        w_sum = G1.add(w_sum, G1.mul_scalar(w, r))
    assert fold(0, 2 * b) == G1.to_affine(G1.add(lhs, G1.neg(interp)))
    assert fold(2 * b, 4 * b) == G1.to_affine(G1.neg(w_sum))


@pytest.mark.parametrize("case", ["honest", "wrong_index", "swapped_proof", "empty", "malformed"])
@pytest.mark.parametrize("backend", ["ref", "fake"])
def test_cell_verify_host_backends_match_the_reference(backend, case):
    items = _items(0, [0, 1])
    if case == "wrong_index":
        comm, k, cell, proof = items[0]
        items = [(comm, 2, cell, proof)] + items[1:]
    elif case == "swapped_proof":
        # across blobs: at n = 2m the cells of one blob share one proof
        a, b = items[0], _items(1, [0])[0]
        items = [a[:3] + (b[3],), b[:3] + (a[3],)]
    elif case == "empty":
        items = []
    elif case == "malformed":
        items = [items[0][:3]]
    out = {}
    for side, mod, geo in (("port", cells, GEO), ("ref", rcells, RGEO)):
        try:
            out[side] = mod.verify_cell_proof_batch(items, geo, backend=backend, seed=4)
        except Exception as exc:
            out[side] = type(exc).__name__
    assert out["port"] == out["ref"]
    want = {"honest": True, "empty": True, "malformed": "DaError"}.get(
        case, backend == "fake")
    assert out["port"] == want


# -------------------------------------------------------------- custody


@pytest.mark.parametrize("make_spec", [mainnet_spec, minimal_spec], ids=["mainnet", "minimal"])
def test_custody_matches_the_reference(make_spec):
    spec = make_spec()
    for node in ("node-0", "node7", "validator-client-3", 12345):
        assert custody.custody_subnets(node, spec) == rcustody.custody_subnets(node, spec)
        assert custody.custody_columns(node, spec) == rcustody.custody_columns(node, spec)
    assert [custody.compute_subnet_for_column(i, spec) for i in range(spec.NUMBER_OF_COLUMNS)] \
        == [rcustody.compute_subnet_for_column(i, spec) for i in range(spec.NUMBER_OF_COLUMNS)]
    geo, rgeo = geometry_for_spec(spec), rgeometry_for_spec(spec)
    assert (geo.num_cells, geo.cell_elements, geo.w2n) == (rgeo.num_cells, rgeo.cell_elements, rgeo.w2n)


# ---------------------------------------------------------------- guard


def _record_device_work(monkeypatch):
    ran = []
    monkeypatch.setattr(rs_extend, "eval_poly_batch_plain", lambda *a, **k: ran.append("rs"))
    monkeypatch.setattr(kzg_verify, "verify_kzg_proof_batch", lambda *a, **k: ran.append("kzg"))
    return ran


def _call(plane, items):
    if plane == "rs_extend":
        return erasure.extend_blobs(BLOBS[:3], GEO, backend="gpu", device="cpu")
    return cells.verify_cell_proof_batch(items, GEO, backend="gpu", seed=3, device="cpu")


@pytest.mark.parametrize("kind", ["stall", "error"])
@pytest.mark.parametrize("plane", ["rs_extend", "da_cells"])
def test_faults_raise_before_device_work_and_quarantine_holds(monkeypatch, plane, kind):
    items = _items(0, [1])
    ran = _record_device_work(monkeypatch)
    launches = dict(cuda_build.LAUNCHES)
    GUARD.configure(threshold=1, cooldown_s=3600.0)
    INJECTOR.arm(kind, plane, rate=1.0, seed=0)
    cls = {"stall": pexec.DeviceStallInjected, "error": pexec.DeviceErrorInjected}[kind]
    with pytest.raises(cls):
        _call(plane, items)
    INJECTOR.reset()
    with pytest.raises(pexec.DeviceFaultError, match="breaker open"):
        _call(plane, items)
    assert ran == [] and cuda_build.LAUNCHES == launches
    assert GUARD.stats()["faults"] == {f"{plane}:{kind}": 1}


def test_flip_leaves_the_extension_and_flips_the_verify(monkeypatch):
    INJECTOR.arm("flip", "rs_extend", rate=1.0, seed=0)
    assert erasure.extend_blobs(BLOBS[:3], GEO, backend="gpu", device="cpu") \
        == erasure.extend_blobs(BLOBS[:3], GEO, backend="ref")
    INJECTOR.reset()
    INJECTOR.arm("flip", "da_cells", rate=1.0, seed=0)
    monkeypatch.setattr(kzg_verify, "verify_kzg_proof_batch", lambda *a, **k: torch.tensor(True))
    assert cells.verify_cell_proof_batch(_items(0, [1]), GEO, backend="gpu", device="cpu") is False


def test_cuda_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: this checks the behaviour without one")
    for call in (lambda: erasure.extend_blobs(BLOBS[:1], GEO, device="cuda"),
                 lambda: cells.verify_cell_proof_batch(_items(0, [0]), GEO, device="cuda")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert GUARD.stats()["faults"] == {}


# ------------------------------------------------------------------ bus


SIDES = {"port": (pbus, PJournal, pbls, GEO), "ref": (rbus, RJournal, rbls, RGEO)}


def _wait_pending(bus, n):
    deadline = time.monotonic() + 10.0
    while bus.stats()["pending"] < n:
        assert time.monotonic() < deadline, "submissions never queued"
        time.sleep(0.001)


def _bus_scenario(side, name):
    busmod, Journal, bls, geo = SIDES[side]
    j = Journal()
    res = {}

    def cells_sub(key, items):
        res[key] = bus.submit_cells(items, geo, journal=j, slot=5)

    good = _items(0, [0, 1])
    comm, k, cell, proof = good[0]
    bad = [(comm, k, _flip(cell, 33), proof)]
    if name == "coalesce":
        bus = busmod.VerificationBus(backend="fake", journal=j, max_hold_ms=5000.0, fill_target=4)
        bus.bulk_flush_live = 1000
        held = [("a", good[:1]), ("b", good)]
        last = ("c", _items(1, [3]))
    elif name == "mixed_failure":
        bus = busmod.VerificationBus(backend="ref", journal=j, max_hold_ms=5000.0, fill_target=3)
        held = [("bad", bad)]
        last = ("good", good)
    elif name == "with_signatures":
        bus = busmod.VerificationBus(backend="fake", journal=j, max_hold_ms=5000.0, fill_target=3)
        kp = bls.interop_keypairs(1)[0]
        sset = bls.SignatureSet(kp.sk.sign(b"da"), [kp.pk], b"da")
        threads = [threading.Thread(target=lambda: res.__setitem__(
            "sig", bus.submit([sset], consumer="gossip_single", journal=j, slot=5)))]
        held = [("a", good[:1])]
        last = ("b", good[1:] + _items(1, [0]))
    else:
        raise ValueError(name)
    threads = [] if name != "with_signatures" else threads
    threads += [threading.Thread(target=cells_sub, args=h) for h in held]
    for t in threads:
        t.start()
        _wait_pending(bus, threads.index(t) + 1)
    cells_sub(*last)
    for t in threads:
        t.join(timeout=30)
    events = [(e["kind"], e["outcome"], {a: v for a, v in e["attrs"].items()
                                         if a not in ("wait_s", "wall_s", "amortized_fixed_ms")})
              for e in j.query() if e["kind"] in ("cell_batch", "signature_batch")]
    st = bus.stats()
    return res, events, {k: st[k] for k in ("batches_formed", "coalesced_batches",
                                            "fallback_batches", "triggers", "live_dispatched")}


@pytest.mark.parametrize("name", ["coalesce", "mixed_failure", "with_signatures"])
def test_submit_cells_matches_the_reference_bus(name):
    port = _bus_scenario("port", name)
    assert port == _bus_scenario("ref", name)
    res, events, st = port
    kinds = {e[0] for e in events}
    if name == "coalesce":
        assert res == {"a": True, "b": True, "c": True}
        assert st["batches_formed"] == 1 and st["triggers"] == {"fill": 1}
        assert [e[2]["n_submissions"] for e in events] == [3, 3, 3] and kinds == {"cell_batch"}
    elif name == "mixed_failure":
        assert res == {"bad": False, "good": True} and st["fallback_batches"] == 2
        assert [e[1] for e in events] == ["failed", "failed", "failed", "ok"]
    else:
        assert res == {"sig": True, "a": True, "b": True}
        assert st["batches_formed"] == 2 and kinds == {"cell_batch", "signature_batch"}
        batch_of = {}
        for kind, _, attrs in events:
            batch_of.setdefault(kind, set()).add(attrs["bus_batch"])
        assert not batch_of["cell_batch"] & batch_of["signature_batch"]


def test_empty_cell_submission_is_vacuous():
    bus = pbus.VerificationBus(backend="fake")
    assert bus.submit_cells([], GEO) is True
    assert bus.stats()["submitted"] == 0
    with pytest.raises(ValueError):
        bus.submit_cells([], GEO, consumer="not_a_consumer")
