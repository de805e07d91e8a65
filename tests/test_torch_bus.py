"""The port's verification bus (`lighthouse_tpu_torch/verification_bus`)
against the reference's (`lighthouse_tpu/verification_bus`), on the CPU.

Both buses run the same scenarios on the "fake" backend and a few "ref"
submissions -- passthrough, fill, bulk carrying a held single, a mixed
failure isolated per submission, a raising submission, an expired
deadline, empty submissions -- and give the same per-submission verdicts,
the same `stats()` (apart from the wall model's learned times and the
card's seed constants), the same `signature_batch` journal events field by
field (apart from times) and the same per-consumer attribution. The flush
decision itself is compared on a grid of pending queues. One submission
goes through the port's "gpu" backend on the CPU (the plain versions),
canary on: the sentinel pair per set, then the shared batch with the valid
sentinel riding it.

Coalescing needs submissions held while another arrives: the held ones
wait on their own events (a 5 s hold that the next submission's trigger
cuts short); the test polls the bus's pending count, and sleeps for no
hold, watchdog or cooldown.
"""

import threading
import time

import pytest

import lighthouse_tpu.bls as rbls
from lighthouse_tpu.common import device_attribution as rattr
from lighthouse_tpu.common.events_journal import Journal as RJournal
from lighthouse_tpu.device_plane import GUARD as RGUARD
from lighthouse_tpu.device_plane import INJECTOR as RINJECTOR
from lighthouse_tpu.verification_bus import bus as rbus
from lighthouse_tpu.verification_bus import wall_model as rwall
import lighthouse_tpu_torch.bls as pbls
from lighthouse_tpu_torch.common import device_attribution as pattr
from lighthouse_tpu_torch.common.device_attribution import FIXED_DEVICE_COST_MS
from lighthouse_tpu_torch.common.events_journal import Journal as PJournal
from lighthouse_tpu_torch.device_plane import GUARD as PGUARD
from lighthouse_tpu_torch.device_plane import INJECTOR as PINJECTOR
from lighthouse_tpu_torch.device_plane import canary as pcanary
from lighthouse_tpu_torch.verification_bus import bus as pbus
from lighthouse_tpu_torch.verification_bus import wall_model as pwall

SIDES = {
    "ref": (rbls, rbus, rattr, RJournal, RGUARD, RINJECTOR),
    "port": (pbls, pbus, pattr, PJournal, PGUARD, PINJECTOR),
}


@pytest.fixture(autouse=True)
def clean_globals():
    for *_, guard, injector in SIDES.values():
        guard.reset()
        injector.reset()
    yield
    for *_, guard, injector in SIDES.values():
        guard.reset()
        injector.reset()


@pytest.fixture(scope="module")
def sets():
    """One valid and one invalid set of each package, the same bytes."""
    out = {}
    for side, (bls, *_) in SIDES.items():
        kp = bls.interop_keypairs(1)[0]
        msg = b"verification-bus-test"
        out[side] = {
            "good": bls.SignatureSet(kp.sk.sign(msg), [kp.pk], msg),
            "bad": bls.SignatureSet(kp.sk.sign(b"wrong"), [kp.pk], msg),
        }
    return out


class _BrokenSet:
    """Quacks enough to reach the ref dispatch, then raises."""

    @property
    def signature(self):
        raise RuntimeError("boom")

    pubkeys = []
    message = b""


def _wait_pending(bus, n):
    deadline = time.monotonic() + 10.0
    while bus.stats()["pending"] < n:
        assert time.monotonic() < deadline, "submissions never queued"
        time.sleep(0.001)


def _submit(bus, results, name, ss, consumer, **kw):
    try:
        results[name] = bus.submit(ss, consumer=consumer, **kw)
    except Exception as exc:
        results[name] = ("raised", type(exc).__name__, str(exc))


def _held_then(bus, results, held, last):
    """Submit `held` from threads, wait until they are queued, then submit
    `last` on this thread (its trigger flushes them all)."""
    threads = [threading.Thread(target=_submit, args=(bus, results) + h) for h in held]
    for t in threads:
        t.start()
        _wait_pending(bus, threads.index(t) + 1)
    _submit(bus, results, *last)
    for t in threads:
        t.join(timeout=30)


def _scenario(name, side, s):
    """Run one scenario on one package's bus; returns (results, bus)."""
    _, busmod, _, Journal, *_ = SIDES[side]
    j = Journal()
    good, bad = s["good"], s["bad"]
    res = {}
    if name == "passthrough":
        bus = busmod.VerificationBus(backend="ref", journal=j)
        _submit(bus, res, "good", [good], "gossip_single")
        _submit(bus, res, "bad", [bad], "gossip_single")
        _submit(bus, res, "empty", [], "gossip_single")
        _submit(bus, res, "unknown", [good], "not_a_consumer")
        res["individual"] = bus.submit_individual([good, bad], consumer="gossip_single")
    elif name == "fill":
        bus = busmod.VerificationBus(backend="fake", journal=j, max_hold_ms=5000.0, fill_target=4)
        bus.bulk_flush_live = 1000
        _held_then(bus, res, [("a", [good], "gossip_single"), ("b", [good] * 2, "sync_segment")],
                   ("c", [good], "oppool"))
    elif name == "bulk":
        bus = busmod.VerificationBus(backend="fake", journal=j, max_hold_ms=5000.0)
        _held_then(bus, res, [("single", [good], "gossip_single")],
                   ("segment", [good] * 8, "sync_segment"))
    elif name == "pressure":
        bus = busmod.VerificationBus(backend="fake", journal=j, max_hold_ms=5000.0)
        bus.pressure_fn = lambda: True
        _submit(bus, res, "single", [good], "gossip_single")
    elif name == "mixed_failure":
        bus = busmod.VerificationBus(backend="ref", journal=j, max_hold_ms=5000.0, fill_target=2)
        _held_then(bus, res, [("bad", [bad], "gossip_single")], ("good", [good], "sync_segment"))
    elif name == "raising":
        bus = busmod.VerificationBus(backend="ref", journal=j, max_hold_ms=5000.0, fill_target=2)
        _held_then(bus, res, [("bad", [_BrokenSet()], "gossip_single")],
                   ("good", [good], "sync_segment"))
    elif name == "expired_deadline":
        bus = busmod.VerificationBus(backend="fake", journal=j, max_hold_ms=5000.0)
        _submit(bus, res, "late", [good], "gossip_single", deadline=0.0)
    else:
        raise ValueError(name)
    return res, bus, j


def _bus_stats(bus):
    st = bus.stats()
    wm = st.pop("wall_model")
    # the learned EMA values are times, the seeds the card's and the TPU's
    st["wall_model_buckets"] = sorted(wm["buckets"])
    st["wall_model_observations"] = wm["observations"]
    return st


def _journal(j, fixed_ms):
    """signature_batch events without their times; the amortized fixed
    cost as a share of the package's own fixed cost (the card's 11.4 ms,
    the TPU's 90; both round to 0.001 ms)."""
    out = []
    for e in j.query(kind="signature_batch"):
        attrs = {k: v for k, v in e["attrs"].items() if k not in ("wait_s", "wall_s")}
        if "amortized_fixed_ms" in attrs:
            attrs["amortized_fixed_ms"] = round(attrs["amortized_fixed_ms"] / fixed_ms, 3)
        out.append((e["seq"], e.get("slot"), e["outcome"], attrs))
    return out


SCENARIOS = ["passthrough", "fill", "bulk", "pressure", "mixed_failure", "raising",
             "expired_deadline"]


@pytest.mark.parametrize("name", SCENARIOS)
def test_buses_give_the_same_verdicts_stats_and_events(sets, name):
    out = {}
    for side in SIDES:
        attr = SIDES[side][2]
        before = dict(attr.consumer_totals())
        res, bus, j = _scenario(name, side, sets[side])
        after = attr.consumer_totals()
        delta = {c: v - before.get(c, 0) for c, v in after.items() if v != before.get(c, 0)}
        out[side] = (res, _bus_stats(bus), _journal(j, attr.FIXED_DEVICE_COST_MS), delta, SIDES[side][4].stats()["dispatches"])
    ref, port = out["ref"], out["port"]
    assert port[0] == ref[0]
    assert port[1] == ref[1]
    assert port[2] == ref[2]
    assert port[3] == ref[3]
    assert port[4] == ref[4]
    # the scenario's own point
    res = port[0]
    if name == "passthrough":
        assert res["good"] is True and res["bad"] is False and res["empty"] is True
        assert res["unknown"][:2] == ("raised", "ValueError")
        assert res["individual"] == [True, False]
    elif name == "mixed_failure":
        assert res == {"bad": False, "good": True} and port[1]["fallback_batches"] == 2
    elif name == "raising":
        assert res == {"bad": ("raised", "RuntimeError", "boom"), "good": True}
    else:
        assert all(v is True for v in res.values())
        trigger = {"fill": "fill", "bulk": "bulk", "pressure": "pressure",
                   "expired_deadline": "deadline"}[name]
        assert port[1]["triggers"] == {trigger: 1}


def _pending(busmod, backend, sizes, budget_s, s):
    return [busmod._Submission([s] * n, "gossip_single", None, None, None, backend, budget_s)
            for n in sizes]


@pytest.mark.parametrize("pressure", [False, True])
@pytest.mark.parametrize("backend", ["device", "fake", "ref"])
def test_flush_decisions_match(sets, backend, pressure):
    """The submit-time flush decision over a grid of pending queues; the
    reference's "tpu" is the port's "gpu"."""
    grid = [
        (sizes, budget, hold, fill)
        for sizes in ([1], [1, 1], [3], [7], [8], [1, 9], [2] * 4, [32, 32], [64], [480])
        for budget in (0.0, 1000.0)
        for hold in (None, 0.0, 25.0)
        for fill in (4, 64)
    ]
    names = {"ref": "tpu" if backend == "device" else backend,
             "port": "gpu" if backend == "device" else backend}
    decisions = {}
    for side in SIDES:
        busmod = SIDES[side][1]
        out = []
        for sizes, budget, hold, fill in grid:
            bus = busmod.VerificationBus(backend=names[side], max_hold_ms=hold, fill_target=fill,
                                         device="cpu") if side == "port" else \
                busmod.VerificationBus(backend=names[side], max_hold_ms=hold, fill_target=fill)
            bus._pending = _pending(busmod, names[side], sizes, budget, sets[side]["good"])
            out.append(bus._flush_trigger_locked(pressure))
        decisions[side] = out
    assert decisions["port"] == decisions["ref"]
    assert {"fill", "bulk", "passthrough"} <= set(decisions["port"]) or pressure or backend == "device"


def test_constants_match_the_reference():
    assert pbus.DEFAULT_FILL_TARGET == rbus.DEFAULT_FILL_TARGET == 64
    assert pbus.DEFAULT_BULK_FLUSH_LIVE == rbus.DEFAULT_BULK_FLUSH_LIVE == 8
    assert pbus.DEFAULT_CLASS_BUDGETS == rbus.DEFAULT_CLASS_BUDGETS
    assert pbus.DEFAULT_BUDGET_S == rbus.DEFAULT_BUDGET_S
    assert pbus.DEFAULT_GPU_HOLD_MS == rbus.DEFAULT_TPU_HOLD_MS == 25.0
    assert pbus.VerificationBus().device == "cuda"
    assert pbus.VerificationBus(backend="gpu").stats()["max_hold_ms"] == 25.0


def test_budget_sources_match_the_reference():
    """A chain with a slot clock wires its gossip budgets into the bus
    (`budget_fns`): an explicit deadline first, then the consumer's
    source, then the class budget; a source that raises falls back."""

    def boom():
        raise RuntimeError("broken clock")

    out = []
    for mod in (rbus, pbus):
        bus = mod.VerificationBus(backend="fake")
        bus.budget_fns["gossip_single"] = lambda: 0.3
        bus.budget_fns["sidecar_header"] = boom
        out.append([bus._budget_for(c, d) for c, d in (
            ("gossip_single", None), ("gossip_single", 0.05), ("sidecar_header", None),
            ("sync_segment", None), ("oppool", -1.0))])
    assert out[0] == out[1] and out[1][0] == 0.3


def test_wall_model_carries_the_cards_figures():
    """Seeded with the card's fixed and per-set costs, never the TPU's; the
    learning rule is the reference's."""
    assert pwall.PER_SET_COST_S != rwall.PER_SET_COST_S
    p, r = pwall.PredictedWallModel(), rwall.PredictedWallModel()
    assert p.fixed_s == FIXED_DEVICE_COST_MS / 1e3
    assert p.predict_s(100) == pytest.approx(p.fixed_s + 100 * pwall.PER_SET_COST_S)
    # the build is the cold risk while no kernel library is loaded
    assert p.predict_s(100, cold_risk=True) == pytest.approx(
        p.predict_s(100) + pwall.DEFAULT_COLD_PENALTY_S)
    for m in (p, r):
        m.observe(100, 0.5)
        m.observe(120, 1.0)
        m.observe(3, -1.0)
    assert p.predict_s(128) == r.predict_s(128) == pytest.approx(0.5 + 0.3 * 0.5)
    assert p.predict_s(128, cold_risk=True) == p.predict_s(128)  # a dispatched bucket is warm
    assert p.stats()["buckets"] == r.stats()["buckets"]
    assert p.stats()["seed_fixed_ms"] == pytest.approx(FIXED_DEVICE_COST_MS)


def test_gpu_backend_submission_on_the_plain_versions():
    """One bus submission through the port's "gpu" backend on the CPU,
    canary on (auto for "gpu"): the sentinel pair per set (K2 then K3's
    per-set entry, plain), then the shared batch with the valid sentinel
    riding it -- one guarded dispatch, the inner gpu calls passing
    through."""
    kp = pbls.interop_keypairs(1)[0]
    good = pbls.SignatureSet(kp.sk.sign(b"bus-gpu"), [kp.pk], b"bus-gpu")
    j = PJournal()
    bus = pbus.VerificationBus(backend="gpu", device="cpu", journal=j, seed=3)
    assert bus.submit([good], consumer="gossip_single", slot=5) is True
    st = bus.stats()
    assert st["triggers"] == {"hold": 1} and st["max_hold_ms"] == 25.0
    g = PGUARD.stats()
    assert g["dispatches"] == 1 and g["faults"] == {}
    assert g["breaker"]["state"] == {"bls/1": "closed"}
    (ev,) = j.query(kind="signature_batch")
    assert ev["outcome"] == "ok" and ev["slot"] == 5
    # the batch held the set and the sentinel, attributed to the set alone
    assert ev["attrs"]["n_sets"] == 1 and ev["attrs"]["batch_live"] == 1
    assert ev["attrs"]["lanes"] == 4 and ev["attrs"]["backend"] == "gpu"
    assert pcanary.bls_sentinels()[0].signature.in_subgroup()


# ------------------------------------------------- slot-program kinds


class _SettleWork:
    """A staged settle on the fake backend: a payload, and every delivered
    verdict recorded."""

    def __init__(self):
        self.verdicts = []

    def payload(self):
        return [bytes(256)], [bytes(48)], [bytes(48)], "fake"

    def deliver(self, verdict):
        self.verdicts.append(verdict)


def _program_scenario(name, side, s):
    """Run one slot-program scenario on one package's bus; returns
    (results, bus, journal, work)."""
    _, busmod, _, Journal, *_ = SIDES[side]
    j = Journal()
    good = s["good"]
    work = _SettleWork()
    res = {}
    bus = busmod.VerificationBus(backend="fake", journal=j, max_hold_ms=5000.0)
    if name == "staged":
        bus.stage_program_work(work)
        _submit(bus, res, "staged", [good], "gossip_single")
        res["left_staged"] = bus.pop_staged_work() is not None
    elif name == "staging_is_thread_local":
        bus.stage_program_work(work)
        bus.max_hold_ms = 0.0  # the plain single passes straight through
        t = threading.Thread(target=_submit, args=(bus, res, "other_thread", [good], "oppool"))
        t.start()
        t.join(timeout=30)
        res["left_staged"] = bus.pop_staged_work() is work
    elif name == "empty_submit_keeps_staged":
        bus.stage_program_work(work)
        _submit(bus, res, "empty", [], "gossip_single")
        res["left_staged"] = bus.pop_staged_work() is work
    elif name == "program_and_plain_flush_apart":
        def staged_last():
            bus.stage_program_work(work)
            _submit(bus, res, "staged", [good], "gossip_single")

        held = threading.Thread(target=_submit, args=(bus, res, "held", [good], "oppool"))
        held.start()
        _wait_pending(bus, 1)
        staged_last()
        held.join(timeout=30)
    elif name == "settle_only":
        res["program"] = bus.submit_program(work, slot=9)
    else:
        raise ValueError(name)
    return res, bus, j, work


PROGRAM_SCENARIOS = ["staged", "staging_is_thread_local", "empty_submit_keeps_staged",
                     "program_and_plain_flush_apart", "settle_only"]


@pytest.mark.parametrize("name", PROGRAM_SCENARIOS)
def test_slot_program_kinds_match_the_reference(sets, name):
    """Staging, the slot_program kind, its "bulk" trigger, the (backend,
    kind) grouping and the settle-only program on both buses ("fake"): the
    same verdicts, deliveries, stats, journal events and dispatches."""
    out = {}
    for side in SIDES:
        attr = SIDES[side][2]
        before = dict(attr.consumer_totals())
        res, bus, j, work = _program_scenario(name, side, sets[side])
        after = attr.consumer_totals()
        delta = {c: v - before.get(c, 0) for c, v in after.items() if v != before.get(c, 0)}
        out[side] = (res, work.verdicts, _bus_stats(bus), _journal(j, attr.FIXED_DEVICE_COST_MS),
                     delta, SIDES[side][4].stats()["dispatches"])
    assert out["port"] == out["ref"]
    res, delivered, st, events, _, dispatches = out["port"]
    if name == "staged":
        assert res == {"staged": True, "left_staged": False} and delivered == [True]
        assert st["triggers"] == {"bulk": 1} and len(events) == 1
    elif name == "staging_is_thread_local":
        assert res == {"other_thread": True, "left_staged": True} and delivered == []
        assert st["triggers"] == {"passthrough": 1}
    elif name == "empty_submit_keeps_staged":
        assert res == {"empty": True, "left_staged": True} and delivered == []
        assert st["batches_formed"] == 0 and dispatches == 0
    elif name == "program_and_plain_flush_apart":
        assert res == {"held": True, "staged": True} and delivered == [True]
        assert st["batches_formed"] == 2 and st["triggers"] == {"bulk": 2} and dispatches == 2
        assert [e[3]["n_submissions"] for e in events] == [1, 1]
    else:
        assert res == {"program": True} and delivered == [True]
        assert events == [] and st["triggers"] == {"bulk": 1} and dispatches == 1
