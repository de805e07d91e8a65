"""The port's device plane (`lighthouse_tpu_torch/device_plane`) against the
reference's (`lighthouse_tpu/device_plane`), on the CPU:

* `faults.decide` gives the same decision over a grid of seeds, kinds,
  planes, buckets, ordinals and rates;
* both breakers take the same transitions for the same allow / record /
  quarantine sequence on an injected clock;
* both guarded executors, the reference's with ``fallbacks=()``, run the
  same seeded injection schedule over the same host device_fns: the same
  result or exception class on each dispatch, the same fault counters,
  transitions and `device_fault` journal events;
* the watchdog, the breaker's refusal, reentrancy and the quarantine after
  a canary violation behave alike;
* the port's bls sentinel pair is the committed vectors' and the
  reference's `bls_sentinels()`, and `check_pair` holds the same contract;
* every device verify of `bls/gpu_backend.py` crosses `GUARD.dispatch`: an
  injected fault raises before any launch and the call counts stay still.

No test sleeps for a watchdog or a cooldown: timeouts are a few ms and
the cooldown is 0 or the injected clock's.
"""

import json
import os
import threading
import time

import pytest

from lighthouse_tpu.common.events_journal import Journal as RJournal
from lighthouse_tpu.device_plane import breaker as rbreaker
from lighthouse_tpu.device_plane import canary as rcanary
from lighthouse_tpu.device_plane import executor as rexec
from lighthouse_tpu.device_plane import faults as rfaults
from lighthouse_tpu_torch import bls as pbls
from lighthouse_tpu_torch.bls import gpu_backend
from lighthouse_tpu_torch.common.events_journal import Journal as PJournal
from lighthouse_tpu_torch.device_plane import breaker as pbreaker
from lighthouse_tpu_torch.device_plane import canary as pcanary
from lighthouse_tpu_torch.device_plane import executor as pexec
from lighthouse_tpu_torch.device_plane import faults as pfaults

SIDES = {"ref": (rexec, rfaults, RJournal), "port": (pexec, pfaults, PJournal)}
VECTORS = os.path.join(os.path.dirname(__file__), "vectors", "sentinel", "bls")


@pytest.fixture
def clean_globals():
    """Both packages' GUARD and INJECTOR are process-global: every test
    that touches them leaves them at boot state."""
    for ex, fa, _ in SIDES.values():
        ex.GUARD.reset()
        fa.INJECTOR.reset()
    yield
    for ex, fa, _ in SIDES.values():
        ex.GUARD.reset()
        fa.INJECTOR.reset()


class FakeClock:
    def __init__(self):
        self.now = 100.0

    def __call__(self):
        return self.now


def _events(journal):
    """device_fault events without their times."""
    return [
        (e["outcome"], e.get("slot"), e["attrs"].get("plane"), e["attrs"].get("bucket"),
         e["attrs"].get("fault"))
        for e in journal.query(kind="device_fault")
    ]


def _stats(g):
    st = g.stats()
    st.pop("failovers", None)  # the reference's failover tier has no twin
    return st


# ------------------------------------------------------------------ faults


@pytest.mark.parametrize("kind", rfaults.KINDS)
def test_decide_is_equal_over_a_grid(kind):
    assert pfaults.KINDS == rfaults.KINDS
    assert pfaults.SLOW_COMPILE_DELAY_S == rfaults.SLOW_COMPILE_DELAY_S
    grid = [
        (seed, kind, plane, bucket, ordinal, rate)
        for seed in (0, 1, 7, 2**40 + 3)
        for plane in ("bls", "kzg", "merkle_proof")
        for bucket in ("1", "64", "g128x512k1", "s1024k4", "stream", "*")
        for ordinal in range(0, 40, 3)
        for rate in (0.0, 0.1, 0.5, 0.9, 1.0)
    ]
    ref = [rfaults.decide(*g) for g in grid]
    assert [pfaults.decide(*g) for g in grid] == ref
    assert True in ref and False in ref


def test_injectors_plan_the_same_faults():
    a, b = rfaults.FaultInjector(), pfaults.FaultInjector()
    for inj in (a, b):
        inj.arm("stall", "bls", rate=0.3, seed=42)
        inj.arm("flip", "bls", rate=0.25, seed=42)
        inj.arm("slow_compile", "kzg", rate=0.5, seed=3)
    seq = [("bls", "64"), ("bls", "128"), ("kzg", "64"), ("bls", "64")] * 12
    assert [a.plan(*k) for k in seq] == [b.plan(*k) for k in seq]
    assert a.injected == b.injected and sum(a.injected.values()) > 0
    for inj in (a, b):
        inj.disarm(kind="stall")
        with pytest.raises(ValueError):
            inj.arm("segfault", "bls")
    assert [a.plan(*k) for k in seq] == [b.plan(*k) for k in seq]


# ----------------------------------------------------------------- breaker


def _breaker_run(mod, steps):
    clock = FakeClock()
    seen = []
    br = mod.CircuitBreaker(threshold=3, cooldown_s=10.0, clock=clock,
                            on_transition=lambda p, b, to: seen.append((p, b, to)))
    out = []
    for op, *args in steps:
        if op == "tick":
            clock.now += args[0]
            continue
        r = getattr(br, op)(*args)
        out.append((op, args, r, br.state_of(*args[:1], "64") if op == "quarantine" else
                    br.state_of(*args)))
    return out, seen, br.snapshot()


BREAKER_SEQUENCES = {
    "trip_probe_close": [
        ("allow", "bls", "64"), ("record_failure", "bls", "64"), ("record_failure", "bls", "64"),
        ("record_success", "bls", "64"), ("record_failure", "bls", "64"),
        ("record_failure", "bls", "64"), ("record_failure", "bls", "64"), ("allow", "bls", "64"),
        ("allow", "bls", "128"), ("allow", "kzg", "64"), ("tick", 10.0), ("allow", "bls", "64"),
        ("allow", "bls", "64"), ("record_success", "bls", "64"), ("allow", "bls", "64"),
    ],
    "probe_failure_reopens": [
        ("record_failure", "bls", "4"), ("record_failure", "bls", "4"),
        ("record_failure", "bls", "4"), ("tick", 10.0), ("allow", "bls", "4"),
        ("record_failure", "bls", "4"), ("tick", 9.9), ("allow", "bls", "4"), ("tick", 0.2),
        ("allow", "bls", "4"), ("record_success", "bls", "4"),
    ],
    "quarantine_and_recovery": [
        ("quarantine", "bls"), ("allow", "bls", "4"), ("allow", "bls", "4096"),
        ("allow", "kzg", "4"), ("tick", 10.0), ("allow", "bls", "4096"), ("allow", "bls", "4"),
        ("record_failure", "bls", "4096"), ("tick", 10.0), ("allow", "bls", "64"),
        ("record_success", "bls", "64"), ("allow", "bls", "4"), ("quarantine", "bls"),
    ],
}


@pytest.mark.parametrize("name", sorted(BREAKER_SEQUENCES))
def test_breakers_take_the_same_transitions(name):
    steps = BREAKER_SEQUENCES[name]
    ref, port = _breaker_run(rbreaker, steps), _breaker_run(pbreaker, steps)
    assert port == ref
    assert ref[1], "the sequence makes no transition"


# ---------------------------------------------------------------- executor


def _device_fns(ex):
    """A sequence of host device_fns: plain results, verdicts through the
    plan, a data exception and the package's own fault class."""

    def verdicts(plan):
        return list(plan.verdict([True, False, True]))

    def verdict(plan):
        return plan.verdict(True)

    def boom(plan):
        raise ValueError("malformed")

    def wedged(plan):
        raise ex.DeviceFaultError("wedged")

    return [lambda plan: "v", verdicts, verdict, boom, verdicts, wedged, verdict, verdicts]


def _outcome(fn):
    try:
        return ("ok", fn())
    except Exception as exc:  # the class decides, not the package
        return ("raise", type(exc).__name__, getattr(exc, "kind", None))


SCHEDULES = {
    "stall_error_flip": [("stall", 0.3, 11), ("error", 0.2, 11), ("flip", 0.4, 5)],
    "stall_dense": [("stall", 0.6, 2)],
    "flip_and_slow": [("flip", 0.5, 9), ("slow_compile", 0.08, 9)],
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
@pytest.mark.parametrize("fault_types", [None, "device"], ids=["any", "device_faults"])
def test_executors_run_the_same_schedule(clean_globals, name, fault_types):
    results, stats, events, injected = {}, {}, {}, {}
    for side, (ex, fa, Journal) in SIDES.items():
        for kind, rate, seed in SCHEDULES[name]:
            fa.INJECTOR.arm(kind, "bls", rate=rate, seed=seed)
        g = ex.GuardedExecutor()
        g.configure(threshold=2, cooldown_s=0.0)
        j = Journal()
        ft = (ex.DeviceFaultError,) if fault_types else None
        fns = _device_fns(ex)
        out = []
        for i in range(24):
            fn = fns[i % len(fns)]
            bucket = 64 if i % 3 else 4096
            kw = {} if side == "port" else {"fallbacks": ()}
            out.append(_outcome(lambda: g.dispatch("bls", bucket, fn, journal=j, slot=i,
                                                   fault_types=ft, **kw)))
        results[side], stats[side], events[side] = out, _stats(g), _events(j)
        injected[side] = dict(fa.INJECTOR.injected)
    ref, port = results["ref"], results["port"]
    for i, (r, p) in enumerate(zip(ref, port)):
        if r[:2] == ("raise", "ValueError") and fault_types is None:
            # the reference re-raises an untyped device fault as it came;
            # the port raises it as a DeviceFaultError chained from it
            assert p == ("raise", "DeviceFaultError", "error"), i
        else:
            assert p == r, i
    assert stats["port"] == stats["ref"]
    assert events["port"] == events["ref"]
    assert injected["port"] == injected["ref"]
    assert any(r[0] == "raise" for r in ref) and any(r[0] == "ok" for r in ref)


def test_untyped_device_error_raises_as_device_fault(clean_globals):
    g = pexec.GuardedExecutor()
    g.configure(watchdog=False)
    with pytest.raises(pexec.DeviceFaultError) as info:
        g.dispatch("bls", 64, lambda plan: (_ for _ in ()).throw(RuntimeError("launch failed: 700")))
    assert isinstance(info.value.__cause__, RuntimeError)
    assert g.stats()["faults"] == {"bls:error": 1}
    # a host backend's data error keeps its class and spares the breaker
    with pytest.raises(ValueError):
        g.dispatch("bls", 64, lambda plan: (_ for _ in ()).throw(ValueError("bytes")),
                   fault_types=(pexec.DeviceFaultError,))
    assert g.stats()["faults"] == {"bls:error": 1}


def test_breaker_open_refuses_without_calling(clean_globals):
    for side, (ex, _, Journal) in SIDES.items():
        g = ex.GuardedExecutor()
        g.configure(threshold=1, cooldown_s=3600.0, watchdog=False)
        kw = {} if side == "port" else {"fallbacks": ()}
        with pytest.raises(ex.DeviceFaultError):
            g.dispatch("bls", 64, lambda plan: (_ for _ in ()).throw(ex.DeviceFaultError("x")), **kw)
        calls = []
        with pytest.raises(ex.DeviceFaultError, match="breaker open"):
            g.dispatch("bls", 64, lambda plan: calls.append(1), **kw)
        assert calls == [] and g.stats()["dispatches"] == 2
        assert g.stats()["transitions"] == {"bls:open": 1}


def test_reentrant_and_disabled_pass_through():
    for ex, _, _ in SIDES.values():
        g = ex.GuardedExecutor()
        g.configure(watchdog=False)
        assert g.dispatch("bls", 64, lambda plan: g.dispatch("bls", 32, lambda p: p)) is ex.NULL_PLAN
        assert g.stats()["dispatches"] == 1
        g.configure(enabled=False)
        assert g.dispatch("bls", 64, lambda plan: "raw") == "raw"
        assert g.stats()["dispatches"] == 1


def test_watchdog_timeout_abandons_and_reaps():
    for side, (ex, _, _) in SIDES.items():
        g = ex.GuardedExecutor()
        release = threading.Event()
        kw = {} if side == "port" else {"fallbacks": ()}
        with pytest.raises(ex.DeviceTimeout):
            g.dispatch("bls", 64, lambda plan: release.wait(5.0), timeout_s=0.005, **kw)
        assert g.stats()["abandoned"] == 1 and g.stats()["faults"] == {"bls:timeout": 1}
        release.set()
        deadline = time.monotonic() + 5.0
        while g.stats()["reaped"] == 0 and time.monotonic() < deadline:
            time.sleep(0.005)
        st = g.stats()
        assert st["reaped"] == 1 and st["abandoned"] == 0
        assert st["faults"] == {"bls:timeout": 1, "bls:reaped": 1}
        # the next dispatch gets its own verdict
        assert g.dispatch("bls", 64, lambda plan: plan.verdict(True), **kw) is True


def test_timeout_budget_and_cold_allowance():
    g = pexec.GuardedExecutor()
    g.configure(base_timeout_s=2.0, timeout_factor=4.0, min_timeout_s=1.0, cold_allowance_s=30.0)
    # no kernel library is loaded on the CPU: the first use's build is granted
    assert g.cold_allowance_s("any") == 30.0
    assert g.timeout_for("bls", "x") == pytest.approx(8.0 + 30.0)
    assert g.timeout_for("bls", "x", predicted_s=0.1) == pytest.approx(1.0 + 30.0)


def test_dispatch_async_resolves_in_order(clean_globals):
    for side, (ex, _, _) in SIDES.items():
        g = ex.GuardedExecutor()
        g.configure(watchdog=False, threshold=5)
        kw = {} if side == "port" else {"fallbacks": ()}
        hs = [g.dispatch_async("bls", 64, (lambda i: lambda plan: i)(i), **kw) for i in range(4)]
        bad = g.dispatch_async("bls", 64, lambda plan: (_ for _ in ()).throw(ex.DeviceErrorInjected("e")),
                               **kw)
        assert [h.result(5.0) for h in hs] == [0, 1, 2, 3]
        with pytest.raises(ex.DeviceErrorInjected):
            bad.result(5.0)


# ------------------------------------------------------------------ canary


def test_sentinel_pair_is_the_committed_one():
    committed = {}
    for name in ("valid", "invalid"):
        with open(os.path.join(VECTORS, f"{name}.json")) as f:
            committed[name] = json.load(f)
    assert pcanary.bls_vectors() == committed
    for p, r in zip(pcanary.bls_sentinels(), rcanary.bls_sentinels()):
        assert p.signature.to_bytes() == r.signature.to_bytes()
        assert [k.to_bytes() for k in p.pubkeys] == [k.to_bytes() for k in r.pubkeys]
        assert p.message == r.message
    with pytest.raises(ValueError):
        pcanary.self_test_plane("da_cells")


def test_check_pair_and_flip(clean_globals):
    assert pcanary.check_pair("ref") == [True, False]
    for can, ex in ((pcanary, pexec), (rcanary, rexec)):
        with pytest.raises(ex.CanaryViolation):
            can.check_pair("ref", ex.InjectionPlan({"flip"}))


def test_canary_violation_quarantines_the_plane(clean_globals):
    """A flip armed on the bls plane: the dispatch's canary pair comes back
    flipped, the plane is quarantined, and the next dispatch of any bucket
    is refused without calling the attempt."""
    out = {}
    for side, (ex, fa, Journal) in SIDES.items():
        can = pcanary if side == "port" else rcanary
        fa.INJECTOR.arm("flip", "bls", rate=1.0, seed=9)
        ex.GUARD.configure(watchdog=False)
        j = Journal()
        kw = {} if side == "port" else {"fallbacks": ()}
        with pytest.raises(ex.CanaryViolation):
            ex.GUARD.dispatch("bls", 64, lambda plan: can.check_pair("ref", plan), journal=j, **kw)
        calls = []
        with pytest.raises(ex.DeviceFaultError, match="breaker open"):
            ex.GUARD.dispatch("bls", 8, lambda plan: calls.append(1), journal=j, **kw)
        assert calls == []
        out[side] = (_stats(ex.GUARD), _events(j))
    assert out["port"] == out["ref"]
    assert out["port"][0]["breaker"]["state"] == {"bls/64": "closed", "bls/*": "open"}


def test_self_test_quarantines_a_failing_plane(monkeypatch, clean_globals):
    g = pexec.GuardedExecutor()
    j = PJournal()
    assert g.self_test(journal=j) == {"bls": True, "kzg": True, "merkle_proof": True}
    monkeypatch.setattr(pcanary, "self_test_plane", lambda plane: False)
    assert g.self_test(journal=j) == {"bls": False, "kzg": False, "merkle_proof": False}
    assert g.breaker.state_of("bls", "anything") == "open"
    assert g.breaker.state_of("kzg", "anything") == "open"
    assert g.breaker.state_of("merkle_proof", "anything") == "open"
    outcomes = [e["outcome"] for e in j.query(kind="device_fault")]
    assert outcomes == ["selftest_ok"] * 3 + ["fault", "breaker_open", "selftest_failed"] * 3


def test_canary_modes():
    g = pexec.GuardedExecutor()
    assert g.canary_active("gpu") and not g.canary_active("ref")
    g.configure(canary="off")
    assert not g.canary_active("gpu")
    with pytest.raises(ValueError):
        g.configure(canary="sometimes")


# --------------------------------------------- the gpu backend's crossings


def _sets(n=2):
    kps = pbls.interop_keypairs(n)
    return [pbls.SignatureSet(kp.sk.sign(b"guard"), [kp.pk], b"guard") for kp in kps]


ENTRIES = {
    "batch": lambda sets: gpu_backend.verify_signature_sets_gpu(sets, seed=1, device="cpu"),
    "individual": lambda sets: gpu_backend.verify_signature_sets_gpu_individual(sets, device="cpu"),
    "stream": lambda sets: gpu_backend.verify_signature_set_batches_gpu([sets, sets], seed=1,
                                                                        device="cpu"),
}


@pytest.mark.parametrize("entry", sorted(ENTRIES))
@pytest.mark.parametrize("kind", ["stall", "error"])
def test_every_gpu_entry_crosses_the_guard(clean_globals, entry, kind):
    """An injected fault raises before any launch: the call counts and the
    launch counters do not move, and the fault is counted on the plane."""
    sets = _sets()
    pfaults.INJECTOR.arm(kind, "bls", rate=1.0, seed=0)
    calls = dict(gpu_backend.CALL_COUNTS)
    exc = {"stall": pexec.DeviceStallInjected, "error": pexec.DeviceErrorInjected}[kind]
    with pytest.raises(exc):
        ENTRIES[entry](sets)
    assert gpu_backend.CALL_COUNTS == calls
    st = pexec.GUARD.stats()
    assert st["dispatches"] == 1 and st["faults"] == {f"bls:{kind}": 1}


def test_quarantined_plane_never_touches_the_card(clean_globals):
    pexec.GUARD.breaker.quarantine("bls")
    calls = dict(gpu_backend.CALL_COUNTS)
    for entry in ENTRIES.values():
        with pytest.raises(pexec.DeviceFaultError, match="breaker open"):
            entry(_sets())
    assert gpu_backend.CALL_COUNTS == calls
    assert pexec.GUARD.stats()["dispatches"] == 3
