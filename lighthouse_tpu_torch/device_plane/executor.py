"""The guarded executor: every host<->device dispatch of the port crosses it.

The port of `lighthouse_tpu/device_plane/executor.py`, without the failover
tier. One wedged, erroring, or silently-corrupting dispatch on the card must
never hang or mis-verify the node. Every guarded dispatch gets:

  watchdog   — the device attempt runs on a watchdog thread with a
               per-(plane, bucket) timeout (a multiple of the caller's
               predicted wall, plus the cold allowance while
               `ops/cuda_build.py` has loaded no kernel library in this
               process: the first use builds every kernel with nvcc). A
               timed-out attempt is ABANDONED to the reaper thread (a
               launched kernel cannot be cancelled; the reaper joins the
               thread off the caller's critical path and counts the late
               completion) and the caller gets `DeviceTimeout`.
  breaker    — per-(plane, shape-bucket) circuit breaker consulted
               before the card is touched; open means `DeviceFaultError`
               at once, half-open admits one probe. Canary violations
               quarantine the whole plane (``breaker.py``).
  injection  — each attempt consumes a deterministic `InjectionPlan`
               from the seeded ``faults.INJECTOR`` (armed only by tests;
               a disarmed injector costs one lock acquisition).

There is no failover: a device fault is counted, journaled, fed to the
breaker and raised to the caller as a `DeviceFaultError` (a fault that is
not one already, such as a refused launch's RuntimeError, is raised as a
`DeviceFaultError` chained from it). This is what the reference does with
``fallbacks=()``.

Everything is observable under the reference's names:
``lighthouse_tpu_device_faults_total{plane,kind}``,
``lighthouse_tpu_device_breaker_transitions_total{plane,to}``, the
``device_fault`` journal kind, and `GUARD.stats()`.

`GUARD` is process-global like the card it protects (one device, one set
of loaded kernel libraries).
"""

import queue
import threading
import time

from lighthouse_tpu_torch.common import slot_budget
from lighthouse_tpu_torch.common.metrics import REGISTRY
from lighthouse_tpu_torch.device_plane.breaker import CircuitBreaker
from lighthouse_tpu_torch.device_plane.faults import (
    INJECTOR,
    SLOW_COMPILE_DELAY_S,
)
from lighthouse_tpu_torch.ops import cuda_build

_FAULTS_TOTAL = REGISTRY.counter_vec(
    "lighthouse_tpu_device_faults_total",
    "device-plane faults observed by the guarded executor, by plane and "
    "fault kind (timeout/stall/error/canary/selftest/reaped)",
    ("plane", "kind"),
)
_TRANSITIONS_TOTAL = REGISTRY.counter_vec(
    "lighthouse_tpu_device_breaker_transitions_total",
    "device-plane circuit-breaker state transitions, by plane and "
    "target state",
    ("plane", "to"),
)

# watchdog defaults: generous — a false-positive timeout abandons a
# healthy dispatch and fails its caller, so the watchdog only exists to
# catch genuinely wedged dispatches, not slow ones
DEFAULT_BASE_TIMEOUT_S = 10.0
DEFAULT_TIMEOUT_FACTOR = 8.0
DEFAULT_MIN_TIMEOUT_S = 5.0
# the first use in a process builds every kernel with nvcc (29.1 s and
# 34.3 s in two runs of chip_smoke.py's build line on an 8-core host); a
# dispatch that may pay it gets this
DEFAULT_COLD_ALLOWANCE_S = 120.0

DEFAULT_SELFTEST_PLANES = ("bls", "kzg", "merkle_proof")


class DeviceFaultError(RuntimeError):
    """Base of every guarded-executor fault; `kind` is the metric/
    journal fault-kind label."""

    kind = "error"


class DeviceTimeout(DeviceFaultError):
    kind = "timeout"


class DeviceStallInjected(DeviceFaultError):
    kind = "stall"


class DeviceErrorInjected(DeviceFaultError):
    kind = "error"


class CanaryViolation(DeviceFaultError):
    """The card returned a wrong verdict for a known-answer sentinel:
    it is lying about everything — quarantine the plane."""

    kind = "canary"


class InjectionPlan:
    """The fault kinds injected into ONE dispatch attempt (usually
    empty). The device closure calls `raise_if_faulted()` before
    touching the card and routes every verdict it produces through
    `verdict()` — so a flip injection flips the canary pair too, which
    is exactly how the canary contract catches it. The executor calls
    `raise_if_faulted()` too; the injected delay is taken once a plan."""

    __slots__ = ("kinds", "_delayed")

    def __init__(self, kinds=frozenset()):
        self.kinds = frozenset(kinds)
        self._delayed = False

    def raise_if_faulted(self):
        if "slow_compile" in self.kinds and not self._delayed:
            # bounded injected delay — visible in wall accounting, far
            # below any watchdog allowance
            self._delayed = True
            time.sleep(SLOW_COMPILE_DELAY_S)
        if "stall" in self.kinds:
            # a stall is a dispatch that never returns; injected as an
            # immediate raise so tests exercise the fault path without
            # sleeping out real watchdog timeouts
            raise DeviceStallInjected("injected device stall")
        if "error" in self.kinds:
            raise DeviceErrorInjected("injected device error")

    def verdict(self, ok):
        """Route every device-produced verdict through the plan; a flip
        injection inverts it (bool or sequence of bools)."""
        if "flip" not in self.kinds:
            return ok
        if isinstance(ok, (list, tuple)):
            return type(ok)(not bool(v) for v in ok)
        return not bool(ok)


NULL_PLAN = InjectionPlan()

# dispatch_async double-buffer depth: one dispatch RUNNING on the
# worker plus this many QUEUED behind it; a deeper submit blocks in
# submission order, bounding how far ahead the host may marshal
ASYNC_QUEUE_DEPTH = 1


class DispatchHandle:
    """Future-like handle returned by `dispatch_async`: the verdict of
    one guarded dispatch running on the executor's FIFO worker thread.
    `result()` blocks until the dispatch resolves and re-raises
    whatever the synchronous `dispatch` would have raised on the
    caller's thread."""

    __slots__ = ("_event", "_result", "_exc")

    def __init__(self):
        self._event = threading.Event()
        self._result = None
        self._exc = None

    def _resolve(self, result, exc):
        self._result = result
        self._exc = exc
        self._event.set()

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout=None):
        if not self._event.wait(timeout):
            raise DeviceTimeout(
                "dispatch_async result not ready within "
                f"{timeout}s wait"
            )
        if self._exc is not None:
            raise self._exc
        return self._result


def pow2_bucket(n: int) -> int:
    """Smallest power of two >= max(n, 1) — the shape-bucket convention
    shared with the padded backends."""
    return 1 << max(0, int(n) - 1).bit_length() if n > 1 else 1


class GuardedExecutor:
    def __init__(self):
        self._lock = threading.Lock()
        self.breaker = CircuitBreaker(on_transition=self._on_transition)
        self._tls = threading.local()
        self._abandoned: list = []
        self._reaper = None
        # dispatch_async plumbing: ONE FIFO worker thread so handles
        # resolve in submission order, and a bounded queue so the host
        # can marshal at most one dispatch ahead (double buffering)
        self._async_lock = threading.Lock()
        self._async_queue = None
        self._async_worker = None
        self._init_config()
        self._init_counters()

    def _init_config(self):
        self.enabled = True
        self.watchdog = True
        self.canary_mode = "auto"  # auto | on | off
        self.base_timeout_s = DEFAULT_BASE_TIMEOUT_S
        self.timeout_factor = DEFAULT_TIMEOUT_FACTOR
        self.min_timeout_s = DEFAULT_MIN_TIMEOUT_S
        self.cold_allowance_default_s = DEFAULT_COLD_ALLOWANCE_S

    def _init_counters(self):
        self.faults: dict[tuple, int] = {}
        self.transitions: dict[tuple, int] = {}
        self.dispatches = 0
        self.reaped = 0
        self.selftest_results: dict[str, bool] = {}

    # ------------------------------------------------------- configuration

    def configure(
        self,
        enabled=None,
        watchdog=None,
        canary=None,
        threshold=None,
        cooldown_s=None,
        base_timeout_s=None,
        timeout_factor=None,
        min_timeout_s=None,
        cold_allowance_s=None,
    ):
        if enabled is not None:
            self.enabled = bool(enabled)
        if watchdog is not None:
            self.watchdog = bool(watchdog)
        if canary is not None:
            if canary not in ("auto", "on", "off"):
                raise ValueError(
                    f"canary mode {canary!r} not one of auto/on/off"
                )
            self.canary_mode = canary
        if threshold is not None:
            self.breaker.threshold = max(1, int(threshold))
        if cooldown_s is not None:
            self.breaker.cooldown_s = max(0.0, float(cooldown_s))
        if base_timeout_s is not None:
            self.base_timeout_s = float(base_timeout_s)
        if timeout_factor is not None:
            self.timeout_factor = float(timeout_factor)
        if min_timeout_s is not None:
            self.min_timeout_s = float(min_timeout_s)
        if cold_allowance_s is not None:
            self.cold_allowance_default_s = float(cold_allowance_s)

    def reset(self):
        """Back to process-boot state (config AND counters) — tests call
        this between cases; the guard, like the card, is process-global."""
        self.breaker = CircuitBreaker(on_transition=self._on_transition)
        with self._lock:
            self._abandoned = []
        self._init_config()
        self._init_counters()

    def canary_active(self, backend: str) -> bool:
        """Should the bus splice sentinel sets into a shared batch on
        `backend`? mode 'auto' canaries the card's backend (and any
        backend while injection is armed); host backends ARE the trusted
        oracle and need no canary."""
        if self.canary_mode == "on":
            return True
        if self.canary_mode == "off":
            return False
        return backend == "gpu" or INJECTOR.armed()

    # ------------------------------------------------------------ timeouts

    def cold_allowance_s(self, bucket) -> float:
        """Extra watchdog allowance while `ops/cuda_build.py` has loaded
        no kernel library in this process: the first launch builds every
        kernel with nvcc. The kernels take any shape once built, so the
        bucket does not matter."""
        return 0.0 if cuda_build.loaded() else self.cold_allowance_default_s

    def timeout_for(self, plane, bucket, predicted_s=None) -> float:
        """Watchdog budget for one (plane, bucket) dispatch: a multiple
        of the predicted warm wall (PredictedWallModel when the caller
        has one, static default otherwise) plus the cold allowance."""
        base = (
            float(predicted_s)
            if predicted_s
            else self.base_timeout_s
        )
        warm = max(self.min_timeout_s, self.timeout_factor * base)
        return warm + self.cold_allowance_s(bucket)

    # ------------------------------------------------------------ dispatch

    def dispatch(
        self,
        plane: str,
        bucket,
        device_fn,
        journal=None,
        slot=None,
        timeout_s=None,
        predicted_s=None,
        fault_types=None,
        watchdog=None,
    ):
        """Run `device_fn(plan)` under the full guard and return its
        result; on a device fault raise a `DeviceFaultError` (never a
        hang).

        `watchdog=False` opts THIS dispatch out of the watchdog while
        keeping injection and the breaker.

        `fault_types` narrows what counts as a device fault: when set
        (a tuple of exception types), anything else raised by the
        attempt re-raises unguarded — callers wrapping HOST backends
        pass ``(DeviceFaultError,)`` so a data-dependent exception
        keeps its original semantics instead of poisoning the breaker.

        Reentrant dispatches pass through: when a guarded attempt
        itself reaches another guarded entry point (the bus's shared
        verify calls the guarded gpu backend), only the OUTERMOST
        crossing injects, times, and counts — one guard per
        host<->device boundary crossing."""
        if not self.enabled or getattr(self._tls, "active", False):
            return device_fn(NULL_PLAN)
        bucket = str(bucket)
        # slot-budget dispatch ledger: the outermost guard crossing IS
        # one host<->device round trip of whatever import is being
        # profiled on this thread
        _budget_tok = slot_budget.open_dispatch(plane)
        self._tls.transitions = []
        try:
            with self._lock:
                self.dispatches += 1
            if not self.breaker.allow(plane, bucket):
                self._drain_transitions(journal, slot)
                raise DeviceFaultError(
                    f"breaker open for {plane}/{bucket}: the card is "
                    "not touched"
                )
            self._drain_transitions(journal, slot)
            plan = InjectionPlan(INJECTOR.plan(plane, bucket))
            try:
                result = self._attempt(
                    plane, bucket, device_fn, plan, timeout_s,
                    predicted_s, watchdog,
                )
            # THE fault boundary — every device fault is counted, journaled, fed to the breaker, and re-raised typed
            except Exception as exc:
                if fault_types is not None and not isinstance(
                    exc, fault_types
                ):
                    raise
                kind = getattr(exc, "kind", None) or "error"
                self._note_fault(plane, bucket, kind, journal, slot)
                if isinstance(exc, CanaryViolation):
                    self.breaker.quarantine(plane)
                else:
                    self.breaker.record_failure(plane, bucket)
                self._drain_transitions(journal, slot)
                if isinstance(exc, DeviceFaultError):
                    raise
                raise DeviceFaultError(
                    f"{plane}/{bucket} dispatch failed: {exc!r}"
                ) from exc
            self.breaker.record_success(plane, bucket)
            self._drain_transitions(journal, slot)
            return result
        finally:
            slot_budget.close_dispatch(_budget_tok)
            self._tls.transitions = None

    def dispatch_async(
        self, plane: str, bucket, device_fn, **kwargs
    ) -> DispatchHandle:
        """Non-blocking submission: enqueue one guarded dispatch on the
        executor's single FIFO worker thread and return a
        `DispatchHandle` immediately, so the caller's host work overlaps
        the card's. Every dispatch keeps the FULL guard rails — the
        worker delegates to `dispatch`.

        Double buffering: the queue admits ONE submission beyond the
        dispatch currently running; a deeper submission blocks here in
        FIFO order."""
        handle = DispatchHandle()
        with self._async_lock:
            if self._async_queue is None:
                self._async_queue = queue.Queue(
                    maxsize=ASYNC_QUEUE_DEPTH
                )
            if (
                self._async_worker is None
                or not self._async_worker.is_alive()
            ):
                self._async_worker = threading.Thread(
                    target=self._async_loop,
                    name="device-async-executor",
                    daemon=True,
                )
                self._async_worker.start()
            q = self._async_queue
        q.put((handle, plane, bucket, device_fn, kwargs))
        return handle

    def _async_loop(self):
        while True:
            q = self._async_queue
            if q is None:
                return
            try:
                item = q.get(timeout=1.0)
            except queue.Empty:
                continue
            handle, plane, bucket, device_fn, kwargs = item
            try:
                result = self.dispatch(plane, bucket, device_fn, **kwargs)
            # worker-thread trampoline — the exception re-raises on the handle owner's thread via result()
            except BaseException as exc:
                handle._resolve(None, exc)
            else:
                handle._resolve(result, None)

    def _run_marked(self, device_fn, plan):
        """Invoke the attempt with this thread marked guard-active, so
        nested guarded entry points pass through (see `dispatch`)."""
        self._tls.active = True
        try:
            return device_fn(plan)
        finally:
            self._tls.active = False

    def _attempt(
        self, plane, bucket, device_fn, plan, timeout_s, predicted_s,
        watchdog=None,
    ):
        plan.raise_if_faulted()
        if not self.watchdog or watchdog is False:
            return self._run_marked(device_fn, plan)
        if timeout_s is None:
            timeout_s = self.timeout_for(plane, bucket, predicted_s)
        box = {}

        def run():
            try:
                box["result"] = self._run_marked(device_fn, plan)
            # watchdog thread trampoline — the exception is re-raised on the caller thread below
            except BaseException as exc:
                box["error"] = exc

        # the attempt's CUDA work runs on this thread's current stream
        # (the default stream), uploads, launches and reads alike
        worker = threading.Thread(
            target=run, name=f"device-dispatch-{plane}", daemon=True
        )
        worker.start()
        worker.join(timeout_s)
        if worker.is_alive():
            self._abandon(worker, plane)
            raise DeviceTimeout(
                f"{plane}/{bucket} dispatch exceeded watchdog budget "
                f"{timeout_s:.3f}s"
            )
        if "error" in box:
            raise box["error"]
        return box["result"]

    # --------------------------------------------------------- accounting

    def _note_fault(self, plane, bucket, kind, journal, slot):
        _FAULTS_TOTAL.labels(plane, kind).inc()
        with self._lock:
            key = (plane, kind)
            self.faults[key] = self.faults.get(key, 0) + 1
        if journal is not None:
            journal.emit(
                "device_fault",
                slot=slot,
                outcome="fault",
                plane=plane,
                bucket=bucket,
                fault=kind,
            )

    def _on_transition(self, plane, bucket, to):
        # called under the breaker lock: keep it to counter increments
        # plus staging — journal emission happens at the drain point on
        # the dispatching thread, which knows the right journal
        _TRANSITIONS_TOTAL.labels(plane, to).inc()
        with self._lock:
            key = (plane, to)
            self.transitions[key] = self.transitions.get(key, 0) + 1
        stage = getattr(self._tls, "transitions", None)
        if stage is not None:
            stage.append((plane, bucket, to))

    def _drain_transitions(self, journal, slot):
        stage = getattr(self._tls, "transitions", None)
        if not stage:
            return
        events, stage[:] = list(stage), []
        if journal is None:
            return
        for plane, bucket, to in events:
            journal.emit(
                "device_fault",
                slot=slot,
                outcome=f"breaker_{to}",
                plane=plane,
                bucket=bucket,
            )

    # -------------------------------------------------------------- reaper

    def _abandon(self, worker, plane):
        with self._lock:
            self._abandoned.append((worker, plane))
            if self._reaper is None or not self._reaper.is_alive():
                self._reaper = threading.Thread(
                    target=self._reap_loop,
                    name="device-plane-reaper",
                    daemon=True,
                )
                self._reaper.start()

    def _reap_loop(self):
        """Join abandoned dispatch threads off every caller's critical
        path; a late completion is a fault-kind of its own (`reaped`) —
        the wedge eventually cleared, which the post-mortem wants to
        know."""
        while True:
            with self._lock:
                pending = list(self._abandoned)
                if not pending:
                    self._reaper = None
                    return
            for worker, plane in pending:
                worker.join(0.05)
                if worker.is_alive():
                    continue
                _FAULTS_TOTAL.labels(plane, "reaped").inc()
                with self._lock:
                    if (worker, plane) in self._abandoned:
                        self._abandoned.remove((worker, plane))
                    self.reaped += 1
                    key = (plane, "reaped")
                    self.faults[key] = self.faults.get(key, 0) + 1
            time.sleep(0.05)

    # ------------------------------------------------------------ selftest

    def self_test(self, planes=DEFAULT_SELFTEST_PLANES, journal=None):
        """Startup known-answer check per plane against the sentinel
        vectors (``canary.py``): the valid sentinel must verify, the
        invalid one must not. A failing plane is quarantined before it
        can mis-verify live traffic. Returns {plane: ok}."""
        from lighthouse_tpu_torch.device_plane import canary

        self._tls.transitions = []
        results = {}
        try:
            for plane in planes:
                try:
                    ok = canary.self_test_plane(plane)
                # a crashing self-test IS a failed self-test — quarantined below, never fatal at boot
                except Exception:
                    ok = False
                results[plane] = ok
                self.selftest_results[plane] = ok
                if ok:
                    if journal is not None:
                        journal.emit(
                            "device_fault",
                            outcome="selftest_ok",
                            plane=plane,
                        )
                    continue
                self._note_fault(plane, "-", "selftest", journal, None)
                self.breaker.quarantine(plane)
                self._drain_transitions(journal, None)
                if journal is not None:
                    journal.emit(
                        "device_fault",
                        outcome="selftest_failed",
                        plane=plane,
                    )
            return results
        finally:
            self._tls.transitions = None

    # --------------------------------------------------------------- stats

    def stats(self) -> dict:
        with self._lock:
            faults = {
                f"{plane}:{kind}": n
                for (plane, kind), n in sorted(self.faults.items())
            }
            transitions = {
                f"{plane}:{to}": n
                for (plane, to), n in sorted(self.transitions.items())
            }
            abandoned = len(self._abandoned)
            dispatches = self.dispatches
            reaped = self.reaped
        return {
            "enabled": self.enabled,
            "watchdog": self.watchdog,
            "canary": self.canary_mode,
            "selftest": dict(self.selftest_results),
            "breaker": {
                "threshold": self.breaker.threshold,
                "cooldown_s": self.breaker.cooldown_s,
                "state": self.breaker.snapshot(),
            },
            "dispatches": dispatches,
            "faults": faults,
            "transitions": transitions,
            "abandoned": abandoned,
            "reaped": reaped,
        }


GUARD = GuardedExecutor()
