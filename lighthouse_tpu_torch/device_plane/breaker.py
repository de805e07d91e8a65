"""Per-(plane, shape-bucket) circuit breaker for device dispatches.

The port's copy of `lighthouse_tpu/device_plane/breaker.py`, unchanged in
behaviour. The port has no failover tier: where the reference fails over,
the port's executor raises `DeviceFaultError` without touching the card.

Classic closed/open/half-open discipline, keyed the way the device
plane actually fails: a wedged or mis-built kernel launch is specific
to one (plane, shape-bucket) program, so one poisoned shape class must
not take down every other bucket's healthy dispatches. A plane-wide
QUARANTINE key (``(plane, "*")``) exists on top for the failures that
ARE plane-wide — a wrong canary verdict means the device is corrupting
results and no bucket of that plane can be trusted.

States per key:

  closed     — dispatches flow; `failures` consecutive faults open it.
  open       — dispatches skip the device (DeviceFaultError) until
               `cooldown_s` elapses, then the key turns half-open.
  half_open  — exactly ONE probe dispatch is admitted (single-probe
               discipline: concurrent callers race `allow`, one wins,
               the rest are refused); probe success closes the key,
               probe failure re-opens it with a fresh cooldown.

The clock is injectable (tests drive transitions without sleeping) and
every transition is reported to the owner's `on_transition` hook so the
executor can count it and journal it.
"""

import threading
import time

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"

DEFAULT_THRESHOLD = 3
DEFAULT_COOLDOWN_S = 30.0

# the plane-wide quarantine bucket key
QUARANTINE_BUCKET = "*"


class _KeyState:
    __slots__ = ("state", "failures", "opened_at", "probe_claimed")

    def __init__(self):
        self.state = CLOSED
        self.failures = 0
        self.opened_at = 0.0
        self.probe_claimed = False


class CircuitBreaker:
    def __init__(
        self,
        threshold: int = DEFAULT_THRESHOLD,
        cooldown_s: float = DEFAULT_COOLDOWN_S,
        clock=time.monotonic,
        on_transition=None,
    ):
        self.threshold = int(threshold)
        self.cooldown_s = float(cooldown_s)
        self._clock = clock
        self._on_transition = on_transition
        self._lock = threading.Lock()
        self._keys: dict[tuple, _KeyState] = {}

    # ------------------------------------------------------------ internals

    def _state(self, plane: str, bucket: str) -> _KeyState:
        key = (plane, bucket)
        st = self._keys.get(key)
        if st is None:
            st = self._keys[key] = _KeyState()
        return st

    def _transition(self, plane, bucket, st: _KeyState, to: str):
        st.state = to
        if to == OPEN:
            st.opened_at = self._clock()
            st.probe_claimed = False
        elif to == CLOSED:
            st.failures = 0
            st.probe_claimed = False
        if self._on_transition is not None:
            self._on_transition(plane, bucket, to)

    def _allow_locked(self, plane, bucket, st: _KeyState) -> bool:
        if st.state == CLOSED:
            return True
        if st.state == OPEN:
            if self._clock() - st.opened_at < self.cooldown_s:
                return False
            self._transition(plane, bucket, st, HALF_OPEN)
        # half-open: admit exactly one probe
        if st.probe_claimed:
            return False
        st.probe_claimed = True
        return True

    # --------------------------------------------------------------- public

    def allow(self, plane: str, bucket: str) -> bool:
        """May a dispatch for (plane, bucket) touch the device? Checks
        the plane-wide quarantine key FIRST — a quarantined plane
        rejects every bucket (except its own recovery probe)."""
        with self._lock:
            q = self._keys.get((plane, QUARANTINE_BUCKET))
            if q is not None and q.state != CLOSED:
                # recovery from quarantine rides the quarantine key's
                # own half-open probe, whatever bucket carries it
                return self._allow_locked(plane, QUARANTINE_BUCKET, q)
            return self._allow_locked(plane, bucket, self._state(plane, bucket))

    def record_success(self, plane: str, bucket: str):
        with self._lock:
            for b in (QUARANTINE_BUCKET, bucket):
                st = self._keys.get((plane, b))
                if st is None:
                    continue
                if st.state == HALF_OPEN:
                    self._transition(plane, b, st, CLOSED)
                elif st.state == CLOSED:
                    st.failures = 0

    def record_failure(self, plane: str, bucket: str):
        with self._lock:
            q = self._keys.get((plane, QUARANTINE_BUCKET))
            if q is not None and q.state == HALF_OPEN:
                self._transition(plane, QUARANTINE_BUCKET, q, OPEN)
                return
            st = self._state(plane, bucket)
            if st.state == HALF_OPEN:
                self._transition(plane, bucket, st, OPEN)
                return
            st.failures += 1
            if st.state == CLOSED and st.failures >= self.threshold:
                self._transition(plane, bucket, st, OPEN)

    def quarantine(self, plane: str):
        """Plane-wide trip — a wrong canary verdict or failed known-
        answer self-test means NO bucket of this plane can be trusted."""
        with self._lock:
            st = self._state(plane, QUARANTINE_BUCKET)
            if st.state != OPEN:
                self._transition(plane, QUARANTINE_BUCKET, st, OPEN)

    def state_of(self, plane: str, bucket: str) -> str:
        with self._lock:
            q = self._keys.get((plane, QUARANTINE_BUCKET))
            if q is not None and q.state != CLOSED:
                return q.state
            st = self._keys.get((plane, bucket))
            return st.state if st is not None else CLOSED

    def snapshot(self) -> dict:
        """{"plane/bucket": state} for every non-closed (or previously
        tripped) key — the health-plane view."""
        with self._lock:
            return {
                f"{plane}/{bucket}": st.state
                for (plane, bucket), st in self._keys.items()
            }

    def reset(self):
        with self._lock:
            self._keys.clear()
