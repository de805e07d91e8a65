"""Timed locks: convert potential deadlocks into diagnosable errors.

The port of `lighthouse_tpu/common/locks.py`.

Role of beacon_chain.rs:104-111 — the reference guards its canonical-head
and snapshot locks with timeouts (`LOCK_TIMEOUT`) so a lock-ordering bug
surfaces as an error naming the lock instead of a frozen process. The
repo's threaded surface (socket reader threads, the beacon processor,
SSE fan-out, KV batches) gets the same discipline: `TimedLock` is a
drop-in `threading.Lock` replacement whose context manager raises
`LockTimeoutError` — carrying the lock's name and the holder's
acquisition site — after `timeout` seconds instead of blocking forever.

A timeout fires a metrics counter too (lock_timeouts_total), mirroring
the reference's BEACON_LOCK_TIMEOUT metrics.
"""

import threading
import time

# generous by default: these fire on real deadlocks/stalls, not on
# ordinary contention (the reference uses 1s for head locks; our Python
# critical sections can legitimately run longer under load)
DEFAULT_LOCK_TIMEOUT = 30.0


class LockTimeoutError(RuntimeError):
    pass


class TimedLock:
    """threading.Lock with a named, time-bounded context manager."""

    __slots__ = ("name", "timeout", "_lock", "_holder")

    def __init__(self, name: str, timeout: float = DEFAULT_LOCK_TIMEOUT):
        self.name = name
        self.timeout = timeout
        self._lock = threading.Lock()
        self._holder = None  # (thread name, site, acquired_at)

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        """threading.Lock-compatible signature — `threading.Condition`
        wraps its lock and probes ownership with `acquire(False)`, which
        must RETURN False, never raise. The deadlock-to-error behavior
        applies to blocking acquisitions (the context-manager path)."""
        if not blocking:
            ok = self._lock.acquire(False)
            if ok:
                self._note_holder()
            return ok
        limit = self.timeout if timeout in (-1, None) else timeout
        if not self._lock.acquire(timeout=limit):
            holder = self._holder
            from lighthouse_tpu_torch.common.metrics import REGISTRY

            REGISTRY.counter(
                "lighthouse_tpu_lock_timeouts_total",
                "TimedLock acquisitions that timed out",
            ).inc()
            held = (
                f"held by {holder[0]} (acquired at {holder[1]}, "
                f"{time.monotonic() - holder[2]:.1f}s ago)"
                if holder
                else "holder unknown"
            )
            raise LockTimeoutError(
                f"lock '{self.name}' not acquired within {limit}s; {held}"
            )
        self._note_holder()
        return True

    def _note_holder(self) -> None:
        import sys

        # walk out of this module so the recorded site is the CALLER's
        # (via `with lock:` the chain is _note_holder -> acquire ->
        # __enter__ -> caller; a direct acquire() skips __enter__)
        frame = sys._getframe(1)
        here = frame.f_code.co_filename
        while frame is not None and frame.f_code.co_filename == here:
            frame = frame.f_back
        site = (
            f"{frame.f_code.co_filename.rsplit('/', 1)[-1]}"
            f":{frame.f_lineno}"
            if frame is not None
            else "?"
        )
        self._holder = (
            threading.current_thread().name,
            site,
            time.monotonic(),
        )

    def release(self) -> None:
        self._holder = None
        self._lock.release()

    def locked(self) -> bool:
        return self._lock.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
