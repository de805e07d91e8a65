"""Deterministic device-fault injection: a seeded FaultyDevice layer.

The port's copy of `lighthouse_tpu/device_plane/faults.py`: every
injection decision is a pure function of ``(seed, kind, plane, bucket,
dispatch-ordinal)`` -- the same sha256 over the same string -- so one
seeded schedule injects the same faults into the same dispatches in both
packages, and tests can assert the exact decisions without running
anything.

Kinds (the card's failure modes the guarded executor must survive):

  stall         -- the dispatch never returns (a wedged launch: a kernel
                  that does not finish, or a host thread stuck in the
                  driver): injected as an immediate DeviceStallInjected
                  so tests exercise the fault path without sleeping out
                  real watchdog timeouts.
  error         -- the dispatch raises (a refused launch: a C entry
                  returning a CUDA error, an illegal address).
  flip          -- the card completes but LIES: every verdict produced
                  by the dispatch is inverted (silent corruption; the
                  canary contract exists to catch exactly this).
  slow_compile  -- the dispatch takes an injected extra delay (the
                  first-use nvcc build of `ops/cuda_build.py`, bounded
                  below the watchdog's cold allowance).

The injector is process-global (`INJECTOR`) because the device plane
is: one card, one set of loaded kernel libraries. Tests arm and disarm
specs; production never arms anything.
"""

import hashlib
import threading

KINDS = ("stall", "error", "flip", "slow_compile")

# injected slow_compile delay (seconds) — long enough to be visible in
# wall accounting, far below any watchdog cold allowance
SLOW_COMPILE_DELAY_S = 0.05


def decide(seed: int, kind: str, plane: str, bucket: str, ordinal: int,
           rate: float) -> bool:
    """THE purity contract: sha256 of the identity tuple against the
    rate. rate >= 1.0 always fires; rate <= 0.0 never does."""
    if rate >= 1.0:
        return True
    if rate <= 0.0:
        return False
    digest = hashlib.sha256(
        f"{seed}:dev:{kind}:{plane}:{bucket}:{ordinal}".encode()
    ).digest()
    return int.from_bytes(digest[:8], "big") / float(1 << 64) < rate


class _Spec:
    __slots__ = ("kind", "plane", "rate", "seed")

    def __init__(self, kind: str, plane: str, rate: float, seed: int):
        self.kind = kind
        self.plane = plane
        self.rate = float(rate)
        self.seed = int(seed)


class FaultInjector:
    def __init__(self):
        self._lock = threading.Lock()
        self._specs: list[_Spec] = []
        self._ordinals: dict[tuple, int] = {}
        # per-kind injected counters (the FaultyRpc convention)
        self.injected: dict[str, int] = {k: 0 for k in KINDS}

    def arm(self, kind: str, plane: str, rate: float = 1.0,
            seed: int = 0):
        if kind not in KINDS:
            raise ValueError(
                f"unknown device fault kind {kind!r} (one of {KINDS})"
            )
        with self._lock:
            self._specs.append(_Spec(kind, plane, rate, seed))

    def disarm(self, kind: str | None = None, plane: str | None = None):
        """Remove matching specs (None matches everything)."""
        with self._lock:
            self._specs = [
                s for s in self._specs
                if not (
                    (kind is None or s.kind == kind)
                    and (plane is None or s.plane == plane)
                )
            ]

    def armed(self) -> bool:
        with self._lock:
            return bool(self._specs)

    def plan(self, plane: str, bucket: str) -> frozenset:
        """Consume one dispatch ordinal for (plane, bucket) and return
        the fault kinds injected into THIS dispatch. The ordinal only
        advances while something is armed, so production dispatches pay
        one lock acquisition and no hashing."""
        with self._lock:
            if not self._specs:
                return frozenset()
            key = (plane, bucket)
            ordinal = self._ordinals.get(key, 0)
            self._ordinals[key] = ordinal + 1
            kinds = set()
            for s in self._specs:
                if s.plane != plane or s.kind in kinds:
                    continue
                if decide(s.seed, s.kind, plane, bucket, ordinal, s.rate):
                    kinds.add(s.kind)
                    self.injected[s.kind] += 1
            return frozenset(kinds)

    def reset(self):
        with self._lock:
            self._specs = []
            self._ordinals = {}
            self.injected = {k: 0 for k in KINDS}


INJECTOR = FaultInjector()
