"""Device-plane fault domain of the port: the guarded executor every
dispatch to the card crosses.

The port of `lighthouse_tpu/device_plane/`, without the failover tier:

  * ``breaker``   — per-(plane, shape-bucket) closed/open/half-open
                    circuit breaker with plane-wide quarantine;
  * ``faults``    — deterministic seeded device-fault injection
                    (stall / error / flip-verdict / slow-compile), a
                    pure function of (seed, plane, bucket, ordinal),
                    the same decisions as the reference's;
  * ``executor``  — the guarded executor: watchdog-timed dispatches
                    abandoned to a reaper thread on timeout, fault
                    metrics and ``device_fault`` journal events; a fault
                    reaches the caller as a ``DeviceFaultError``;
  * ``canary``    — the bls known-answer sentinel pair for
                    canary-verified bus batches and slot programs, and
                    the bls, kzg and merkle_proof pairs of the startup
                    self-test.

Callers reach everything through the process-global ``GUARD`` (one card,
one set of loaded kernel libraries).
"""

from lighthouse_tpu_torch.device_plane.breaker import CircuitBreaker
from lighthouse_tpu_torch.device_plane.executor import (
    GUARD,
    CanaryViolation,
    DeviceFaultError,
    DispatchHandle,
    GuardedExecutor,
    pow2_bucket,
)
from lighthouse_tpu_torch.device_plane.faults import INJECTOR, FaultInjector

__all__ = [
    "CircuitBreaker",
    "GUARD",
    "CanaryViolation",
    "DeviceFaultError",
    "DispatchHandle",
    "GuardedExecutor",
    "pow2_bucket",
    "INJECTOR",
    "FaultInjector",
]
