"""Predicted batch-wall model: what will this dispatch cost on the card?

The port of `lighthouse_tpu/verification_bus/wall_model.py`. The bus
flushes when the earliest queued deadline's slack falls below the
predicted wall of the batch it would form — so the prediction IS the
scheduling policy. Three information sources, best-first:

  1. **Observed walls** (learned): every bus dispatch feeds the model
     its (live sets, wall seconds); an EMA per pow2 lane bucket tracks
     the measured cost of exactly the shapes this process dispatches.
  2. **The card's build** (cold risk): the kernels take any shape once
     built, so the one cold case is the first use in a process, which
     builds every kernel with nvcc (`ops/cuda_build.py`). Until a kernel
     library is loaded, a bucket the bus has not dispatched is charged
     the build's wall.
  3. **The card's scaling model** (seed): FIXED_DEVICE_COST_MS, one
     dispatch of the smallest bucket, plus PER_SET_COST_S a live set,
     both measured by `chip_smoke.py` on an NVIDIA H100 80GB HBM3 at a
     700 W power limit (PERF.md §5) — the prior before any observation.

Host backends (ref/fake) observe their verify walls through the same
interface, so the model stays meaningful off the card: it predicts
whatever boundary it watched.
"""

import threading

from lighthouse_tpu_torch.common.device_attribution import FIXED_DEVICE_COST_MS
from lighthouse_tpu_torch.ops import cuda_build

# the card's marginal cost of one live set: the grouped slot's wall p50
# less the fixed dispatch cost, over its 30,720 sets, as chip_smoke.py's
# wall_model line measures it on an NVIDIA H100 80GB HBM3 at a 700 W power
# limit: (226.8 ms - 11.2 ms) / 30,720
PER_SET_COST_S = 7.02e-6
# EMA smoothing for per-bucket observed walls
EMA_ALPHA = 0.3
# the first use's nvcc build of every kernel, seconds: chip_smoke.py's
# build line, 29.1 s and 34.3 s in two runs on an 8-core host
DEFAULT_COLD_PENALTY_S = 30.0


def _bucket(n: int) -> int:
    """Pow2 lane bucket — the same bucketing the gpu marshal applies."""
    b = 1
    n = max(1, int(n))
    while b < n:
        b <<= 1
    return b


class PredictedWallModel:
    """EMA-per-bucket wall predictor seeded from the card's scaling
    model, with the build as its cold risk."""

    def __init__(
        self,
        fixed_s: float = FIXED_DEVICE_COST_MS / 1e3,
        per_set_s: float = PER_SET_COST_S,
    ):
        self.fixed_s = fixed_s
        self.per_set_s = per_set_s
        self._lock = threading.Lock()
        self._ema: dict[int, float] = {}
        self._seen: set[int] = set()
        self.observations = 0

    def observe(self, live: int, wall_s: float):
        """Feed one completed dispatch's (live sets, wall seconds)."""
        if wall_s is None or wall_s < 0:
            return
        b = _bucket(live)
        with self._lock:
            prev = self._ema.get(b)
            self._ema[b] = (
                wall_s
                if prev is None
                else prev + EMA_ALPHA * (wall_s - prev)
            )
            self._seen.add(b)
            self.observations += 1

    def _cold_penalty(self, bucket: int) -> float:
        """Extra seconds when `bucket` was never dispatched by this bus
        and no kernel library is loaded yet: the dispatch will wait for
        the nvcc build."""
        with self._lock:
            if bucket in self._seen:
                return 0.0
        return 0.0 if cuda_build.loaded() else DEFAULT_COLD_PENALTY_S

    def predict_s(self, live: int, cold_risk: bool = False) -> float:
        """Predicted wall seconds for a batch of `live` sets. With
        `cold_risk` the build penalty is added — the deadline-flush
        decision uses it, the amortization math never does."""
        b = _bucket(live)
        with self._lock:
            ema = self._ema.get(b)
        base = (
            ema
            if ema is not None
            else self.fixed_s + self.per_set_s * max(1, int(live))
        )
        if cold_risk:
            base += self._cold_penalty(b)
        return base

    def stats(self) -> dict:
        with self._lock:
            return {
                "observations": self.observations,
                "buckets": {
                    str(b): round(v, 6)
                    for b, v in sorted(self._ema.items())
                },
                "seed_fixed_ms": round(self.fixed_s * 1e3, 3),
                "seed_per_set_us": round(self.per_set_s * 1e6, 3),
            }
