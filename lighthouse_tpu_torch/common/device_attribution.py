"""Per-consumer device-plane attribution: who pays the batch boundary.

The port's copy of `lighthouse_tpu/common/device_attribution.py`, with the
same consumer vocabulary and metric names. Every BLS signature goes
through ONE batch boundary (`verify_signature_sets`), shared by very
different consumers (gossip batches, sync segments, sidecar header checks,
op-pool revalidation, the slasher, benches); this module records which
consumer pays a dispatch's fixed device cost alone, how often, and how
many padding lanes it wastes doing so:

  * ``lighthouse_tpu_device_batches_total{consumer,plane,lanes}`` — one
    inc per dispatched batch; `lanes` is the bucketed device lane count
    (``host`` for the ref/fake backends, which have no padding).
  * ``lighthouse_tpu_device_sets_total{consumer}`` — signature sets
    entering the BLS plane per consumer.
  * ``lighthouse_tpu_device_seconds{consumer,plane}`` — device (or
    host-verify) wall time per batch.
  * padding waste: ``device_padding_waste_lanes`` (last batch, gauge),
    ``device_waste_lanes_total`` / ``device_live_lanes_total``
    (cumulative; waste fraction = waste / (waste + live)).
  * ``lighthouse_tpu_device_amortized_fixed_ms{consumer,plane}`` — the
    fixed-cost amortization estimate for the LAST batch:
    FIXED_DEVICE_COST_MS divided by the batch's live sets. A consumer
    whose gauge sits near FIXED_DEVICE_COST_MS pays the whole dispatch
    alone.

Consumer labels are a CLOSED vocabulary (`CONSUMERS`); `normalize`
raises on anything else, so a typo cannot misattribute silently.

`note_batch` also records the batch's economics in a THREAD-LOCAL
pending list so the dispatching API layer (bls/api, which owns the
journal emission) can attach exact lanes/waste numbers to the
`signature_batch` journal event without racing other threads' batches.
"""

import threading

from lighthouse_tpu_torch.common.metrics import REGISTRY

# the closed consumer vocabulary — every device-plane call site names
# one of these (None normalizes to "unattributed")
CONSUMERS = frozenset(
    {
        "gossip_single",   # gossip object batches (blocks, atts, sync msgs)
        "sync_segment",    # range-sync / backfill bulk segment batches
        "sidecar_header",  # blob-sidecar proposer-header checks
        "oppool",          # op-pool / aggregation revalidation
        "kzg",             # KZG proof verification + producer MSMs
        "da_cells",        # DA sampling plane: RS extension + cell proofs
        "slasher",         # slashing-proof verification
        "light_client",    # light-client update production + sim actor
        "bench",           # benchmarks and measurement harnesses
    }
)
UNATTRIBUTED = "unattributed"

# fixed device cost of one batch dispatch on the card, in ms: the device
# time (`gpu_backend.LAST_HOST_STATS["device_ms"]`: the launch and the
# verdict's read, host clock; p50 of 5) of a 4-set batch, the smallest
# bucket, as chip_smoke.py's ingest phase measures it: 11.42 ms on an NVIDIA
# H100 80GB HBM3 at a 700.00 W power limit
FIXED_DEVICE_COST_MS = 11.4

_BATCHES = REGISTRY.counter_vec(
    "lighthouse_tpu_device_batches_total",
    "device-plane batch dispatches by consumer, plane, and bucketed "
    "lane count (lanes='host' for ref/fake backends)",
    ("consumer", "plane", "lanes"),
)
_SETS = REGISTRY.counter_vec(
    "lighthouse_tpu_device_sets_total",
    "signature sets entering the BLS verification plane, by consumer",
    ("consumer",),
)
_SECONDS = REGISTRY.histogram_vec(
    "lighthouse_tpu_device_seconds",
    "per-batch device (or host-verify) wall time by consumer and plane",
    ("consumer", "plane"),
)
_WASTE_GAUGE = REGISTRY.gauge_vec(
    "lighthouse_tpu_device_padding_waste_lanes",
    "padding lanes (bucket minus live sets) of the LAST batch",
    ("consumer", "plane"),
)
_WASTE_TOTAL = REGISTRY.counter_vec(
    "lighthouse_tpu_device_waste_lanes_total",
    "cumulative padding lanes dispatched (bucket minus live sets)",
    ("consumer", "plane"),
)
_LIVE_TOTAL = REGISTRY.counter_vec(
    "lighthouse_tpu_device_live_lanes_total",
    "cumulative live lanes dispatched (the waste denominator partner)",
    ("consumer", "plane"),
)
_AMORTIZED = REGISTRY.gauge_vec(
    "lighthouse_tpu_device_amortized_fixed_ms",
    "estimated fixed-device-cost share per live set of the LAST batch "
    "(FIXED_DEVICE_COST_MS / live sets)",
    ("consumer", "plane"),
)
_AMORTIZED_TOTAL = REGISTRY.counter_vec(
    "lighthouse_tpu_device_amortized_fixed_ms_total",
    "cumulative modeled fixed-cost milliseconds paid per consumer: each "
    "dispatched batch charges its contributors live_sets x "
    "(FIXED_DEVICE_COST_MS / batch live sets). Counted for host "
    "backends too (what the dispatch WOULD pay on device), so bus "
    "on/off A/B comparisons run off-hardware",
    ("consumer", "plane"),
)

_TLS = threading.local()


def normalize(consumer) -> str:
    """None -> 'unattributed'; unknown labels raise (fail-loud, the
    bench exit-4 convention — a typo must not silently misattribute)."""
    if consumer is None or consumer == UNATTRIBUTED:
        return UNATTRIBUTED
    if consumer not in CONSUMERS:
        raise ValueError(
            f"unknown device-plane consumer {consumer!r} "
            f"(one of {sorted(CONSUMERS)} or None)"
        )
    return consumer


def note_sets(consumer, n: int) -> str:
    """Count `n` signature sets entering the BLS plane; returns the
    normalized consumer label."""
    consumer = normalize(consumer)
    _SETS.labels(consumer).inc(n)
    return consumer


def begin_batch_window():
    """Open this thread's batch-economics window — the BLS api layer
    calls it before dispatching so `take_batches` returns exactly the
    batches of the call it wraps. Outside an open window `note_batch`
    records metrics only (a no-window append would leak one dict per
    batch on threads that never drain)."""
    _TLS.pending = []
    _TLS.shared = None


def begin_shared_window(contributions):
    """Open a batch window for ONE dispatch shared by several consumers
    (`bls.api.verify_signature_sets_shared`): `contributions` is a
    list of (consumer, live_sets). The next `note_batch` on this thread
    fans its accounting out per contributor — participation-counted
    batches, proportional device seconds and waste, and the SHARED
    amortized fixed cost (FIXED_DEVICE_COST_MS / total live) that is
    the whole point of coalescing."""
    _TLS.pending = []
    _TLS.shared = [
        (normalize(c), int(n)) for c, n in contributions
    ]


def take_batches() -> list:
    """Drain this thread's pending batch-economics records (one dict
    per `note_batch` since `begin_batch_window`) and CLOSE the
    window."""
    out = getattr(_TLS, "pending", None) or []
    _TLS.pending = None
    _TLS.shared = None
    return out


def note_batch(
    consumer,
    plane: str,
    lanes,
    live: int,
    duration_s: float | None = None,
):
    """Record one dispatched batch: counters, waste/amortization
    gauges, and the thread-local pending record for journal attrs.

    `lanes` is the bucketed lane count (int) or None for host backends
    (no padding concept — counted under lanes='host', no waste).

    Inside a `begin_shared_window` the single-consumer arguments are
    advisory: accounting fans out over the window's contributions."""
    shared = getattr(_TLS, "shared", None)
    if shared:
        return _note_shared_batch(shared, plane, lanes, live, duration_s)
    consumer = normalize(consumer)
    lanes_label = "host" if lanes is None else str(int(lanes))
    _BATCHES.labels(consumer, plane, lanes_label).inc()
    record = {
        "consumer": consumer,
        "plane": plane,
        "lanes": None if lanes is None else int(lanes),
        "live": int(live),
    }
    if duration_s is not None:
        _SECONDS.labels(consumer, plane).observe(duration_s)
        record["duration_s"] = duration_s
    amortized = FIXED_DEVICE_COST_MS / max(1, int(live))
    # a solo batch pays the WHOLE modeled fixed cost, however many live
    # sets amortize it: live x (fixed / live)
    _AMORTIZED_TOTAL.labels(consumer, plane).inc(FIXED_DEVICE_COST_MS)
    if lanes is not None:
        waste = max(0, int(lanes) - int(live))
        _WASTE_GAUGE.labels(consumer, plane).set(waste)
        _WASTE_TOTAL.labels(consumer, plane).inc(waste)
        _LIVE_TOTAL.labels(consumer, plane).inc(int(live))
        _AMORTIZED.labels(consumer, plane).set(amortized)
        record["waste"] = waste
    record["amortized_fixed_ms"] = round(amortized, 3)
    pending = getattr(_TLS, "pending", None)
    if pending is not None:  # window open: the api layer will drain
        pending.append(record)
    return record


def _note_shared_batch(contributions, plane, lanes, live, duration_s):
    """Fan one dispatched batch's accounting out over its contributing
    consumers: each contributor is charged its PROPORTIONAL share of
    device seconds and padding waste, participation-counted in
    `device_batches_total`, and credited the SHARED amortized fixed
    cost (fixed / total live — the number coalescing exists to
    shrink)."""
    total = sum(n for _, n in contributions)
    total = max(1, total)
    lanes_label = "host" if lanes is None else str(int(lanes))
    waste = max(0, int(lanes) - total) if lanes is not None else None
    amortized = FIXED_DEVICE_COST_MS / total
    record = {
        "consumer": None,
        "consumers": list(contributions),
        "plane": plane,
        "lanes": None if lanes is None else int(lanes),
        "live": int(live),
        "amortized_fixed_ms": round(amortized, 3),
    }
    if waste is not None:
        record["waste"] = waste
    if duration_s is not None:
        record["duration_s"] = duration_s
    for consumer, n in contributions:
        share = n / total
        _BATCHES.labels(consumer, plane, lanes_label).inc()
        if duration_s is not None:
            _SECONDS.labels(consumer, plane).observe(duration_s * share)
        _AMORTIZED_TOTAL.labels(consumer, plane).inc(amortized * n)
        if lanes is not None:
            _WASTE_GAUGE.labels(consumer, plane).set(waste)
            _WASTE_TOTAL.labels(consumer, plane).inc(waste * share)
            _LIVE_TOTAL.labels(consumer, plane).inc(n)
            _AMORTIZED.labels(consumer, plane).set(amortized)
    pending = getattr(_TLS, "pending", None)
    if pending is not None:
        pending.append(record)
    return record


def observe_seconds(consumer, plane: str, seconds: float):
    """Record wall time against a consumer without a batch record (the
    streamed multi-batch path: per-batch device time is hidden by the
    double-buffered overlap, so the whole call observes once)."""
    _SECONDS.labels(normalize(consumer), plane).observe(seconds)


def amortized_totals() -> dict:
    """{(consumer, plane): cumulative modeled fixed-cost ms} from the
    registry."""
    out = {}
    for key, child in _AMORTIZED_TOTAL.children().items():
        out[key] = child.value
    return out


def consumer_totals() -> dict:
    """{consumer: cumulative sets} from the registry, the per-consumer
    throughput read (no series creation side effect)."""
    out = {}
    for (consumer,), child in _SETS.children().items():
        out[consumer] = child.value
    return out
