"""Lightweight wall-clock span tracer for the data plane.

The port's copy of `lighthouse_tpu/common/tracing.py`, with the same span
names and metric names: `with span("verify/miller_loop", n_sets=...)`
records a nested wall-clock span. Completed ROOT spans land in a bounded
ring buffer (oldest evicted), exportable as JSONL, one span tree per line.

Spans are also mirrored into registry histograms so the `/metrics` scrape
carries per-stage latency without a second instrumentation pass:

  * ``<family>/<stage>`` -> ``lighthouse_tpu_<family>_stage_seconds{stage="<stage>"}``
    for the known family, verify;
  * anything else        -> ``lighthouse_tpu_span_seconds{span="<name>"}``
    (leaves only).

Span taxonomy of the verify path:

  verify                          one verify_signature_sets batch (root)
    verify/subgroup_check         host signature subgroup policy
    verify/hash_to_curve          message hashing (ref path, per set)
    verify/pubkey_aggregation     host G1 aggregation (ref path)
    verify/to_affine              Jacobian -> affine conversion (ref path)
    verify/miller_loop            ref-backend Miller loop
    verify/final_exp              ref-backend final exponentiation
    verify/marshal                gpu-backend host marshalling
      verify/marshal/points       message memo + the lanes' point lists
      verify/marshal/pack         word, mask and table-index packing
    verify/rlc_sample             RLC scalar sampling
    verify/device                 device launch + verdict read (uploads
                                  and kernels; the read waits for them)

A span times host wall clock: on the card, a span ends when its host work
does, and only a span that reads a device value (verify/device) includes
the device time before it.

Nesting is tracked per thread; a span closed on one thread never
corrupts another thread's stack. The tracer is enabled by default with
a small ring (256 roots); `configure()` resizes or disables span-tree
buffering. Disabling only stops tree retention: stage spans still time
their bodies and mirror into the histograms, so the /metrics scrape never
goes dark.
"""

import json
import threading
import time
from collections import deque
from contextlib import contextmanager

from lighthouse_tpu_torch.common.metrics import REGISTRY

# sub-millisecond stages (single field ops) up to multi-second batches
STAGE_BUCKETS = (
    0.0001, 0.0005, 0.001, 0.005, 0.01, 0.05, 0.1, 0.5,
    1.0, 5.0, 30.0,
)

_STAGE_FAMILIES = {
    "verify": REGISTRY.histogram_vec(
        "lighthouse_tpu_verify_stage_seconds",
        "per-stage wall time of the signature-verification data plane",
        ("stage",),
        buckets=STAGE_BUCKETS,
    ),
}

_SPAN_FALLBACK = REGISTRY.histogram_vec(
    "lighthouse_tpu_span_seconds",
    "leaf span wall time for spans outside the stage families",
    ("span",),
    buckets=STAGE_BUCKETS,
)

DEFAULT_CAPACITY = 256
MAX_CHILDREN_PER_SPAN = 512


class Span:
    __slots__ = ("name", "wall_start", "duration_s", "attrs", "children")

    def __init__(self, name: str, attrs: dict):
        self.name = name
        self.wall_start = time.time()
        self.duration_s = 0.0
        self.attrs = attrs
        self.children: list = []

    def to_dict(self) -> dict:
        out = {
            "name": self.name,
            "wall_start": self.wall_start,
            "duration_s": self.duration_s,
        }
        if self.attrs:
            out["attrs"] = self.attrs
        out["children"] = [c.to_dict() for c in self.children]
        return out

    def leaves(self):
        if not self.children:
            return [self]
        return [l for c in self.children for l in c.leaves()]


class Tracer:
    def __init__(self, capacity: int = DEFAULT_CAPACITY, enabled=True):
        self.enabled = enabled
        self._lock = threading.Lock()
        self._roots: deque = deque(maxlen=max(1, capacity))
        self._local = threading.local()
        self.completed_roots = 0

    # ------------------------------------------------------- configuration

    @property
    def capacity(self) -> int:
        return self._roots.maxlen

    def configure(self, enabled=None, capacity=None):
        with self._lock:
            if enabled is not None:
                self.enabled = bool(enabled)
            if capacity is not None:
                self._roots = deque(
                    self._roots, maxlen=max(1, int(capacity))
                )

    def reset(self):
        with self._lock:
            self._roots.clear()
            self.completed_roots = 0

    # ------------------------------------------------------------- spans

    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    @contextmanager
    def span(self, name: str, **attrs):
        if not self.enabled:
            # ring disabled: no tree retention, but the stage-family
            # histograms keep recording — /metrics must not go dark
            # because an operator turned off span buffering
            t0 = time.perf_counter()
            try:
                yield None
            finally:
                self._mirror_duration(
                    name, time.perf_counter() - t0, leaf=False
                )
            return
        s = Span(name, attrs)
        stack = self._stack()
        stack.append(s)
        t0 = time.perf_counter()
        try:
            yield s
        finally:
            s.duration_s = time.perf_counter() - t0
            stack.pop()
            if stack:
                parent = stack[-1]
                # bound tree size: a 30k-set ref batch would otherwise
                # pin ~6 Span objects per set in one root
                if len(parent.children) < MAX_CHILDREN_PER_SPAN:
                    parent.children.append(s)
                else:
                    parent.attrs["children_dropped"] = (
                        parent.attrs.get("children_dropped", 0) + 1
                    )
            else:
                with self._lock:
                    self._roots.append(s)
                    self.completed_roots += 1
            self._mirror(s)

    def _mirror(self, s: Span):
        self._mirror_duration(s.name, s.duration_s, leaf=not s.children)

    def _mirror_duration(self, name: str, duration_s: float, leaf: bool):
        """Span -> registry histogram (taxonomy in the module doc).
        Every stage span (name contains '/') is mirrored — including
        parents like verify/marshal or import/block_processing, whose
        children land in their own stage series — while family-less
        spans are mirrored only as leaves (roots such as 'verify'
        already have dedicated batch histograms)."""
        if "/" in name:
            family, stage = name.split("/", 1)
            fam = _STAGE_FAMILIES.get(family)
            if fam is not None:
                fam.labels(stage).observe(duration_s)
                return
        if leaf:
            _SPAN_FALLBACK.labels(name).observe(duration_s)

    # ------------------------------------------------------------ export

    def recent(self, limit: int | None = None) -> list[dict]:
        """Most recent root span trees, oldest first; limit=0 is empty
        (roots[-0:] would be the whole deque)."""
        with self._lock:
            roots = list(self._roots)
        if limit is not None and limit >= 0:
            roots = roots[-limit:] if limit else []
        return [r.to_dict() for r in roots]

    def to_jsonl(self, limit: int | None = None) -> str:
        docs = self.recent(limit)
        if not docs:
            return ""
        return "\n".join(json.dumps(d) for d in docs) + "\n"

    def export_jsonl(self, path, limit: int | None = None) -> int:
        """Write the buffered span trees to `path`; returns tree count."""
        docs = self.recent(limit)
        with open(path, "w") as f:
            for d in docs:
                f.write(json.dumps(d) + "\n")
        return len(docs)


TRACER = Tracer()


def span(name: str, **attrs):
    """`with span("verify/miller_loop", n_sets=8):` on the default tracer."""
    return TRACER.span(name, **attrs)


def configure(enabled=None, capacity=None):
    TRACER.configure(enabled=enabled, capacity=capacity)
