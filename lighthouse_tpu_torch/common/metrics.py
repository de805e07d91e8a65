"""Process-wide metrics registry with Prometheus text exposition.

The port's copy of `lighthouse_tpu/common/metrics.py` (the role of
common/lighthouse_metrics: lazy-static Prometheus registries,
start_timer/stop_timer histograms) — a dependency-free registry exposing
the same scrape format, with the same metric names.

Beyond the plain Counter/Gauge/Histogram, the registry carries LABELED
families (`CounterVec`/`GaugeVec`/`HistogramVec`): one registered name,
one child series per label-value tuple, rendered with the standard
`name{label="value"} v` exposition. Every metric family must be
registered exactly once per process (the registry raises on a
kind/label-schema conflict) and every name must match
`lighthouse_tpu_[a-z0-9_]+`.

Thread-safety: every mutation and every render path takes the owning
metric's lock; `Registry.render` snapshots the metric list under the
registry lock and then lets each metric render under its own lock, so a
scrape never races an observation.
"""

import threading
import time
from collections import defaultdict
from collections.abc import MutableMapping


def _escape_label_value(v) -> str:
    return (
        str(v)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


def _label_str(items) -> str:
    """((k, v), ...) -> '{k="v",...}' or '' for no labels."""
    items = tuple(items)
    if not items:
        return ""
    body = ",".join(
        f'{k}="{_escape_label_value(v)}"' for k, v in items
    )
    return "{" + body + "}"


class _Metric:
    def __init__(self, name: str, help_: str, kind: str):
        self.name = name
        self.help = help_
        self.kind = kind


class Counter(_Metric):
    def __init__(self, name, help_="", label_items=()):
        super().__init__(name, help_, "counter")
        self.value = 0.0
        self._labels = tuple(label_items)
        self._lock = threading.Lock()

    def inc(self, v: float = 1.0):
        with self._lock:
            self.value += v

    def render(self):
        with self._lock:
            return [f"{self.name}{_label_str(self._labels)} {self.value}"]


class Gauge(_Metric):
    def __init__(self, name, help_="", label_items=()):
        super().__init__(name, help_, "gauge")
        self.value = 0.0
        self._labels = tuple(label_items)
        self._lock = threading.Lock()

    def set(self, v: float):
        with self._lock:
            self.value = float(v)

    def inc(self, v: float = 1.0):
        with self._lock:
            self.value += v

    def dec(self, v: float = 1.0):
        self.inc(-v)

    def render(self):
        with self._lock:
            return [f"{self.name}{_label_str(self._labels)} {self.value}"]


class Histogram(_Metric):
    DEFAULT_BUCKETS = (
        0.001, 0.005, 0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0
    )

    def __init__(self, name, help_="", buckets=None, label_items=()):
        super().__init__(name, help_, "histogram")
        self.buckets = tuple(buckets or self.DEFAULT_BUCKETS)
        self.counts = defaultdict(int)
        self.total = 0.0
        self.n = 0
        self._labels = tuple(label_items)
        self._lock = threading.Lock()

    def observe(self, v: float):
        # counts[b] holds the CUMULATIVE count of observations <= b
        # (every bucket at or above v is bumped), matching the
        # Prometheus le-bucket contract directly.
        with self._lock:
            self.n += 1
            self.total += v
            for b in self.buckets:
                if v <= b:
                    self.counts[b] += 1

    def time(self):
        return _Timer(self)

    def _series(self, suffix: str, extra=()) -> str:
        return f"{self.name}{suffix}{_label_str(self._labels + tuple(extra))}"

    def render(self):
        with self._lock:
            out = [
                f'{self._series("_bucket", (("le", b),))} {self.counts[b]}'
                for b in self.buckets
            ]
            out.append(f'{self._series("_bucket", (("le", "+Inf"),))} {self.n}')
            out.append(f'{self._series("_sum")} {self.total}')
            out.append(f'{self._series("_count")} {self.n}')
            return out


class _Timer:
    def __init__(self, hist):
        self.hist = hist

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.hist.observe(time.perf_counter() - self.t0)


# ------------------------------------------------------- labeled families


class _MetricVec(_Metric):
    """A family of child metrics keyed by a label-value tuple."""

    def __init__(self, name, help_, kind, labelnames):
        super().__init__(name, help_, kind)
        if not labelnames:
            raise ValueError(f"{name}: a labeled family needs labelnames")
        self.labelnames = tuple(labelnames)
        self._children: dict[tuple, _Metric] = {}
        self._lock = threading.Lock()

    def _make_child(self, label_items):
        raise NotImplementedError

    def labels(self, *values, **by_name):
        if by_name:
            if values:
                raise ValueError("pass label values or kwargs, not both")
            try:
                values = tuple(by_name[k] for k in self.labelnames)
            except KeyError as e:
                raise ValueError(
                    f"{self.name}: missing label {e.args[0]!r}"
                ) from None
        values = tuple(str(v) for v in values)
        if len(values) != len(self.labelnames):
            raise ValueError(
                f"{self.name}: expected labels {self.labelnames}, "
                f"got {values}"
            )
        with self._lock:
            child = self._children.get(values)
            if child is None:
                child = self._make_child(
                    tuple(zip(self.labelnames, values))
                )
                self._children[values] = child
        return child

    def children(self):
        with self._lock:
            return dict(self._children)

    def render(self):
        with self._lock:
            kids = list(self._children.values())
        lines = []
        for child in kids:
            lines.extend(child.render())
        return lines


class CounterVec(_MetricVec):
    def __init__(self, name, help_="", labelnames=()):
        super().__init__(name, help_, "counter", labelnames)

    def _make_child(self, label_items):
        return Counter(self.name, self.help, label_items=label_items)


class GaugeVec(_MetricVec):
    def __init__(self, name, help_="", labelnames=()):
        super().__init__(name, help_, "gauge", labelnames)

    def _make_child(self, label_items):
        return Gauge(self.name, self.help, label_items=label_items)


class HistogramVec(_MetricVec):
    def __init__(self, name, help_="", labelnames=(), buckets=None):
        super().__init__(name, help_, "histogram", labelnames)
        self.buckets = tuple(buckets or Histogram.DEFAULT_BUCKETS)

    def _make_child(self, label_items):
        return Histogram(
            self.name, self.help, buckets=self.buckets,
            label_items=label_items,
        )


class Registry:
    def __init__(self):
        self._metrics: dict[str, _Metric] = {}
        self._lock = threading.Lock()

    def counter(self, name, help_="") -> Counter:
        return self._get_or_create(
            name, "counter", lambda: Counter(name, help_)
        )

    def gauge(self, name, help_="") -> Gauge:
        return self._get_or_create(
            name, "gauge", lambda: Gauge(name, help_)
        )

    def histogram(self, name, help_="", buckets=None) -> Histogram:
        return self._get_or_create(
            name, "histogram", lambda: Histogram(name, help_, buckets)
        )

    def counter_vec(self, name, help_="", labelnames=()) -> CounterVec:
        return self._get_or_create(
            name, "counter", lambda: CounterVec(name, help_, labelnames),
            labelnames=labelnames,
        )

    def gauge_vec(self, name, help_="", labelnames=()) -> GaugeVec:
        return self._get_or_create(
            name, "gauge", lambda: GaugeVec(name, help_, labelnames),
            labelnames=labelnames,
        )

    def histogram_vec(
        self, name, help_="", labelnames=(), buckets=None
    ) -> HistogramVec:
        return self._get_or_create(
            name, "histogram",
            lambda: HistogramVec(name, help_, labelnames, buckets),
            labelnames=labelnames,
        )

    def _get_or_create(self, name, kind, factory, labelnames=None):
        with self._lock:
            existing = self._metrics.get(name)
            if existing is None:
                existing = self._metrics[name] = factory()
                return existing
        # conflict checks outside the registry lock (read-only attrs):
        # one name, one kind, one label schema — "registered exactly once"
        if existing.kind != kind:
            raise ValueError(
                f"metric {name!r} already registered as {existing.kind}, "
                f"requested {kind}"
            )
        want_vec = labelnames is not None
        have_vec = isinstance(existing, _MetricVec)
        if want_vec != have_vec:
            raise ValueError(
                f"metric {name!r} already registered "
                f"{'with' if have_vec else 'without'} labels"
            )
        if want_vec and tuple(labelnames) != existing.labelnames:
            raise ValueError(
                f"metric {name!r} already registered with labels "
                f"{existing.labelnames}, requested {tuple(labelnames)}"
            )
        return existing

    def get(self, name):
        """The registered metric or None (no registration side effect)."""
        with self._lock:
            return self._metrics.get(name)

    def get_value(self, name, labels=None, default=0.0):
        """Scalar value of a counter/gauge (or one labeled child), or
        `default` when the series does not exist yet. The read path for
        consumers (notifier, monitoring) that must not create series."""
        m = self.get(name)
        if m is None:
            return default
        if isinstance(m, _MetricVec):
            if labels is None:
                return default
            key = tuple(str(v) for v in labels)
            with m._lock:
                m = m._children.get(key)
            if m is None:
                return default
        return getattr(m, "value", default)

    def names(self):
        with self._lock:
            return list(self._metrics)

    def render(self) -> str:
        with self._lock:
            metrics = list(self._metrics.values())
        lines = []
        for m in metrics:
            if m.help:
                lines.append(f"# HELP {m.name} {m.help}")
            lines.append(f"# TYPE {m.name} {m.kind}")
            lines.extend(m.render())
        return "\n".join(lines) + "\n"


REGISTRY = Registry()


# ------------------------------------------------ dict-compatible views


class RegistryBackedMetrics(MutableMapping):
    """A dict-compatible metrics mapping mirrored onto registry gauges.

    Drop-in replacement for the ad-hoc `chain.metrics` dict: reads and
    dict semantics (KeyError, .get defaults, iteration, `dict(...)`)
    come from a local store, so multiple instances (tests build many
    chains per process) never bleed into each other — while every write
    is mirrored to a `<prefix><key>` gauge in the process registry, so
    `/metrics` scrapes and remote telemetry read the same numbers.
    """

    def __init__(self, prefix: str, initial=None, registry=None):
        self._prefix = prefix
        self._registry = registry or REGISTRY
        self._values: dict[str, float] = {}
        self._gauges: dict[str, Gauge] = {}
        for k, v in (initial or {}).items():
            self[k] = v

    def _metric_name(self, key: str) -> str:
        safe = "".join(
            c if c.isalnum() or c == "_" else "_" for c in key.lower()
        )
        return self._prefix + safe

    def __setitem__(self, key, value):
        self._values[key] = value
        g = self._gauges.get(key)
        if g is None:
            g = self._gauges[key] = self._registry.gauge(
                self._metric_name(key)
            )
        g.set(float(value))

    def __getitem__(self, key):
        return self._values[key]

    def __delitem__(self, key):
        del self._values[key]
        g = self._gauges.pop(key, None)
        if g is not None:
            g.set(0.0)

    def __iter__(self):
        return iter(self._values)

    def __len__(self):
        return len(self._values)

    def snapshot(self) -> dict:
        """Atomic point-in-time copy (C-level plain-dict copy) — the
        read for scrape/health threads while the owner mutates;
        `dict(view)` goes through the MutableMapping iterator and can
        raise mid-resize."""
        return dict(self._values)

    def __repr__(self):
        return f"RegistryBackedMetrics({self._values!r})"
