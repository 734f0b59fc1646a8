"""Process-local metrics registry: counters, gauges, histograms.

Copy of ``dlrover_tpu/telemetry/metrics.py`` (the port imports nothing of the JAX
package).

Role of the reference's metric collection layer
(``dlrover/python/master/monitor`` + the training-event metric
emitters): every subsystem records through one registry so the master
endpoint, the agent textfile dump and tests all read the same numbers.
Stdlib-only (no prometheus_client dependency) and thread-safe; the
exposition format follows the Prometheus text format so standard
scrapers parse it unchanged.

Metric identity is ``(name, sorted(label items))``; a metric object is
created once per name via the registry and holds one series per label
combination.  All ``dlrover_tpu`` metric names carry the ``dlrover_``
prefix.
"""

import math
import re
import threading
import time
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

# latency-oriented default buckets: µs-scale lock waits up to
# multi-minute checkpoint persists
DEFAULT_BUCKETS: Tuple[float, ...] = (
    0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0, 300.0, 600.0,
)

LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Dict[str, str]) -> LabelKey:
    for k in labels:
        if not _LABEL_RE.match(k):
            raise ValueError(f"invalid label name {k!r}")
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def _escape_label_value(value: str) -> str:
    return (
        value.replace("\\", "\\\\")
        .replace("\n", "\\n")
        .replace('"', '\\"')
    )


def _render_labels(key: LabelKey, extra: str = "") -> str:
    parts = [
        f'{k}="{_escape_label_value(v)}"' for k, v in key
    ]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


def _fmt(value: float) -> str:
    if value == math.inf:
        return "+Inf"
    if value == -math.inf:
        return "-Inf"
    if float(value).is_integer() and abs(value) < 1e15:
        return str(int(value))
    return repr(float(value))


class Metric:
    """Base: one named metric holding a series per label set."""

    type_name = "untyped"

    def __init__(self, name: str, help: str = ""):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._series: Dict[LabelKey, object] = {}

    def labels(self, **labels) -> "_Bound":
        return _Bound(self, _label_key(labels))

    def _samples(self) -> Iterator[Tuple[str, str, float]]:
        """Yield (sample name, rendered labels, value)."""
        raise NotImplementedError

    def collect(self) -> List[Tuple[Dict[str, str], object]]:
        """Structured series view for push exporters (OTLP): one
        ``(labels, value)`` pair per label combination.  Counters and
        gauges yield floats; histograms yield
        ``{"count", "sum", "bounds", "bucket_counts"}`` (per-bucket,
        non-cumulative, last bucket is +Inf)."""
        with self._lock:
            return [
                (dict(key), self._collect_value(series))
                for key, series in sorted(self._series.items())
            ]

    def _collect_value(self, series):
        return float(series)

    def render(self) -> str:
        lines = []
        if self.help:
            lines.append(f"# HELP {self.name} {self.help}")
        lines.append(f"# TYPE {self.name} {self.type_name}")
        with self._lock:
            for sample_name, rendered, value in self._samples():
                lines.append(f"{sample_name}{rendered} {_fmt(value)}")
        return "\n".join(lines)


class _Bound:
    """A metric bound to one label combination (hot-loop handle)."""

    __slots__ = ("_metric", "_key")

    def __init__(self, metric: Metric, key: LabelKey):
        self._metric = metric
        self._key = key

    def inc(self, amount: float = 1.0):
        self._metric._inc(self._key, amount)

    def dec(self, amount: float = 1.0):
        self._metric._inc(self._key, -amount)

    def set(self, value: float):
        self._metric._set(self._key, value)

    def observe(self, value: float):
        self._metric._observe(self._key, value)

    def value(self) -> float:
        return self._metric._value(self._key)

    def time(self):
        return _Timer(self.observe)


class _Timer:
    """``with histogram.time():`` convenience."""

    def __init__(self, observe):
        self._observe = observe
        self._start = 0.0

    def __enter__(self):
        self._start = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        self._observe(time.perf_counter() - self._start)
        return False


class Counter(Metric):
    """Monotonically increasing count."""

    type_name = "counter"

    def inc(self, amount: float = 1.0, **labels):
        if amount < 0:
            raise ValueError("counters only go up")
        self._inc(_label_key(labels), amount)

    def value(self, **labels) -> float:
        return self._value(_label_key(labels))

    def _inc(self, key: LabelKey, amount: float):
        if amount < 0:
            raise ValueError("counters only go up")
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + amount

    def _set(self, key, value):  # pragma: no cover - type misuse
        raise TypeError("cannot set() a Counter")

    def _observe(self, key, value):  # pragma: no cover - type misuse
        raise TypeError("cannot observe() a Counter")

    def _value(self, key: LabelKey) -> float:
        with self._lock:
            return float(self._series.get(key, 0.0))

    def _samples(self):
        for key in sorted(self._series):
            yield self.name, _render_labels(key), self._series[key]


class Gauge(Metric):
    """Point-in-time value (set/inc/dec)."""

    type_name = "gauge"

    def set(self, value: float, **labels):
        self._set(_label_key(labels), value)

    def inc(self, amount: float = 1.0, **labels):
        self._inc(_label_key(labels), amount)

    def dec(self, amount: float = 1.0, **labels):
        self._inc(_label_key(labels), -amount)

    def value(self, **labels) -> float:
        return self._value(_label_key(labels))

    def _set(self, key: LabelKey, value: float):
        with self._lock:
            self._series[key] = float(value)

    def _inc(self, key: LabelKey, amount: float):
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + amount

    def _observe(self, key, value):
        self._set(key, value)

    def _value(self, key: LabelKey) -> float:
        with self._lock:
            return float(self._series.get(key, 0.0))

    def _samples(self):
        for key in sorted(self._series):
            yield self.name, _render_labels(key), self._series[key]


class _HistogramSeries:
    __slots__ = ("counts", "total", "count")

    def __init__(self, n_buckets: int):
        self.counts = [0] * n_buckets  # per-bucket (non-cumulative)
        self.total = 0.0
        self.count = 0


class Histogram(Metric):
    """Bucketed distribution (Prometheus-style cumulative buckets)."""

    type_name = "histogram"

    def __init__(
        self,
        name: str,
        help: str = "",
        buckets: Sequence[float] = DEFAULT_BUCKETS,
    ):
        super().__init__(name, help)
        bounds = sorted(float(b) for b in buckets)
        if not bounds:
            raise ValueError("histogram needs at least one bucket")
        if bounds[-1] != math.inf:
            bounds.append(math.inf)
        self.buckets: Tuple[float, ...] = tuple(bounds)

    def observe(self, value: float, **labels):
        self._observe(_label_key(labels), value)

    def time(self, **labels):
        key = _label_key(labels)
        return _Timer(lambda v: self._observe(key, v))

    def _observe(self, key: LabelKey, value: float):
        value = float(value)
        with self._lock:
            series = self._series.get(key)
            if series is None:
                series = self._series[key] = _HistogramSeries(
                    len(self.buckets)
                )
            for i, bound in enumerate(self.buckets):
                if value <= bound:
                    series.counts[i] += 1
                    break
            series.total += value
            series.count += 1

    def _inc(self, key, amount):  # pragma: no cover - type misuse
        raise TypeError("cannot inc() a Histogram")

    def _set(self, key, value):  # pragma: no cover - type misuse
        raise TypeError("cannot set() a Histogram")

    def _value(self, key: LabelKey) -> float:
        with self._lock:
            series = self._series.get(key)
            return float(series.count) if series else 0.0

    def snapshot(self, **labels) -> Dict[str, object]:
        """{count, sum, buckets: {upper_bound: cumulative_count}} for
        one label combination — what tests and in-process consumers
        (e.g. the diagnosis chain) query."""
        key = _label_key(labels)
        with self._lock:
            series = self._series.get(key)
            if series is None:
                return {"count": 0, "sum": 0.0, "buckets": {}}
            cum, out = 0, {}
            for bound, n in zip(self.buckets, series.counts):
                cum += n
                out[bound] = cum
            return {
                "count": series.count,
                "sum": series.total,
                "buckets": out,
            }

    def _samples(self):
        for key in sorted(self._series):
            series = self._series[key]
            cum = 0
            for bound, n in zip(self.buckets, series.counts):
                cum += n
                yield (
                    self.name + "_bucket",
                    _render_labels(key, f'le="{_fmt(bound)}"'),
                    cum,
                )
            yield self.name + "_sum", _render_labels(key), series.total
            yield self.name + "_count", _render_labels(key), series.count

    def _collect_value(self, series: _HistogramSeries):
        return {
            "count": series.count,
            "sum": series.total,
            # finite upper bounds; counts carry one extra (+Inf) entry
            "bounds": [b for b in self.buckets if b != math.inf],
            "bucket_counts": list(series.counts),
        }


class MetricsRegistry:
    """Name -> metric map with get-or-create semantics."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, Metric] = {}

    def _get_or_create(self, cls, name, help, **kwargs) -> Metric:
        with self._lock:
            metric = self._metrics.get(name)
            if metric is None:
                metric = cls(name, help, **kwargs)
                self._metrics[name] = metric
            elif not isinstance(metric, cls):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(metric).__name__}, not {cls.__name__}"
                )
            return metric

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_create(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get_or_create(Gauge, name, help)

    def histogram(
        self,
        name: str,
        help: str = "",
        buckets: Optional[Sequence[float]] = None,
    ) -> Histogram:
        return self._get_or_create(
            Histogram, name, help,
            buckets=tuple(buckets) if buckets else DEFAULT_BUCKETS,
        )

    def get(self, name: str) -> Optional[Metric]:
        with self._lock:
            return self._metrics.get(name)

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._metrics)

    def unregister(self, name: str):
        with self._lock:
            self._metrics.pop(name, None)

    def render_prometheus(self) -> str:
        """Full registry in Prometheus text exposition format."""
        with self._lock:
            metrics = [self._metrics[n] for n in sorted(self._metrics)]
        blocks = [m.render() for m in metrics]
        return "\n".join(blocks) + ("\n" if blocks else "")


_default_registry: Optional[MetricsRegistry] = None
_default_lock = threading.Lock()


def get_registry() -> MetricsRegistry:
    """The process-global registry every instrumented subsystem
    records into (master endpoint / agent textfile read it back)."""
    global _default_registry
    with _default_lock:
        if _default_registry is None:
            _default_registry = MetricsRegistry()
        return _default_registry
