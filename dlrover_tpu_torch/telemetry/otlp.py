"""OTLP/HTTP JSON push export for spans and metrics.

Copy of ``dlrover_tpu/telemetry/otlp.py`` (the port imports nothing of
the JAX package).

The ROADMAP follow-on to the telemetry subsystem: ship the same spans
and registry series the master endpoint / textfile dumps expose to an
OpenTelemetry collector, **behind the existing Tracer/MetricsRegistry
interfaces** — instrumentation sites do not change.  Spans arrive via
:meth:`Tracer.add_listener`; metrics are periodic snapshots of the
registry (cumulative temporality, start time = exporter start).

Wire format is the OTLP/HTTP **JSON** protobuf mapping (no protobuf
dependency): ``POST <endpoint>/v1/traces`` and
``POST <endpoint>/v1/metrics`` with ``Content-Type:
application/json``.  64-bit integers (nanosecond timestamps, bucket
counts) are encoded as strings per the proto3 JSON mapping.

Operational posture matches the rest of the telemetry layer — never a
hard dependency of training:

- bounded span queue: when full, new spans are DROPPED and counted
  (``dlrover_otlp_dropped_spans_total``), the training path never
  blocks;
- batched: at most ``max_batch`` spans per request, flushed every
  ``DLROVER_OTLP_INTERVAL`` seconds (and on stop);
- retry with the RPC layer's jittered backoff
  (:func:`~dlrover_tpu_torch.common.comm.compute_backoff`) on transport
  errors / 429 / 5xx; client errors (4xx) never retry;
- export outcomes counted per signal
  (``dlrover_otlp_exports_total{signal,result}``).

Enable per process::

    DLROVER_OTLP_ENDPOINT=http://collector:4318   # enables the exporter
    DLROVER_OTLP_INTERVAL=5                       # flush cadence (s)

The cross-process trace context that rides the RPC frames surfaces
here unchanged: an agent-side span and the master-side handler span it
parented share ``traceId`` and link via ``parentSpanId`` in the
exported payloads.
"""

import json
import os
import threading
import time
import urllib.error
import urllib.request
from collections import deque
from typing import Dict, List, Optional, Sequence

from dlrover_tpu_torch.common.env_utils import _get_int as _env_int
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.telemetry import metrics as _metrics
from dlrover_tpu_torch.telemetry import tracing as _tracing
from dlrover_tpu_torch.telemetry.events import EVENT_SOURCE_ENV

OTLP_ENDPOINT_ENV = "DLROVER_OTLP_ENDPOINT"
OTLP_INTERVAL_ENV = "DLROVER_OTLP_INTERVAL"
OTLP_QUEUE_ENV = "DLROVER_OTLP_QUEUE"
OTLP_RETRIES_ENV = "DLROVER_OTLP_RETRIES"

_SCOPE = {"name": "dlrover_tpu"}


# -- encoding (pure functions; golden-file tested) -------------------------


def _attr_value(value) -> Dict:
    """One OTLP AnyValue."""
    if isinstance(value, bool):
        return {"boolValue": value}
    if isinstance(value, int):
        return {"intValue": str(value)}
    if isinstance(value, float):
        return {"doubleValue": value}
    if isinstance(value, str):
        return {"stringValue": value}
    # containers and anything exotic: readable string form (the
    # collector treats unknown structures as opaque anyway)
    try:
        return {"stringValue": json.dumps(value, default=str)}
    except (TypeError, ValueError):
        return {"stringValue": str(value)}


def encode_attributes(attrs: Dict) -> List[Dict]:
    return [
        {"key": str(k), "value": _attr_value(v)}
        for k, v in attrs.items()
    ]


def _trace_id(tid: str) -> str:
    """Our ids are 16 hex chars (8 bytes); OTLP trace ids are 16
    bytes — left-pad.  Padding is stable, so the agent- and
    master-side spans of one RPC still share a trace id."""
    return str(tid).rjust(32, "0")[:32]


def _span_id(sid: str) -> str:
    return str(sid).rjust(16, "0")[:16]


def _nanos(seconds: float) -> str:
    return str(int(seconds * 1e9))


def encode_span(span: "_tracing.Span") -> Dict:
    out = {
        "traceId": _trace_id(span.trace_id),
        "spanId": _span_id(span.span_id),
        "name": span.name,
        "kind": 1,  # SPAN_KIND_INTERNAL
        "startTimeUnixNano": _nanos(span.start_time),
        "endTimeUnixNano": _nanos(span.end_time),
        "attributes": encode_attributes(span.attributes),
        # STATUS_CODE_OK / STATUS_CODE_ERROR
        "status": {"code": 2 if span.status == "error" else 1},
    }
    if span.parent_id:
        out["parentSpanId"] = _span_id(span.parent_id)
    return out


def encode_spans(
    spans: Sequence["_tracing.Span"], resource: Dict
) -> Dict:
    """OTLP ExportTraceServiceRequest (JSON mapping)."""
    return {
        "resourceSpans": [{
            "resource": {"attributes": encode_attributes(resource)},
            "scopeSpans": [{
                "scope": dict(_SCOPE),
                "spans": [encode_span(s) for s in spans],
            }],
        }]
    }


def _number_point(labels, value, time_ns, start_ns) -> Dict:
    return {
        "attributes": encode_attributes(labels),
        "startTimeUnixNano": start_ns,
        "timeUnixNano": time_ns,
        "asDouble": float(value),
    }


def _encode_metric(metric, time_ns: str, start_ns: str) -> Dict:
    out = {"name": metric.name, "description": metric.help}
    if isinstance(metric, _metrics.Counter):
        out["sum"] = {
            "dataPoints": [
                _number_point(labels, v, time_ns, start_ns)
                for labels, v in metric.collect()
            ],
            "aggregationTemporality": 2,  # CUMULATIVE
            "isMonotonic": True,
        }
    elif isinstance(metric, _metrics.Histogram):
        out["histogram"] = {
            "dataPoints": [
                {
                    "attributes": encode_attributes(labels),
                    "startTimeUnixNano": start_ns,
                    "timeUnixNano": time_ns,
                    "count": str(snap["count"]),
                    "sum": float(snap["sum"]),
                    "bucketCounts": [
                        str(c) for c in snap["bucket_counts"]
                    ],
                    "explicitBounds": list(snap["bounds"]),
                }
                for labels, snap in metric.collect()
            ],
            "aggregationTemporality": 2,
        }
    else:  # Gauge and anything untyped
        out["gauge"] = {
            "dataPoints": [
                _number_point(labels, v, time_ns, start_ns)
                for labels, v in metric.collect()
            ]
        }
    return out


def encode_metrics(
    registry: _metrics.MetricsRegistry,
    resource: Dict,
    time_unix_nano: Optional[str] = None,
    start_time_unix_nano: Optional[str] = None,
) -> Dict:
    """OTLP ExportMetricsServiceRequest for a registry snapshot.
    Timestamps are injectable for deterministic tests."""
    time_ns = time_unix_nano or _nanos(time.time())
    start_ns = start_time_unix_nano or time_ns
    encoded = []
    for name in registry.names():
        metric = registry.get(name)
        if metric is None:
            continue
        enc = _encode_metric(metric, time_ns, start_ns)
        # skip empty families: a metric that never recorded a sample
        # has nothing to say (and some backends reject empty points)
        body = enc.get("sum") or enc.get("gauge") or enc.get("histogram")
        if body and body.get("dataPoints"):
            encoded.append(enc)
    return {
        "resourceMetrics": [{
            "resource": {"attributes": encode_attributes(resource)},
            "scopeMetrics": [{
                "scope": dict(_SCOPE),
                "metrics": encoded,
            }],
        }]
    }


# -- exporter --------------------------------------------------------------


def default_resource(service_name: str = "") -> Dict:
    name = service_name or (
        "dlrover_tpu_torch."
        + (os.environ.get(EVENT_SOURCE_ENV) or "job")
    )
    resource = {"service.name": name, "process.pid": os.getpid()}
    rank = os.environ.get("DLROVER_NODE_RANK")
    if rank is not None:
        resource["dlrover.node_rank"] = rank
    return resource


class OtlpExporter:
    """Background OTLP/HTTP JSON pusher for the process's tracer and
    registry.  ``start()``/``stop()`` matches the master's aux-service
    interface; safe to construct unconditionally (a falsy endpoint
    makes every call a no-op)."""

    def __init__(
        self,
        endpoint: str,
        interval: Optional[float] = None,
        registry: Optional[_metrics.MetricsRegistry] = None,
        tracer: Optional[_tracing.Tracer] = None,
        queue_size: Optional[int] = None,
        max_batch: int = 512,
        retries: Optional[int] = None,
        timeout: float = 5.0,
        service_name: str = "",
    ):
        self.endpoint = (endpoint or "").rstrip("/")
        if interval is None:
            try:
                interval = float(
                    os.environ.get(OTLP_INTERVAL_ENV) or 5.0
                )
            except ValueError:
                interval = 5.0
        # floor, not validation: interval=0 would turn the flush loop
        # into a busy-spin that pegs a core and floods the collector
        self._interval = max(0.1, interval)
        self._registry = registry or _metrics.get_registry()
        self._tracer = tracer or _tracing.get_tracer()
        # shared env parsing (malformed operator input degrades to
        # the default — telemetry must never stop a master/agent
        # from starting), clamped so a negative value cannot
        # silently disable export
        self._queue_size = max(
            1, queue_size or _env_int(OTLP_QUEUE_ENV, 4096)
        )
        self._max_batch = max(1, max_batch)
        self._retries = max(
            0,
            retries if retries is not None
            else _env_int(OTLP_RETRIES_ENV, 3),
        )
        self._timeout = timeout
        self._resource = default_resource(service_name)
        self._queue: "deque[_tracing.Span]" = deque()
        self._qlock = threading.Lock()
        self._stopped = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._start_ns = _nanos(time.time())
        reg = self._registry
        self._dropped = reg.counter(
            "dlrover_otlp_dropped_spans_total",
            "Spans dropped because the OTLP export queue was full "
            "or delivery failed after retries",
        )
        self._exports = reg.counter(
            "dlrover_otlp_exports_total",
            "OTLP export requests by signal and result",
        )

    # -- span intake (Tracer listener) ------------------------------------

    def _on_span(self, span: "_tracing.Span"):
        with self._qlock:
            if len(self._queue) >= self._queue_size:
                self._dropped.inc(reason="queue_full")
                return
            self._queue.append(span)

    def _drain(self) -> List["_tracing.Span"]:
        with self._qlock:
            batch = list(self._queue)
            self._queue.clear()
        return batch

    # -- transport ---------------------------------------------------------

    def _post(self, path: str, payload: Dict, signal: str) -> bool:
        """POST with jittered-backoff retries.  Returns True when the
        collector acked; False once the envelope is exhausted or on a
        non-retryable (4xx) rejection."""
        body = json.dumps(payload).encode("utf-8")
        url = self.endpoint + path
        # shutdown path: an unreachable collector (black-holed
        # address) must not stall process exit for retries × socket
        # timeout — one short attempt, best effort
        stopping = self._stopped.is_set()
        retries = 0 if stopping else self._retries
        timeout = min(self._timeout, 2.0) if stopping else self._timeout
        for attempt in range(retries + 1):
            try:
                req = urllib.request.Request(
                    url, data=body,
                    headers={"Content-Type": "application/json"},
                    method="POST",
                )
                with urllib.request.urlopen(req, timeout=timeout):
                    self._exports.inc(signal=signal, result="ok")
                    return True
            except urllib.error.HTTPError as e:
                if e.code not in (429,) and e.code < 500:
                    # a 4xx is OUR bug or a config mismatch; retrying
                    # the identical payload cannot succeed
                    self._exports.inc(signal=signal, result="rejected")
                    logger.warning(
                        "OTLP %s export rejected by %s: HTTP %s",
                        signal, url, e.code,
                    )
                    return False
            except (urllib.error.URLError, OSError, ValueError):
                pass
            if attempt < retries and not self._stopped.is_set():
                from dlrover_tpu_torch.common.comm import compute_backoff

                time.sleep(compute_backoff(attempt, base=0.2, cap=2.0))
        self._exports.inc(signal=signal, result="error")
        return False

    # -- flush loop --------------------------------------------------------

    def flush(self) -> bool:
        """Export one span batch + one metrics snapshot now."""
        if not self.endpoint:
            return False
        ok = True
        batch = self._drain()
        while batch:
            chunk, batch = batch[: self._max_batch], batch[self._max_batch:]
            if not self._post(
                "/v1/traces",
                encode_spans(chunk, self._resource),
                "traces",
            ):
                ok = False
                self._dropped.inc(len(chunk), reason="export_failed")
        payload = encode_metrics(
            self._registry, self._resource,
            start_time_unix_nano=self._start_ns,
        )
        scope = payload["resourceMetrics"][0]["scopeMetrics"][0]
        if scope["metrics"]:
            ok = self._post("/v1/metrics", payload, "metrics") and ok
        return ok

    def _run(self):
        while not self._stopped.wait(self._interval):
            try:
                self.flush()
            except Exception:  # noqa: BLE001 - export must never die
                logger.exception("OTLP flush failed")

    def start(self):
        if not self.endpoint or self._thread is not None:
            return
        self._stopped.clear()
        self._tracer.add_listener(self._on_span)
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="otlp-exporter"
        )
        self._thread.start()
        logger.info(
            "OTLP exporter pushing to %s every %.1fs",
            self.endpoint, self._interval,
        )

    def stop(self):
        if self._thread is None:
            return
        self._stopped.set()
        self._tracer.remove_listener(self._on_span)
        self._thread.join(timeout=max(5.0, self._timeout))
        self._thread = None
        try:
            self.flush()  # final batch so short-lived jobs export
        except Exception:  # noqa: BLE001
            logger.exception("final OTLP flush failed")


def maybe_from_env(
    registry: Optional[_metrics.MetricsRegistry] = None,
    tracer: Optional[_tracing.Tracer] = None,
    service_name: str = "",
) -> Optional[OtlpExporter]:
    """An exporter when ``DLROVER_OTLP_ENDPOINT`` is set, else None —
    the one-line wiring masters/agents call at process entry."""
    endpoint = os.environ.get(OTLP_ENDPOINT_ENV, "").strip()
    if not endpoint:
        return None
    return OtlpExporter(
        endpoint, registry=registry, tracer=tracer,
        service_name=service_name,
    )
