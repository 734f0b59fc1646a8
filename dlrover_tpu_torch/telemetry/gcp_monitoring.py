"""GCP Cloud Monitoring / Cloud Trace push export (stub transport).

Copy of ``dlrover_tpu/telemetry/gcp_monitoring.py`` (the port imports
nothing of the JAX package).

The carried-forward ROADMAP item: TPU jobs run on GCP, where the
native sink is Cloud Monitoring (metrics) + Cloud Trace (spans).
This exporter rides the SAME interfaces the OTLP exporter proved out
— spans subscribe via :meth:`Tracer.add_listener`, metrics snapshot
via :meth:`Metric.collect` — so instrumentation sites change for
neither backend and both exporters can run side by side.

Wire format is the REST JSON of the two services (no
``google-cloud-*`` dependency, plain ``urllib``):

- ``POST https://monitoring.googleapis.com/v3/projects/<p>/timeSeries``
  with a ``CreateTimeSeriesRequest`` — counters become CUMULATIVE
  DOUBLE series, gauges GAUGE DOUBLE, histograms CUMULATIVE
  DISTRIBUTION with explicit bucket bounds; metric types are
  ``custom.googleapis.com/dlrover/<name>``.
- ``POST https://cloudtrace.googleapis.com/v2/projects/<p>/traces:batchWrite``
  with Cloud Trace v2 spans (our 8-byte ids left-padded to the
  16-byte trace / 8-byte span widths, same scheme as the OTLP
  exporter, so cross-RPC parent links survive).

Transport is a *stub* posture: enabled only when
``DLROVER_GCP_PROJECT`` is set, authenticated with a bearer token
from ``DLROVER_GCP_TOKEN`` (metadata-server/ADC integration is the
deployment's concern), and never a hard dependency of training —
tier-1 tests exercise the pure encoders against golden files, no
network.
"""

import json
import os
import threading
import time
import urllib.error
import urllib.request
from collections import deque
from datetime import datetime, timezone
from typing import Dict, List, Optional, Sequence

from dlrover_tpu_torch.common.env_utils import _get_int as _env_int
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.telemetry import metrics as _metrics
from dlrover_tpu_torch.telemetry import tracing as _tracing
from dlrover_tpu_torch.telemetry.otlp import default_resource

GCP_PROJECT_ENV = "DLROVER_GCP_PROJECT"
GCP_TOKEN_ENV = "DLROVER_GCP_TOKEN"
GCP_INTERVAL_ENV = "DLROVER_GCP_INTERVAL"

MONITORING_URL = "https://monitoring.googleapis.com/v3"
TRACE_URL = "https://cloudtrace.googleapis.com/v2"
METRIC_PREFIX = "custom.googleapis.com/dlrover/"


def _rfc3339(seconds: float) -> str:
    """Cloud APIs want RFC3339 UTC ("Z"-suffixed)."""
    return (
        datetime.fromtimestamp(float(seconds), tz=timezone.utc)
        .isoformat()
        .replace("+00:00", "Z")
    )


def _series_labels(labels: Dict, resource: Dict) -> Dict[str, str]:
    """Metric labels: the series' own labels plus the process
    identity (Cloud Monitoring has no per-payload resource
    attributes the way OTLP does, so identity rides the labels)."""
    out = {str(k): str(v) for k, v in labels.items()}
    for key in ("service.name", "dlrover.node_rank"):
        if key in resource:
            out[key.replace(".", "_")] = str(resource[key])
    return out


def encode_time_series(
    registry: _metrics.MetricsRegistry,
    project: str,
    resource: Optional[Dict] = None,
    end_time: Optional[float] = None,
    start_time: Optional[float] = None,
) -> Dict:
    """``CreateTimeSeriesRequest`` JSON body for a registry snapshot.
    Timestamps are injectable for deterministic (golden-file)
    tests."""
    resource = resource or default_resource()
    end = _rfc3339(end_time if end_time is not None else time.time())
    start = _rfc3339(
        start_time if start_time is not None
        else (end_time if end_time is not None else time.time())
    )
    monitored = {
        "type": "global",
        "labels": {"project_id": project},
    }
    series: List[Dict] = []
    for name in registry.names():
        metric = registry.get(name)
        if metric is None:
            continue
        for labels, value in metric.collect():
            entry = {
                "metric": {
                    "type": METRIC_PREFIX + name,
                    "labels": _series_labels(labels, resource),
                },
                "resource": monitored,
            }
            if isinstance(metric, _metrics.Counter):
                entry["metricKind"] = "CUMULATIVE"
                entry["valueType"] = "DOUBLE"
                entry["points"] = [{
                    "interval": {
                        "startTime": start, "endTime": end,
                    },
                    "value": {"doubleValue": float(value)},
                }]
            elif isinstance(metric, _metrics.Histogram):
                entry["metricKind"] = "CUMULATIVE"
                entry["valueType"] = "DISTRIBUTION"
                count = int(value["count"])
                mean = (
                    float(value["sum"]) / count if count else 0.0
                )
                entry["points"] = [{
                    "interval": {
                        "startTime": start, "endTime": end,
                    },
                    "value": {"distributionValue": {
                        "count": str(count),
                        "mean": mean,
                        "bucketOptions": {"explicitBuckets": {
                            "bounds": list(value["bounds"]),
                        }},
                        "bucketCounts": [
                            str(c) for c in value["bucket_counts"]
                        ],
                    }},
                }]
            else:  # Gauge / untyped: point-in-time
                entry["metricKind"] = "GAUGE"
                entry["valueType"] = "DOUBLE"
                entry["points"] = [{
                    "interval": {"endTime": end},
                    "value": {"doubleValue": float(value)},
                }]
            series.append(entry)
    return {"timeSeries": series}


def _trace_id(tid: str) -> str:
    return str(tid).rjust(32, "0")[:32]


def _span_id(sid: str) -> str:
    return str(sid).rjust(16, "0")[:16]


def _attribute_map(attrs: Dict) -> Dict:
    out = {}
    for k, v in attrs.items():
        if isinstance(v, bool):
            out[str(k)] = {"boolValue": v}
        elif isinstance(v, int):
            out[str(k)] = {"intValue": str(v)}
        else:
            if not isinstance(v, str):
                v = json.dumps(v, default=str)
            out[str(k)] = {
                "stringValue": {"value": v[:256]}
            }
    return out


def encode_trace_spans(
    spans: Sequence["_tracing.Span"], project: str
) -> Dict:
    """Cloud Trace v2 ``traces:batchWrite`` body."""
    encoded = []
    for s in spans:
        span_id = _span_id(s.span_id)
        entry = {
            "name": (
                f"projects/{project}/traces/{_trace_id(s.trace_id)}"
                f"/spans/{span_id}"
            ),
            "spanId": span_id,
            "displayName": {"value": s.name[:128]},
            "startTime": _rfc3339(s.start_time),
            "endTime": _rfc3339(s.end_time),
            "attributes": {
                "attributeMap": _attribute_map(s.attributes),
            },
        }
        if s.parent_id:
            entry["parentSpanId"] = _span_id(s.parent_id)
        if s.status == "error":
            entry["status"] = {"code": 2}
        encoded.append(entry)
    return {"spans": encoded}


class CloudMonitoringExporter:
    """Background pusher mirroring
    :class:`~dlrover_tpu_torch.telemetry.otlp.OtlpExporter`: bounded span
    queue via the tracer listener, periodic registry snapshots, one
    short-retry POST per flush; ``start()``/``stop()`` matches the
    master's aux-service interface."""

    def __init__(
        self,
        project: str,
        token: str = "",
        interval: Optional[float] = None,
        registry: Optional[_metrics.MetricsRegistry] = None,
        tracer: Optional[_tracing.Tracer] = None,
        queue_size: Optional[int] = None,
        monitoring_url: str = MONITORING_URL,
        trace_url: str = TRACE_URL,
        timeout: float = 5.0,
    ):
        self.project = project
        self._token = token or os.environ.get(GCP_TOKEN_ENV, "")
        if interval is None:
            try:
                interval = float(
                    os.environ.get(GCP_INTERVAL_ENV) or 30.0
                )
            except ValueError:
                interval = 30.0
        self._interval = max(1.0, interval)
        self._registry = registry or _metrics.get_registry()
        self._tracer = tracer or _tracing.get_tracer()
        self._queue_size = max(
            1, queue_size or _env_int("DLROVER_GCP_QUEUE", 4096)
        )
        self._monitoring_url = monitoring_url.rstrip("/")
        self._trace_url = trace_url.rstrip("/")
        self._timeout = timeout
        self._resource = default_resource()
        self._start_time = time.time()
        self._queue: "deque[_tracing.Span]" = deque()
        self._qlock = threading.Lock()
        self._stopped = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._exports = self._registry.counter(
            "dlrover_gcp_exports_total",
            "Cloud Monitoring/Trace export requests by signal and "
            "result",
        )

    def _on_span(self, span: "_tracing.Span"):
        with self._qlock:
            if len(self._queue) >= self._queue_size:
                return  # bounded: drop silently, training never blocks
            self._queue.append(span)

    def _post(self, url: str, payload: Dict, signal: str) -> bool:
        body = json.dumps(payload).encode("utf-8")
        headers = {"Content-Type": "application/json"}
        if self._token:
            headers["Authorization"] = f"Bearer {self._token}"
        try:
            req = urllib.request.Request(
                url, data=body, headers=headers, method="POST"
            )
            with urllib.request.urlopen(
                req, timeout=self._timeout
            ):
                self._exports.inc(signal=signal, result="ok")
                return True
        except urllib.error.HTTPError as e:
            self._exports.inc(signal=signal, result="rejected")
            logger.warning(
                "GCP %s export rejected: HTTP %s", signal, e.code
            )
        except (urllib.error.URLError, OSError, ValueError) as e:
            self._exports.inc(signal=signal, result="error")
            logger.debug("GCP %s export failed: %s", signal, e)
        return False

    def flush(self) -> bool:
        with self._qlock:
            batch = list(self._queue)
            self._queue.clear()
        ok = True
        if batch:
            ok = self._post(
                f"{self._trace_url}/projects/{self.project}"
                "/traces:batchWrite",
                encode_trace_spans(batch, self.project),
                "traces",
            )
        payload = encode_time_series(
            self._registry, self.project,
            resource=self._resource,
            start_time=self._start_time,
        )
        if payload["timeSeries"]:
            ok = self._post(
                f"{self._monitoring_url}/projects/{self.project}"
                "/timeSeries",
                payload,
                "metrics",
            ) and ok
        return ok

    def _run(self):
        while not self._stopped.wait(self._interval):
            try:
                self.flush()
            except Exception:  # noqa: BLE001 - export must never die
                logger.exception("GCP export flush failed")

    def start(self):
        if not self.project or self._thread is not None:
            return
        self._stopped.clear()
        self._tracer.add_listener(self._on_span)
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="gcp-exporter"
        )
        self._thread.start()
        logger.info(
            "Cloud Monitoring exporter pushing project %s every "
            "%.0fs", self.project, self._interval,
        )

    def stop(self):
        if self._thread is None:
            return
        self._stopped.set()
        self._tracer.remove_listener(self._on_span)
        self._thread.join(timeout=max(5.0, self._timeout))
        self._thread = None
        try:
            self.flush()
        except Exception:  # noqa: BLE001
            logger.exception("final GCP flush failed")


def maybe_from_env(
    registry: Optional[_metrics.MetricsRegistry] = None,
    tracer: Optional[_tracing.Tracer] = None,
) -> Optional[CloudMonitoringExporter]:
    """An exporter when ``DLROVER_GCP_PROJECT`` is set, else None —
    the one-line wiring next to the OTLP exporter's."""
    project = os.environ.get(GCP_PROJECT_ENV, "").strip()
    if not project:
        return None
    return CloudMonitoringExporter(
        project, registry=registry, tracer=tracer
    )
