"""Twin of ``tests/test_otlp.py``, against the port (:mod:`dlrover_tpu_torch`).

OTLP/HTTP JSON export: golden-file
encoding checks (spans with cross-process parent links, all three
metric kinds incl. histogram buckets) and exporter behaviour against
a local HTTP sink — batching, drop-on-full, retry/backoff — with NO
instrumentation-site changes (spans arrive via the Tracer listener
hook).

The golden files are the reference's: the port encodes the same
payloads byte for byte.
"""

import json
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

from dlrover_tpu_torch.telemetry.metrics import MetricsRegistry
from dlrover_tpu_torch.telemetry.otlp import (
    OtlpExporter,
    encode_metrics,
    encode_spans,
)
from dlrover_tpu_torch.telemetry.tracing import Span, Tracer

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")


def _golden(name: str):
    with open(os.path.join(FIXTURES, name)) as f:
        return json.load(f)


# -- golden-file encoding --------------------------------------------------


def _fixed_spans():
    """An agent-side span and the master-side handler span it
    parented across the RPC frame: same trace id, explicit
    parentSpanId — the cross-process linkage the exporter must
    surface as real OTLP parent/child spans."""
    agent = Span(
        name="rdzv.join",
        trace_id="00000000000000aa",
        span_id="00000000000000ab",
        parent_id=None,
        start_time=1722600000.0,
        end_time=1722600000.5,
        attributes={"node_rank": 0, "rdzv": "elastic-training"},
    )
    master = Span(
        name="rdzv.join",
        trace_id="00000000000000aa",
        span_id="00000000000000ac",
        parent_id="00000000000000ab",
        start_time=1722600000.1,
        end_time=1722600000.4,
        attributes={"rdzv": "elastic-training"},
        status="ok",
    )
    failed = Span(
        name="ckpt.restore",
        trace_id="00000000000000ba",
        span_id="00000000000000bb",
        parent_id=None,
        start_time=1722600001.0,
        end_time=1722600002.25,
        attributes={"tier": "storage", "ok": False,
                    "bytes": 1048576, "ratio": 0.5,
                    "shards": [0, 1]},
        status="error",
    )
    return [agent, master, failed]


def test_otlp_span_encoding_matches_golden():
    payload = encode_spans(
        _fixed_spans(),
        resource={"service.name": "dlrover_tpu.master",
                  "process.pid": 4242},
    )
    # always a valid JSON document
    assert json.loads(json.dumps(payload)) == payload
    assert payload == _golden("otlp_spans_golden.json")


def test_otlp_span_parent_links_cross_process():
    payload = encode_spans(_fixed_spans(), resource={})
    spans = payload["resourceSpans"][0]["scopeSpans"][0]["spans"]
    agent, master, failed = spans
    # 16-byte trace ids / 8-byte span ids, zero-padded from our ids
    assert len(agent["traceId"]) == 32
    assert len(agent["spanId"]) == 16
    assert master["traceId"] == agent["traceId"]
    assert master["parentSpanId"] == agent["spanId"]
    assert "parentSpanId" not in agent
    assert failed["status"]["code"] == 2  # STATUS_CODE_ERROR
    assert master["status"]["code"] == 1


def _fixed_registry() -> MetricsRegistry:
    reg = MetricsRegistry()
    c = reg.counter("dlrover_rpc_retries_total", "retries")
    c.inc(3, verb="get")
    c.inc(1, verb="report")
    reg.gauge("dlrover_global_step", "step").set(17)
    h = reg.histogram(
        "dlrover_span_seconds", "spans", buckets=[0.1, 1.0]
    )
    h.observe(0.05, name="rdzv.join")
    h.observe(0.5, name="rdzv.join")
    h.observe(5.0, name="rdzv.join")
    return reg


def test_otlp_metric_encoding_matches_golden():
    payload = encode_metrics(
        _fixed_registry(),
        resource={"service.name": "dlrover_tpu.master"},
        time_unix_nano="1722600010000000000",
        start_time_unix_nano="1722600000000000000",
    )
    assert json.loads(json.dumps(payload)) == payload
    assert payload == _golden("otlp_metrics_golden.json")


def test_otlp_metric_kinds_and_histogram_buckets():
    payload = encode_metrics(
        _fixed_registry(), resource={},
        time_unix_nano="1", start_time_unix_nano="0",
    )
    metrics = {
        m["name"]: m
        for m in payload["resourceMetrics"][0]["scopeMetrics"][0][
            "metrics"
        ]
    }
    # counter -> monotonic cumulative sum, one point per label set
    counter = metrics["dlrover_rpc_retries_total"]["sum"]
    assert counter["isMonotonic"] is True
    assert counter["aggregationTemporality"] == 2
    assert len(counter["dataPoints"]) == 2
    # gauge -> plain data point
    gauge = metrics["dlrover_global_step"]["gauge"]
    assert gauge["dataPoints"][0]["asDouble"] == 17.0
    # histogram -> per-bucket counts + explicit bounds (+Inf implied
    # by the extra bucketCounts entry)
    (hist_point,) = metrics["dlrover_span_seconds"]["histogram"][
        "dataPoints"
    ]
    assert hist_point["explicitBounds"] == [0.1, 1.0]
    assert hist_point["bucketCounts"] == ["1", "1", "1"]
    assert hist_point["count"] == "3"
    assert hist_point["sum"] == pytest.approx(5.55)
    assert hist_point["attributes"] == [
        {"key": "name", "value": {"stringValue": "rdzv.join"}}
    ]


# -- local HTTP sink -------------------------------------------------------


class _Sink:
    """In-process OTLP collector stand-in: records every POST, can
    fail the first N requests with a retryable 503."""

    def __init__(self, fail_first: int = 0, status_after: int = 200):
        self.requests = []
        self.fail_first = fail_first
        self.status_after = status_after
        self._lock = threading.Lock()
        sink = self

        class Handler(BaseHTTPRequestHandler):
            def do_POST(self):  # noqa: N802
                length = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(length)
                with sink._lock:
                    n = len(sink.requests)
                    sink.requests.append(
                        (self.path, json.loads(body.decode()))
                    )
                    status = (
                        503 if n < sink.fail_first
                        else sink.status_after
                    )
                self.send_response(status)
                self.send_header("Content-Length", "0")
                self.end_headers()

            def log_message(self, fmt, *args):
                pass

        self._server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self._server.daemon_threads = True
        self.endpoint = (
            f"http://127.0.0.1:{self._server.server_address[1]}"
        )
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True
        )
        self._thread.start()

    def paths(self):
        with self._lock:
            return [p for p, _ in self.requests]

    def bodies(self, path):
        with self._lock:
            return [b for p, b in self.requests if p == path]

    def close(self):
        self._server.shutdown()
        self._server.server_close()


@pytest.fixture()
def sink():
    s = _Sink()
    yield s
    s.close()


def _exporter(sink_obj, **kw):
    reg = kw.pop("registry", None) or MetricsRegistry()
    tracer = kw.pop("tracer", None) or Tracer(registry=reg)
    kw.setdefault("interval", 3600)  # flush manually in tests
    kw.setdefault("retries", 0)
    exp = OtlpExporter(
        sink_obj.endpoint, registry=reg, tracer=tracer, **kw
    )
    return exp, reg, tracer


def test_exporter_pushes_spans_and_metrics(sink):
    exp, reg, tracer = _exporter(sink)
    exp.start()
    try:
        reg.counter("dlrover_test_total").inc(2)
        with tracer.span("outer"):
            with tracer.span("inner"):
                pass
        assert exp.flush()
    finally:
        exp.stop()
    (traces,) = sink.bodies("/v1/traces")[:1]
    spans = traces["resourceSpans"][0]["scopeSpans"][0]["spans"]
    by_name = {s["name"]: s for s in spans}
    assert by_name["inner"]["parentSpanId"] == (
        by_name["outer"]["spanId"]
    )
    metrics = sink.bodies("/v1/metrics")[0]
    names = [
        m["name"]
        for m in metrics["resourceMetrics"][0]["scopeMetrics"][0][
            "metrics"
        ]
    ]
    assert "dlrover_test_total" in names
    assert "dlrover_span_seconds" in names  # tracer's histogram


def test_exporter_batches_large_span_backlogs(sink):
    exp, reg, tracer = _exporter(sink, max_batch=10)
    tracer.add_listener(exp._on_span)
    try:
        for i in range(25):
            with tracer.span(f"op{i}"):
                pass
        assert exp.flush()
    finally:
        tracer.remove_listener(exp._on_span)
    trace_posts = sink.bodies("/v1/traces")
    sizes = [
        len(b["resourceSpans"][0]["scopeSpans"][0]["spans"])
        for b in trace_posts
    ]
    assert sizes == [10, 10, 5]  # batched, nothing lost


def test_exporter_drops_on_full_queue_and_counts(sink):
    exp, reg, tracer = _exporter(sink, queue_size=5)
    tracer.add_listener(exp._on_span)
    try:
        for i in range(12):
            with tracer.span(f"op{i}"):
                pass
    finally:
        tracer.remove_listener(exp._on_span)
    dropped = reg.get("dlrover_otlp_dropped_spans_total")
    assert dropped.value(reason="queue_full") == 7
    assert exp.flush()
    spans = sink.bodies("/v1/traces")[0]["resourceSpans"][0][
        "scopeSpans"
    ][0]["spans"]
    assert len(spans) == 5  # the bounded queue's worth survived


def test_exporter_retries_with_backoff_then_succeeds():
    s = _Sink(fail_first=2)
    try:
        exp, reg, tracer = _exporter(s, retries=3)
        tracer.add_listener(exp._on_span)
        with tracer.span("flaky"):
            pass
        tracer.remove_listener(exp._on_span)
        assert exp.flush()
        # 503 twice, then the replayed batch accepted
        assert s.paths().count("/v1/traces") == 3
        exports = reg.get("dlrover_otlp_exports_total")
        assert exports.value(signal="traces", result="ok") == 1
    finally:
        s.close()


def test_exporter_gives_up_after_retry_budget_and_counts():
    s = _Sink(fail_first=99)
    try:
        exp, reg, tracer = _exporter(s, retries=1)
        tracer.add_listener(exp._on_span)
        with tracer.span("doomed"):
            pass
        tracer.remove_listener(exp._on_span)
        assert exp.flush() is False
        exports = reg.get("dlrover_otlp_exports_total")
        assert exports.value(signal="traces", result="error") == 1
        dropped = reg.get("dlrover_otlp_dropped_spans_total")
        assert dropped.value(reason="export_failed") == 1
    finally:
        s.close()


def test_exporter_lifecycle_via_tracer_listener(sink):
    """start() subscribes, stop() unsubscribes + final-flushes: the
    zero-instrumentation contract."""
    exp, reg, tracer = _exporter(sink)
    exp.start()
    with tracer.span("while-running"):
        pass
    exp.stop()
    with tracer.span("after-stop"):
        pass
    names = [
        s["name"]
        for b in sink.bodies("/v1/traces")
        for s in b["resourceSpans"][0]["scopeSpans"][0]["spans"]
    ]
    assert "while-running" in names
    assert "after-stop" not in names


def test_maybe_from_env(monkeypatch, sink):
    from dlrover_tpu_torch.telemetry.otlp import (
        OTLP_ENDPOINT_ENV,
        OTLP_INTERVAL_ENV,
        maybe_from_env,
    )

    monkeypatch.delenv(OTLP_ENDPOINT_ENV, raising=False)
    assert maybe_from_env() is None
    monkeypatch.setenv(OTLP_ENDPOINT_ENV, sink.endpoint)
    monkeypatch.setenv(OTLP_INTERVAL_ENV, "123")
    exp = maybe_from_env(registry=MetricsRegistry())
    assert exp is not None
    assert exp.endpoint == sink.endpoint
    assert exp._interval == 123.0
    # review regressions: interval 0 must not become a busy-spin, and
    # a garbage env value must not crash master/agent construction
    monkeypatch.setenv(OTLP_INTERVAL_ENV, "0")
    assert maybe_from_env(
        registry=MetricsRegistry()
    )._interval >= 0.1
    monkeypatch.setenv(OTLP_INTERVAL_ENV, "not-a-number")
    assert maybe_from_env(
        registry=MetricsRegistry()
    )._interval == 5.0
    # malformed/negative queue+retry knobs degrade, never disable
    monkeypatch.setenv("DLROVER_OTLP_QUEUE", "-1")
    monkeypatch.setenv("DLROVER_OTLP_RETRIES", "oops")
    exp = maybe_from_env(registry=MetricsRegistry())
    assert exp._queue_size >= 1
    assert exp._retries == 3
    monkeypatch.setenv("DLROVER_OTLP_RETRIES", "-4")
    assert maybe_from_env(
        registry=MetricsRegistry()
    )._retries == 0
