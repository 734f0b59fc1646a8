"""Unified telemetry: metrics registry, span tracer, training events.

Copy of ``dlrover_tpu/telemetry/__init__.py`` (the port imports
nothing of the JAX package).

The paper's control plane (fault diagnosis, auto-scaling, Brain
resource optimization) runs on runtime signals; the reference DLRover
ships a dedicated training-event/metrics exporter layer
(``dlrover/python/training_event``, ``master/monitor``) for exactly
this reason.  This package is that layer for the TPU stack, with zero
hard dependencies:

- :mod:`dlrover_tpu_torch.telemetry.metrics` — process-local registry of
  counters/gauges/histograms with labels (thread-safe), rendered in
  Prometheus text exposition format.
- :mod:`dlrover_tpu_torch.telemetry.tracing` — lightweight span tracer with
  parent/child context propagation, carried across the master↔agent
  RPC by :mod:`dlrover_tpu_torch.common.comm`.
- :mod:`dlrover_tpu_torch.telemetry.events` — append-only JSONL training
  event log (schema-versioned, size-rotated), shared by master, agent
  and trainer processes through ``DLROVER_EVENT_LOG``.
- :mod:`dlrover_tpu_torch.telemetry.exporter` — a Prometheus scrape
  endpoint served from the master (plus ``/timeline``, the job
  flight-recorder view) and a textfile dump fallback for agents.
- :mod:`dlrover_tpu_torch.telemetry.otlp` — OTLP/HTTP JSON push export of
  spans and metrics to an OpenTelemetry collector
  (``DLROVER_OTLP_ENDPOINT``), behind the same registry/tracer
  interfaces.
- :mod:`dlrover_tpu_torch.telemetry.timeline` — job timeline assembly from
  the per-process event logs (Chrome trace JSON, incident report,
  goodput-loss attribution); runnable as
  ``python -m dlrover_tpu_torch.telemetry.timeline``.
- :mod:`dlrover_tpu_torch.telemetry.schema` +
  :mod:`dlrover_tpu_torch.telemetry.check_events` — the event-schema
  registry and its call-site/log checker
  (``python -m dlrover_tpu_torch.telemetry.check_events``).
"""

from dlrover_tpu_torch.telemetry.events import (
    EVENT_SCHEMA_VERSION,
    TrainingEventExporter,
    collect_events,
    emit_event,
    read_events,
    set_event_source,
)
from dlrover_tpu_torch.telemetry.exporter import (
    PrometheusEndpoint,
    TextfileDumper,
)
from dlrover_tpu_torch.telemetry.metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    get_registry,
)
from dlrover_tpu_torch.telemetry.tracing import (
    SpanContext,
    Tracer,
    attach_context,
    get_tracer,
    inject_context,
    span,
)

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "get_registry",
    "SpanContext",
    "Tracer",
    "attach_context",
    "get_tracer",
    "inject_context",
    "span",
    "EVENT_SCHEMA_VERSION",
    "TrainingEventExporter",
    "collect_events",
    "emit_event",
    "read_events",
    "set_event_source",
    "PrometheusEndpoint",
    "TextfileDumper",
]
