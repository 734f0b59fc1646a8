"""Span tracer with cross-RPC parent/child propagation.

Copy of ``dlrover_tpu/telemetry/tracing.py``.  A span is one timed
operation (``ckpt.restore``, ``rdzv.join``, ``node_check``); nesting
inside a process rides a ``contextvars`` context variable.  Crossing
the master<->agent RPC rides a trace-context field that the master's
transport injects into every frame (``inject_context`` and
``attach_context`` here); that transport comes with the launcher in
slice 3b of the port.

Every finished span is (1) kept in a bounded in-memory buffer for
in-process consumers/tests, (2) observed into the
``dlrover_span_seconds`` histogram of the global metrics registry,
and (3) emitted as a ``span`` training event when an event log is
configured.
"""

import contextvars
import threading
import time
import uuid
from collections import deque
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from dlrover_tpu_torch.telemetry import events as _events
from dlrover_tpu_torch.telemetry import metrics as _metrics

TRACE_ID_KEY = "trace_id"
SPAN_ID_KEY = "span_id"


@dataclass(frozen=True)
class SpanContext:
    trace_id: str
    span_id: str


_current_span: "contextvars.ContextVar[Optional[SpanContext]]" = (
    contextvars.ContextVar("dlrover_current_span", default=None)
)


def _new_id() -> str:
    return uuid.uuid4().hex[:16]


@dataclass
class Span:
    name: str
    trace_id: str
    span_id: str
    parent_id: Optional[str] = None
    start_time: float = 0.0
    end_time: float = 0.0
    status: str = "ok"
    attributes: Dict[str, object] = field(default_factory=dict)

    @property
    def duration(self) -> float:
        return max(0.0, self.end_time - self.start_time)

    @property
    def context(self) -> SpanContext:
        return SpanContext(self.trace_id, self.span_id)

    def set_attribute(self, key: str, value):
        self.attributes[key] = value


class Tracer:
    def __init__(
        self,
        registry: Optional[_metrics.MetricsRegistry] = None,
        max_finished: int = 2048,
    ):
        self._registry = registry or _metrics.get_registry()
        self._duration_hist = self._registry.histogram(
            "dlrover_span_seconds", "Span durations by span name"
        )
        self._finished: "deque[Span]" = deque(maxlen=max_finished)
        self._lock = threading.Lock()
        # push exporters (OTLP) subscribe here instead of patching
        # instrumentation sites: every finished span is handed to each
        # listener, failures swallowed (telemetry must never raise)
        self._listeners: List = []

    def add_listener(self, fn):
        """Register ``fn(span)`` called once per finished span."""
        with self._lock:
            if fn not in self._listeners:
                self._listeners.append(fn)

    def remove_listener(self, fn):
        with self._lock:
            if fn in self._listeners:
                self._listeners.remove(fn)

    @contextmanager
    def span(self, name: str, **attributes):
        parent = _current_span.get()
        trace_id = parent.trace_id if parent else _new_id()
        s = Span(
            name=name,
            trace_id=trace_id,
            span_id=_new_id(),
            parent_id=parent.span_id if parent else None,
            start_time=time.time(),
            attributes=dict(attributes),
        )
        token = _current_span.set(s.context)
        try:
            yield s
        except BaseException as e:
            s.status = "error"
            s.attributes.setdefault("error", repr(e))
            raise
        finally:
            _current_span.reset(token)
            s.end_time = time.time()
            self._record(s)

    def _record(self, s: Span):
        with self._lock:
            self._finished.append(s)
            listeners = list(self._listeners)
        for fn in listeners:
            try:
                fn(s)
            except Exception:  # noqa: BLE001 - exporter bug must not
                pass  # kill the instrumented operation
        try:
            self._duration_hist.observe(s.duration, name=s.name)
        except Exception:  # noqa: BLE001 - telemetry must not raise
            pass
        _events.emit_event(
            "span",
            name=s.name,
            trace_id=s.trace_id,
            span_id=s.span_id,
            parent_id=s.parent_id,
            duration_s=round(s.duration, 6),
            status=s.status,
            attributes=s.attributes,
        )

    def finished_spans(self, name: Optional[str] = None) -> List[Span]:
        with self._lock:
            spans = list(self._finished)
        if name is not None:
            spans = [s for s in spans if s.name == name]
        return spans

    def clear(self):
        with self._lock:
            self._finished.clear()


_default_tracer: Optional[Tracer] = None
_default_lock = threading.Lock()


def get_tracer() -> Tracer:
    global _default_tracer
    with _default_lock:
        if _default_tracer is None:
            _default_tracer = Tracer()
        return _default_tracer


@contextmanager
def span(name: str, **attributes):
    """``with trace.span("rdzv.join", node_rank=r):`` on the global
    tracer."""
    with get_tracer().span(name, **attributes) as s:
        yield s


def current_context() -> Optional[SpanContext]:
    return _current_span.get()


def inject_context() -> Optional[Dict[str, str]]:
    """The wire form comm.py appends to each frame (None when no span
    is active — the common case costs one ContextVar read)."""
    ctx = _current_span.get()
    if ctx is None:
        return None
    return {TRACE_ID_KEY: ctx.trace_id, SPAN_ID_KEY: ctx.span_id}


@contextmanager
def attach_context(wire_ctx: Optional[Dict[str, str]]):
    """Server side: adopt the caller's trace context for the scope of
    a handler dispatch, so handler-opened spans become its children.
    Tolerates None/malformed (a no-op) — telemetry must never break
    the control plane."""
    if not isinstance(wire_ctx, dict):
        yield
        return
    trace_id = wire_ctx.get(TRACE_ID_KEY)
    span_id = wire_ctx.get(SPAN_ID_KEY)
    if not (isinstance(trace_id, str) and isinstance(span_id, str)):
        yield
        return
    token = _current_span.set(SpanContext(trace_id, span_id))
    try:
        yield
    finally:
        _current_span.reset(token)
