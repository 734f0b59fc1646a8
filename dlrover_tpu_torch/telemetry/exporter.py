"""Metric export surfaces: master scrape endpoint + agent textfile.

Copy of ``dlrover_tpu/telemetry/exporter.py`` (the port imports
nothing of the JAX package).

- :class:`PrometheusEndpoint`: a threaded HTTP server answering
  ``GET /metrics`` with the registry's text exposition — the master
  serves this next to its message port so one scrape covers the whole
  job's control-plane view (reference capability: the master's
  monitor/metric reporting, surfaced in standard exposition format).
- :class:`TextfileDumper`: agents (no stable scrape address under
  churn) periodically write the same exposition to a file for the
  node-exporter textfile collector to pick up.
- :func:`aggregate_textfiles`: folds the agents' textfile dumps into
  one exposition (every sample tagged ``agent="<file stem>"``); the
  master's endpoint appends it when ``DLROVER_METRICS_AGGREGATE_GLOB``
  points at the dump files, so ONE scrape of the master also covers
  worker-side metrics — no per-agent scrape targets under churn.  The
  chaos invariant checkers read worker metrics through the same
  aggregation.
"""

import glob as _glob
import json as _json
import os
import threading
from collections import OrderedDict
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional

from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.telemetry import metrics as _metrics

METRICS_PORT_ENV = "DLROVER_METRICS_PORT"
METRICS_TEXTFILE_ENV = "DLROVER_METRICS_TEXTFILE"
METRICS_AGGREGATE_ENV = "DLROVER_METRICS_AGGREGATE_GLOB"
CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

# sample-name suffixes that belong to their base metric family
_FAMILY_SUFFIXES = ("_bucket", "_sum", "_count")


def _parse_families(
    text: str,
) -> "OrderedDict[str, Dict[str, object]]":
    """Prometheus text exposition -> ordered
    ``{family: {"help", "type", "samples": [raw line, ...]}}``.
    Sample lines are kept verbatim; family attribution follows the
    preceding ``# TYPE`` block, falling back to suffix stripping."""
    fams: "OrderedDict[str, Dict[str, object]]" = OrderedDict()

    def fam(name: str) -> Dict[str, object]:
        return fams.setdefault(
            name, {"help": "", "type": "", "samples": []}
        )

    current = ""
    for line in text.splitlines():
        if not line.strip():
            continue
        if line.startswith("# HELP "):
            name, _, help_ = line[len("# HELP "):].partition(" ")
            f = fam(name)
            f["help"] = f["help"] or help_
            current = name
        elif line.startswith("# TYPE "):
            name, _, type_ = line[len("# TYPE "):].partition(" ")
            f = fam(name)
            f["type"] = f["type"] or type_.strip()
            current = name
        elif line.startswith("#"):
            continue
        else:
            brace = line.find("{")
            space = line.find(" ")
            end = brace if 0 <= brace < (
                space if space >= 0 else len(line)
            ) else space
            sname = line[:end] if end >= 0 else line
            family = sname
            if sname not in fams:
                if current and (
                    sname == current
                    or any(
                        sname == current + sfx
                        for sfx in _FAMILY_SUFFIXES
                    )
                ):
                    family = current
                else:
                    for sfx in _FAMILY_SUFFIXES:
                        if sname.endswith(sfx) and (
                            sname[: -len(sfx)] in fams
                        ):
                            family = sname[: -len(sfx)]
                            break
            fam(family)["samples"].append(line)
    return fams


def _with_label(line: str, key: str, value: str) -> str:
    """Inject ``key="value"`` into one raw sample line."""
    escaped = (
        value.replace("\\", "\\\\").replace('"', '\\"')
    )
    brace = line.find("{")
    space = line.find(" ")
    if 0 <= brace < (space if space >= 0 else len(line)):
        close = line.rfind("}")
        if close < 0:
            return line
        inner = line[brace + 1:close].strip()
        sep = "," if inner else ""
        return (
            line[:close] + f'{sep}{key}="{escaped}"' + line[close:]
        )
    if space < 0:
        return line
    return f'{line[:space]}{{{key}="{escaped}"}}{line[space:]}'


def _render_families(fams) -> str:
    lines: List[str] = []
    for name, f in fams.items():
        if f["help"]:
            lines.append(f"# HELP {name} {f['help']}")
        if f["type"]:
            lines.append(f"# TYPE {name} {f['type']}")
        lines.extend(f["samples"])
    return "\n".join(lines) + ("\n" if lines else "")


# mtime/size cache for aggregate_textfiles: a hundreds-of-agents
# deployment re-reading + re-parsing + re-labeling every .prom file
# on EVERY /metrics scrape made the scrape itself a fan-in hot spot.
# Keyed by path; entries hold the already-agent-labeled families so
# an unchanged file costs one stat().  Bounded implicitly by the dump
# population (stale paths are pruned each call).
_AGG_CACHE: Dict[str, tuple] = {}
_AGG_CACHE_LOCK = threading.Lock()


def _labeled_families(path: str):
    """Parsed + agent-labeled families for one dump file, served
    from the mtime/size cache when the file is unchanged."""
    try:
        st = os.stat(path)
        key = (st.st_mtime_ns, st.st_size)
    except OSError as e:
        logger.debug("cannot stat textfile dump %s: %s", path, e)
        return None
    with _AGG_CACHE_LOCK:
        hit = _AGG_CACHE.get(path)
        if hit is not None and hit[0] == key:
            return hit[1]
    try:
        with open(path) as f:
            text = f.read()
    except OSError as e:
        logger.debug("cannot read textfile dump %s: %s", path, e)
        return None
    stem = os.path.splitext(os.path.basename(path))[0]
    labeled = OrderedDict()
    for name, parsed in _parse_families(text).items():
        labeled[name] = {
            "help": parsed["help"],
            "type": parsed["type"],
            "samples": [
                _with_label(line, "agent", stem)
                for line in parsed["samples"]
            ],
        }
    with _AGG_CACHE_LOCK:
        _AGG_CACHE[path] = (key, labeled)
    return labeled


def aggregate_textfiles(pattern: str) -> str:
    """Merge every textfile dump matching ``pattern`` into one
    exposition; each file's samples get an ``agent="<stem>"`` label so
    same-named worker series never collide across agents.  Unchanged
    files are served from an mtime/size cache so a fleet-sized scrape
    stays cheap; ``dlrover_metrics_aggregated_files`` reports how
    many dumps the last scrape folded in."""
    fams: "OrderedDict[str, Dict[str, object]]" = OrderedDict()
    paths = sorted(_glob.glob(pattern))
    merged_files = 0
    for path in paths:
        labeled = _labeled_families(path)
        if labeled is None:
            continue
        merged_files += 1
        for name, parsed in labeled.items():
            merged = fams.setdefault(
                name, {"help": "", "type": "", "samples": []}
            )
            merged["help"] = merged["help"] or parsed["help"]
            merged["type"] = merged["type"] or parsed["type"]
            merged["samples"].extend(parsed["samples"])
    with _AGG_CACHE_LOCK:
        for stale in set(_AGG_CACHE) - set(paths):
            del _AGG_CACHE[stale]
    _metrics.get_registry().gauge(
        "dlrover_metrics_aggregated_files",
        "Agent textfile dumps folded into the last /metrics scrape",
    ).set(merged_files)
    return _render_families(fams)


def merge_expositions(primary: str, *others: str) -> str:
    """Concatenate expositions family-wise: one HELP/TYPE per family,
    samples appended in order.  Callers are responsible for label
    disambiguation (``aggregate_textfiles`` already tags its samples)."""
    fams = _parse_families(primary)
    for text in others:
        for name, parsed in _parse_families(text).items():
            merged = fams.setdefault(
                name, {"help": "", "type": "", "samples": []}
            )
            merged["help"] = merged["help"] or parsed["help"]
            merged["type"] = merged["type"] or parsed["type"]
            merged["samples"].extend(parsed["samples"])
    return _render_families(fams)


class _MetricsHandler(BaseHTTPRequestHandler):
    def do_GET(self):  # noqa: N802 - http.server API
        registry: _metrics.MetricsRegistry = (
            self.server.registry  # type: ignore[attr-defined]
        )
        path = self.path.split("?")[0]
        if path == "/timeline":
            self._serve_timeline()
            return
        if path not in ("/metrics", "/"):
            self.send_error(404)
            return
        text = registry.render_prometheus()
        pattern = (
            getattr(self.server, "aggregate_glob", "")
            or os.environ.get(METRICS_AGGREGATE_ENV, "")
        )
        if pattern:
            try:
                text = merge_expositions(
                    text, aggregate_textfiles(pattern)
                )
            except Exception as e:  # noqa: BLE001 - never fail a scrape
                logger.warning(
                    "agent textfile aggregation failed: %s", e
                )
        body = text.encode()
        self.send_response(200)
        self.send_header("Content-Type", CONTENT_TYPE)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _serve_timeline(self):
        """GET /timeline: the assembled job flight recorder — Chrome
        trace-event JSON by default (loadable in Perfetto),
        ``?format=report`` for the plain-text incident report.
        Sources: the endpoint's configured event files plus the
        agent-shipping glob (``DLROVER_EVENTS_AGGREGATE_GLOB``), the
        event analog of the metrics textfile aggregation."""
        from dlrover_tpu_torch.telemetry import timeline as _timeline

        try:
            sources = (
                list(getattr(self.server, "event_sources", None) or [])
                or _timeline.default_sources()
            )
            events = _timeline.collect_events(sources)
            tl = _timeline.assemble(events)
            attribution = _timeline.attribute_goodput_loss(tl)
            if "format=report" in (self.path.split("?", 1) + [""])[1]:
                body = _timeline.to_report(tl, attribution).encode()
                ctype = "text/plain; charset=utf-8"
            else:
                body = _json.dumps(
                    _timeline.to_chrome_trace(tl, attribution),
                    default=str,
                ).encode()
                ctype = "application/json"
        except Exception as e:  # noqa: BLE001 - never fail the server
            logger.warning("timeline assembly failed: %s", e)
            self.send_error(500, "timeline assembly failed")
            return
        self.send_response(200)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, fmt, *args):  # silence per-scrape stderr
        pass


class PrometheusEndpoint:
    """``GET /metrics`` over a daemon thread (start()/stop() matches
    the master's aux-service interface)."""

    def __init__(
        self,
        port: int = 0,
        host: str = "0.0.0.0",
        registry: Optional[_metrics.MetricsRegistry] = None,
        aggregate_glob: str = "",
        event_sources: Optional[List[str]] = None,
    ):
        """``aggregate_glob``: glob of agent textfile dumps folded
        into every scrape response (one master scrape covers
        worker-side metrics); defaults to
        ``DLROVER_METRICS_AGGREGATE_GLOB`` at request time.
        ``event_sources``: event-log paths/globs ``/timeline``
        assembles from; defaults to ``DLROVER_EVENT_LOG`` +
        ``DLROVER_EVENTS_AGGREGATE_GLOB`` at request time."""
        self._requested_port = port
        self._host = host
        self._registry = registry or _metrics.get_registry()
        self._aggregate_glob = aggregate_glob
        self._event_sources = event_sources
        self._server: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self.port = 0

    def start(self):
        if self._server is not None:
            return
        try:
            self._server = ThreadingHTTPServer(
                (self._host, self._requested_port), _MetricsHandler
            )
        except OSError as e:
            # telemetry must never be a hard dependency: a stolen or
            # privileged port degrades to "no endpoint", not a dead
            # master
            logger.warning(
                "metrics endpoint cannot bind port %s (%s); "
                "metrics endpoint disabled",
                self._requested_port, e,
            )
            self._server = None
            return
        self._server.daemon_threads = True
        self._server.registry = self._registry  # type: ignore[attr-defined]
        self._server.aggregate_glob = (  # type: ignore[attr-defined]
            self._aggregate_glob
        )
        self._server.event_sources = (  # type: ignore[attr-defined]
            self._event_sources
        )
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever,
            name="metrics-endpoint",
            daemon=True,
        )
        self._thread.start()
        logger.info("metrics endpoint serving on port %s", self.port)

    def stop(self):
        if self._server is None:
            return
        self._server.shutdown()
        self._server.server_close()
        self._server = None
        self._thread = None


class TextfileDumper:
    """Periodic registry dump for node-exporter textfile collection
    (agent fallback when there is no scrapeable address)."""

    def __init__(
        self,
        path: str,
        interval: float = 15.0,
        registry: Optional[_metrics.MetricsRegistry] = None,
    ):
        self._path = path
        self._interval = interval
        self._registry = registry or _metrics.get_registry()
        self._stopped = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def dump_once(self) -> bool:
        try:
            tmp = self._path + ".tmp"
            with open(tmp, "w") as f:
                f.write(self._registry.render_prometheus())
            os.replace(tmp, self._path)
            return True
        except OSError as e:
            logger.debug("metrics textfile dump failed: %s", e)
            return False

    def start(self):
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._run, daemon=True, name="metrics-textfile"
            )
            self._thread.start()

    def _run(self):
        self.dump_once()  # a dump exists from the start, not at t+15s
        while not self._stopped.wait(self._interval):
            self.dump_once()
        self.dump_once()  # final flush so short runs leave a dump

    def stop(self):
        self._stopped.set()
        # wait for the final flush: without the join a short-lived
        # agent can exit (killing the daemon thread) before the dump
        # lands, leaving no .prom file at all
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
