"""Standalone serving-replica process.

Copy of ``dlrover_tpu/serving/__main__.py`` (the port imports nothing of the JAX
package).

``python -m dlrover_tpu_torch.serving --dir <serving_dir>`` runs a
read-only replica next to a live training job: an ingest poller keeps
the tables at the newest committed generation while lookup traffic
flows through the native host-gather path — the "user traffic" half
of the train-to-serve loop.

Two traffic modes, composable:

* **Self-driving** (the original, default): the main thread drives
  seeded lookup batches, the serving-plane microbenchmark shape.
* **Fleet member** (``--serve-port``/``--router``): a
  ``MessageServer`` answers routed ``LookupRequest`` batches, a
  heartbeat thread pushes :class:`ReplicaStatus` to the lookup
  router, and the drain protocol runs before every base re-base (the
  replica asks the router to shift traffic away, applies the O(1)
  staged swap, and re-admits at the new generation through its next
  status report).  ``--no-self-traffic`` turns the seeded loop off
  for pool members.

Lookup latency lands in the ``dlrover_serving_lookup_seconds``
histogram; the periodic ``serving_lookup_stats`` event estimates
p50/p99 from its windowed bucket deltas via the SAME
bucket-interpolated estimator the SLO checker and fleet Scoreboard
use — one quantile implementation everywhere.  ``--metrics-prom``
dumps the registry as a textfile for the master's
``DLROVER_METRICS_AGGREGATE_GLOB`` aggregation, so per-replica
windows survive the replica process.

``--lookup-floor-ms`` models the accelerator-side gather latency a
TPU-backed replica pays per batch (this CI box is CPU-only); it makes
per-request service time latency-dominated, which is what the routed
QPS scaling bench measures.

Arms chaos from ``DLROVER_CHAOS`` like every other job process (the
``serving.ingest`` hook lives inside the replica's apply path), and
exits cleanly on SIGTERM, ``--duration`` expiry, or the appearance of
``--stop-file``.
"""

import argparse
import os
import signal
import sys
import threading
import time

import numpy as np

from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.serving.replica import ServingReplica
from dlrover_tpu_torch.telemetry.events import emit_event
from dlrover_tpu_torch.telemetry.metrics import get_registry
from dlrover_tpu_torch.telemetry.slo import (
    HistogramWindow,
    window_quantiles_ms,
)

LOOKUP_METRIC = "dlrover_serving_lookup_seconds"
LOOKUP_BUCKETS = (
    0.0001, 0.0002, 0.0005, 0.001, 0.002, 0.005, 0.01, 0.02,
    0.05, 0.1, 0.25, 0.5, 1.0,
)


class _LookupService:
    """Fleet-member plumbing: routed-lookup server + router client
    (heartbeats, drain protocol)."""

    def __init__(self, replica, args, hist, stop):
        from dlrover_tpu_torch.common.comm import (
            MessageClient,
            MessageServer,
        )

        self._replica = replica
        self._args = args
        self._hist = hist
        self._stop = stop
        self._replica_id = args.replica_id
        self._floor_s = max(0.0, args.lookup_floor_ms) / 1e3
        self._served = 0
        self._last_window = {"p50_ms": 0.0, "p99_ms": 0.0, "qps": 0.0}
        self._server = None
        self._router = None
        self._drain_grace_t0 = {}
        if args.serve_port is not None:
            self._server = MessageServer(args.serve_port, self)
            self._server.start()
            if args.port_file:
                tmp = args.port_file + ".tmp"
                with open(tmp, "w") as f:
                    f.write(str(self._server.port))
                os.replace(tmp, args.port_file)
        if args.router:
            # fail-fast transport: a dead router must never wedge the
            # heartbeat/drain paths — the loops own the retrying
            self._router = MessageClient(
                args.router, node_id=args.replica_id,
                node_type="serving", timeout=5.0, retries=1,
                backoff_base=0.05, backoff_max=0.1,
                resync_timeout=0.0,
            )
            replica.pre_base_hook = self._request_drain
            threading.Thread(
                target=self._heartbeat_loop, daemon=True,
                name="replica-heartbeat",
            ).start()

    @property
    def addr(self) -> str:
        return (
            f"127.0.0.1:{self._server.port}" if self._server else ""
        )

    # -- routed lookups (comm.RequestHandler interface) ----------------

    def get(self, node_id, node_type, message):
        from dlrover_tpu_torch.serving.messages import (
            LookupRequest,
            LookupResponse,
        )

        if not isinstance(message, LookupRequest):
            return None
        t0 = time.perf_counter()
        values = self._replica.lookup(message.keys, message.table)
        if self._floor_s:
            # modeled device-gather floor (see module docstring)
            remain = self._floor_s - (time.perf_counter() - t0)
            if remain > 0:
                time.sleep(remain)
        self._hist.observe(time.perf_counter() - t0)
        self._served += 1
        return LookupResponse(
            values=values,
            generation=self._replica.generation,
            replica_id=self._replica_id,
        )

    def report(self, node_id, node_type, message) -> bool:
        return False

    # -- router-facing loops -------------------------------------------

    def _status(self, draining=False):
        from dlrover_tpu_torch.serving.messages import ReplicaStatus

        return ReplicaStatus(
            replica_id=self._replica_id,
            addr=self.addr,
            generation=self._replica.generation,
            draining=draining,
            respawned=self._replica.respawned,
            lookups=self._served,
            p50_ms=self._last_window["p50_ms"],
            p99_ms=self._last_window["p99_ms"],
            qps=self._last_window["qps"],
        )

    def push_status(self):
        if self._router is None:
            return
        try:
            self._router.report(self._status())
        except Exception:  # noqa: BLE001 - next beat retries
            logger.debug("replica heartbeat failed", exc_info=True)

    def note_window(self, stats):
        self._last_window = {
            "p50_ms": stats.get("p50_ms", 0.0),
            "p99_ms": stats.get("p99_ms", 0.0),
            "qps": stats.get("qps", 0.0),
        }

    def _heartbeat_loop(self):
        while not self._stop.wait(self._args.heartbeat):
            self.push_status()

    def _request_drain(self, gen: int) -> bool:
        """pre_base_hook: ask the router to shift traffic before the
        re-base.  Denied -> defer (next poll retries).  Router
        unreachable -> defer up to ``drain_grace`` seconds, then
        proceed (no reachable router means no routed traffic to
        protect)."""
        from dlrover_tpu_torch.serving.messages import DrainRequest

        try:
            resp = self._router.get(DrainRequest(
                replica_id=self._replica_id, target_generation=gen,
            ))
            granted = bool(getattr(resp, "granted", False))
            if granted:
                self._drain_grace_t0.pop(gen, None)
                logger.info(
                    "drain granted for base generation %d", gen
                )
            return granted
        except Exception:  # noqa: BLE001 - router down/respawning
            t0 = self._drain_grace_t0.setdefault(
                gen, time.monotonic()
            )
            if time.monotonic() - t0 >= self._args.drain_grace:
                logger.warning(
                    "router unreachable for %.1fs; re-basing to "
                    "generation %d without a drain grant",
                    time.monotonic() - t0, gen,
                )
                self._drain_grace_t0.pop(gen, None)
                return True
            return False

    def stop(self):
        self.push_status()  # final generation, best-effort
        if self._server is not None:
            self._server.stop()
        if self._router is not None:
            self._router.close()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m dlrover_tpu_torch.serving",
        description="read-only embedding serving replica",
    )
    parser.add_argument("--dir", required=True,
                        help="serving directory (publisher output)")
    parser.add_argument("--poll", type=float, default=0.2,
                        help="ingest poll interval seconds")
    parser.add_argument("--batch", type=int, default=256,
                        help="lookup batch size")
    parser.add_argument("--key-space", type=int, default=4000,
                        help="lookup keys drawn from [0, key_space)")
    parser.add_argument("--seed", type=int, default=0,
                        help="lookup traffic seed")
    parser.add_argument("--qps", type=float, default=0.0,
                        help="target lookup batches/s (0 = max rate)")
    parser.add_argument("--duration", type=float, default=0.0,
                        help="exit after this many seconds (0 = run "
                             "until stopped)")
    parser.add_argument("--stop-file", default="",
                        help="exit when this path appears")
    parser.add_argument("--stats-every", type=float, default=1.0,
                        help="serving_lookup_stats cadence seconds")
    # --- serving-fleet membership ---
    parser.add_argument("--replica-id", type=int, default=0,
                        help="pool member id (stable across respawns)")
    parser.add_argument("--serve-port", type=int, default=None,
                        help="answer routed lookups on this port "
                             "(0 = auto; omit to disable the server)")
    parser.add_argument("--port-file", default="",
                        help="write the bound lookup port here")
    parser.add_argument("--router", default="",
                        help="lookup router host:port (enables "
                             "heartbeats + the drain protocol)")
    parser.add_argument("--heartbeat", type=float, default=0.3,
                        help="router status-report cadence seconds")
    parser.add_argument("--drain-grace", type=float, default=5.0,
                        help="re-base without a grant after the "
                             "router is unreachable this long")
    parser.add_argument("--metrics-prom", default="",
                        help="textfile registry dump path (master "
                             "aggregation via "
                             "DLROVER_METRICS_AGGREGATE_GLOB)")
    parser.add_argument("--lookup-floor-ms", type=float, default=0.0,
                        help="modeled per-batch device-gather floor")
    parser.add_argument("--no-self-traffic", action="store_true",
                        help="serve routed traffic only (pool member)")
    args = parser.parse_args(argv)

    stop = threading.Event()

    def _on_term(signum, frame):  # noqa: ARG001
        stop.set()

    signal.signal(signal.SIGTERM, _on_term)
    signal.signal(signal.SIGINT, _on_term)

    replica = ServingReplica(args.dir)
    hist = get_registry().histogram(
        LOOKUP_METRIC,
        "Per-batch lookup latency on this replica",
        buckets=LOOKUP_BUCKETS,
    )
    window = HistogramWindow()
    window.reset(hist.collect())

    service = _LookupService(replica, args, hist, stop)

    dumper = None
    if args.metrics_prom:
        from dlrover_tpu_torch.telemetry.exporter import TextfileDumper

        dumper = TextfileDumper(
            args.metrics_prom,
            interval=max(1.0, args.stats_every),
        )
        dumper.start()

    def poller():
        while not stop.wait(args.poll):
            try:
                if replica.ingest_pending():
                    # prompt re-admission at the new generation —
                    # don't leave it to the next heartbeat
                    service.push_status()
            except Exception:  # noqa: BLE001 - keep serving
                logger.exception("serving ingest poll failed")

    threading.Thread(target=poller, daemon=True,
                     name="serving-ingest").start()

    def flush_window(window_s: float, rows: int = 0):
        """One shared-estimator stats window over the histogram's
        bucket deltas (self-driven AND routed lookups both observe
        into it)."""
        deltas = window.deltas(hist.collect())
        entry = next(iter(deltas.values()), None)
        if entry is None or entry["count"] == 0:
            return
        stats = window_quantiles_ms(entry)
        stats.update(
            count=int(entry["count"]),
            rows=int(rows) if rows else int(
                entry["count"] * args.batch
            ),
            qps=round(entry["count"] / window_s, 2),
            window_s=round(window_s, 3),
            generation=replica.generation,
            replica=args.replica_id,
        )
        service.note_window(stats)
        emit_event("serving_lookup_stats", **stats)

    rng = np.random.default_rng(args.seed)
    deadline = (
        time.monotonic() + args.duration if args.duration else None
    )
    window_t0 = time.monotonic()
    rows = 0
    min_interval = 1.0 / args.qps if args.qps > 0 else 0.0
    while not stop.is_set():
        now = time.monotonic()
        if deadline is not None and now >= deadline:
            break
        if args.stop_file and os.path.exists(args.stop_file):
            break
        if not replica.tables:
            # nothing committed yet: wait for the first base
            try:
                replica.ingest_pending()
            except Exception:  # noqa: BLE001
                logger.exception("serving ingest failed")
            time.sleep(min(args.poll, 0.1))
            continue
        if args.no_self_traffic:
            # routed traffic observes into the histogram from the
            # server threads; this loop only flushes windows
            time.sleep(min(args.stats_every, 0.1))
        else:
            keys = rng.integers(
                0, args.key_space, args.batch
            ).astype(np.int64)
            t0 = time.perf_counter()
            replica.lookup(keys)
            hist.observe(time.perf_counter() - t0)
            rows += args.batch
            if min_interval:
                time.sleep(min_interval)
        if now - window_t0 >= args.stats_every:
            flush_window(now - window_t0, rows)
            window_t0 = now
            rows = 0
    # final window so short runs still report
    flush_window(max(1e-9, time.monotonic() - window_t0), rows)
    stop.set()
    service.stop()
    if dumper is not None:
        dumper.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
