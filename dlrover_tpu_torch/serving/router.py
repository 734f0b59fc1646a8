"""Freshness-aware lookup router over a serving-replica pool.

Copy of ``dlrover_tpu/serving/router.py`` (the port imports nothing of the JAX
package).

The serving plane's routing tier (ROADMAP item 4's "serve while one
replica re-bases"): N :class:`~dlrover_tpu_torch.serving.replica
.ServingReplica` processes ingest the same publisher generations
independently, and this router fronts them for lookup traffic.

Design, mirroring the training control plane:

* **Journaled membership.**  Replica joins, drain grants, admissions
  at a new generation and removals are records in a
  :class:`~dlrover_tpu_torch.master.journal.StateJournal` — a router
  kill/respawn replays them and resumes routing the SAME table
  (liveness is deliberately runtime-only: it re-establishes from the
  next heartbeat, exactly like agent liveness after a master
  restart).
* **Key-consistent routing.**  Owner = highest-random-weight over
  ``mix64(mix64(shard_key) ^ seed(replica))`` — the splitmix64
  finalizer the KvVariable partition already uses.  HRW gives the
  elasticity contract the pool needs: growing by one replica moves
  only the keys whose max score lands on it; shrinking moves only the
  removed replica's keys.
* **Least-loaded fallback + optional hedging.**  A suspect/draining/
  stale owner is skipped for the least-loaded eligible member; a
  forward failure marks the member suspect and re-routes in-line
  (outcome ``rerouted``, never a caller-visible failure while any
  member is healthy).  With ``hedge_ms > 0`` a straggling primary
  gets a second request on another member and the first answer wins.
* **Drain protocol.**  A replica asks to drain before applying a
  base generation; the router grants at most ``pool - min_available``
  concurrent drains, journals the grant (traffic shifts immediately)
  and re-admits the replica when its next status report carries the
  new generation.  Re-base becomes invisible: zero failed and zero
  stale-beyond-slack lookups, asserted from ``serving_route`` events.
* **Freshness floor.**  The router tracks the newest admitted
  generation; routed responses more than ``stale_slack`` generations
  behind it are counted under outcome ``stale`` (the event-provable
  staleness SLO), and per-replica admitted generations are monotonic
  by construction.
* **Brain feed.**  Each stats window lands in the Brain datastore
  (``DLROVER_BRAIN_DB``) as a routed-QPS/freshness snapshot so
  capacity logic can grow/shrink the pool like ResizeCoordinator
  grows the training fleet.
"""

import argparse
import os
import signal
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from dlrover_tpu_torch import chaos as _chaos
from dlrover_tpu_torch.common.comm import (
    MessageClient,
    MessageServer,
    RemoteError,
)
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.master.journal import StateJournal, replay_dir
from dlrover_tpu_torch.serving.messages import (
    DrainRequest,
    DrainResponse,
    LookupRequest,
    LookupResponse,
    ReplicaStatus,
    RoutingTableRequest,
    RoutingTableResponse,
)
from dlrover_tpu_torch.telemetry.events import emit_event
from dlrover_tpu_torch.telemetry.metrics import get_registry
from dlrover_tpu_torch.telemetry.slo import (
    HistogramWindow,
    estimate_quantile,
)

ROUTE_METRIC = "dlrover_serving_route_seconds"
# routed lookups are sub-ms to tens of ms — the registry's default
# 1ms..600s buckets would collapse every quantile into two buckets
ROUTE_BUCKETS = (
    0.0002, 0.0005, 0.001, 0.002, 0.005, 0.01, 0.02, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5,
)

BRAIN_DB_ENV = "DLROVER_BRAIN_DB"


def mix64(x: int) -> int:
    """Scalar splitmix64/murmur finalizer — the same constants as the
    vectorized ``checkpoint.sparse._hash64`` and ``Table::hash_key``
    in the C++ store, so every plane partitions keys identically."""
    x &= 0xFFFFFFFFFFFFFFFF
    x ^= x >> 33
    x = (x * 0xFF51AFD7ED558CCD) & 0xFFFFFFFFFFFFFFFF
    x ^= x >> 33
    x = (x * 0xC4CEB9FE1A85EC53) & 0xFFFFFFFFFFFFFFFF
    x ^= x >> 33
    return x


def hrw_owner(shard_key: int, replica_ids: List[int]) -> int:
    """Highest-random-weight owner of ``shard_key`` among
    ``replica_ids`` — only keys whose argmax moves re-route when the
    member set changes."""
    mixed = mix64(int(shard_key))
    return max(
        replica_ids, key=lambda rid: mix64(mixed ^ mix64(rid + 1))
    )


@dataclass
class Member:
    """One pool member.  Journaled identity/state + runtime liveness
    (``last_seen``/``suspect`` restart at zero after a router respawn
    and re-establish from the next heartbeat)."""

    replica_id: int
    addr: str
    generation: int = -1
    draining: bool = False
    drain_target: int = -1
    removed: bool = False
    # --- runtime only (never journaled) ---
    last_seen: float = 0.0
    suspect: bool = False
    inflight: int = 0
    respawned: bool = False

    def journal_view(self) -> Dict:
        return {
            "replica_id": self.replica_id,
            "addr": self.addr,
            "generation": self.generation,
            "draining": self.draining,
            "drain_target": self.drain_target,
            "removed": self.removed,
        }


class RoutingTable:
    """Replayable routing state.  Every mutation is a journal record
    (``member`` / ``drain`` / ``admit`` / ``remove``) applied through
    the same transition the replay path uses, so a restarted router
    reconstructs the identical table from the journal alone."""

    def __init__(self, journal_dir: Optional[str] = None):
        self.members: Dict[int, Member] = {}
        self.generation_floor = -1
        self._journal: Optional[StateJournal] = None
        self.last_seq = 0
        if journal_dir:
            self._journal = StateJournal(journal_dir)
            replay = self._journal.recovered
            if replay.snapshot:
                self._load_snapshot(replay.snapshot)
            for seq, kind, data in replay.entries:
                self._apply(kind, data)
                self.last_seq = seq

    @classmethod
    def replayed(cls, journal_dir: str) -> "RoutingTable":
        """Cold read-only replay (no journal handle kept open) — what
        the determinism test diffs against the live table."""
        table = cls()
        replay = replay_dir(journal_dir)
        if replay.snapshot:
            table._load_snapshot(replay.snapshot)
        for seq, kind, data in replay.entries:
            table._apply(kind, data)
            table.last_seq = seq
        return table

    def _load_snapshot(self, snap: Dict):
        self.generation_floor = int(snap.get("generation_floor", -1))
        for view in snap.get("members", []):
            m = Member(
                replica_id=int(view["replica_id"]),
                addr=view["addr"],
                generation=int(view.get("generation", -1)),
                draining=bool(view.get("draining")),
                drain_target=int(view.get("drain_target", -1)),
                removed=bool(view.get("removed")),
            )
            self.members[m.replica_id] = m

    def _apply(self, kind: str, data: Dict):
        rid = int(data.get("replica_id", -1))
        if kind == "member":
            m = self.members.get(rid)
            if m is None:
                m = Member(replica_id=rid, addr=data.get("addr", ""))
                self.members[rid] = m
            m.addr = data.get("addr", m.addr)
            m.removed = False
            gen = int(data.get("generation", -1))
            if gen > m.generation:
                m.generation = gen
        elif kind == "drain":
            m = self.members.get(rid)
            if m is not None:
                m.draining = True
                m.drain_target = int(data.get("target_generation", -1))
        elif kind == "admit":
            m = self.members.get(rid)
            if m is not None:
                gen = int(data.get("generation", -1))
                m.draining = False
                m.drain_target = -1
                # admitted generations are monotonic per replica by
                # construction — a regression is simply not applied
                if gen > m.generation:
                    m.generation = gen
                if gen > self.generation_floor:
                    self.generation_floor = gen
        elif kind == "remove":
            m = self.members.get(rid)
            if m is not None:
                m.removed = True

    def record(self, kind: str, data: Dict):
        """Journal-then-apply (the order a replay reproduces)."""
        if self._journal is not None:
            self.last_seq = self._journal.append(kind, data)
        self._apply(kind, data)

    def snapshot(self) -> Dict:
        return {
            "generation_floor": self.generation_floor,
            "members": [
                m.journal_view()
                for _, m in sorted(self.members.items())
            ],
        }

    def close(self):
        if self._journal is not None:
            try:
                self._journal.snapshot(self.snapshot(), self.last_seq)
            except Exception:  # noqa: BLE001 - best-effort final
                logger.exception("routing table snapshot failed")
            self._journal.close()
            self._journal = None


class LookupRouter:
    """The routing process: one ``MessageServer`` for lookups + status
    reports, one fail-fast ``MessageClient`` per member for forwards,
    a journaled :class:`RoutingTable`, and a stats/health loop."""

    def __init__(
        self,
        journal_dir: Optional[str] = None,
        port: int = 0,
        heartbeat_timeout_s: float = 1.5,
        min_available: int = 1,
        stale_slack: int = 1,
        hedge_ms: float = 0.0,
        forward_timeout_s: float = 10.0,
        stats_every_s: float = 1.0,
        brain_db: Optional[str] = None,
        job_name: str = "serving-fleet",
    ):
        self._table = RoutingTable(journal_dir)
        self._lock = threading.RLock()
        self._clients: Dict[int, MessageClient] = {}
        self._client_addrs: Dict[int, str] = {}
        self._heartbeat_timeout = heartbeat_timeout_s
        self._min_available = max(1, min_available)
        self._stale_slack = max(0, stale_slack)
        self._hedge_ms = hedge_ms
        self._forward_timeout = forward_timeout_s
        self._stats_every = stats_every_s
        self._routed = 0
        self._outcomes = {
            k: 0 for k in ("ok", "rerouted", "stale", "failed")
        }
        self._hedged = 0
        self._stop = threading.Event()
        self._window = HistogramWindow()
        reg = get_registry()
        self._route_hist = reg.histogram(
            ROUTE_METRIC,
            "Routed lookup latency through the serving router "
            "(labels: outcome = ok / rerouted / stale / failed)",
            buckets=ROUTE_BUCKETS,
        )
        self._members_gauge = reg.gauge(
            "dlrover_serving_pool_members",
            "Serving pool members by state (label: state)",
        )
        self._floor_gauge = reg.gauge(
            "dlrover_serving_generation_floor",
            "Newest admitted serving generation across the pool",
        )
        self._brain_store = None
        self._job_name = job_name
        brain_db = brain_db or os.environ.get(BRAIN_DB_ENV, "")
        if brain_db:
            try:
                from dlrover_tpu_torch.brain.datastore import (
                    SqliteJobMetricsStore,
                )

                self._brain_store = SqliteJobMetricsStore(brain_db)
            except Exception:  # noqa: BLE001 - feed is best-effort
                logger.exception("brain datastore open failed")
        self._server = MessageServer(port, _Handler(self))
        self._server.start()
        self._stats_thread = threading.Thread(
            target=self._stats_loop, daemon=True, name="route-stats"
        )
        self._stats_thread.start()
        logger.info(
            "lookup router on port %s (journal=%s)",
            self._server.port, journal_dir,
        )

    @property
    def port(self) -> int:
        return self._server.port

    @property
    def table(self) -> RoutingTable:
        return self._table

    # ------------------------------------------------------------------
    # membership / drain
    # ------------------------------------------------------------------

    def on_status(self, st: ReplicaStatus) -> bool:
        with self._lock:
            m = self._table.members.get(st.replica_id)
            joined = m is None or m.removed or m.addr != st.addr
            if joined:
                self._table.record("member", {
                    "replica_id": st.replica_id,
                    "addr": st.addr,
                    "generation": st.generation,
                })
                m = self._table.members[st.replica_id]
            gen_changed = st.generation > m.generation
            if gen_changed:
                # covers both the steady-state advance and the
                # re-admission at a drained-for base generation
                # (admit clears the draining flag in _apply)
                self._table.record("admit", {
                    "replica_id": st.replica_id,
                    "generation": st.generation,
                })
            m.last_seen = time.monotonic()
            was_suspect = m.suspect
            m.suspect = False
            m.respawned = st.respawned
            if joined or gen_changed or was_suspect:
                emit_event(
                    "replica_status",
                    replica_id=st.replica_id,
                    addr=st.addr,
                    generation=int(st.generation),
                    state=(
                        "joined" if joined
                        else "recovered" if was_suspect
                        else "admitted"
                    ),
                    draining=bool(m.draining),
                    respawned=bool(st.respawned),
                )
        return True

    def on_drain(self, req: DrainRequest) -> DrainResponse:
        with self._lock:
            m = self._table.members.get(req.replica_id)
            if m is None or m.removed:
                return DrainResponse(False, "unknown replica")
            if m.draining:
                return DrainResponse(True, "already draining")
            avail = [
                x for x in self._eligible()
                if x.replica_id != req.replica_id
            ]
            if len(avail) < self._min_available:
                return DrainResponse(
                    False,
                    f"pool would drop below min_available="
                    f"{self._min_available}",
                )
            self._table.record("drain", {
                "replica_id": req.replica_id,
                "target_generation": req.target_generation,
            })
            emit_event(
                "replica_status",
                replica_id=req.replica_id,
                addr=m.addr,
                generation=int(m.generation),
                state="draining",
                draining=True,
                target_generation=int(req.target_generation),
            )
            return DrainResponse(True, "")

    def remove(self, replica_id: int):
        """Planned removal (pool shrink) — journaled, unlike a
        heartbeat loss."""
        with self._lock:
            m = self._table.members.get(replica_id)
            if m is None or m.removed:
                return
            self._table.record("remove", {"replica_id": replica_id})
            emit_event(
                "replica_status",
                replica_id=replica_id,
                addr=m.addr,
                generation=int(m.generation),
                state="removed",
                draining=False,
            )
            client = self._clients.pop(replica_id, None)
            self._client_addrs.pop(replica_id, None)
        if client is not None:
            client.close()

    def _eligible(self) -> List[Member]:
        """Members lookups may route to (caller holds the lock)."""
        floor = self._table.generation_floor
        out = []
        for m in self._table.members.values():
            if m.removed or m.draining or m.suspect:
                continue
            if m.generation < 0:
                continue  # never admitted anything servable
            if m.generation < floor - self._stale_slack:
                continue  # beyond the staleness slack: not routable
            out.append(m)
        return out

    # ------------------------------------------------------------------
    # routing
    # ------------------------------------------------------------------

    def _client_for(self, m: Member) -> MessageClient:
        client = self._clients.get(m.replica_id)
        if client is None or self._client_addrs.get(
            m.replica_id
        ) != m.addr:
            if client is not None:
                client.close()
            # fail-fast: the ROUTER owns retries (on another member),
            # not the transport envelope
            client = MessageClient(
                m.addr, node_id=-2, node_type="router",
                timeout=self._forward_timeout, retries=1,
                backoff_base=0.05, backoff_max=0.05,
                resync_timeout=0.0,
            )
            self._clients[m.replica_id] = client
            self._client_addrs[m.replica_id] = m.addr
        return client

    def _forward(self, m: Member, req: LookupRequest) -> LookupResponse:
        with self._lock:
            client = self._client_for(m)
            m.inflight += 1
        try:
            resp = client.get(req)
        finally:
            with self._lock:
                m.inflight -= 1
        if not isinstance(resp, LookupResponse):
            raise RemoteError(
                "BadResponse", f"unexpected reply {type(resp)}"
            )
        return resp

    def _forward_hedged(
        self, primary: Member, backup: Member, req: LookupRequest
    ) -> LookupResponse:
        """Primary in a worker thread; if it straggles past
        ``hedge_ms`` fire the backup and take the first success."""
        result: Dict[str, object] = {}
        done = threading.Event()

        def _run(member, slot):
            try:
                result.setdefault(slot, self._forward(member, req))
            except Exception as e:  # noqa: BLE001
                result.setdefault(slot, e)
            done.set()

        threading.Thread(
            target=_run, args=(primary, "a"), daemon=True
        ).start()
        if not done.wait(self._hedge_ms / 1e3):
            self._hedged += 1
            _run(backup, "b")
        else:
            done.wait()
        for slot in ("a", "b"):
            got = result.get(slot)
            if isinstance(got, LookupResponse):
                return got
        got = result.get("a") or result.get("b")
        raise got if isinstance(got, Exception) else RemoteError(
            "HedgeFailed", "no response"
        )

    def route(self, req: LookupRequest) -> LookupResponse:
        t0 = time.perf_counter()
        self._routed += 1
        _chaos.fire("serving.route", step=self._routed)
        outcome = "ok"
        resp: Optional[LookupResponse] = None
        with self._lock:
            candidates = self._eligible()
            floor = self._table.generation_floor
            if candidates:
                owner_id = hrw_owner(
                    req.shard_key, [m.replica_id for m in candidates]
                )
                by_id = {m.replica_id: m for m in candidates}
                order = [by_id[owner_id]] + sorted(
                    (m for m in candidates
                     if m.replica_id != owner_id),
                    key=lambda m: m.inflight,
                )
            else:
                order = []
        for i, m in enumerate(order):
            try:
                if (
                    self._hedge_ms > 0 and i == 0 and len(order) > 1
                ):
                    resp = self._forward_hedged(m, order[1], req)
                else:
                    resp = self._forward(m, req)
                if i > 0:
                    outcome = "rerouted"
                break
            except Exception:  # noqa: BLE001 - shed and re-route
                with self._lock:
                    m.suspect = True
                logger.warning(
                    "forward to replica %d failed; marked suspect",
                    m.replica_id,
                )
                emit_event(
                    "replica_status",
                    replica_id=m.replica_id,
                    addr=m.addr,
                    generation=int(m.generation),
                    state="suspect",
                    draining=bool(m.draining),
                )
        if resp is None:
            outcome = "failed"
        elif resp.generation < floor - self._stale_slack:
            outcome = "stale"
        self._outcomes[outcome] += 1
        self._route_hist.observe(
            time.perf_counter() - t0, outcome=outcome
        )
        if resp is None:
            raise RemoteError(
                "NoReplicaAvailable",
                "no healthy serving replica answered",
            )
        resp.outcome = outcome
        return resp

    # ------------------------------------------------------------------
    # stats / health loop
    # ------------------------------------------------------------------

    def _sweep_liveness(self):
        now = time.monotonic()
        with self._lock:
            for m in self._table.members.values():
                if m.removed or m.suspect or m.last_seen == 0.0:
                    continue
                if now - m.last_seen > self._heartbeat_timeout:
                    m.suspect = True
                    logger.warning(
                        "replica %d missed heartbeats for %.2fs; "
                        "shedding", m.replica_id, now - m.last_seen,
                    )
                    emit_event(
                        "replica_status",
                        replica_id=m.replica_id,
                        addr=m.addr,
                        generation=int(m.generation),
                        state="lost",
                        draining=bool(m.draining),
                    )

    def stats_snapshot(self, window_s: float) -> Dict:
        deltas = self._window.deltas(self._route_hist.collect())
        merged_counts: List[int] = []
        bounds: List[float] = []
        total = 0
        per_outcome: Dict[str, int] = {}
        for entry in deltas.values():
            per_outcome[
                entry["labels"].get("outcome", "?")
            ] = entry["count"]
            total += entry["count"]
            if not merged_counts:
                merged_counts = list(entry["counts"])
                bounds = entry["bounds"]
            else:
                merged_counts = [
                    a + b
                    for a, b in zip(merged_counts, entry["counts"])
                ]
        with self._lock:
            floor = self._table.generation_floor
            states = {"up": 0, "draining": 0, "suspect": 0}
            for m in self._table.members.values():
                if m.removed:
                    continue
                if m.suspect:
                    states["suspect"] += 1
                elif m.draining:
                    states["draining"] += 1
                else:
                    states["up"] += 1
        snap = {
            "count": total,
            "qps": round(total / window_s, 2) if window_s > 0 else 0.0,
            "window_s": round(window_s, 3),
            "generation_floor": int(floor),
            "members_up": states["up"],
            "members_draining": states["draining"],
            "members_suspect": states["suspect"],
            "hedged": self._hedged,
        }
        for k in ("ok", "rerouted", "stale", "failed"):
            snap[k] = int(per_outcome.get(k, 0))
        if total and merged_counts:
            snap["p50_ms"] = round(estimate_quantile(
                bounds, merged_counts, 0.5
            ) * 1e3, 4)
            snap["p99_ms"] = round(estimate_quantile(
                bounds, merged_counts, 0.99
            ) * 1e3, 4)
        return snap

    def _stats_loop(self):
        last = time.monotonic()
        while not self._stop.wait(self._stats_every):
            self._sweep_liveness()
            now = time.monotonic()
            snap = self.stats_snapshot(now - last)
            last = now
            self._members_gauge.set(
                snap["members_up"], state="up"
            )
            self._members_gauge.set(
                snap["members_draining"], state="draining"
            )
            self._members_gauge.set(
                snap["members_suspect"], state="suspect"
            )
            self._floor_gauge.set(float(snap["generation_floor"]))
            if snap["count"] or snap["members_up"]:
                emit_event("serving_route", **snap)
            self._feed_brain(snap)

    def _feed_brain(self, snap: Dict):
        if self._brain_store is None:
            return
        try:
            from dlrover_tpu_torch.brain.cluster_monitor import (
                record_serving_fleet_snapshot,
            )

            record_serving_fleet_snapshot(
                self._brain_store, self._job_name, snap
            )
        except Exception:  # noqa: BLE001 - feed is best-effort
            logger.exception("brain serving-fleet feed failed")

    def stop(self):
        self._stop.set()
        self._server.stop()
        self._stats_thread.join(timeout=5.0)
        with self._lock:
            clients = list(self._clients.values())
            self._clients.clear()
        for c in clients:
            c.close()
        self._table.close()
        if self._brain_store is not None:
            try:
                self._brain_store.close()
            except Exception:  # noqa: BLE001
                pass


class _Handler:
    """RequestHandler facade dispatching by message class."""

    def __init__(self, router: LookupRouter):
        self._router = router

    def report(self, node_id, node_type, message) -> bool:
        if isinstance(message, ReplicaStatus):
            return self._router.on_status(message)
        return False

    def get(self, node_id, node_type, message):
        if isinstance(message, LookupRequest):
            return self._router.route(message)
        if isinstance(message, DrainRequest):
            return self._router.on_drain(message)
        if isinstance(message, RoutingTableRequest):
            table = self._router.table
            return RoutingTableResponse(
                members={
                    rid: m.journal_view()
                    for rid, m in table.members.items()
                },
                generation_floor=table.generation_floor,
                journal_seq=table.last_seq,
            )
        return None


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m dlrover_tpu_torch.serving.router",
        description="serving-fleet lookup router",
    )
    parser.add_argument("--port", type=int, default=0)
    parser.add_argument("--port-file", default="",
                        help="write the bound port here once up")
    parser.add_argument("--journal-dir", required=True)
    parser.add_argument("--heartbeat-timeout", type=float,
                        default=1.5)
    parser.add_argument("--min-available", type=int, default=1)
    parser.add_argument("--stale-slack", type=int, default=1)
    parser.add_argument("--hedge-ms", type=float, default=0.0)
    parser.add_argument("--stats-every", type=float, default=1.0)
    parser.add_argument("--stop-file", default="")
    args = parser.parse_args(argv)

    stop = threading.Event()

    def _on_term(signum, frame):  # noqa: ARG001
        stop.set()

    signal.signal(signal.SIGTERM, _on_term)
    signal.signal(signal.SIGINT, _on_term)

    router = LookupRouter(
        journal_dir=args.journal_dir,
        port=args.port,
        heartbeat_timeout_s=args.heartbeat_timeout,
        min_available=args.min_available,
        stale_slack=args.stale_slack,
        hedge_ms=args.hedge_ms,
        stats_every_s=args.stats_every,
    )
    if args.port_file:
        tmp = args.port_file + ".tmp"
        with open(tmp, "w") as f:
            f.write(str(router.port))
        os.replace(tmp, args.port_file)
    try:
        while not stop.wait(0.1):
            if args.stop_file and os.path.exists(args.stop_file):
                break
    finally:
        router.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
