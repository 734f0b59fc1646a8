"""Twins of ``tests/test_serving_router.py`` for the port's lookup
router (``dlrover_tpu_torch/serving/router.py``): HRW routing that moves
only the keys whose owner changed, the journaled routing table that a
respawned router replays to the live one, the owner fallback, the drain
protocol, hedged forwards, the stats window and the replicas' textfile
metrics.

Each case drives both packages' routers through the same sequence (a
fake replica per package answers over that package's transport) and
holds the port's observations (owners, outcomes, replica ids, table
snapshots, stats counts) equal to the JAX package's, the reference's
``fleet.scoreboard`` identity check (the scoreboard's per-verb window IS
the telemetry ``HistogramWindow``) included.
"""

import time
import urllib.request
from types import SimpleNamespace

import numpy as np

import dlrover_tpu.checkpoint.sparse as j_sparse
import dlrover_tpu.common.comm as j_comm
import dlrover_tpu.fleet.scoreboard as j_scoreboard
import dlrover_tpu.serving.messages as j_msg
import dlrover_tpu.serving.router as j_router
import dlrover_tpu.telemetry.exporter as j_exp
import dlrover_tpu.telemetry.metrics as j_metrics
import dlrover_tpu.telemetry.slo as j_slo
import dlrover_tpu_torch.checkpoint.sparse as t_sparse
import dlrover_tpu_torch.common.comm as t_comm
import dlrover_tpu_torch.fleet.scoreboard as t_scoreboard
import dlrover_tpu_torch.serving.messages as t_msg
import dlrover_tpu_torch.serving.router as t_router
import dlrover_tpu_torch.telemetry.exporter as t_exp
import dlrover_tpu_torch.telemetry.metrics as t_metrics
import dlrover_tpu_torch.telemetry.slo as t_slo

PKGS = {
    "jax": SimpleNamespace(comm=j_comm, msg=j_msg, router=j_router,
                           sparse=j_sparse, exp=j_exp,
                           metrics=j_metrics, slo=j_slo),
    "torch": SimpleNamespace(comm=t_comm, msg=t_msg, router=t_router,
                             sparse=t_sparse, exp=t_exp,
                             metrics=t_metrics, slo=t_slo),
}


def _both(body, tmp_path=None):
    out = {}
    for name, m in PKGS.items():
        d = None
        if tmp_path is not None:
            d = tmp_path / name
            d.mkdir()
        out[name] = body(m, d)
    assert out["torch"] == out["jax"]
    return out["torch"]


def test_hrw_only_moved_keys_reroute():
    def body(m, _d):
        hrw_owner = m.router.hrw_owner
        keys = list(range(2000))
        before = {k: hrw_owner(k, [0, 1, 2]) for k in keys}
        grown = {k: hrw_owner(k, [0, 1, 2, 3]) for k in keys}
        moved = [k for k in keys if grown[k] != before[k]]
        assert moved, "growing a pool must claim some keys"
        assert all(grown[k] == 3 for k in moved)
        assert len(moved) < len(keys) / 2
        shrunk = {k: hrw_owner(k, [0, 2]) for k in keys}
        for k in keys:
            if before[k] != 1:
                assert shrunk[k] == before[k], k
            else:
                assert shrunk[k] in (0, 2)
        counts = {}
        for k in keys:
            counts[before[k]] = counts.get(before[k], 0) + 1
        assert min(counts.values()) > len(keys) / 6, counts
        return before, grown, shrunk

    _both(body)


def test_mix64_matches_vectorized_hash():
    def body(m, _d):
        keys = np.array([0, 1, 7, 12345, 2**63 - 1], dtype=np.int64)
        vec = m.sparse._hash64(keys)
        for k, h in zip(keys.tolist(), vec.tolist()):
            assert m.router.mix64(k) == h & 0xFFFFFFFFFFFFFFFF
        return [m.router.mix64(k) for k in keys.tolist()]

    _both(body)


def test_routing_table_replay_determinism(tmp_path):
    def body(m, d):
        RoutingTable = m.router.RoutingTable
        jdir = str(d / "journal")
        live = RoutingTable(jdir)
        live.record("member", {"replica_id": 0, "addr": "a:1",
                               "generation": 1})
        live.record("member", {"replica_id": 1, "addr": "b:2",
                               "generation": 1})
        live.record("admit", {"replica_id": 0, "generation": 3})
        live.record("drain", {"replica_id": 1, "target_generation": 4})
        live.record("admit", {"replica_id": 1, "generation": 4})
        live.record("member", {"replica_id": 2, "addr": "c:3",
                               "generation": 4})
        live.record("remove", {"replica_id": 2})
        replayed = RoutingTable.replayed(jdir)
        assert replayed.snapshot() == live.snapshot()
        assert replayed.generation_floor == 4
        assert replayed.members[1].draining is False
        assert replayed.members[2].removed is True
        live.record("admit", {"replica_id": 0, "generation": 2})
        assert live.members[0].generation == 3
        snap_before = live.snapshot()
        live.close()
        assert RoutingTable.replayed(jdir).snapshot() == snap_before
        reopened = RoutingTable(jdir)
        try:
            assert reopened.snapshot() == snap_before
        finally:
            reopened.close()
        return snap_before

    _both(body, tmp_path)


class _FakeReplica:
    """Minimal replica over one package's transport: a real
    MessageServer answering lookups with a fixed generation, with an
    optional service delay."""

    def __init__(self, m, replica_id: int, generation: int,
                 delay_s: float = 0.0):
        self.m = m
        self.replica_id = replica_id
        self.generation = generation
        self.delay_s = delay_s
        self.fail = False
        self.served = 0
        self.server = m.comm.MessageServer(0, self)
        self.server.start()

    @property
    def addr(self) -> str:
        return f"127.0.0.1:{self.server.port}"

    def status(self, **kw):
        return self.m.msg.ReplicaStatus(
            replica_id=self.replica_id, addr=self.addr,
            generation=self.generation, **kw,
        )

    def report(self, node_id, node_type, message) -> bool:
        return True

    def get(self, node_id, node_type, message):
        if isinstance(message, self.m.msg.LookupRequest):
            if self.fail:
                raise RuntimeError("replica is down")
            if self.delay_s:
                time.sleep(self.delay_s)
            self.served += 1
            return self.m.msg.LookupResponse(
                values=np.zeros((1, 2), dtype=np.float32),
                generation=self.generation,
                replica_id=self.replica_id,
            )
        return None

    def stop(self):
        self.server.stop()


def _router(m, d, **kw):
    kw.setdefault("heartbeat_timeout_s", 30.0)
    kw.setdefault("stats_every_s", 30.0)
    return m.router.LookupRouter(journal_dir=str(d / "journal"), **kw)


def _owned_by(m, rid, members):
    return next(
        k for k in range(1000) if m.router.hrw_owner(k, members) == rid
    )


def test_route_owner_fallback_and_suspect(tmp_path):
    def body(m, d):
        router = _router(m, d, min_available=1)
        a = _FakeReplica(m, 0, generation=5)
        b = _FakeReplica(m, 1, generation=5)
        seen = []
        try:
            router.on_status(a.status())
            router.on_status(b.status())
            key = _owned_by(m, 0, [0, 1])
            LookupRequest = m.msg.LookupRequest
            resp = router.route(LookupRequest(shard_key=key))
            assert resp.outcome == "ok" and resp.replica_id == 0
            seen.append((resp.outcome, resp.replica_id))
            a.fail = True
            resp = router.route(LookupRequest(shard_key=key))
            assert resp.outcome == "rerouted" and resp.replica_id == 1
            assert router.table.members[0].suspect
            seen.append((resp.outcome, resp.replica_id))
            resp = router.route(LookupRequest(shard_key=key))
            assert resp.outcome == "ok" and resp.replica_id == 1
            seen.append((resp.outcome, resp.replica_id))
            a.fail = False
            router.on_status(a.status())
            assert not router.table.members[0].suspect
        finally:
            router.stop()
            a.stop()
            b.stop()
        return key, seen

    _both(body, tmp_path)


def test_drain_protocol_grant_deny_readmit(tmp_path):
    def body(m, d):
        router = _router(m, d, min_available=1)
        a = _FakeReplica(m, 0, generation=3)
        b = _FakeReplica(m, 1, generation=3)
        DrainRequest = m.msg.DrainRequest
        try:
            router.on_status(a.status())
            router.on_status(b.status())
            grant = router.on_drain(
                DrainRequest(replica_id=0, target_generation=4))
            assert grant.granted
            deny = router.on_drain(
                DrainRequest(replica_id=1, target_generation=4))
            assert not deny.granted and "min_available" in deny.reason
            key = _owned_by(m, 0, [0, 1])
            resp = router.route(m.msg.LookupRequest(shard_key=key))
            assert resp.replica_id == 1 and resp.outcome == "ok"
            a.generation = 4
            router.on_status(a.status())
            member = router.table.members[0]
            assert not member.draining and member.generation == 4
            assert router.table.generation_floor == 4
            assert router.on_drain(
                DrainRequest(replica_id=1, target_generation=4)
            ).granted
            view = {rid: (mm.generation, mm.draining)
                    for rid, mm in router.table.members.items()}
        finally:
            router.stop()
            a.stop()
            b.stop()
        return deny.reason, view

    _both(body, tmp_path)


def test_hedged_forward_takes_first_answer(tmp_path):
    def body(m, d):
        router = _router(m, d, hedge_ms=20.0)
        slow = _FakeReplica(m, 0, generation=2, delay_s=0.4)
        fast = _FakeReplica(m, 1, generation=2)
        try:
            router.on_status(slow.status())
            router.on_status(fast.status())
            key = _owned_by(m, 0, [0, 1])
            t0 = time.perf_counter()
            resp = router.route(m.msg.LookupRequest(shard_key=key))
            dt = time.perf_counter() - t0
            assert resp.replica_id == 1, "backup's answer must win"
            assert dt < 0.4, f"hedge did not cut the straggle: {dt:.3f}s"
            assert router._hedged >= 1
        finally:
            router.stop()
            slow.stop()
            fast.stop()
        return resp.replica_id, resp.generation

    _both(body, tmp_path)


def test_router_restart_replays_membership(tmp_path):
    def body(m, d):
        r1 = _router(m, d)
        a = _FakeReplica(m, 0, generation=7)
        b = _FakeReplica(m, 1, generation=7)
        try:
            r1.on_status(a.status())
            r1.on_status(b.status())
            r1.on_drain(m.msg.DrainRequest(replica_id=0,
                                           target_generation=8))
            want = r1.table.snapshot()
            r1.stop()
            r2 = _router(m, d)
            try:
                assert r2.table.snapshot() == want
                assert r2.table.members[0].draining
                resp = r2.route(m.msg.LookupRequest(shard_key=1))
                assert resp.replica_id == 1 and resp.outcome == "ok"
            finally:
                r2.stop()
        finally:
            a.stop()
            b.stop()
        # addresses hold each run's own ports
        return {k: v for k, v in want.items() if k != "members"}, [
            {k: v for k, v in mm.items() if k != "addr"}
            for mm in want["members"]
        ]

    _both(body, tmp_path)


def test_route_over_real_transport_and_stats(tmp_path):
    def body(m, d):
        router = _router(m, d, min_available=1)
        a = _FakeReplica(m, 0, generation=8)
        router.on_status(a.status())
        a.generation = 9
        router.on_status(a.status())
        router.stats_snapshot(window_s=0.1)
        client = m.comm.MessageClient(
            f"127.0.0.1:{router.port}", node_id=0,
            node_type="test-load", timeout=10.0, retries=2,
            backoff_base=0.05, backoff_max=0.1, resync_timeout=0.0,
        )
        try:
            for k in range(20):
                resp = client.get(m.msg.LookupRequest(
                    keys=np.arange(4, dtype=np.int64), shard_key=k,
                ))
                assert resp.outcome == "ok" and resp.generation == 9
            snap = router.stats_snapshot(window_s=1.0)
            assert snap["count"] == 20 and snap["ok"] == 20
            assert snap["failed"] == 0 and snap["stale"] == 0
            assert snap["p99_ms"] >= snap["p50_ms"] > 0
            assert snap["generation_floor"] == 9
            assert snap["members_up"] == 1
        finally:
            client.close()
            router.stop()
            a.stop()
        return {k: snap[k] for k in ("count", "ok", "failed", "stale",
                                     "generation_floor", "members_up")}

    _both(body, tmp_path)


def test_shared_quantile_estimator_is_single_implementation():
    """One quantile implementation: the scoreboard's per-verb window IS
    the telemetry ``HistogramWindow``, and the replica / router
    percentiles come from the same bucket-interpolated estimator."""
    assert t_scoreboard._VerbWindow is t_slo.HistogramWindow
    assert j_scoreboard._VerbWindow is j_slo.HistogramWindow

    def body(m, _d):
        reg = m.metrics.MetricsRegistry()
        hist = reg.histogram(
            "t_seconds", "t", buckets=(0.001, 0.01, 0.1, 1.0)
        )
        for v in (0.002, 0.003, 0.02, 0.05, 0.5):
            hist.observe(v)
        window = m.slo.HistogramWindow()
        entry = next(iter(window.deltas(hist.collect()).values()))
        assert entry["count"] == 5
        q = m.slo.window_quantiles_ms(entry)
        assert 1.0 <= q["p50_ms"] <= 100.0
        assert q["p99_ms"] >= q["p50_ms"]
        again = next(iter(window.deltas(hist.collect()).values()))
        assert again["count"] == 0
        # the router's percentiles come from the same estimator
        assert m.router.estimate_quantile is m.slo.estimate_quantile
        return q

    _both(body)


def test_replica_prom_files_aggregate_into_master_metrics(tmp_path):
    def body(m, d):
        for rid, count in ((0, 11), (1, 7)):
            with open(d / f"replica{rid}.prom", "w") as f:
                f.write(
                    "# HELP dlrover_serving_lookup_seconds lookup\n"
                    "# TYPE dlrover_serving_lookup_seconds histogram\n"
                    "dlrover_serving_lookup_seconds_count "
                    f"{count}\n"
                    f"dlrover_serving_lookup_seconds_sum 0.{count}\n"
                )
        glob = str(d / "replica*.prom")
        merged = m.exp.aggregate_textfiles(glob)
        assert 'agent="replica0"' in merged
        assert 'agent="replica1"' in merged
        endpoint = m.exp.PrometheusEndpoint(
            port=0, registry=m.metrics.MetricsRegistry(),
            aggregate_glob=glob,
        )
        endpoint.start()
        try:
            body = urllib.request.urlopen(
                f"http://127.0.0.1:{endpoint.port}/metrics", timeout=10
            ).read().decode()
        finally:
            endpoint.stop()
        for line in (
            'dlrover_serving_lookup_seconds_count{agent="replica0"} 11',
            'dlrover_serving_lookup_seconds_count{agent="replica1"} 7',
        ):
            assert line in body
        return merged.replace(str(d), "<dir>")

    _both(body, tmp_path)
