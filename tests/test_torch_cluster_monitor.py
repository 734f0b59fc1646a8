"""Twins of ``tests/test_cluster_monitor.py`` for the port's standalone
Brain cluster monitor (``dlrover_tpu_torch/brain/cluster_monitor.py``),
plus its serving-fleet feed and event ingest: pod lifecycle events of
every job on a (mock) cluster feed the datastore, the router's windows
size the replica pool, and a job's event logs become a goodput
diagnosis row, with the master's ``DLROVER_BRAIN_DB`` hook calling it on
a cadence.

Each case runs with each package's classes on the same inputs, keeps
the reference's assertions and holds the port's job states, records and
sizes equal to the JAX package's.
"""

import json
import time
from types import SimpleNamespace

import dlrover_tpu.brain.cluster_monitor as j_cm
import dlrover_tpu.brain.datastore as j_ds
import dlrover_tpu.master.master as j_master
import dlrover_tpu.scheduler.kubernetes as j_k8s
import dlrover_tpu_torch.brain.cluster_monitor as t_cm
import dlrover_tpu_torch.brain.datastore as t_ds
import dlrover_tpu_torch.master.master as t_master
import dlrover_tpu_torch.scheduler.kubernetes as t_k8s

PKGS = {
    "jax": SimpleNamespace(cm=j_cm, ds=j_ds, k8s=j_k8s,
                           master=j_master),
    "torch": SimpleNamespace(cm=t_cm, ds=t_ds, k8s=t_k8s,
                             master=t_master),
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


def _pod(name, job, phase="Pending", reason=""):
    return {
        "metadata": {
            "name": name,
            "labels": {"app": "dlrover-tpu", "job": job},
        },
        "status": {"phase": phase, "reason": reason},
    }


def _wait(pred, timeout=10.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(0.05)
    return False


def _states(mon):
    return {
        name: (s.running, s.pending, s.failed, s.succeeded,
               s.relaunches, s.oom_kills)
        for name, s in mon.job_states().items()
    }


def _monitor(m):
    api = m.k8s.MockK8sApi()
    client = m.k8s.K8sClient(namespace="test", api=api)
    store = m.ds.SqliteJobMetricsStore(":memory:")
    mon = m.cm.ClusterMonitor(client, store, snapshot_interval=3600)
    mon.start()
    return api, store, mon


def test_cluster_monitor_aggregates_multi_job_lifecycle():
    def body(m, _d):
        api, store, mon = _monitor(m)
        try:
            api.create_pod("test", _pod("a-0", "job-a"))
            api.create_pod("test", _pod("a-1", "job-a"))
            api.create_pod("test", _pod("b-0", "job-b"))
            api.set_pod_phase("a-0", "Running")
            api.set_pod_phase("a-1", "Running")
            api.set_pod_phase("b-0", "Running")
            assert _wait(lambda: (
                "job-a" in mon.job_states()
                and mon.job_states()["job-a"].running == 2
            ))
            api.set_pod_phase("a-1", "Failed", reason="OOMKilled")
            assert _wait(
                lambda: mon.job_states()["job-a"].oom_kills == 1
            )
            api.create_pod("test", _pod("a-2", "job-a"))
            api.set_pod_phase("a-2", "Running")
            assert _wait(
                lambda: mon.job_states()["job-a"].relaunches == 1
            )
            api.set_pod_phase("b-0", "Succeeded")
            assert _wait(
                lambda: mon.job_states()["job-b"].succeeded == 1
            )
            names = set(store.job_names())
            assert {"job-a", "job-b"} <= names
            recs = store.load(job_name="job-a")
            assert recs
            assert recs[-1].workers == 2
            done = store.load(job_name="job-b")[-1]
            assert done.finished
            return _states(mon), recs[-1].workers, done.finished
        finally:
            mon.stop()

    _both(body)


def test_cluster_monitor_ignores_unlabeled_pods():
    def body(m, _d):
        api, _store, mon = _monitor(m)
        try:
            api.create_pod("test", {
                "metadata": {"name": "x", "labels": {}},
                "status": {"phase": "Running"},
            })
            api.create_pod("test", _pod("a-0", "job-a", phase="Running"))
            assert _wait(lambda: "job-a" in mon.job_states())
            assert set(mon.job_states()) == {"job-a"}
            return sorted(mon.job_states())
        finally:
            mon.stop()

    _both(body)


def test_cluster_monitor_handles_deleted_pods():
    def body(m, _d):
        api, store, mon = _monitor(m)
        try:
            api.create_pod("test", _pod("c-0", "job-c"))
            api.create_pod("test", _pod("c-1", "job-c"))
            api.set_pod_phase("c-0", "Running")
            api.set_pod_phase("c-1", "Running")
            assert _wait(lambda: (
                "job-c" in mon.job_states()
                and mon.job_states()["job-c"].running == 2
            ))
            api.delete_pod("test", "c-1")
            assert _wait(lambda: mon.job_states()["job-c"].running == 1)
            assert mon.job_states()["job-c"].failed >= 1
            api.create_pod("test", _pod("c-2", "job-c"))
            api.set_pod_phase("c-2", "Running")
            assert _wait(
                lambda: mon.job_states()["job-c"].relaunches == 1
            )
            api.set_pod_phase("c-0", "Succeeded")
            api.set_pod_phase("c-2", "Succeeded")
            api.delete_pod("test", "c-0")
            api.delete_pod("test", "c-2")
            assert _wait(
                lambda: store.load(job_name="job-c")
                and store.load(job_name="job-c")[-1].finished
            )
            return _states(mon)
        finally:
            mon.stop()

    _both(body)


def test_serving_fleet_snapshot_and_pool_size():
    """The router's window lands as a ``serving_fleet_snapshot`` row
    and sizes the pool alike in both packages (a spare member for
    drains once traffic flows)."""
    snaps = [
        {"members_up": 3, "qps": 900.0, "count": 450, "failed": 0,
         "stale": 0, "rerouted": 2, "p99_ms": 4.5,
         "generation_floor": 7, "members_draining": 1,
         "members_suspect": 0},
        {"members_up": 1, "qps": 10.0, "count": 5},
        {"members_up": 2, "qps": 0.0},
    ]

    def body(m, _d):
        store = m.ds.SqliteJobMetricsStore(":memory:")
        for i, s in enumerate(snaps):
            m.cm.record_serving_fleet_snapshot(store, "pool", s,
                                               timestamp=100.0 + i)
        rows = [vars(r) for r in store.load("pool")]
        extras = store.load_extras("pool")
        assert [e["event"] for e in extras] == [
            "serving_fleet_snapshot"] * 3
        sizes = [
            m.cm.suggest_serving_pool_size(s, qps_per_replica=q)
            for s in snaps for q in (100.0, 400.0, 5000.0)
        ]
        assert sizes[0] == 8 and sizes[2] == 2
        return rows, extras, sizes

    _both(body)


def test_brain_feed_skips_jobs_that_never_trained(tmp_path):
    def body(m, d):
        log = d / "lifecycle.jsonl"
        log.write_text(json.dumps(
            {"schema": 1, "ts": 1.0, "pid": 1, "source": "master",
             "type": "master_start", "job": "j", "port": 1,
             "node_num": 1, "metrics_port": 0}
        ) + "\n")
        store = m.ds.SqliteJobMetricsStore(":memory:")
        assert m.cm.ingest_job_events(store, "dead-job", [str(log)]) \
            is None
        assert store.load_extras("dead-job") == []
        return True

    _both(body, tmp_path)


def test_master_brain_auto_ingest(tmp_path, monkeypatch):
    """The master's run-loop Brain feed ships throughput snapshots and
    event-log diagnoses into the datastore on a cadence."""
    def body(m, d):
        events = d / "events.jsonl"
        t0 = 1_700_000_000.0
        with open(events, "w") as f:
            for i in range(4):
                f.write(json.dumps({
                    "schema": 1, "ts": t0 + i, "pid": 1,
                    "source": "trainer", "type": "train_step",
                    "step": i + 1, "restart_count": 0, "node_rank": 0,
                }) + "\n")
        monkeypatch.setenv("DLROVER_EVENT_LOG", str(events))
        monkeypatch.setenv("DLROVER_BRAIN_DB", str(d / "brain.db"))
        monkeypatch.setenv("DLROVER_BRAIN_INGEST_INTERVAL_S", "0.01")
        master = m.master.JobMaster(port=0, node_num=2, job_name="brainy")
        try:
            assert master.brain_store is not None
            master.speed_monitor.collect_global_step(1, t0 + 1)
            assert master.maybe_brain_ingest() is True
            master._brain_ingest_interval = 3600.0
            assert master.maybe_brain_ingest() is False
            rows = master.brain_store.load("brainy")
            assert rows, "no rows ingested"
            kinds = sorted(
                e.get("event")
                for e in master.brain_store.load_extras("brainy")
            )
            assert "throughput_snapshot" in kinds
        finally:
            master.stop()
        return kinds

    _both(body, tmp_path)
