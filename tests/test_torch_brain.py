"""Twins of the non-BO cases of ``tests/test_brain.py`` and of
``tests/test_brain_stats.py`` for the port's Brain
(``dlrover_tpu_torch/brain/{service,datastore,optimizer_chain}.py``) and
the master's Brain hooks (``DLROVER_BRAIN_DB``,
``BrainStatsReporter``).

Each case runs its body with each package's classes on the same inputs,
keeps the reference's assertions for both, and holds the port's plans,
records and counts equal to the JAX package's.  The two BO cases are
twinned in ``tests/test_torch_optim_extra.py``.
"""

import json
import subprocess
import sys
import threading
import time
from types import SimpleNamespace

import pytest

import dlrover_tpu.brain as j_brain
import dlrover_tpu.brain.datastore as j_ds
import dlrover_tpu.brain.optimizer_chain as j_chain
import dlrover_tpu.brain.service as j_service
import dlrover_tpu.common.constants as j_const
import dlrover_tpu.master.master as j_master
import dlrover_tpu.master.speed_monitor as j_speed
import dlrover_tpu.master.stats as j_stats
import dlrover_tpu.scheduler.kubernetes as j_k8s
import dlrover_tpu_torch.brain as t_brain
import dlrover_tpu_torch.brain.datastore as t_ds
import dlrover_tpu_torch.brain.optimizer_chain as t_chain
import dlrover_tpu_torch.brain.service as t_service
import dlrover_tpu_torch.common.constants as t_const
import dlrover_tpu_torch.master.master as t_master
import dlrover_tpu_torch.master.speed_monitor as t_speed
import dlrover_tpu_torch.master.stats as t_stats
import dlrover_tpu_torch.scheduler.kubernetes as t_k8s

PKGS = {
    "jax": SimpleNamespace(
        name="dlrover_tpu", brain=j_brain, ds=j_ds, chain=j_chain,
        service=j_service, const=j_const, master=j_master,
        speed=j_speed, stats=j_stats, k8s=j_k8s),
    "torch": SimpleNamespace(
        name="dlrover_tpu_torch", brain=t_brain, ds=t_ds, chain=t_chain,
        service=t_service, const=t_const, master=t_master,
        speed=t_speed, stats=t_stats, k8s=t_k8s),
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


def _plan(plan):
    return (plan.worker_count, plan.memory_mb, plan.comment)


# -- tests/test_brain.py ------------------------------------------------------


def test_brain_initial_plan_from_history(tmp_path):
    def body(m, d):
        store = m.brain.JobMetricsStore(str(d / "metrics.jsonl"))
        for name, workers, sps, params in (
            ("job-a", 4, 100.0, 1_000_000),
            ("job-b", 8, 120.0, 1_000_000),
            ("job-c", 2, 90.0, 50_000_000),
        ):
            store.persist(m.service.JobMetricRecord(
                job_name=name, workers=workers, samples_per_sec=sps,
                model_params=params, finished=True,
            ))
        brain = m.brain.BrainService(store, job_name="new-job")
        plan = brain.initial_resource_plan(model_params=1_100_000)
        assert plan.worker_count in (4, 8)
        assert "similar job" in plan.comment
        return _plan(plan)

    _both(body, tmp_path)


def test_brain_worker_plan_prefers_best_observed(tmp_path):
    def body(m, d):
        store = m.brain.JobMetricsStore(str(d / "m.jsonl"))
        brain = m.brain.BrainService(store, job_name="j1")
        for w, sps in ((2, 100.0), (4, 150.0), (8, 160.0)):
            brain.persist_metrics(workers=w, samples_per_sec=sps)
        plan = brain.generate_worker_plan(8, m.speed.SpeedMonitor())
        assert plan.worker_count == 2
        return _plan(plan)

    _both(body, tmp_path)


WRITER = r"""
import sys
from {pkg}.brain.datastore import SqliteJobMetricsStore
from {pkg}.brain.service import JobMetricRecord

db, job, n = sys.argv[1], sys.argv[2], int(sys.argv[3])
store = SqliteJobMetricsStore(db)
for i in range(n):
    store.persist(JobMetricRecord(
        job_name=job, timestamp=float(i), workers=2,
        samples_per_sec=100.0 + i,
    ), event="snap", i=i)
store.close()
"""


def test_multi_process_writers_one_datastore(tmp_path):
    """Several writer PROCESSES with their own sqlite connections feed
    one datastore file; every row lands."""
    def body(m, d):
        db = str(d / "brain.db")
        n_jobs, n_rows = 4, 40
        procs = [
            subprocess.Popen(
                [sys.executable, "-c", WRITER.format(pkg=m.name), db,
                 f"job{j}", str(n_rows)],
                stderr=subprocess.PIPE,
            )
            for j in range(n_jobs)
        ]
        for p in procs:
            _out, err = p.communicate(timeout=120)
            assert p.returncode == 0, err.decode()[-2000:]
        store = m.ds.SqliteJobMetricsStore(db)
        try:
            assert sorted(store.job_names()) == [
                f"job{j}" for j in range(n_jobs)
            ]
            got = {}
            for j in range(n_jobs):
                rows = store.load(f"job{j}")
                assert len(rows) == n_rows, (
                    f"job{j}: {len(rows)}/{n_rows} rows survived the "
                    "concurrent write storm"
                )
                extras = store.load_extras(f"job{j}")
                assert {e["i"] for e in extras} == set(range(n_rows))
                # (a zero timestamp is stamped with the wall clock)
                got[j] = sorted(
                    (r.workers, r.samples_per_sec) for r in rows
                )
        finally:
            store.close()
        return got

    _both(body, tmp_path)


def test_two_journal_backed_masters_one_brain_db(tmp_path, monkeypatch):
    """TWO journal-backed port masters auto-ingest into ONE
    ``DLROVER_BRAIN_DB`` datastore concurrently: both jobs' throughput
    snapshots land, keyed by job name, with no lost writes (the JAX
    package's masters, on the same inputs, land the same counts)."""
    def body(m, d):
        events = d / "events.jsonl"
        t0 = time.time()
        with open(events, "w") as f:
            for i in range(4):
                f.write(json.dumps({
                    "schema": 1, "ts": t0 + i, "pid": 1,
                    "source": "trainer", "type": "train_step",
                    "step": i + 1, "restart_count": 0, "node_rank": 0,
                }) + "\n")
        db = str(d / "brain.db")
        monkeypatch.setenv("DLROVER_EVENT_LOG", str(events))
        monkeypatch.setenv("DLROVER_BRAIN_DB", db)
        monkeypatch.setenv("DLROVER_BRAIN_INGEST_INTERVAL_S", "0")
        masters = [
            m.master.JobMaster(
                port=0, node_num=2, job_name=f"multi{j}",
                journal_dir=str(d / f"journal{j}"),
            )
            for j in range(2)
        ]
        rounds = 10
        errors: list = []

        def feed(master):
            try:
                for i in range(rounds):
                    master.speed_monitor.collect_global_step(i + 1)
                    master._last_brain_ingest = 0.0
                    assert master.maybe_brain_ingest() is True
            except Exception as e:  # noqa: BLE001
                errors.append(e)

        threads = [threading.Thread(target=feed, args=(mm,))
                   for mm in masters]
        try:
            assert all(mm.brain is not None for mm in masters)
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
            assert not errors, errors
            store = m.ds.SqliteJobMetricsStore(db)
            try:
                assert sorted(store.job_names()) == ["multi0", "multi1"]
                counts = {}
                for j in range(2):
                    extras = store.load_extras(f"multi{j}")
                    snaps = [e for e in extras
                             if e.get("event") == "throughput_snapshot"]
                    assert len(snaps) == rounds, (
                        f"multi{j}: {len(snaps)}/{rounds} snapshots"
                    )
                    counts[j] = sorted(
                        e.get("event") for e in extras)
            finally:
                store.close()
        finally:
            for mm in masters:
                mm.stop()
        return counts

    _both(body, tmp_path)


# -- tests/test_brain_stats.py ------------------------------------------------


def _records(m):
    R = m.service.JobMetricRecord
    return [
        R("old-a", 1.0, workers=4, samples_per_sec=400,
          model_params=1000, finished=True),
        R("old-b", 2.0, workers=8, samples_per_sec=480,
          model_params=1000, finished=True),
        R("me", 3.0, workers=2, samples_per_sec=100),
        R("me", 4.0, workers=4, samples_per_sec=280),
    ]


def test_sqlite_store_roundtrip(tmp_path):
    def body(m, d):
        store = m.ds.SqliteJobMetricsStore(str(d / "brain.db"))
        for r in _records(m):
            store.persist(r)
        assert sorted(store.job_names()) == ["me", "old-a", "old-b"]
        me = store.load("me")
        assert len(me) == 2 and me[0].workers == 2
        store.close()
        store2 = m.ds.SqliteJobMetricsStore(str(d / "brain.db"))
        rows = store2.load()
        assert len(rows) == 4
        store2.close()
        return [vars(r) for r in rows]

    _both(body, tmp_path)


def test_optimizer_chain_stages(tmp_path):
    def body(m, d):
        JobStage = m.chain.JobStage
        store = m.ds.SqliteJobMetricsStore(str(d / "b.db"))
        for r in _records(m):
            store.persist(r)
        brain = m.service.BrainService(store, job_name="me")
        create = brain.optimize_stage(
            JobStage.CREATE, model_params=1000, current_workers=0
        )
        assert create.worker_count == 4
        running = brain.optimize_stage(
            JobStage.RUNNING, current_workers=2
        )
        assert running.worker_count == 4
        oom = brain.optimize_stage(
            JobStage.OOM, current_workers=4, memory_mb=1000
        )
        assert oom.memory_mb == 1500
        store.close()
        return [_plan(p) for p in (create, running, oom)]

    _both(body, tmp_path)


def test_utilization_scale_down():
    def body(m, _d):
        plan = m.chain.OptimizerChain().optimize(
            m.chain.JobStage.RUNNING,
            m.chain.OptimizeContext(job_name="x", current_workers=8,
                                    chip_util=0.1),
        )
        assert plan.worker_count == 4
        return _plan(plan)

    _both(body)


def test_stats_collector_and_brain_reporter(tmp_path):
    now = time.time()

    def body(m, d):
        sm = m.speed.SpeedMonitor()
        sm.set_batch_size(32)
        sm.set_model_flops(1e9, 1e14)
        for i in range(10):
            sm.collect_global_step(i * 10, now + i)
        store = m.ds.SqliteJobMetricsStore(str(d / "s.db"))
        collector = m.stats.JobMetricCollector(
            "j", sm, reporter=m.stats.BrainStatsReporter(store, "j"),
        )
        collector.collect_model_info(123456)
        collector.collect_node_resource(0, {"cpu": 50.0})
        snap = collector.snapshot()
        assert snap.samples_per_sec > 0
        assert snap.mfu > 0
        assert 0 < snap.goodput <= 1.0
        collector.report_once()
        recs = store.load("j")
        assert len(recs) == 1 and recs[0].model_params == 123456
        store.close()
        return (snap.samples_per_sec, snap.mfu, recs[0].workers,
                recs[0].samples_per_sec, recs[0].model_params)

    _both(body, tmp_path)


def test_event_callbacks_fire():
    def body(m, _d):
        master = m.master.JobMaster(port=0, node_num=2, job_name="cb")
        try:
            recycled = []
            master.task_manager.recycle_worker_tasks = recycled.append
            running = m.const.NodeStatus.RUNNING
            master.job_manager.update_node_status(3, "worker", running)
            assert 3 in master.elastic_rdzv._alive_nodes
            assert 3 in master.speed_monitor.running_workers
            master.job_manager.update_node_status(
                3, "worker", m.const.NodeStatus.FAILED,
                exit_reason="oom",
            )
            assert recycled == [3]
            assert 3 not in master.elastic_rdzv._alive_nodes
            assert 3 not in master.speed_monitor.running_workers
        finally:
            master.stop()
        api = m.k8s.MockK8sApi()
        client = m.k8s.K8sClient(namespace="t", api=api)
        assert m.stats.emit_k8s_event(client, "cb", "NodeFailed",
                                      "node 3 oom")
        events = [v for k, v in api.custom_resources.items()
                  if k.startswith("events/")]
        assert events and events[0]["reason"] == "NodeFailed"
        return recycled, events[0]["reason"], events[0].get("message")

    _both(body)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_brain_sqlite_file_reads_back_in_the_other_package(
    tmp_path, writer,
):
    """The sqlite schema is the reference's: a datastore file written
    by either package reads back equal in the other (records and
    event extras)."""
    reader = "torch" if writer == "jax" else "jax"
    db = str(tmp_path / "brain.db")
    w = PKGS[writer]
    store = w.ds.SqliteJobMetricsStore(db)
    for r in _records(w):
        store.persist(r, event="snap", node=r.workers)
    want_rows = [vars(r) for r in store.load()]
    want_extras = {j: store.load_extras(j) for j in store.job_names()}
    store.close()
    back = PKGS[reader].ds.SqliteJobMetricsStore(db)
    try:
        assert [vars(r) for r in back.load()] == want_rows
        assert {j: back.load_extras(j)
                for j in back.job_names()} == want_extras
        assert len(want_rows) == 4
    finally:
        back.close()
