"""Twins of ``tests/test_fleet.py`` for the port's fleet observatory
(``dlrover_tpu_torch/fleet/``): the synthetic agents, the scoreboard,
the runner's ramps and SLO-green capacity search, and the fan-in
instrumentation, piggybacked step reports, connection guard, Brain
resize decisions and textfile aggregation they measure.

Both packages run the same profile and seed, and the test holds what is
deterministic equal: the verb sequence of one agent under a simulated
clock (the same ``random.Random`` schedule drives both), the emitted
event types and their fields, and the capacity search's decisions on an
injected level sequence.  What depends on wall time (rates, quantiles)
is held to the reference's bounds on the port's own run.  The
200-agent ramp keeps its ``slow`` marker.  The reference's
``test_master_brain_auto_ingest`` has its twin in
``tests/test_torch_cluster_monitor.py``.
"""

import random
import time
import types

import pytest

from dlrover_tpu.fleet import runner as j_runner
from dlrover_tpu.fleet import synthetic_agent as j_agent
from dlrover_tpu.telemetry import schema as j_schema
from dlrover_tpu_torch.fleet import AgentProfile, FleetRunner
from dlrover_tpu_torch.fleet import runner as p_runner
from dlrover_tpu_torch.fleet import synthetic_agent as p_agent
from dlrover_tpu_torch.telemetry import metrics as tmetrics
from dlrover_tpu_torch.telemetry.events import read_events
from dlrover_tpu_torch.telemetry.schema import validate_event
from dlrover_tpu_torch.telemetry.slo import SloRule

FAST_PROFILE = AgentProfile(
    heartbeat_interval=0.3,
    step_interval=0.2,
    shard_interval=0.5,
    kv_interval=1.0,
    reconnect_prob=0.02,
)


@pytest.fixture
def event_log(tmp_path, monkeypatch):
    path = tmp_path / "events.jsonl"
    monkeypatch.setenv("DLROVER_EVENT_LOG", str(path))
    return path


# -- one agent's verb mix under a simulated clock ------------------------------


class _RecordingClient:
    """The agent's client surface, recording each call in order."""

    def __init__(self):
        self.calls = []
        self._client = types.SimpleNamespace(close=lambda: None)

    def join_rendezvous(self, node_id, local_world_size, name, node_ip=""):
        self.calls.append(("join", node_id, local_world_size, name))
        return 1

    def report_heartbeat(self):
        self.calls.append(("heartbeat",))
        return ""

    def report_global_step(self, step):
        self.calls.append(("step", step))

    def get_task(self, dataset):
        self.calls.append(("shard_get", dataset))
        return types.SimpleNamespace(task_id=len(self.calls))

    def report_task_result(self, dataset, task_id, ok):
        self.calls.append(("shard_ack", dataset, task_id, ok))

    def kv_store_add(self, key, amount):
        self.calls.append(("kv_add", key, amount))

    def kv_store_set(self, key, value):
        self.calls.append(("kv_set", key, value))

    def session_resync(self):
        self.calls.append(("resync",))

    def close(self):
        self.calls.append(("close",))


def _simulated_run(mod, monkeypatch, profile, node_id, seed, sim_s):
    """One ``SyntheticAgent._run`` of package ``mod`` for ``sim_s``
    simulated seconds: its clock and its stop event's waits advance a
    shared fake clock, so the schedule is the agent's RNG alone."""
    clock = [0.0]
    monkeypatch.setattr(mod, "time", types.SimpleNamespace(
        monotonic=lambda: clock[0]))

    class _Stop:
        def is_set(self):
            return clock[0] >= sim_s

        def wait(self, d):
            clock[0] += max(float(d), 1e-4)
            return self.is_set()

        def set(self):
            clock[0] = max(clock[0], sim_s)

    agent = mod.SyntheticAgent("127.0.0.1:1", node_id=node_id,
                               profile=profile, seed=seed)
    agent.client = _RecordingClient()
    agent._stop = _Stop()
    agent._run()
    return agent.client.calls, dict(agent.stats.ops), agent.stats.resyncs


@pytest.mark.parametrize("node_id,seed", [(0, None), (7, 1234)])
def test_agent_verb_mix_matches_the_reference(monkeypatch, node_id, seed):
    """Same profile, node id and seed: the port's agent puts the
    reference's verb sequence on the wire, call for call, forced
    reconnects included."""
    profile = dict(heartbeat_interval=0.3, step_interval=0.2,
                   shard_interval=0.5, kv_interval=1.0,
                   reconnect_prob=0.05)
    got = _simulated_run(p_agent, monkeypatch, p_agent.AgentProfile(
        **profile), node_id, seed, 20.0)
    want = _simulated_run(j_agent, monkeypatch, j_agent.AgentProfile(
        **profile), node_id, seed, 20.0)
    assert got == want
    calls, ops, resyncs = got
    assert calls[0][0] == "join" and calls[-1] == ("close",)
    assert {"heartbeat", "step", "shard_get", "shard_ack", "kv"} <= set(ops)
    assert resyncs > 0


def test_jittered_intervals_match_the_reference():
    for jitter in (0.0, 0.3):
        p = p_agent.AgentProfile(jitter=jitter)
        j = j_agent.AgentProfile(jitter=jitter)
        rp, rj = random.Random(5), random.Random(5)
        assert [p.jittered(1.0, rp) for _ in range(50)] == [
            j.jittered(1.0, rj) for _ in range(50)]


# -- the runner against one real journal-backed master -------------------------


def test_fleet_smoke_tier1(tmp_path, event_log):
    """~25 agents, a few seconds, one journal-backed master: the
    acceptance smoke for the whole harness, with the reference's
    bounds; its fleet_report events carry the reference schema's
    fields."""
    runner = FleetRunner(
        max_nodes=64,
        profile=FAST_PROFILE,
        workdir=str(tmp_path / "fleet"),
        fsync_window_s=0.05,
        scoreboard_interval_s=0.5,
    )
    try:
        summary = runner.run_load(25, 3.0, settle_s=0.5)
        stats = runner.stats()
    finally:
        runner.stop()

    assert summary["samples"] >= 3
    assert summary["agents"] == 25
    assert summary["mean_rps"] > 20
    worst = summary["worst_p99_ms"]
    for verb in (
        "get.HeartbeatRequest",
        "report.GlobalStepRecord",
        "get.GetShardTaskRequest",
        "report.ReportTaskResultRequest",
    ):
        assert verb in worst, f"{verb} missing from scoreboard"

    ops = stats["ops"]
    for verb in (
        "join", "heartbeat", "step", "shard_get", "shard_ack", "kv",
    ):
        assert ops.get(verb, 0) > 0, f"no {verb} ops"
    assert stats["resyncs"] > 0, "fault mix never forced a resync"
    assert stats["errors"] == {}, stats["errors"]

    qg = tmetrics.get_registry().get("dlrover_rpc_quantile_seconds")
    assert qg is not None and len(qg.collect()) > 0
    assert summary["conns_peak"] >= 25

    reports = [
        e for e in read_events(str(event_log))
        if e.get("type") == "fleet_report"
    ]
    assert len(reports) >= 3
    ref = j_schema.EVENT_SCHEMAS["fleet_report"]
    for e in reports:
        assert validate_event(e) == [], validate_event(e)
        assert j_schema.validate_event(e) == []
        assert ref.required <= set(e)
    assert any(e["agents"] == 25 for e in reports)
    fields = set(reports[0]) - {"ts", "pid", "source", "schema"}
    assert fields == {
        "type", "agents", "rps", "window_s", "ops", "verbs", "breaches",
        "conns_active", "conns_peak", "inflight", "journal_append_p99_ms",
        "journal_lock_wait_p99_ms", "journal_pending_fsync",
        "journal_mirror_queue"}


def test_capacity_search_reports_green_levels(tmp_path, event_log):
    """With generous rules every level is green: the search walks to
    max_agents and reports it sustained."""
    runner = FleetRunner(
        max_nodes=16,
        profile=FAST_PROFILE,
        workdir=str(tmp_path / "fleet"),
        fsync_window_s=0.05,
        rules=[SloRule("get.*", 0.99, 30.0),
               SloRule("report.*", 0.99, 30.0)],
    )
    try:
        result = runner.capacity_search(
            start=5, step=5, max_agents=10,
            window_s=1.2, settle_s=0.3, deadline_s=60.0,
        )
    finally:
        runner.stop()
    assert result["max_sustained_agents"] == 10
    assert result["first_breach"] is None
    assert [lvl["agents"] for lvl in result["levels"]] == [5, 10]
    assert all(lvl["green"] for lvl in result["levels"])
    assert result["p99_at_capacity_ms"]
    caps = [
        e for e in read_events(str(event_log))
        if e.get("type") == "fleet_capacity"
    ]
    assert len(caps) == 1
    assert caps[0]["max_sustained_agents"] == 10
    assert validate_event(caps[0]) == []
    assert j_schema.validate_event(caps[0]) == []


def test_capacity_search_backs_off_on_breach(tmp_path):
    """An impossible SLO breaches at the first level: the search
    stops, reports the breach, and sustains nothing."""
    runner = FleetRunner(
        max_nodes=16,
        profile=FAST_PROFILE,
        workdir=str(tmp_path / "fleet"),
        fsync_window_s=0.05,
        rules=[SloRule("*", 0.5, 1e-9)],
    )
    try:
        result = runner.capacity_search(
            start=5, step=5, max_agents=10,
            window_s=1.2, settle_s=0.3, deadline_s=60.0,
        )
    finally:
        runner.stop()
    assert result["max_sustained_agents"] == 0
    assert result["first_breach"]["agents"] == 5
    assert result["first_breach"]["breaches"]


class _IdleMaster:
    """What the runner needs of a master when no agent ever runs."""

    rdzv_managers = {}
    port = 0

    def prepare(self):
        pass

    def stop(self):
        pass


# agent count -> green, per injected sequence: a clean walk to the cap,
# a breach with a confirming back-off, a breach whose confirm fails and
# keeps stepping down, a breach at the first level
BREACHES = {
    "all-green": lambda n: True,
    "breach-at-20": lambda n: n < 20,
    "confirm-fails": None,  # built per run: green once below 15
    "first-level": lambda n: False,
}


@pytest.mark.parametrize("sequence", sorted(BREACHES))
def test_capacity_search_decisions_match_the_reference(
        tmp_path, monkeypatch, sequence):
    """The search's decisions on an injected breach sequence — the
    levels probed, confirmations, the capacity and the first breach —
    and its ``fleet_capacity`` event equal the reference's."""
    out = {}
    for name, mod in (("port", p_runner), ("ref", j_runner)):
        log = tmp_path / f"{name}.jsonl"
        monkeypatch.setenv("DLROVER_EVENT_LOG", str(log))
        green = BREACHES[sequence]
        if sequence == "confirm-fails":
            seen = []

            def green(n, seen=seen):
                seen.append(n)
                return n < 15 and seen.count(n) == 1

        def probe(self, n, window_s, settle_s, green=green):
            ok = green(n)
            return {"agents": n, "green": ok, "mean_rps": float(n),
                    "worst_p99_ms": {"get.X": 1.0}, "error_ratio": 0.0,
                    "breach_count": 0 if ok else 1,
                    "breaches": [] if ok else [{"verb": "get.X"}]}

        monkeypatch.setattr(mod.FleetRunner, "_probe_level", probe)
        runner = mod.FleetRunner(
            max_nodes=40, workdir=str(tmp_path / name),
            master_factory=lambda _journal: _IdleMaster())
        try:
            result = runner.capacity_search(
                start=5, step=5, max_agents=30, window_s=0.0,
                settle_s=0.0, deadline_s=60.0)
        finally:
            runner.stop()
        result.pop("search_s")
        events = [e for e in read_events(str(log))
                  if e.get("type") == "fleet_capacity"]
        for e in events:
            for k in ("ts", "pid", "source", "search_s"):
                e.pop(k, None)
        out[name] = (result, events)
    assert out["port"] == out["ref"]


def test_step_piggyback_coalesces_rpcs(tmp_path, monkeypatch):
    """With DLROVER_STEP_PIGGYBACK armed, a burst of step reports
    costs ONE GlobalStepRecord RPC (the rest coalesce), the next
    heartbeat carries the newest step, and the master's speed
    monitor still sees it."""
    from dlrover_tpu_torch.agent.master_client import MasterClient
    from dlrover_tpu_torch.master.master import JobMaster

    monkeypatch.setenv("DLROVER_STEP_PIGGYBACK", "1")
    monkeypatch.setenv("DLROVER_STEP_PIGGYBACK_WINDOW_S", "60")
    master = JobMaster(port=0, node_num=4, job_name="pgy")
    master.prepare()
    try:
        client = MasterClient(
            f"127.0.0.1:{master.port}", node_id=0,
            node_type="worker", node_rank=0, local_world_size=1,
        )
        hist = tmetrics.get_registry().get("dlrover_rpc_seconds")
        before = hist.snapshot(
            verb="report.GlobalStepRecord"
        )["count"]
        for step in range(1, 6):
            client.report_global_step(step)
        after = hist.snapshot(verb="report.GlobalStepRecord")["count"]
        assert after - before == 1, (
            "coalescing sent more than one direct step RPC"
        )
        # the master only saw the first direct send so far
        assert master.speed_monitor.completed_global_step == 1
        client.report_heartbeat()
        assert master.speed_monitor.completed_global_step == 5, (
            "heartbeat did not deliver the piggybacked step"
        )
        client.close()
    finally:
        master.stop()


def test_max_conns_guard_rejects_cleanly():
    """Over-limit connects get a typed RemoteError instead of a
    silent thread pile-up; freeing a slot re-admits."""
    from dlrover_tpu_torch.common import messages as msg
    from dlrover_tpu_torch.common.comm import (
        MessageClient,
        MessageServer,
        RemoteError,
        RequestHandler,
    )

    class Echo(RequestHandler):
        def report(self, node_id, node_type, m):
            return True

        def get(self, node_id, node_type, m):
            return m

    server = MessageServer(0, Echo(), max_conns=2)
    server.start()
    reg = tmetrics.get_registry()
    rejected_before = reg.get(
        "dlrover_master_conns_rejected_total"
    ).value()
    clients = [
        MessageClient(f"127.0.0.1:{server.port}", retries=1)
        for _ in range(3)
    ]
    try:
        assert clients[0].get(msg.BaseRequest()) is not None
        assert clients[1].get(msg.BaseRequest()) is not None
        with pytest.raises(RemoteError, match="connection limit"):
            clients[2].get(msg.BaseRequest())
        assert reg.get(
            "dlrover_master_conns_rejected_total"
        ).value() == rejected_before + 1
        # free a slot; a fresh client is admitted
        clients[0].close()
        time.sleep(0.3)
        late = MessageClient(f"127.0.0.1:{server.port}", retries=1)
        assert late.get(msg.BaseRequest()) is not None
        late.close()
    finally:
        for c in clients:
            c.close()
        server.stop()


def test_brain_data_drives_resize_decision(monkeypatch):
    """ROADMAP item 1 acceptance: a ResizeCoordinator decision
    sourced from Brain data — throughput history showing better
    per-worker throughput at world=1 shrinks a healthy 2-node world
    with a journaled 'brain:' decision."""
    from dlrover_tpu_torch.brain.datastore import SqliteJobMetricsStore
    from dlrover_tpu_torch.brain.service import BrainService, JobMetricRecord
    from dlrover_tpu_torch.common.constants import MasterAction, NodeType
    from dlrover_tpu_torch.master.auto_scaler import ResizeCoordinator
    from dlrover_tpu_torch.master.job_manager import JobManager
    from dlrover_tpu_torch.master.rdzv_manager import (
        ElasticTrainingRendezvousManager,
    )
    from dlrover_tpu_torch.master.speed_monitor import SpeedMonitor

    monkeypatch.setenv("DLROVER_RESIZE_GRACE_S", "0")
    rdzv = ElasticTrainingRendezvousManager()
    rdzv.update_rdzv_params(min_nodes=1, max_nodes=2)
    rdzv.join_rendezvous(0, 0, 1, "10.0.0.1")
    rdzv.join_rendezvous(1, 1, 1, "10.0.0.2")
    rdzv.get_comm_world(0)
    jm = JobManager()
    for node_id in (0, 1):
        jm.add_node(NodeType.WORKER, node_id)
        jm.collect_heartbeat(node_id)

    class FakeServicer:
        def __init__(self):
            self.actions = {}

        def request_node_action(self, node_id, action):
            self.actions[node_id] = action

    servicer = FakeServicer()
    store = SqliteJobMetricsStore(":memory:")
    # observed: 1 worker does 100 samples/s, 2 workers only 110 —
    # per-worker throughput says the second node is near-worthless
    for workers, sps in ((1, 100.0), (2, 110.0)):
        for _ in range(3):
            store.persist(JobMetricRecord(
                job_name="j", timestamp=time.time(),
                workers=workers, samples_per_sec=sps,
            ))
    coord = ResizeCoordinator(
        rdzv, jm, SpeedMonitor(), servicer,
        min_nodes=1, max_nodes=2,
    )
    coord.set_brain(
        BrainService(store, job_name="j"), interval_s=1.0
    )
    coord._last_brain_poll = -1e9
    coord.poll()
    assert coord.pending is not None
    assert coord.pending["target"] == 1
    assert coord.pending["reason"].startswith("brain:")
    # the decision drives the standard drain machinery
    assert servicer.actions, "no drain actions delivered"
    assert set(servicer.actions.values()) == {MasterAction.RESIZE}


def test_brain_grow_beyond_capacity_deferred(monkeypatch):
    """The Brain proposing more nodes than are alive must NOT start
    a resize whose rendezvous can never complete."""
    from dlrover_tpu_torch.master.auto_scaler import ResizeCoordinator
    from dlrover_tpu_torch.master.job_manager import JobManager
    from dlrover_tpu_torch.master.rdzv_manager import (
        ElasticTrainingRendezvousManager,
    )
    from dlrover_tpu_torch.master.resource_optimizer import ResourcePlan
    from dlrover_tpu_torch.master.speed_monitor import SpeedMonitor

    monkeypatch.setenv("DLROVER_RESIZE_GRACE_S", "1000")
    rdzv = ElasticTrainingRendezvousManager()
    rdzv.update_rdzv_params(min_nodes=1, max_nodes=1)
    rdzv.join_rendezvous(0, 0, 1, "10.0.0.1")
    rdzv.get_comm_world(0)
    jm = JobManager()

    class Brain:
        def generate_worker_plan(self, current, speed):
            return ResourcePlan(worker_count=4, comment="grow!")

    class FakeServicer:
        def request_node_action(self, node_id, action):
            raise AssertionError("should not drain")

    coord = ResizeCoordinator(
        rdzv, jm, SpeedMonitor(), FakeServicer(),
        min_nodes=1, max_nodes=4,
    )
    coord.set_brain(Brain(), interval_s=1.0)
    coord._last_brain_poll = -1e9
    coord.poll()
    assert coord.pending is None


def test_aggregate_textfiles_mtime_cache(tmp_path, monkeypatch):
    """Unchanged .prom dumps are served from the mtime/size cache
    (no re-read, no re-parse); a modified dump is re-read; the
    aggregated-file-count gauge tracks the fold."""
    from dlrover_tpu_torch.telemetry import exporter

    a = tmp_path / "agent_a.prom"
    b = tmp_path / "agent_b.prom"
    a.write_text(
        "# HELP m1 x\n# TYPE m1 counter\nm1 1\n"
    )
    b.write_text(
        "# HELP m1 x\n# TYPE m1 counter\nm1 2\n"
    )
    pattern = str(tmp_path / "*.prom")

    parses = {"n": 0}
    real_parse = exporter._parse_families

    def counting_parse(text):
        parses["n"] += 1
        return real_parse(text)

    monkeypatch.setattr(
        exporter, "_parse_families", counting_parse
    )
    exporter._AGG_CACHE.clear()
    out1 = exporter.aggregate_textfiles(pattern)
    assert 'agent="agent_a"' in out1 and 'agent="agent_b"' in out1
    assert parses["n"] == 2
    out2 = exporter.aggregate_textfiles(pattern)
    assert parses["n"] == 2, "unchanged files were re-parsed"
    assert out2 == out1
    gauge = tmetrics.get_registry().get(
        "dlrover_metrics_aggregated_files"
    )
    assert gauge.value() == 2
    # a changed dump is re-read (different size forces a new key
    # even on coarse-mtime filesystems)
    a.write_text(
        "# HELP m1 x\n# TYPE m1 counter\nm1 111\n"
    )
    out3 = exporter.aggregate_textfiles(pattern)
    assert parses["n"] == 3
    assert 'm1{agent="agent_a"} 111' in out3
    # a vanished dump is pruned from cache and count
    b.unlink()
    exporter.aggregate_textfiles(pattern)
    assert gauge.value() == 1
    assert str(b) not in exporter._AGG_CACHE

@pytest.mark.slow
def test_fleet_full_ramp_200_agents(tmp_path, event_log):
    """The headline claim at test scale: 200 synthetic agents
    sustained SLO-green against one journal-backed master
    (``chip_smoke.py`` phase 19b runs it on the card machine's host)."""
    runner = FleetRunner(
        max_nodes=512,
        profile=AgentProfile(
            heartbeat_interval=2.0,
            step_interval=1.0,
            shard_interval=4.0,
            kv_interval=8.0,
            reconnect_prob=0.002,
        ),
        workdir=str(tmp_path / "fleet"),
        fsync_window_s=0.05,
        piggyback=True,
        # subprocess packs: in-process agent threads at this count
        # would fight the master for the GIL and measure the
        # harness, not the control plane
        pack_size=50,
    )
    try:
        level = runner._probe_level(200, window_s=8.0, settle_s=2.0)
        stats = runner.stats()
    finally:
        runner.stop()
    assert level["green"], level
    assert stats["errors"] == {}
    reports = [
        e for e in read_events(str(event_log))
        if e.get("type") == "fleet_report"
    ]
    assert any(e["agents"] == 200 for e in reports)
