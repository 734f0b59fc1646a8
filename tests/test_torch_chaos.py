"""Twin of ``tests/test_chaos.py``, against the port (:mod:`dlrover_tpu_torch`).

Chaos subsystem unit tests: zero-cost disabled hooks, seeded
deterministic schedules, fault primitives against the real transport/
storage/shm surfaces, and the invariant-checker plumbing.

The cases of the harness, the scenarios, the CLI and the agent's
preemption probe come with slice 3b.2.
"""

import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

from dlrover_tpu_torch import chaos
from dlrover_tpu_torch.chaos.injector import ChaosInjector
from dlrover_tpu_torch.chaos.schedule import Rule, Scenario, load_scenario

pytestmark = pytest.mark.chaos


@pytest.fixture(autouse=True)
def _clean_injector():
    chaos.uninstall()
    yield
    chaos.uninstall()


# -- registry / zero-cost gating ------------------------------------------


def test_fire_is_noop_when_disabled():
    assert not chaos.chaos_enabled()
    assert chaos.fire("trainer.step", step=1) is None
    assert chaos.fire("anything.else") is None


def test_disabled_fire_overhead_is_negligible():
    """The permanent hooks live in hot paths; the disabled path must
    stay within a microsecond per call (it is one module-global load
    plus a None check — budget is ~30x that to stay unflaky)."""
    n = 100_000
    t0 = time.perf_counter()
    for _ in range(n):
        chaos.fire("trainer.step", step=7)
    per_call = (time.perf_counter() - t0) / n
    assert per_call < 1e-5, f"{per_call * 1e9:.0f} ns/call"


def test_install_from_env_and_malformed_spec(tmp_path, monkeypatch):
    spec = {
        "name": "envtest", "seed": 1,
        "rules": [{"point": "x", "action": "delay",
                   "args": {"seconds": 0.0}}],
    }
    path = tmp_path / "s.json"
    path.write_text(json.dumps(spec))
    monkeypatch.setenv(chaos.CHAOS_ENV, str(path))
    inj = chaos.install_from_env()
    assert inj is not None and inj.scenario.name == "envtest"
    chaos.uninstall()
    # malformed spec must NOT raise — chaos cannot take a job down
    monkeypatch.setenv(chaos.CHAOS_ENV, "{not json")
    assert chaos.install_from_env() is None
    assert not chaos.chaos_enabled()


def test_yaml_scenario_loading(tmp_path):
    path = tmp_path / "s.yaml"
    path.write_text(
        "name: yaml-test\n"
        "seed: 9\n"
        "rules:\n"
        "  - point: storage.write\n"
        "    action: io_error\n"
        "    after_calls: 3\n"
        "    max_count: 2\n"
    )
    s = load_scenario(str(path))
    assert s.name == "yaml-test" and s.seed == 9
    assert s.rules[0].after_calls == 3 and s.rules[0].max_count == 2


def test_missing_scenario_file_raises_not_silently_parses(tmp_path):
    """A path that names a nonexistent file must raise, not fall
    through to the YAML parser (which would 'parse' the path string
    as a scalar and arm nothing — a silent no-chaos run)."""
    with pytest.raises(FileNotFoundError):
        load_scenario(str(tmp_path / "nope.yaml"))
    with pytest.raises(FileNotFoundError):
        load_scenario("/etc/chaos/kill.conf")
    # and install_from_env degrades to disabled with the clear error
    os.environ[chaos.CHAOS_ENV] = str(tmp_path / "gone.json")
    try:
        assert chaos.install_from_env() is None
    finally:
        os.environ.pop(chaos.CHAOS_ENV, None)


def test_rule_validation():
    with pytest.raises(ValueError, match="unknown chaos action"):
        Rule(point="x", action="explode")
    with pytest.raises(ValueError, match="more than one trigger"):
        Rule(point="x", action="delay", at_step=1, prob=0.5)
    with pytest.raises(ValueError, match="step_window"):
        Rule(point="x", action="delay", step_window=[7, 3])


def test_scenario_roundtrips_through_dict():
    s = Scenario.from_dict({
        "name": "rt", "seed": 4,
        "rules": [
            {"point": "trainer.step", "action": "kill",
             "step_window": [2, 9], "only_first_incarnation": True},
            {"point": "rpc.*", "action": "drop", "after_time": 1.0,
             "duration": 2.5, "max_count": 0},
        ],
    })
    s2 = Scenario.from_dict(s.to_dict())
    assert s2.to_dict() == s.to_dict()


# -- triggers + determinism ------------------------------------------------


def _drive_steps(spec, steps=12):
    inj = ChaosInjector(spec)
    for s in range(1, steps + 1):
        try:
            inj.fire("trainer.step", step=s)
        except Exception:  # noqa: BLE001 - raising actions are valid
            pass
    return inj


def test_at_step_fires_once():
    spec = {
        "name": "t", "seed": 0,
        "rules": [{"point": "trainer.step", "action": "slow",
                   "at_step": 5, "args": {"seconds": 0.0}}],
    }
    inj = _drive_steps(spec)
    assert inj.timeline_keys() == [
        (0, "trainer.step", "rule0", "slow", 5)
    ]


def test_step_window_is_seed_deterministic():
    spec = {
        "name": "t", "seed": 42,
        "rules": [{"point": "trainer.step", "action": "slow",
                   "step_window": [3, 9], "args": {"seconds": 0.0}}],
    }
    t1 = _drive_steps(spec).timeline_keys()
    t2 = _drive_steps(spec).timeline_keys()
    assert t1 == t2 and len(t1) == 1
    assert 3 <= t1[0][4] <= 9
    # different seeds spread over the window (at least one differs)
    chosen = {
        _drive_steps({**spec, "seed": s}).timeline_keys()[0][4]
        for s in range(8)
    }
    assert len(chosen) > 1


def test_probabilistic_trigger_is_seed_deterministic():
    spec = {
        "name": "t", "seed": 123,
        "rules": [{"point": "trainer.step", "action": "slow",
                   "prob": 0.4, "max_count": 0,
                   "args": {"seconds": 0.0}}],
    }
    t1 = _drive_steps(spec, steps=30).timeline_keys()
    t2 = _drive_steps(spec, steps=30).timeline_keys()
    assert t1 == t2
    assert 3 <= len(t1) <= 27  # p=0.4 over 30 draws, loose bounds


def test_after_step_threshold_trigger():
    """after_step fires on ctx step >= N — the progress-based kill
    trigger for SAMPLED step observations (the agent.monitor hook
    reports the step it last saw, which can skip values an at_step
    equality would wait on forever); a missing step never fires."""
    spec = {
        "name": "t", "seed": 0,
        "rules": [{"point": "agent.monitor", "action": "delay",
                   "after_step": 6, "args": {"seconds": 0.0}}],
    }
    inj = ChaosInjector(spec)
    inj.fire("agent.monitor")               # no step in ctx
    inj.fire("agent.monitor", step=None)    # trainer not started
    inj.fire("agent.monitor", step=5)
    assert inj.timeline_keys() == []
    inj.fire("agent.monitor", step=7)       # skipped right past 6
    assert [k[4] for k in inj.timeline_keys()] == [7]
    inj.fire("agent.monitor", step=8)       # max_count=1 exhausted
    assert len(inj.timeline_keys()) == 1


def test_after_calls_and_max_count():
    spec = {
        "name": "t", "seed": 0,
        "rules": [{"point": "p", "action": "delay",
                   "after_calls": 3, "max_count": 2,
                   "args": {"seconds": 0.0}}],
    }
    inj = ChaosInjector(spec)
    for _ in range(6):
        inj.fire("p")
    assert [k[0] for k in inj.timeline_keys()] == [0, 1]
    assert inj.describe()["rules"][0]["exhausted"]


def test_after_time_duration_window_with_fake_clock():
    """A partition rule opens at after_time and drops everything for
    `duration` seconds, then closes for good."""
    now = [0.0]
    spec = {
        "name": "t", "seed": 0,
        "rules": [{"point": "rpc.client.*", "action": "drop",
                   "after_time": 5.0, "duration": 3.0}],
    }
    inj = ChaosInjector(spec, clock=lambda: now[0])

    def hit(t):
        now[0] = t
        try:
            inj.fire("rpc.client.roundtrip", verb="get")
            return False
        except chaos.ChaosRpcError:
            return True

    assert not hit(1.0)         # before the window
    assert hit(5.5)             # window opens
    assert hit(7.0)             # still inside
    assert not hit(9.0)         # window closed
    assert not hit(20.0)        # and stays closed
    assert inj.describe()["rules"][0]["exhausted"]


def test_duration_window_honors_explicit_max_count():
    """An explicit max_count bounds the blast radius INSIDE a
    duration window (default for windows is unbounded)."""
    now = [0.0]
    spec = {
        "name": "t", "seed": 0,
        "rules": [{"point": "storage.write", "action": "io_error",
                   "after_time": 1.0, "duration": 100.0,
                   "max_count": 2}],
    }
    inj = ChaosInjector(spec, clock=lambda: now[0])

    def hit(t):
        now[0] = t
        try:
            inj.fire("storage.write", path="/x")
            return False
        except chaos.ChaosIOError:
            return True

    assert not hit(0.5)
    assert hit(2.0) and hit(3.0)   # two bounded injections
    assert not hit(4.0)            # bound reached mid-window
    assert inj.describe()["rules"][0]["exhausted"]
    # an unbounded window (no explicit max_count) keeps dropping
    spec2 = {
        "name": "t2", "seed": 0,
        "rules": [{"point": "storage.write", "action": "io_error",
                   "after_time": 1.0, "duration": 100.0}],
    }
    now[0] = 0.0  # installed_at is read from the fake clock
    inj2 = ChaosInjector(spec2, clock=lambda: now[0])
    now[0] = 2.0
    for _ in range(5):
        with pytest.raises(chaos.ChaosIOError):
            inj2.fire("storage.write", path="/x")


def test_compute_backoff_huge_attempt_does_not_overflow():
    from dlrover_tpu_torch.common.comm import compute_backoff

    assert compute_backoff(5000, 0.5, 8.0) <= 8.0


def test_only_first_incarnation(monkeypatch):
    from dlrover_tpu_torch.common.constants import NodeEnv

    spec = {
        "name": "t", "seed": 0,
        "rules": [{"point": "trainer.step", "action": "slow",
                   "at_step": 2, "only_first_incarnation": True,
                   "args": {"seconds": 0.0}}],
    }
    monkeypatch.setenv(NodeEnv.RESTART_COUNT, "1")
    inj = _drive_steps(spec)
    assert inj.timeline_keys() == []
    monkeypatch.setenv(NodeEnv.RESTART_COUNT, "0")
    inj = _drive_steps(spec)
    assert len(inj.timeline_keys()) == 1


def test_chaos_inject_events_written(tmp_path, monkeypatch):
    monkeypatch.setenv(
        "DLROVER_EVENT_LOG", str(tmp_path / "ev.jsonl")
    )
    spec = {
        "name": "evt", "seed": 6,
        "rules": [{"point": "p", "action": "delay",
                   "args": {"seconds": 0.0}}],
    }
    chaos.install(spec)
    chaos.fire("p", step=3)
    from dlrover_tpu_torch.telemetry.events import read_events

    events = [
        e for e in read_events(str(tmp_path / "ev.jsonl"))
        if e["type"] == "chaos_inject"
    ]
    assert len(events) == 1
    e = events[0]
    assert e["scenario"] == "evt" and e["seed"] == 6
    assert e["point"] == "p" and e["action"] == "delay"
    assert e["step"] == 3 and e["seq"] == 0


# -- fault primitives against real surfaces --------------------------------


def test_storage_io_error_and_recovery(tmp_path):
    from dlrover_tpu_torch.common.storage import PosixDiskStorage

    chaos.install({
        "name": "t", "seed": 0,
        "rules": [{"point": "storage.write", "action": "io_error",
                   "max_count": 1}],
    })
    storage = PosixDiskStorage()
    target = str(tmp_path / "a" / "f.bin")
    with pytest.raises(OSError, match="chaos"):
        storage.write(b"x", target)
    assert not os.path.exists(target)
    # the rule is exhausted: the backend "recovered"
    storage.write(b"x", target)
    assert storage.read(target) == b"x"


def test_storage_stall_delays_write(tmp_path):
    from dlrover_tpu_torch.common.storage import PosixDiskStorage

    chaos.install({
        "name": "t", "seed": 0,
        "rules": [{"point": "storage.write", "action": "stall",
                   "max_count": 1, "args": {"seconds": 0.3}}],
    })
    storage = PosixDiskStorage()
    t0 = time.perf_counter()
    storage.write(b"x", str(tmp_path / "f.bin"))
    assert time.perf_counter() - t0 >= 0.3


def test_rpc_partition_ridden_out_by_backoff(tmp_path):
    """A drop window on the client hook exercises the hardened
    reconnect path: bounded jittered retries until the partition
    lifts, then the request completes against the intact server."""
    from dlrover_tpu_torch.common.comm import (
        MessageClient,
        MessageServer,
        RequestHandler,
    )

    class Echo(RequestHandler):
        def report(self, node_id, node_type, message):
            return True

        def get(self, node_id, node_type, message):
            return message

    server = MessageServer(0, Echo(), host="127.0.0.1")
    server.start()
    try:
        chaos.install({
            "name": "t", "seed": 0,
            "rules": [{"point": "rpc.client.roundtrip",
                       "action": "drop", "max_count": 3}],
        })
        client = MessageClient(
            f"127.0.0.1:{server.port}", retries=8,
            backoff_base=0.01, backoff_max=0.05,
        )
        t0 = time.perf_counter()
        assert client.get("hello") == "hello"
        assert time.perf_counter() - t0 < 5.0
        inj = chaos.get_injector()
        assert len(inj.timeline) == 3  # all three drops exercised
        client.close()
    finally:
        server.stop()


def test_rpc_client_gives_up_after_bounded_retries():
    from dlrover_tpu_torch.common.comm import MessageClient

    chaos.install({
        "name": "t", "seed": 0,
        "rules": [{"point": "rpc.client.roundtrip", "action": "drop",
                   "max_count": 0}],  # unbounded partition
    })
    client = MessageClient(
        "127.0.0.1:1", retries=3, backoff_base=0.01, backoff_max=0.02,
    )
    t0 = time.perf_counter()
    with pytest.raises(ConnectionError, match="after 3 attempts"):
        client.get("x")
    # bounded: 2 sleeps of ≤0.02 s, not 3 (no sleep after the last)
    assert time.perf_counter() - t0 < 2.0


def test_compute_backoff_envelope():
    import random

    from dlrover_tpu_torch.common.comm import compute_backoff

    rng = random.Random(0)
    for attempt in range(12):
        cap = min(0.5 * 2 ** attempt, 8.0)
        for _ in range(20):
            b = compute_backoff(attempt, 0.5, 8.0, rng)
            assert cap / 2 <= b <= cap


def test_server_side_drop_is_replayed(tmp_path):
    """A server-side drop kills the connection pre-dispatch; the
    client reconnects and the retry is served."""
    from dlrover_tpu_torch.common.comm import (
        MessageClient,
        MessageServer,
        RequestHandler,
    )

    calls = []

    class Echo(RequestHandler):
        def report(self, node_id, node_type, message):
            return True

        def get(self, node_id, node_type, message):
            calls.append(message)
            return message

    server = MessageServer(0, Echo(), host="127.0.0.1")
    server.start()
    try:
        chaos.install({
            "name": "t", "seed": 0,
            "rules": [{"point": "rpc.server.dispatch",
                       "action": "drop", "max_count": 2}],
        })
        client = MessageClient(
            f"127.0.0.1:{server.port}", retries=8,
            backoff_base=0.01, backoff_max=0.05,
        )
        assert client.get("ping") == "ping"
        assert calls == ["ping"]  # dropped frames never dispatched
        client.close()
    finally:
        server.stop()


def test_kill_worker_primitive_signals_supervised_proc():
    proc = subprocess.Popen([sys.executable, "-c",
                             "import time; time.sleep(600)"])
    try:
        chaos.install({
            "name": "t", "seed": 0,
            "rules": [{"point": "agent.monitor",
                       "action": "kill_worker",
                       "args": {"rank": 0, "signal": "KILL"}}],
        })
        chaos.fire("agent.monitor", procs=[proc])
        assert proc.wait(timeout=10) == -signal.SIGKILL
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def test_corrupt_shm_torn_snapshot_refused(tmp_path, monkeypatch):
    """A torn shm snapshot (chaos republished writing=True) must be
    refused by the restore path rather than loaded as garbage."""
    from dlrover_tpu_torch.checkpoint.shm_handler import (
        CheckpointConfig,
        SharedMemoryHandler,
    )

    monkeypatch.setenv("DLROVER_JOB_NAME", "chaos-shm-test")
    handler = SharedMemoryHandler(0, host=True)
    try:
        state = {"w": np.arange(8, dtype=np.float32)}
        chaos.install({
            "name": "t", "seed": 0,
            "rules": [{"point": "ckpt.shm_save",
                       "action": "corrupt_shm", "at_step": 3,
                       "args": {"mode": "torn"}}],
        })
        handler.save_state_dict(
            state, CheckpointConfig(step=3, rank=0)
        )
        config, loaded = handler.load_state_dict()
        assert config is None and loaded == {}
        # an intact later snapshot loads again (rule exhausted)
        handler.save_state_dict(
            state, CheckpointConfig(step=4, rank=0)
        )
        config, loaded = handler.load_state_dict()
        assert config is not None and config.step == 4
        np.testing.assert_array_equal(loaded["w"], state["w"])
    finally:
        handler.unlink()
        handler.close()


def test_corrupt_shm_flip_changes_payload(tmp_path, monkeypatch):
    from dlrover_tpu_torch.checkpoint.shm_handler import (
        CheckpointConfig,
        SharedMemoryHandler,
    )

    monkeypatch.setenv("DLROVER_JOB_NAME", "chaos-shm-flip")
    handler = SharedMemoryHandler(0, host=True)
    try:
        state = {"w": np.ones(64, dtype=np.float32)}
        chaos.install({
            "name": "t", "seed": 0,
            "rules": [{"point": "ckpt.shm_save",
                       "action": "corrupt_shm", "at_step": 1,
                       "args": {"nbytes": 16}}],
        })
        handler.save_state_dict(
            state, CheckpointConfig(step=1, rank=0)
        )
        config, loaded = handler.load_state_dict()
        assert config is not None
        assert not np.array_equal(loaded["w"], state["w"])
    finally:
        handler.unlink()
        handler.close()


# -- harness plumbing ------------------------------------------------------


def test_only_first_incarnation_prefers_ctx():
    """Agent-side hooks pass restart_count in ctx (the agent process
    never carries DLROVER_RESTART_COUNT in its own env); the guard
    must consult it so a kill_worker rule does not re-kill the
    recovered worker."""
    spec = {
        "name": "t", "seed": 0,
        "rules": [{"point": "agent.monitor", "action": "delay",
                   "max_count": 0, "only_first_incarnation": True,
                   "args": {"seconds": 0.0}}],
    }
    inj = ChaosInjector(spec)
    inj.fire("agent.monitor", restart_count=0)
    inj.fire("agent.monitor", restart_count=1)  # recovered: skipped
    inj.fire("agent.monitor", restart_count=0)
    assert len(inj.timeline_keys()) == 2


def test_incarnation_trigger_targets_one_respawn(monkeypatch):
    """`incarnation: N` fires only in the worker incarnation whose
    restart count is N — the scheduled-churn scenarios kill
    incarnation 0 at step A and incarnation 1 at step B without
    re-killing a respawn that replays step A."""
    from dlrover_tpu_torch.common.constants import NodeEnv

    spec = {
        "name": "t", "seed": 0,
        "rules": [
            {"point": "trainer.step", "action": "slow",
             "at_step": 3, "incarnation": 1, "args": {"seconds": 0.0}},
        ],
    }
    monkeypatch.setenv(NodeEnv.RESTART_COUNT, "0")
    assert _drive_steps(spec).timeline_keys() == []
    monkeypatch.setenv(NodeEnv.RESTART_COUNT, "1")
    assert len(_drive_steps(spec).timeline_keys()) == 1
    monkeypatch.setenv(NodeEnv.RESTART_COUNT, "2")
    assert _drive_steps(spec).timeline_keys() == []


def test_env_equals_targets_process_subset(monkeypatch):
    """`env_equals` confines a rule to processes whose environment
    matches — how a partition rule targets ONE node of a multi-agent
    job or one forkserver template generation."""
    spec = {
        "name": "t", "seed": 0,
        "rules": [
            {"point": "trainer.step", "action": "slow", "at_step": 2,
             "env_equals": {"DLROVER_NODE_RANK": "1"},
             "args": {"seconds": 0.0}},
        ],
    }
    monkeypatch.setenv("DLROVER_NODE_RANK", "0")
    assert _drive_steps(spec).timeline_keys() == []
    monkeypatch.setenv("DLROVER_NODE_RANK", "1")
    assert len(_drive_steps(spec).timeline_keys()) == 1


def test_env_equals_and_incarnation_serialize_roundtrip():
    from dlrover_tpu_torch.chaos.schedule import Scenario

    spec = {
        "name": "t", "seed": 3,
        "rules": [
            {"point": "p", "action": "slow", "at_step": 4,
             "incarnation": 2,
             "env_equals": {"DLROVER_NODE_RANK": "1"}},
        ],
    }
    s = Scenario.from_dict(spec)
    s2 = Scenario.from_dict(s.to_dict())
    assert s2.rules[0].incarnation == 2
    assert s2.rules[0].env_equals == {"DLROVER_NODE_RANK": "1"}


