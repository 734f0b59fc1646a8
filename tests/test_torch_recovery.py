"""Twins of ``tests/test_recovery.py`` for the port: the trainer-side
RecoveryProfiler (the measured death->first-step budget), the
timeline's recovery-breakdown slices, and the agent-side overlap knob
and recovery clock.

The reference's two compile-cache cases have their twins here: a step
resolved through the caches hits in the next incarnation, and the
retrace witness reads the compile cache's kernel libraries
(``kernel-cache-hit`` over a warm directory, ``cold`` otherwise); the
AOT cache's own cases are in ``tests/test_torch_aot_cache.py``.  Times are
held to what the calls slept (>=) and to the values recorded (exact
after the profiler's rounding to 0.1 ms).
"""

import time

import pytest

from dlrover_tpu_torch.telemetry import timeline as flight
from dlrover_tpu_torch.telemetry.events import EVENT_LOG_ENV, read_events
from dlrover_tpu_torch.trainer import recovery as rec


@pytest.fixture()
def event_log(tmp_path, monkeypatch):
    path = str(tmp_path / "events.jsonl")
    monkeypatch.setenv(EVENT_LOG_ENV, path)
    return path


# -- step caches ----------------------------------------------------------


def _tiny_step():
    import torch

    from dlrover_tpu_torch.trainer.elastic_trainer import (
        TrainState, make_train_step,
    )

    torch.manual_seed(0)
    module = torch.nn.Linear(4, 2)
    opt = torch.optim.SGD(module.parameters(), lr=0.1)

    def loss_fn(m, batch):
        return (m(batch["x"]) ** 2).mean()

    batch = {"x": torch.ones(3, 4)}
    return (make_train_step(loss_fn, opt, device="cpu"),
            TrainState.create(module, opt), batch)


def test_resolve_step_through_the_cache_hits_in_the_next_incarnation(
        tmp_path, monkeypatch, event_log):
    """``resolve_step(cache_dir=...)``: incarnation 0 misses and writes
    the entry at its first call; incarnation 1 hits it (``aot-hit``),
    books the resolve as ``aot`` and its first eager call as
    ``retrace``, and steps to incarnation 0's loss."""
    monkeypatch.setenv("DLROVER_COMPILE_CACHE_DIR", str(tmp_path / "cc"))
    aot = str(tmp_path / "cc" / "aot")
    losses, profs = [], []
    for restart in (0, 1):
        step_fn, state, batch = _tiny_step()
        prof = rec.RecoveryProfiler(restart_count=restart, node_rank=0)
        assert prof.cache_dir == str(tmp_path / "cc")
        step = prof.resolve_step(step_fn, lambda: (state, batch),
                                 cache_dir=aot)
        _, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
        profs.append(prof)
    assert losses[0] == losses[1]
    assert [p.aot_hit for p in profs] == [False, True]
    assert profs[1].cache_hit is True and profs[1].phases["retrace"] > 0
    events = list(read_events(event_log))
    aot_ev = [e for e in events if e["type"] == "aot_cache"]
    assert [(e["hit"], e["wrote"]) for e in aot_ev] == [
        (False, True), (True, False)]
    assert aot_ev[1]["fast"] is True
    cache = [e for e in events if e["type"] == "compile_cache"]
    assert [e["status"] for e in cache] == ["cold", "aot-hit"]
    assert cache[1]["aot_entries"] == 1
    assert (tmp_path / "cc" / "kernels").is_dir()


def test_resolve_step_async_through_the_cache(tmp_path, monkeypatch,
                                              event_log):
    """``resolve_step_async``: the resolve runs on a thread; the join
    books its wait as ``aot`` (``wait_s`` on the event) and yields the
    hit in the second incarnation."""
    aot = str(tmp_path / "aot")
    hits = []
    for restart in (0, 1):
        step_fn, state, batch = _tiny_step()
        prof = rec.RecoveryProfiler(restart_count=restart, node_rank=0)
        join = prof.resolve_step_async(
            step_fn, lambda: (state, batch), cache_dir=aot,
            restore_busy=False)
        step = join()
        step(state, batch)
        hits.append(prof.aot_hit)
    assert hits == [False, True]
    aot_ev = [e for e in read_events(event_log) if e["type"] == "aot_cache"]
    assert all("wait_s" in e and e["overlapped_restore"] is False
               for e in aot_ev)


def test_retrace_witness_reads_the_kernel_cache(tmp_path, monkeypatch,
                                                event_log):
    """Twin of the reference's ``test_retrace_hit_vs_miss_witness``: no
    NEW kernel library across the bracket over a WARM cache = HIT
    (``kernel-cache-hit``); a new library (or an empty cache) = MISS
    (``cold``)."""
    cache = tmp_path / "cache"
    monkeypatch.setenv("DLROVER_COMPILE_CACHE_DIR", str(cache))
    monkeypatch.setenv("DLROVER_RESTART_COUNT", "1")
    prof = rec.RecoveryProfiler()
    with prof.measured_retrace():
        (cache / "kernels" / "flash_attention-1.so").write_bytes(b"x")
    assert prof.cache_hit is False
    prof2 = rec.RecoveryProfiler()
    with prof2.measured_retrace():
        pass
    assert prof2.cache_hit is True
    events = [e for e in read_events(event_log)
              if e["type"] == "compile_cache"]
    assert [(e["hit"], e["status"]) for e in events] == [
        (False, "cold"), (True, "kernel-cache-hit")]
    assert [e["entries_before"] for e in events] == [0, 1]
    assert all("retrace_s" in e and e["build_s"] == 0.0 for e in events)
    assert "retrace" in prof2.phases


def test_resolve_step_is_the_reference_off_path(event_log):
    """No example inputs, so no entry is keyed: the first call of the
    resolved step runs under the measured retrace (booked once), later
    calls go straight through; the aot phase is 0, the aot witness says
    off, and the compile witness reads the (empty) cache: cold."""
    prof = rec.RecoveryProfiler(restart_count=1, node_rank=0)
    calls = []

    def step(x):
        calls.append(x)
        time.sleep(0.02)
        return x

    resolved = prof.resolve_step(step, restore_busy=lambda: True)
    assert resolved(1) == 1 and resolved(2) == 2
    assert calls == [1, 2]
    assert prof.phases["aot"] == 0.0
    assert prof.phases["retrace"] >= 0.02
    assert prof.aot_hit is False and prof.cache_hit is False
    events = list(read_events(event_log))
    aot = [e for e in events if e["type"] == "aot_cache"]
    assert len(aot) == 1 and aot[0]["resolution"] == "off"
    assert aot[0]["hit"] is False and aot[0]["overlapped_restore"] is True
    cache = [e for e in events if e["type"] == "compile_cache"]
    assert len(cache) == 1 and cache[0]["status"] == "cold"
    retraces = [e for e in events if e["type"] == "recovery_phase"
                and e["phase"] == "retrace"]
    assert len(retraces) == 1


# -- recovery profiler --------------------------------------------------


def test_profiler_phases_and_events(tmp_path, monkeypatch, event_log):
    monkeypatch.setenv("DLROVER_RESTART_COUNT", "2")
    monkeypatch.setenv("DLROVER_NODE_RANK", "0")
    # T0 slightly in the past: the spawn phase is proc_start - t0
    monkeypatch.setenv(
        rec.RECOVERY_T0_ENV, f"{time.time() - 5.0:.6f}"
    )
    prof = rec.RecoveryProfiler()
    assert prof.restart_count == 2
    assert "import" in prof.phases
    # spawn only books when the kernel start time resolves; on /proc
    # platforms it must be ~the 5s offset
    if "spawn" in prof.phases:
        assert 0.0 <= prof.phases["spawn"] <= 60.0
    prof.record_restore({"total_s": 0.25, "tier": "shm"})
    assert prof.phases["restore"] == 0.25
    with prof.phase("custom"):
        time.sleep(0.01)
    assert prof.phases["custom"] >= 0.01
    prof.record_first_step()
    assert prof.phases["first_step"] >= 0.0
    types = [e["type"] for e in read_events(event_log)]
    assert types.count("recovery_phase") >= 4


def test_retrace_witness_waits_for_the_step(monkeypatch, event_log):
    """The retrace bracket books the step's wall time, waits for the
    device work behind ``block``ed outputs (a CPU tensor needs none),
    and emits the witness once per bracket: no compile cache is armed,
    so it reads cold."""
    import torch

    monkeypatch.setenv("DLROVER_RESTART_COUNT", "1")
    prof = rec.RecoveryProfiler()
    with prof.measured_retrace() as r:
        time.sleep(0.02)
        r.block({"loss": torch.ones(())})
    assert prof.cache_hit is False
    assert prof.phases["retrace"] >= 0.02
    prof2 = rec.RecoveryProfiler()
    with prof2.measured_retrace():
        pass
    events = [
        e for e in read_events(event_log)
        if e["type"] == "compile_cache"
    ]
    assert [e["hit"] for e in events] == [False, False]
    assert [e["status"] for e in events] == ["cold", "cold"]
    assert all("retrace_s" in e for e in events)
    assert "retrace" in prof2.phases


# -- timeline integration ----------------------------------------------


def _mk_events():
    t = 1000.0
    return [
        {"type": "recovery_phase", "ts": t + 1.0, "phase": "spawn",
         "seconds": 0.2, "restart_count": 1, "node_rank": 0,
         "source": "trainer"},
        {"type": "recovery_phase", "ts": t + 1.5, "phase": "restore",
         "seconds": 0.3, "restart_count": 1, "node_rank": 0,
         "source": "trainer"},
        {"type": "recovery_phase", "ts": t + 2.5, "phase": "retrace",
         "seconds": 0.9, "restart_count": 1, "node_rank": 0,
         "source": "trainer"},
        {"type": "recovery_phase", "ts": t + 2.6,
         "phase": "first_step", "seconds": 0.1, "restart_count": 1,
         "node_rank": 0, "source": "trainer"},
        {"type": "compile_cache", "ts": t + 2.5, "hit": True,
         "retrace_s": 0.9, "entries_before": 40,
         "entries_after": 40, "restart_count": 1, "node_rank": 0,
         "source": "trainer"},
    ]


def test_timeline_recovery_slices_and_budgets():
    tl = flight.assemble(_mk_events())
    slices = tl.slices_by_cat(flight.CAT_RECOVERY_PHASE)
    assert {s.meta["phase"] for s in slices} == {
        "spawn", "restore", "retrace", "first_step",
    }
    retrace = next(s for s in slices if s.meta["phase"] == "retrace")
    assert retrace.duration == pytest.approx(0.9)
    cache = [
        e for e in tl.instants if e["type"] == "compile_cache"
    ]
    assert cache
    budgets = flight.recovery_budgets(tl.events)
    assert budgets[(0, 1)]["retrace"] == pytest.approx(0.9)
    assert budgets[(0, 1)]["compile_cache_hit"] is True
    text = flight.to_report(tl)
    assert "recovery budgets" in text
    assert "cache=HIT" in text
    assert "retrace=0.900s" in text


# -- agent-side knobs ---------------------------------------------------


def test_agent_overlap_save_knob(monkeypatch):
    """The breakpoint persist of a failure or hang restart runs on a
    thread of its own, overlapped with the stop and the respawn; a
    planned drain (resize) persists before the stop.  The port has no
    switch for this (the reference's DLROVER_OVERLAP_BREAKPOINT_SAVE
    is not read)."""
    import threading

    from dlrover_tpu_torch.agent.training import ElasticTrainingAgent

    monkeypatch.setenv("DLROVER_OVERLAP_BREAKPOINT_SAVE", "0")
    agent = ElasticTrainingAgent.__new__(ElasticTrainingAgent)
    agent._node_rank = 0
    agent._restart_count = 0
    agent._budget_restarts = 0
    agent._save_thread = None
    agent._hang_watchdog = None
    calls = []
    release = threading.Event()

    def save():
        calls.append(("save", threading.current_thread().name))
        release.wait(5.0)

    agent._save_ckpt_at_breakpoint = save
    agent._prefetch_shm_for_restore = lambda: calls.append(("prefetch",))
    agent._stop_workers = lambda timeout=None: calls.append(("stop",))
    agent._initialize_workers = lambda: calls.append(("init",))

    agent._restart_workers("failure")
    # the stop and the respawn went ahead while the save still waits
    assert agent._save_thread.is_alive()
    assert ("stop",) in calls and ("init",) in calls
    release.set()
    agent._join_save_thread()
    assert ("save", "breakpoint-save") in calls
    assert calls[0] == ("prefetch",)

    calls.clear()
    agent._restart_workers("resize")
    assert agent._save_thread is None
    assert calls == [("prefetch",), ("save", "MainThread"), ("stop",),
                     ("init",)]
    assert agent._restart_count == 2 and agent._budget_restarts == 1


def test_worker_env_exports_recovery_t0(monkeypatch):
    """The agent stamps DLROVER_RECOVERY_T0 into respawned workers'
    env (and never into a first start's); no compile-cache env rides
    along unless the operator armed the cache (the reference exports
    its JAX cache always)."""
    from dlrover_tpu_torch.agent.training import (
        ElasticTrainingAgent, RendezvousOutcome, WorkerSpec,
    )

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    agent = ElasticTrainingAgent.__new__(ElasticTrainingAgent)
    agent._spec = WorkerSpec(entrypoint=["x.py"])
    agent._node_rank = 0
    agent._restart_count = 0
    agent._recovery_t0 = 0.0

    class _C:
        master_addr = "127.0.0.1:1"

    agent._client = _C()
    outcome = RendezvousOutcome(
        round=1, world={0: 1}, coordinator="127.0.0.1:2"
    )
    env = agent._worker_env(outcome, 0)
    assert "DLROVER_RECOVERY_T0" not in env
    assert "JAX_COMPILATION_CACHE_DIR" not in env
    assert env["DLROVER_COORDINATOR_ADDR"] == "127.0.0.1:2"
    agent._recovery_t0 = time.time()
    agent._restart_count = 1
    env = agent._worker_env(outcome, 0)
    assert float(env["DLROVER_RECOVERY_T0"]) == pytest.approx(
        agent._recovery_t0, abs=1e-3
    )
    assert env["DLROVER_RESTART_COUNT"] == "1"


def test_train_state_round_trip_replays_the_next_step():
    """The recovery's state: ``train_state_tree`` after 2 steps, copied
    to private CPU tensors as a restore hands them over, loaded by
    ``restore_train_state`` into a fresh model and optimizer, takes the
    third step to the uninterrupted run's loss and params exactly (one
    CPU process, the same kernels)."""
    import numpy as np
    import torch

    from dlrover_tpu_torch.checkpoint.shm_handler import map_leaves
    from dlrover_tpu_torch.models.gpt import GPT, GPTConfig, cross_entropy_loss
    from dlrover_tpu_torch.trainer.elastic_trainer import (
        TrainState,
        make_train_step,
        restore_train_state,
        train_state_tree,
    )

    data = np.random.default_rng(0).integers(0, 256, (8, 17), dtype=np.int32)
    batch = {"x": data[:, :-1], "y": data[:, 1:]}

    def fresh(seed):
        model = GPT(GPTConfig.tiny(dtype=torch.float32), device="cpu",
                    seed=seed)
        opt = torch.optim.Adam(model.parameters(), lr=1e-3)
        step = make_train_step(
            lambda m, b: cross_entropy_loss(m(b["x"]), b["y"]), opt,
            device="cpu")
        return TrainState.create(model, opt), step

    state, step = fresh(0)
    for _ in range(2):
        state, _ = step(state, batch)
    saved = map_leaves(
        lambda path, leaf: leaf.detach().clone()
        if isinstance(leaf, torch.Tensor) else leaf,
        train_state_tree(state))
    assert saved["step"] == 2
    assert set(saved["opt_state"]) == {"step", "exp_avg", "exp_avg_sq"}
    state, metrics = step(state, batch)

    other, other_step = fresh(1)  # other weights until the restore
    restore_train_state(other, saved)
    assert other.step == 2
    other, other_metrics = other_step(other, batch)
    assert other.step == 3
    assert other_metrics["loss"].item() == metrics["loss"].item()
    for (name, p), q in zip(state.module.named_parameters(),
                            other.module.parameters()):
        assert torch.equal(p, q), name
