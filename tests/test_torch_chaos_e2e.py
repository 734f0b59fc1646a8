"""Twins of ``tests/test_chaos_e2e.py`` for the port (slice 3b.2): a
seeded kill of the training worker mid-step drives the REAL recovery
machinery — the port's launcher, agent monitor loop, breakpoint shm
persist, master re-rendezvous, worker respawn, flash restore — and the
invariant checkers verify recovery from the telemetry event log alone.

The slice as a whole is first held against the JAX package: the tiny
GPT of the chaos train loop (``GPTConfig.tiny()``, bf16 compute over
fp32 params) takes 4 steps on the loop's batch in both packages from
the same flax init, optax ``adam(1e-3)`` against torch's ``Adam``
(optax's formula, eps 1e-8): losses within rtol 2e-3 (bf16 has a
relative step of 2^-8 = 3.9e-3 and XLA and ATen round its products in
another order; measured max 4.1e-4).  The kill twin also holds every
reported loss to an uninterrupted torch control of the same loop
(``LossTrajectoryMatches``, the reference's rtol 1e-3 / atol 1e-5).

The elastic world resize (slice 4.2) runs as the reference's
``test_elastic_resize_churn``: two launcher agents on this box against
one master, the tiny GPT under FSDP2 on gloo, node 1 lost, the world
shrunk to 1 and grown back to 2, every restore resharded from
committed storage.  A second case SIGKILLs and respawns the master
between the shrink and the grow (ROADMAP §C 3): the grown world forms
its group on the coordinator the respawned master hands out.

The resize loop's rank 0 feeds one sample per step from the master's
sharded dataset, held exactly-once (``NoDuplicateShards``) across both
resizes.  The master-recovery twins are in
``tests/test_torch_chaos_master.py``.  The multi-node hang and
partition, sparse, serving, RL and compile-cache scenarios of the
reference's file come with slices 4.3, 6, 7, 8.2 and 9 of the port.
The long scenarios are ``slow``, as in the reference.
"""

import os
import shutil
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dlrover_tpu_torch.chaos import harness, scenarios
from dlrover_tpu_torch.chaos.schedule import Scenario
from dlrover_tpu_torch.checkpoint.saver import read_last_checkpoint
from dlrover_tpu_torch.checkpoint.shm_handler import SharedMemoryHandler

pytestmark = pytest.mark.chaos

TOTAL_STEPS = 8
CKPT_EVERY = 2


@pytest.fixture()
def root(monkeypatch):
    """A short work root for the test's runs: a run's unix sockets live
    in ``<workdir>/sock``, and a socket path holds at most 107 bytes
    (pytest's ``tmp_path`` under xdist is too long).  Every run names
    its shm segment after that socket dir; the segment outlives the job
    by design, so the test's segments are unlinked at its end."""
    monkeypatch.delenv("DLROVER_JOB_NAME", raising=False)
    path = tempfile.mkdtemp(prefix="dlce")
    yield path
    for name in os.listdir(path):
        sock = os.path.join(path, name, "sock")
        if os.path.isdir(sock):
            with harness._patched_env({"DLROVER_SHARED_DIR": sock}):
                SharedMemoryHandler(0).unlink()
    shutil.rmtree(path, ignore_errors=True)


def _run(root, name, scenario, **kwargs):
    workdir = os.path.join(root, name)
    return harness.run_scenario(
        scenario,
        workdir=workdir,
        total_steps=TOTAL_STEPS,
        ckpt_every=CKPT_EVERY,
        monitor_interval=0.3,
        **kwargs,
    )


# -- the slice against the JAX package ------------------------------------


def test_tiny_gpt_losses_match_the_jax_chaos_loop():
    """4 steps of the chaos loop in both packages, in-process."""
    from dlrover_tpu.models.gpt import GPT as JaxGPT
    from dlrover_tpu.models.gpt import GPTConfig as JaxGPTConfig
    from dlrover_tpu.models.gpt import cross_entropy_loss as jax_ce
    from dlrover_tpu.trainer import elastic_trainer as jax_et
    from dlrover_tpu_torch.models.gpt import GPT, GPTConfig, cross_entropy_loss
    from dlrover_tpu_torch.trainer.elastic_trainer import (
        TrainState,
        make_train_step,
    )
    from dlrover_tpu_torch.utils.convert import params_from_jax

    cfg = JaxGPTConfig.tiny()
    jmodel = JaxGPT(cfg)
    params = jmodel.init_params(jax.random.PRNGKey(0))
    np_params = jax.tree.map(np.asarray, params)
    optimizer = optax.adam(1e-3)

    def jloss(p, batch):
        return jax_ce(jmodel.apply({"params": p}, batch["x"]), batch["y"])

    jstep = jax_et.make_train_step(jloss, optimizer)
    jstate = jax_et.TrainState.create(params, optimizer)
    data = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (8, 17), dtype=np.int32)
    batch = {"x": data[:, :-1], "y": data[:, 1:]}

    model = GPT(GPTConfig.tiny(), device="cpu")
    model.load_state_dict(params_from_jax(np_params))
    opt = torch.optim.Adam(model.parameters(), lr=1e-3,
                           betas=(0.9, 0.999), eps=1e-8)
    step = make_train_step(
        lambda m, b: cross_entropy_loss(m(b["x"]), b["y"]), opt,
        device="cpu")
    state = TrainState.create(model, opt)

    jax_losses, port_losses = [], []
    for _ in range(4):
        jstate, jm = jstep(jstate, jax.tree.map(jnp.asarray, batch))
        state, m = step(state, batch)
        jax_losses.append(float(jm["loss"]))
        port_losses.append(float(m["loss"]))
    np.testing.assert_allclose(port_losses, jax_losses, rtol=2e-3)
    assert port_losses[-1] < port_losses[0]


# -- the recovery scenarios -----------------------------------------------


def _control_losses(root):
    """The loop's losses uninterrupted: the same script under the
    launcher, no scenario armed."""
    workdir = os.path.join(root, "control")
    control = Scenario.from_dict({"name": "control", "seed": 0,
                                  "rules": []})
    report = harness.run_scenario(
        control, workdir=workdir, total_steps=TOTAL_STEPS,
        ckpt_every=CKPT_EVERY, monitor_interval=0.3, invariants=[],
    )
    assert report.rc == 0, report.summary()
    losses = {e["step"]: e["loss"] for e in report.events
              if e.get("type") == "train_step"}
    assert sorted(losses) == list(range(1, TOTAL_STEPS + 1))
    return [losses[s] for s in range(1, TOTAL_STEPS + 1)]


def test_kill_worker_midstep_recovers(root):
    """Acceptance: kill one worker mid-step with a fixed seed →
    rendezvous reconverges, training resumes from the shm checkpoint
    losing ≤ 1 checkpoint interval, every loss equals the
    uninterrupted control's, the final step commits, nothing is
    orphaned — all verified from telemetry events."""
    control = _control_losses(root)
    scenario = scenarios.kill_worker_midstep(seed=42)
    # narrow the window to the shortened step budget
    scenario.rules[0].step_window = [3, 6]
    workdir = os.path.join(root, "run")
    invariants = harness.invariants_for_scenario(
        scenario.name, TOTAL_STEPS, CKPT_EVERY, workdir,
    ) + [
        harness.RestoredFromTier("shm"),
        harness.FinalStepCommitted(),
        harness.LossTrajectoryMatches(control),
    ]
    names = {inv.name for inv in invariants}
    assert {"worker_restarted", "rendezvous_reconverged",
            "bounded_step_loss", "training_completed",
            "no_orphan_processes", "goodput_conservation"} <= names
    report = _run(root, "run", scenario, invariants=invariants)
    assert report.ok, report.summary()

    # exactly one seeded kill, mid-step, in the window
    assert len(report.timeline) == 1, report.timeline
    seq, point, rule, action, step = report.timeline[0]
    assert point == "trainer.step" and action == "kill"
    assert 3 <= step <= 6
    restarts = [e for e in report.events
                if e.get("type") == "worker_restart"]
    assert len(restarts) == 1, restarts

    # the run really finished: last committed checkpoint on storage
    # is the final step
    final_step, shards = read_last_checkpoint(
        os.path.join(root, "run", "ckpt")
    )
    assert final_step == TOTAL_STEPS and 0 in shards


def test_shm_corruption_falls_back_to_storage_tier(root):
    """Tear the shm snapshot, kill the worker → the respawned trainer
    refuses the torn shm tier and restores from the last committed
    DISK step; the RestoredFromTier invariant decides from the
    checkpoint_restore event's tier field alone."""
    report = _run(
        root, "run", scenarios.shm_corrupt_storage_fallback(seed=23),
    )
    assert report.ok, report.summary()
    # both seeded faults executed, in order: tear then kill
    actions = [t[3] for t in report.timeline]
    assert actions == ["corrupt_shm", "kill"], report.timeline
    restores = [
        e for e in report.events
        if e.get("type") == "checkpoint_restore"
    ]
    assert restores and restores[0]["tier"] == "storage", restores
    final_step, shards = read_last_checkpoint(
        os.path.join(root, "run", "ckpt")
    )
    assert final_step == TOTAL_STEPS and 0 in shards


def test_trainer_hang_detected_and_culprit_restarted(root):
    """Freeze the trainer mid-step with the stall primitive.  The
    agent watchdog must capture hang flight data and ship it; the
    master's inference chain must reach a *hung* verdict carrying the
    evidence and a measured stall; ONLY the culprit node is restarted,
    the restored incarnation finishes the budget, and the goodput
    attribution books the stall under the ``hang`` bucket."""
    report = _run(root, "run", scenarios.trainer_hang_detected(seed=47))
    assert report.ok, report.summary()

    assert len(report.timeline) == 1, report.timeline
    _seq, point, _rule, action, step = report.timeline[0]
    assert point == "trainer.step" and action == "stall"
    assert step == 5

    evidence = [
        e for e in report.events if e.get("type") == "hang_evidence"
    ]
    assert evidence, "no hang_evidence events"
    assert any("pid" in (e.get("workers") or "") for e in evidence)

    verdicts = [
        e for e in report.events
        if e.get("type") == "diagnosis_verdict" and e.get("hung")
    ]
    assert verdicts, "no hung verdict"
    assert verdicts[0]["stall_s"] > 0
    assert verdicts[0]["evidence"]
    assert verdicts[0]["culprit_node"] >= 0

    attr = report.attribution
    assert attr["loss_s"] > 0
    assert sum(attr["buckets"].values()) >= 0.9 * attr["loss_s"]
    assert attr["buckets"]["hang"] > 0, attr["buckets"]

    final_step, shards = read_last_checkpoint(
        os.path.join(root, "run", "ckpt")
    )
    assert final_step == TOTAL_STEPS and 0 in shards


@pytest.mark.slow
def test_kill_scenario_timeline_deterministic_across_runs(root):
    """Same scenario + same seed twice → identical fault timelines."""
    scenario = scenarios.kill_worker_midstep(seed=1234)
    scenario.rules[0].step_window = [3, 6]
    first = _run(root, "a", scenario)
    assert first.ok, first.summary()
    second = _run(
        root, "b", scenario,
        invariants=harness.default_invariants(
            TOTAL_STEPS, CKPT_EVERY, os.path.join(root, "b")
        ) + [harness.DeterministicTimeline(first.timeline)],
    )
    assert second.ok, second.summary()
    assert second.timeline == first.timeline


@pytest.mark.slow
@pytest.mark.parametrize(
    "factory", ["warm_template_import_kill",
                "warm_template_midspawn_kill"],
)
def test_warm_restart_template_chaos(root, factory):
    """Kill the forkserver template during its preload imports /
    mid-spawn — the agent must detect the dead template immediately,
    fall back to cold spawns (warm_fork_fallback event), finish the
    job, and leave no orphan processes (template children
    included)."""
    workdir = os.path.join(root, "run")
    report = harness.run_scenario(
        scenarios.SCENARIOS[factory](),
        workdir=workdir,
        total_steps=6,
        ckpt_every=CKPT_EVERY,
        monitor_interval=0.3,
    )
    assert report.ok, report.summary()
    assert any(
        t[1].startswith("forkserver.") and t[3] == "kill"
        for t in report.timeline
    ), report.timeline


# -- the elastic world resize (slice 4.2) -------------------------------------


def _resize(root, name, **kwargs):
    workdir = os.path.join(root, name)
    try:
        return harness.run_elastic_resize_scenario(
            scenarios.elastic_resize_churn(seed=53), workdir=workdir,
            nnodes=2, **kwargs)
    finally:
        for sock in ("sock0", "sock1", "sock1b"):
            with harness._patched_env(
                    {"DLROVER_SHARED_DIR": os.path.join(workdir, sock)}):
                SharedMemoryHandler(0).unlink()


def _assert_resize_arc(report):
    assert report.ok, report.summary()
    # the node loss really happened, on rank 1, exactly once
    kills = [t for t in report.timeline if t[3] == "kill_node"]
    assert len(kills) == 1, report.timeline
    # both resize directions were decided by the coordinator
    decisions = [e for e in report.events
                 if e.get("type") == "resize_decision"]
    targets = [e["target"] for e in decisions]
    assert 1 in targets and 2 in targets, decisions
    # the drain rode the heartbeat-action channel: resize-reason
    # restarts on the surviving node
    resize_restarts = [e for e in report.events
                       if e.get("type") == "worker_restart"
                       and e.get("reason") == "resize"]
    assert resize_restarts, "no resize-driven worker restart"
    # cross-world restores resharded from storage, never from a stale
    # per-node shm snapshot
    restores = [e for e in report.events
                if e.get("type") == "checkpoint_restore"]
    assert restores and all(
        e.get("tier") == "storage" for e in restores), restores


def test_elastic_resize_churn(root):
    """Kill one of two agents mid-run (the whole supervision tree: a
    vanished node, no failure report).  The master's resize coordinator
    must detect the silence, decide world 2 -> 1, drain the survivor
    over the heartbeat-action channel, and the re-formed world must
    restore the checkpoint RESHARDED from the committed storage tier
    (node 1's shards redistributed onto node 0) and keep stepping.  When
    the harness respawns the lost agent (a replacement host), the world
    grows back to 2 the same way.  Verified from telemetry alone:
    completed-world sizes 2 -> 1 -> 2, every reported loss equal to the
    uninterrupted-control trajectory, per-restart step loss bounded,
    final step committed, resize phase breakdown on the assembled
    timeline, goodput loss booked under the resize cause."""
    _assert_resize_arc(_resize(root, "resize"))


def test_grown_world_forms_its_group_on_the_respawned_master(root):
    """ROADMAP §C 3: the master is SIGKILLed between the shrink and the
    grow and respawned on its port and journal, and picks a new
    coordinator port.  The grown world's ranks take the rendezvous
    address from the respawned master's reply for the round they join,
    so both form their gloo group on it and train on (the whole resize
    arc holds as without the respawn)."""
    report = _resize(root, "resize_respawn", respawn_master=True)
    _assert_resize_arc(report)
    killed_at = report.master_respawned_at
    assert killed_at is not None
    groups = [e for e in report.events
              if e.get("type") == "process_group"
              and e.get("world_size") == 2]
    before = {e["coordinator"] for e in groups if e["ts"] < killed_at}
    after = [e for e in groups if e["ts"] > killed_at]
    assert len(before) == 1 and len(after) == 2, groups
    assert {e["node_rank"] for e in after} == {0, 1}
    assert len({e["coordinator"] for e in after}) == 1
    assert {e["coordinator"] for e in after} != before
    # and the grown world stepped together on it
    steps = [e for e in report.events
             if e.get("type") == "train_step" and e["ts"] > max(
                 e2["ts"] for e2 in after)]
    assert {e["node_rank"] for e in steps} == {0, 1}
