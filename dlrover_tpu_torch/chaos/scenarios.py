"""Built-in chaos scenarios + the toy elastic train loop they drive.

Each scenario is a factory ``(seed) -> Scenario`` registered in
:data:`SCENARIOS`; the CLI (``python -m dlrover_tpu_torch.chaos``) and
the e2e tests run them through :mod:`dlrover_tpu_torch.chaos.harness`.
They are deliberately small compositions of the schedule vocabulary —
the point of the subsystem is that new failure modes are a dict away,
not a new test file away.

Copy of ``dlrover_tpu/chaos/scenarios.py``, cut to the single-node
scenarios of the port's slice 3b.2: the worker kill (SIGKILL and
SIGTERM), the torn shm snapshot with its storage-tier fallback, the
trainer hang and the two warm-template kills.  The train loop is the
torch twin of the reference's ``CHAOS_TRAIN_SCRIPT``.  The other
scripts and scenarios come with the slices that bring what they drive:
the multi-node and resize scenarios with slice 4.2, the sparse and
serving ones with slices 6 and 9, the RL one with slice 7, the
master-recovery ones (they need the sharding client) and the
compile-cache one with slice 8.
"""

from typing import Callable, Dict, Optional

from dlrover_tpu_torch.chaos.schedule import Scenario

# knobs the harness exports to the training subprocess
TOTAL_STEPS_ENV = "DLROVER_CHAOS_TOTAL_STEPS"
CKPT_EVERY_ENV = "DLROVER_CHAOS_CKPT_EVERY"
# durable mid-run saves every N steps (0 = only the final step goes
# to disk) — the tier-fallback scenarios restore from these when the
# shm snapshot is refused
DISK_EVERY_ENV = "DLROVER_CHAOS_DISK_EVERY"

# Toy GPT elastic train loop, the torch twin of the reference's: the
# tiny GPT on the CPU (asked for explicitly, as the reference pins
# jax_platforms=cpu), torch's Adam (optax.adam's formula, eps 1e-8) on
# one fixed batch.  Flash-checkpoints the WHOLE train state (params,
# Adam slots, step) to shm every CKPT_EVERY steps; a killed incarnation
# restores from the snapshot the agent kept alive and finishes the
# fixed step budget; the final step is persisted to disk and
# committed.  argv: ckpt_dir
CHAOS_TRAIN_SCRIPT = r'''
import os, sys, time
import numpy as np
import torch

from dlrover_tpu_torch.checkpoint.checkpointer import Checkpointer, StorageType
from dlrover_tpu_torch.models.gpt import GPT, GPTConfig, cross_entropy_loss
from dlrover_tpu_torch.trainer.elastic_trainer import (
    ElasticTrainer, TrainState, make_train_step, restore_train_state,
    train_state_tree,
)
from dlrover_tpu_torch.trainer.recovery import RecoveryProfiler

DEVICE = "cpu"
ckpt_dir = sys.argv[1]
TOTAL_STEPS = int(os.environ.get("DLROVER_CHAOS_TOTAL_STEPS", "10"))
CKPT_EVERY = int(os.environ.get("DLROVER_CHAOS_CKPT_EVERY", "2"))
DISK_EVERY = int(os.environ.get("DLROVER_CHAOS_DISK_EVERY", "0"))
# the reference's master-recovery scenarios drive the master's dynamic
# data sharding through this knob; they come with slice 8 of the port
if int(os.environ.get("DLROVER_CHAOS_SHARD_DATASET", "0")):
    raise NotImplementedError(
        "the sharded-dataset loop needs agent/sharding_client.py, which "
        "comes with slice 8 of the port")

# measured death->first-step budget: books the spawn/import phases
# now, restore/retrace/first_step below — every incarnation emits
# recovery_phase events the invariants and timeline read
prof = RecoveryProfiler()

tracker = os.path.join(ckpt_dir, "latest_checkpointed_iteration.txt")

def committed_step():
    try:
        with open(tracker) as f:
            return int(f.read().strip() or -1)
    except (OSError, ValueError):
        return -1

# restore overlap: the read/assemble stages run on a background
# thread WHILE the model/optimizer/step build below proceeds — only
# the result() join is serial with training
with prof.phase("ckpt_init"):
    ckpt = Checkpointer(ckpt_dir)
    load_handle = ckpt.load_checkpoint_async()

with prof.phase("model_build"):
    cfg = GPTConfig.tiny()
    model = GPT(cfg, device=DEVICE, seed=0)
    optimizer = torch.optim.Adam(model.parameters(), lr=1e-3,
                                 betas=(0.9, 0.999), eps=1e-8)

    def loss_fn(module, batch):
        return cross_entropy_loss(module(batch["x"]), batch["y"])

    step_fn = make_train_step(loss_fn, optimizer, device=DEVICE)

rng = np.random.default_rng(0)
data = rng.integers(0, cfg.vocab_size, (8, 17), dtype=np.int32)

def place_batch():
    # per-step host->device placement so the always-on profiler's
    # h2d phase measures a real transfer
    return {"x": torch.from_numpy(data[:, :-1]).to(DEVICE),
            "y": torch.from_numpy(data[:, 1:]).to(DEVICE)}

# no step cache before slice 8: the first call is the measured retrace
step = prof.resolve_step(
    step_fn, restore_busy=lambda: not load_handle.done(),
)

start_step, restored = load_handle.result()
prof.record_restore(ckpt.last_restore_phases)
with prof.phase("state_build"):
    state = TrainState.create(model, optimizer)
    if start_step is None:
        start_step = 0
    else:
        # the checkpoint carries the WHOLE train state (params + Adam
        # slots + step): nothing is re-initialised
        restore_train_state(state, restored["state"])

_first_step = [True]
def run_step(state, batch):
    state, metrics = step(state, batch)
    if _first_step[0]:
        _first_step[0] = False
        prof.record_first_step()
    return state, metrics

with prof.phase("loop_setup"):
    trainer = ElasticTrainer(global_batch_size=8, micro_batch_size=8,
                             dp_size=1)
    trainer.global_step = start_step

def after_step():
    sd = {"state": train_state_tree(state), "trainer": trainer.state_dict()}
    if DISK_EVERY and trainer.global_step % DISK_EVERY == 0:
        # durable mid-run save; wait for the commit so a kill rule
        # scheduled a couple of steps later deterministically finds
        # a committed storage step to fall back to
        ckpt.save_checkpoint(
            trainer.global_step, sd, storage_type=StorageType.DISK,
        )
        ckpt.wait()
        deadline = time.time() + 30
        while (time.time() < deadline
               and committed_step() < trainer.global_step):
            time.sleep(0.1)
    elif trainer.global_step % CKPT_EVERY == 0:
        ckpt.save_checkpoint(
            trainer.global_step, sd, storage_type=StorageType.MEMORY,
        )

for i in range(start_step, TOTAL_STEPS):
    with trainer.profile("h2d"):
        batch = place_batch()
    with trainer.profile("compute") as p:
        state, metrics = run_step(state, batch)
        p.block(metrics)
    # report_step emits the train_step event and fires the
    # trainer.step chaos hook — a kill rule ends the process HERE
    trainer.report_step(metrics)
    with trainer.profile("checkpoint"):
        after_step()
FINAL_STEP = TOTAL_STEPS

# final durable save, retried until the commit lands (a transient
# brownout may eat one persist round); only node rank 0 waits on the
# commit tracker, which the saver writes on rank 0 alone
final_sd = {"state": train_state_tree(state), "trainer": trainer.state_dict()}
NODE_RANK = int(os.environ.get("DLROVER_NODE_RANK", "0") or 0)
if NODE_RANK == 0:
    deadline = time.time() + 60
    while time.time() < deadline and committed_step() < FINAL_STEP:
        ckpt.save_checkpoint(
            FINAL_STEP, final_sd, storage_type=StorageType.DISK,
        )
        ckpt.wait()
        poll_end = time.time() + 10
        while time.time() < poll_end and committed_step() < FINAL_STEP:
            time.sleep(0.2)
    assert committed_step() >= FINAL_STEP, (
        "checkpoint commit did not land"
    )
else:
    ckpt.save_checkpoint(
        FINAL_STEP, final_sd, storage_type=StorageType.DISK,
    )
    ckpt.wait()
ckpt.close()
'''


def kill_worker_midstep(seed: int = 42) -> Scenario:
    """THE acceptance scenario: SIGKILL the worker at a seed-chosen
    step mid-run.  The agent's monitor loop observes the death,
    persists the shm snapshot, re-rendezvouses and respawns; the
    recovered incarnation must lose at most one checkpoint interval."""
    return Scenario.from_dict({
        "name": "kill-worker-midstep",
        "seed": seed,
        "rules": [{
            "name": "kill-midstep",
            "point": "trainer.step",
            "action": "kill",
            "step_window": [4, 7],
            "only_first_incarnation": True,
        }],
    })


def sigterm_worker_midstep(seed: int = 42) -> Scenario:
    """Graceful-eviction flavour of the kill scenario (SIGTERM)."""
    return Scenario.from_dict({
        "name": "sigterm-worker-midstep",
        "seed": seed,
        "rules": [{
            "name": "term-midstep",
            "point": "trainer.step",
            "action": "kill",
            "step_window": [4, 7],
            "only_first_incarnation": True,
            "args": {"signal": "TERM"},
        }],
    })


def shm_corrupt_storage_fallback(seed: int = 23) -> Scenario:
    """Tier-fallback acceptance: tear the shm snapshot at a MEMORY
    save, then kill the worker one step later.  The respawned trainer
    must refuse the torn shm tier and restore from the last committed
    storage step (the harness runs this with ``disk_every=4`` so one
    exists) — asserted by the ``RestoredFromTier`` invariant reading
    the ``checkpoint_restore`` event's ``tier`` field."""
    return Scenario.from_dict({
        "name": "shm-corrupt-storage-fallback",
        "seed": seed,
        "rules": [
            {
                "name": "torn-snapshot",
                "point": "ckpt.shm_save",
                "action": "corrupt_shm",
                "at_step": 6,
                "only_first_incarnation": True,
                "args": {"mode": "torn"},
            },
            {
                "name": "kill-after-tear",
                "point": "trainer.step",
                "action": "kill",
                "at_step": 7,
                "only_first_incarnation": True,
            },
        ],
    })


def warm_template_import_kill(seed: int = 37) -> Scenario:
    """Warm-restart chaos: SIGKILL the forkserver template DURING its
    heavy preload imports — generation 1 and its rebuild both die, so
    the agent's spawn must detect the dead template immediately and
    fall back to cold spawns with no orphan processes."""
    return Scenario.from_dict({
        "name": "warm-template-import-kill",
        "seed": seed,
        "rules": [
            {
                "name": "kill-template-import-gen1",
                "point": "forkserver.template_import",
                "action": "kill",
                "after_calls": 2,
                "env_equals": {"DLROVER_FORKSERVER_GENERATION": "1"},
            },
            {
                # the rebuilt template dies the same way: the agent
                # must give up on warm forks for the round instead of
                # rebuilding forever
                "name": "kill-template-import-gen2",
                "point": "forkserver.template_import",
                "action": "kill",
                "after_calls": 2,
                "env_equals": {"DLROVER_FORKSERVER_GENERATION": "2"},
            },
        ],
    })


def warm_template_midspawn_kill(seed: int = 41) -> Scenario:
    """Warm-restart chaos: SIGKILL the template mid-spawn — the spawn
    request is consumed but no child is forked and no reply is coming,
    the hardest template loss to detect.  The agent must fall back to
    a cold spawn in milliseconds (dead-template check in the wait
    loop), leaving no orphans."""
    return Scenario.from_dict({
        "name": "warm-template-midspawn-kill",
        "seed": seed,
        "rules": [{
            "name": "kill-template-midspawn",
            "point": "forkserver.spawn",
            "action": "kill",
            "env_equals": {"DLROVER_FORKSERVER_GENERATION": "1"},
        }],
    })


def trainer_hang_detected(seed: int = 47) -> Scenario:
    """Deep-diagnosis acceptance: freeze one trainer mid-step with the
    stall primitive (a sleep in the report path — the process is
    alive, heartbeats flow, steps stop: exactly the silent-hang class
    that is indistinguishable from slowness without flight data).  The
    agent watchdog must capture stacks + /proc state and ship
    ``hang_evidence``; the master's inference chain must reach a
    *hung* verdict carrying that evidence and a measured stall, and
    restart ONLY the culprit node through the heartbeat-action
    relaunch path; the restored incarnation finishes the budget.
    Thresholds are shrunk via RUN_OPTIONS env so the whole diagnosis
    plays out in seconds (tier-1)."""
    return Scenario.from_dict({
        "name": "trainer-hang-detected",
        "seed": seed,
        "rules": [{
            "name": "freeze-midstep",
            "point": "trainer.step",
            "action": "stall",
            "at_step": 5,
            "max_count": 1,
            "only_first_incarnation": True,
            # far beyond every diagnosis threshold: the sleep is
            # ended by the culprit restart's SIGTERM, never by the
            # timer — a diagnosis that fails leaves the job hung
            # until the harness timeout, not a silent pass
            "args": {"seconds": 90.0},
        }],
    })


SCENARIOS: Dict[str, Callable[[int], Scenario]] = {
    "kill_worker_midstep": kill_worker_midstep,
    "sigterm_worker_midstep": sigterm_worker_midstep,
    "shm_corrupt_storage_fallback": shm_corrupt_storage_fallback,
    "warm_template_import_kill": warm_template_import_kill,
    "warm_template_midspawn_kill": warm_template_midspawn_kill,
    "trainer_hang_detected": trainer_hang_detected,
}


# per-scenario harness knobs, keyed by the SCENARIO's name field, so
# the CLI and the tests drive each scenario the way it needs without
# repeating the recipe: the tier-fallback scenario needs a committed
# disk step to fall back to; the hang scenario shrinks the diagnosis
# thresholds
RUN_OPTIONS: Dict[str, Dict] = {
    "shm-corrupt-storage-fallback": {"disk_every": 4},
    "warm-template-import-kill": {"warm_restart": True},
    "warm-template-midspawn-kill": {"warm_restart": True},
    # hang diagnosis in seconds instead of half an hour: fast step
    # reporting, a 2 s agent watchdog window, a 3 s master hang
    # timeout and a sub-second master poll — the 90 s stall is
    # diagnosed, evidenced and culprit-restarted long before the
    # sleep could expire
    "trainer-hang-detected": {
        "extra_env": {
            "DLROVER_MONITOR_REPORT_INTERVAL": "0.5",
            "DLROVER_HANG_THRESHOLD_S": "2",
            "DLROVER_HANG_TIMEOUT": "3",
            "DLROVER_SECONDS_TO_CHECK_HANG": "0.5",
            # the 3 s hang timeout is smaller than a cold restart;
            # the post-restart grace keeps the recovery window from
            # re-convicting the fresh incarnation
            "DLROVER_HANG_RESTART_GRACE_S": "20",
        },
    },
}

def build(name: str, seed: Optional[int] = None) -> Scenario:
    """The registered scenario ``name`` (``kill_worker_midstep`` or
    its scenario name ``kill-worker-midstep``)."""
    key = name.replace("-", "_")
    if key not in SCENARIOS:
        raise KeyError(
            f"unknown scenario {name!r}; known: {sorted(SCENARIOS)}"
        )
    factory = SCENARIOS[key]
    return factory(seed) if seed is not None else factory()
