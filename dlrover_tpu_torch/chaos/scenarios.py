"""Built-in chaos scenarios + the toy elastic train loop they drive.

Each scenario is a factory ``(seed) -> Scenario`` registered in
:data:`SCENARIOS`; the CLI (``python -m dlrover_tpu_torch.chaos``) and
the e2e tests run them through :mod:`dlrover_tpu_torch.chaos.harness`.
They are deliberately small compositions of the schedule vocabulary —
the point of the subsystem is that new failure modes are a dict away,
not a new test file away.

Copy of ``dlrover_tpu/chaos/scenarios.py``, cut to the scenarios of
the port's slices 3b.2, 4.2 and 8.1: the worker kill (SIGKILL and
SIGTERM), the torn shm snapshot with its storage-tier fallback, the
trainer hang, the two warm-template kills, the elastic world resize
(``elastic_resize_churn``) and the two master kills mid-dispatch
(``master_kill_restart_midround``, ``master_respawn_other_host``) over
the loop's sharded dataset.  The train loops are the torch twins of the
reference's ``CHAOS_TRAIN_SCRIPT`` and ``RESIZE_TRAIN_SCRIPT`` (the
latter a tiny GPT under FSDP2 on gloo).  The other scripts and
scenarios come with the slices that bring what they drive: the other
single-node scenarios (``rpc_partition``, ``storage_brownout``,
``storage_stall``, ``straggler``, ``preemption_notice``,
``shm_corruption``, ``ckpt_brownout_during_preemption``,
``goodput_under_scheduled_churn``) and the multi-node hang and
partition ones with slice 4.4.  The compile-cache one (slice 8.2,
``warm_recovery_cache_hit``) drives :data:`CHAOS_TRAIN_SCRIPT` under
warm restarts with the job's compile cache scoped to the run: the first
incarnation writes its step's AOT entry, the template preloads it, and
the respawn resolves through it.  The RL scenario
(``rl_rollout_worker_kill``, slice 7) drives :data:`RL_TRAIN_SCRIPT`,
the twin of the reference's elastic PPO loop, with the reference's
``compile_cache`` option: the loop's actor and critic steps resolve
through the AOT step cache (``resolve_role_steps``).  The
sparse scenarios (``sparse_kill_restore``,
``sparse_spill_io_error``, ``sparse_streaming_reshard_kill`` and
``sparse_resize_churn``) drive :data:`SPARSE_TRAIN_SCRIPT`,
:data:`SPARSE_RESHARD_TRAIN_SCRIPT` and
:data:`SPARSE_RESIZE_TRAIN_SCRIPT`, the twins of the reference's DeepFM,
streaming-reshard and sparse-resize loops; ``DLROVER_CHAOS_SPARSE_DEVICE``
puts the DeepFM loop's dense tower on the card.  The serving scenarios
(slice 9.1: ``serving_replica_kill_midingest``,
``serving_trainer_kill_midpublish``, ``serving_fleet_replica_kill``)
drive :data:`SPARSE_SERVING_TRAIN_SCRIPT`, the twin of the reference's
train-to-serve loop, or (the fleet one) no trainer at all.
"""

from typing import Callable, Dict, Optional

from dlrover_tpu_torch.agent.forkserver import TRAINER_PRELOAD
from dlrover_tpu_torch.chaos.schedule import Scenario

# knobs the harness exports to the training subprocess
TOTAL_STEPS_ENV = "DLROVER_CHAOS_TOTAL_STEPS"
CKPT_EVERY_ENV = "DLROVER_CHAOS_CKPT_EVERY"
STEP_SLEEP_ENV = "DLROVER_CHAOS_STEP_SLEEP"
# durable mid-run saves every N steps (0 = only the final step goes
# to disk) — the tier-fallback scenarios restore from these when the
# shm snapshot is refused
DISK_EVERY_ENV = "DLROVER_CHAOS_DISK_EVERY"
# shard-driven loops: one sample per shard task, one step per task,
# the dataset sized to the run's step budget
SHARD_DATASET_ENV = "DLROVER_CHAOS_SHARD_DATASET"

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
# the tiny GPT's step is ~20 ms of single-threaded work: one intra-op
# thread, as the RL loop below.  With torch's default (a thread per
# core) a host shared with other processes stretched the step past a
# second (ROADMAP C 13), as long as the master outage the recovery
# invariants attribute from the step gaps
torch.set_num_threads(1)
ckpt_dir = sys.argv[1]
TOTAL_STEPS = int(os.environ.get("DLROVER_CHAOS_TOTAL_STEPS", "10"))
CKPT_EVERY = int(os.environ.get("DLROVER_CHAOS_CKPT_EVERY", "2"))
DISK_EVERY = int(os.environ.get("DLROVER_CHAOS_DISK_EVERY", "0"))
# the master-recovery scenarios drive the master's dynamic data
# sharding: one sample per shard task, one step per task
SHARD_DATASET = int(os.environ.get("DLROVER_CHAOS_SHARD_DATASET", "0"))

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

# the step caches, when the run armed them (DLROVER_COMPILE_CACHE_DIR):
# a warm incarnation resolves straight through the label index and
# finds the entry the first incarnation wrote (its kernel libraries, on
# the card, loaded before the first call — by the forkserver template
# under DLROVER_AOT_PRETRACE) while the restore reads; a cold one writes
# the entry at its first call.  Either way the first call is the
# measured retrace.  The examples are the live state and batch: the
# restore below fills the same tensors
if os.environ.get("DLROVER_COMPILE_CACHE_DIR"):
    from dlrover_tpu_torch.common.aot_cache import aot_cache_dir

    step = prof.resolve_step(
        step_fn, lambda: (TrainState.create(model, optimizer), place_batch()),
        cache_dir=aot_cache_dir(),
        restore_busy=lambda: not load_handle.done(),
    )
else:
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

if SHARD_DATASET:
    # master-driven dynamic sharding: one step per shard task.  The
    # master journals every dispatch/ack, so a master crash mid-run
    # (the master-recovery scenarios SIGKILL it between dispatches)
    # must lose no shard and complete none twice — decided later
    # from the shard_ack events
    from dlrover_tpu_torch.agent.sharding_client import ShardingClient

    sc = ShardingClient(
        dataset_name="chaos-ds", batch_size=1, num_epochs=1,
        dataset_size=SHARD_DATASET, shuffle=False,
        num_minibatches_per_shard=1, storage_type="table",
    )
    while True:
        with trainer.profile("data_wait"):
            task = sc.fetch_task()
        if task is None:
            break
        with trainer.profile("h2d"):
            batch = place_batch()
        with trainer.profile("compute") as p:
            state, metrics = run_step(state, batch)
            p.block(metrics)
        trainer.report_step(metrics)
        sc.report_task_done(task.task_id)
        # books into the NEXT step's breakdown (the step is closed by
        # report_step), which is where a save's stall is felt anyway
        with trainer.profile("checkpoint"):
            after_step()
    FINAL_STEP = trainer.global_step
else:
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


# Elastic PPO loop (slice 7), the torch twin of the reference's: the
# four-role RL engine driven by master-dispatched ROLLOUT LEASES.  Each
# shard task is one rollout: prompts and the generation RNG derive
# purely from the lease id, so a lease requeued off a SIGKILLed worker
# regenerates bit-identically on the replacement, and exactly-once
# rollout accounting follows from shard_dispatch/shard_ack events.  The
# four-role state (actor + critic train states, the cursor, the PARTIAL
# rollout buffer) rides every flash snapshot through PPOStateAdapter;
# the snapshot is taken after every completed lease and NEVER after a
# train phase, so a mid-iteration kill restores to the last completed
# lease and REPLAYS that iteration's train steps, whose losses the
# loss-trajectory invariant cross-checks.  One PPO train step per lease
# (LEASES_PER_ITER leases buffered, then that many in-order PPO
# updates), so train steps == leases == TOTAL_STEPS.  The models, the
# device and the recipe are :func:`rl_loop`'s (the control computes
# through the same function); ``DLROVER_CHAOS_RL_DEVICE`` (cpu) and
# ``DLROVER_CHAOS_RL_PRESET`` (tiny) pick them.  argv: ckpt_dir
RL_TRAIN_SCRIPT = r'''
import os, sys, time
import numpy as np

from dlrover_tpu_torch import chaos as _chaos
from dlrover_tpu_torch.agent.sharding_client import ShardingClient
from dlrover_tpu_torch.chaos.scenarios import rl_loop
from dlrover_tpu_torch.checkpoint.checkpointer import Checkpointer, StorageType
from dlrover_tpu_torch.rl.elastic import (
    PPOCursor, PPOStateAdapter, lease_prompts, lease_rng,
)
from dlrover_tpu_torch.rl.rollout import make_experience, train_on_batch
from dlrover_tpu_torch.rl.trainer import ReplayBuffer
from dlrover_tpu_torch.telemetry.events import emit_event
from dlrover_tpu_torch.trainer.elastic_trainer import ElasticTrainer

ckpt_dir = sys.argv[1]
TOTAL_STEPS = int(os.environ.get("DLROVER_CHAOS_TOTAL_STEPS", "8"))
STEP_SLEEP = float(os.environ.get("DLROVER_CHAOS_STEP_SLEEP", "0"))
LEASES_PER_ITER = int(
    os.environ.get("DLROVER_CHAOS_RL_LEASES_PER_ITER", "2")
)
RESTART_COUNT = int(os.environ.get("DLROVER_RESTART_COUNT", "0") or 0)
NODE_RANK = int(os.environ.get("DLROVER_NODE_RANK", "0") or 0)

tracker = os.path.join(ckpt_dir, "latest_checkpointed_iteration.txt")

def committed_step():
    try:
        with open(tracker) as f:
            return int(f.read().strip() or -1)
    except (OSError, ValueError):
        return -1

DEVICE = os.environ.get("DLROVER_CHAOS_RL_DEVICE", "cpu")
if DEVICE == "cpu":
    import torch

    # the tiny loop's ops are a few KB each: one intra-op thread, as a
    # pool of them costs more than it gives on a shared host
    torch.set_num_threads(1)
loop = rl_loop(DEVICE, os.environ.get("DLROVER_CHAOS_RL_PRESET", "tiny"))
engine = loop["engine"]

# register the PPO adapter BEFORE the load: the import restores into
# the engine's fresh states
buffer = ReplayBuffer()
cursor = PPOCursor(rng_key=np.asarray([loop["seed"]], np.int64))
adapter = PPOStateAdapter(engine, buffer, cursor)
ckpt = Checkpointer(ckpt_dir)
ckpt.register_sparse(adapter)
start_step, restored = ckpt.load_checkpoint()
# roles/buffer/cursor were rebuilt by the adapter during the load; the
# dense subtree only carried the trainer bookkeeping

trainer = ElasticTrainer(global_batch_size=loop["batch"],
                         micro_batch_size=loop["batch"], dp_size=1)
trainer.global_step = cursor.ppo_updates

# AOT-cached actor/critic steps (the compile_cache run option): a
# respawn finds the entries the first incarnation wrote, their kernel
# libraries loaded before the first calls
steps = None
if os.environ.get("DLROVER_COMPILE_CACHE_DIR"):
    from dlrover_tpu_torch.rl.elastic import resolve_role_steps

    steps = {
        role: res.fn
        for role, res in resolve_role_steps(engine, loop["sample"]).items()
    }

sc = ShardingClient(
    dataset_name="rl-rollouts", batch_size=1, num_epochs=1,
    dataset_size=TOTAL_STEPS, shuffle=False,
    num_minibatches_per_shard=1, storage_type="table",
)

phase_s = {"rollout": 0.0, "score": 0.0, "gae": 0.0}

def train_phase():
    # in INSERTION order, never shuffled: a restored incarnation
    # replays byte-identical PPO steps off the restored buffer
    t0 = time.perf_counter()
    batches = buffer.batches()
    actor_loss = critic_loss = 0.0
    for bt in batches:
        with trainer.profile("compute"):
            losses = train_on_batch(engine, bt, steps=steps)
        actor_loss = losses["actor_loss"]
        critic_loss = losses["critic_loss"]
        trainer.report_step(
            {"loss": losses["actor_loss"] + losses["critic_loss"]}
        )
    cursor.ppo_updates = trainer.global_step
    emit_event(
        "rl_iteration",
        iteration=trainer.global_step // max(1, LEASES_PER_ITER),
        restart_count=RESTART_COUNT, node_rank=NODE_RANK,
        leases=len(batches),
        rollout_s=round(phase_s["rollout"], 4),
        score_s=round(phase_s["score"], 4),
        gae_s=round(phase_s["gae"], 4),
        train_s=round(time.perf_counter() - t0, 4),
        actor_loss=actor_loss, critic_loss=critic_loss,
    )
    phase_s.update(rollout=0.0, score=0.0, gae=0.0)
    buffer.reset()

while True:
    if len(buffer.batches()) >= LEASES_PER_ITER:
        train_phase()
    with trainer.profile("data_wait"):
        task = sc.fetch_task()
    if task is None:
        break
    lease_id = int(task.start)
    if lease_id < cursor.leases_done:
        # the checkpointed predecessor already buffered (or trained
        # on) this lease before dying un-acked: ack WITHOUT
        # regenerating, or the batch would enter the buffer twice
        sc.report_task_done(task.task_id)
        continue
    with trainer.profile("rollout"):
        batch, metrics = loop["experience"](lease_id)
    for k in ("rollout", "score", "gae"):
        phase_s[k] += metrics[k + "_s"]
    # the kill rule lands HERE: batch generated but neither buffered,
    # checkpointed nor acked; the master requeues the lease and the
    # replacement regenerates it bit-identically
    _chaos.fire("rl.rollout", step=lease_id)
    buffer.add(batch)
    cursor.leases_done = lease_id + 1
    # flash snapshot after EVERY completed lease and never after a
    # train phase: a mid-iteration kill restores to the last lease and
    # REPLAYS the iteration's train steps
    with trainer.profile("checkpoint"):
        ckpt.save_checkpoint(
            trainer.global_step, {"trainer": trainer.state_dict()},
            storage_type=StorageType.MEMORY,
        )
    sc.report_task_done(task.task_id)
    if STEP_SLEEP:
        time.sleep(STEP_SLEEP)

if buffer.batches():
    train_phase()

FINAL_STEP = trainer.global_step
final_sd = {"trainer": trainer.state_dict()}
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
ckpt.close()
'''

# the RL loop's presets: the reference's tiny GPT on the CPU, and GPT-2
# small's width cut to 2 layers (the card's cell of the scenario)
RL_PRESETS = {
    "tiny": dict(num_layers=2, num_heads=4, hidden_dim=64,
                 vocab_size=32, max_seq_len=16, attention_impl="xla"),
    "gpt2_small_2l": dict(num_layers=2, num_heads=12, hidden_dim=768,
                          vocab_size=50304, max_seq_len=1024,
                          attention_impl="flash"),
}


def rl_loop(device: str = "cpu", preset: str = "tiny"):
    """The elastic PPO loop's recipe, shared by :data:`RL_TRAIN_SCRIPT`
    and :func:`rl_reference_losses`: the four-role engine (actor and
    value-head critic on torch's Adam, the reference's ``optax.adam``,
    the ref a frozen copy of its own seed), the reward (the share of
    response tokens in the low half of the vocab) and
    ``experience(lease_id)``, the lease's batch (prompts and RNG from
    the lease id).  B=8, prompts of 4 tokens, 8 new tokens, seed 2, as
    the reference's loop."""
    import dataclasses

    import torch

    from dlrover_tpu_torch.accel import Strategy
    from dlrover_tpu_torch.models.gpt import GPT, GPTConfig
    from dlrover_tpu_torch.rl.elastic import lease_prompts, lease_rng
    from dlrover_tpu_torch.rl.model_engine import (
        ModelRole,
        RLModelEngine,
        RoleSpec,
    )
    from dlrover_tpu_torch.rl.rollout import (
        make_actor_loss,
        make_critic_loss,
        make_experience,
        sample_rollout_batch,
    )

    b, prompt_len, max_new, seed = 8, 4, 8, 2
    actor_cfg = GPTConfig(**RL_PRESETS[preset])
    vocab = actor_cfg.vocab_size
    critic_cfg = dataclasses.replace(actor_cfg, head="value")
    actor = GPT(actor_cfg, device=device, seed=0)
    critic = GPT(critic_cfg, device=device, seed=3)
    ref = GPT(actor_cfg, device=device, seed=1)
    sample = sample_rollout_batch(
        torch.zeros((b, prompt_len), dtype=torch.int32), max_new)
    dp = Strategy(opts=[("parallel_mode", {})])
    engine = RLModelEngine(sample, {
        ModelRole.ACTOR: RoleSpec(
            model=actor, loss_fn=make_actor_loss(actor, prompt_len),
            optim_factory=lambda ps: torch.optim.Adam(ps, lr=5e-3),
            strategy=dp,
        ),
        ModelRole.CRITIC: RoleSpec(
            model=critic, loss_fn=make_critic_loss(critic, prompt_len),
            optim_factory=lambda ps: torch.optim.Adam(ps, lr=1e-3),
            strategy=dp,
        ),
        ModelRole.REF: RoleSpec(model=ref),
    }, device=device).build()

    def reward_fn(sequences):
        return (sequences[:, prompt_len:] < vocab // 2).float().mean(dim=1)

    def experience(lease_id: int):
        return make_experience(
            engine, torch.from_numpy(
                lease_prompts(lease_id, b, prompt_len, vocab)),
            lease_rng(seed, lease_id, device=device),
            max_new_tokens=max_new, kl_coef=0.01, reward_fn=reward_fn,
        )

    return {"engine": engine, "experience": experience, "batch": b,
            "seed": seed, "sample": sample}


def rl_reference_losses(total_steps: int, device: str = "cpu",
                        preset: str = "tiny"):
    """Uninterrupted-control loss trajectory of :data:`RL_TRAIN_SCRIPT`,
    computed in-process: the same recipe (:func:`rl_loop`), the same
    lease-derived prompts and RNG, the same buffer-then-train iteration
    structure.  ``result[k-1]`` is the combined actor+critic loss PPO
    train step ``k`` must report regardless of kills and flash
    restores: a restore that dropped an optimizer slot, a buffered
    rollout batch or the cursor forks the trajectory at the first
    replayed step."""
    from dlrover_tpu_torch.rl.rollout import train_on_batch
    from dlrover_tpu_torch.rl.trainer import ReplayBuffer

    leases_per_iter = 2
    loop = rl_loop(device, preset)
    engine = loop["engine"]
    buffer = ReplayBuffer()
    out = []

    def train():
        for bt in buffer.batches():
            losses = train_on_batch(engine, bt)
            out.append(losses["actor_loss"] + losses["critic_loss"])
        buffer.reset()

    for lease_id in range(total_steps):
        batch, _metrics = loop["experience"](lease_id)
        buffer.add(batch)
        if len(buffer.batches()) >= leases_per_iter:
            train()
    train()
    return out


# Elastic world-resize train loop, the torch twin of the reference's
# (its GSPMD toy parameter becomes the tiny GPT under FSDP2): every
# incarnation forms its gloo group from the agent's env (a one-rank
# group at world 1), shards the GPT with FSDP2 over every rank of it and
# restores params and AdamW moments RESHARDED onto this world's
# DTensors through load_checkpoint(target_state=...).  The storage tier
# holds a shard file per rank, so a 2-node -> 1-node restore genuinely
# redistributes node 1's shards onto node 0.  The batch of step k is a
# pure function of k (:func:`resize_batch`), so the loss at step k is
# the same for any world size and restart history:
# :func:`resize_reference_losses` recomputes the uninterrupted control
# in-process.  argv: ckpt_dir (SHARED across all nodes: that is what
# makes cross-node redistribution possible).
RESIZE_TRAIN_SCRIPT = r"""
import os, sys, time
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from dlrover_tpu_torch.chaos.scenarios import (
    resize_batch, resize_fsdp_model, resize_loss, resize_optimizer,
)
from dlrover_tpu_torch.checkpoint.checkpointer import Checkpointer, StorageType
from dlrover_tpu_torch.common.comm import find_free_port
from dlrover_tpu_torch.telemetry.events import emit_event
from dlrover_tpu_torch.trainer.elastic_trainer import (
    ElasticTrainer, TrainState, init_torch_distributed, make_train_step,
)
from dlrover_tpu_torch.utils.convert import (
    adamw_state_from_tree, adamw_state_tree, params_tree,
)

ckpt_dir = sys.argv[1]
TOTAL_STEPS = int(os.environ.get("DLROVER_CHAOS_TOTAL_STEPS", "24"))
DISK_EVERY = int(os.environ.get("DLROVER_CHAOS_DISK_EVERY", "3"))
STEP_SLEEP = float(os.environ.get("DLROVER_CHAOS_STEP_SLEEP", "0"))
# tail-stretch: while below full strength (the shrunken world between
# the kill and the grow-back) the loop crawls, so the job cannot finish
# before the coordinator's grow-back decision lands
NNODES = int(os.environ.get("DLROVER_CHAOS_NNODES", "0") or 0)
SHRUNK_SLEEP = float(
    os.environ.get("DLROVER_CHAOS_SHRUNK_STEP_SLEEP", "0") or 0
)

if not init_torch_distributed(device="cpu"):
    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{find_free_port()}",
        rank=0, world_size=1)
# the rendezvous address this group formed on, as the master's reply for
# the round handed it out (ROADMAP C 3: a respawned master picks anew)
emit_event("process_group", world_size=dist.get_world_size(),
           rank=dist.get_rank(),
           coordinator=os.environ.get("DLROVER_COORDINATOR_ADDR", ""),
           node_rank=int(os.environ.get("DLROVER_NODE_RANK", "0") or 0),
           restart_count=int(
               os.environ.get("DLROVER_RESTART_COUNT", "0") or 0))
# the mesh spans EVERY rank of this world, as the reference's spans every
# device: FSDP2 over it (an fsdp plan of auto_accelerate would keep the
# fsdp axis inside a node)
WORLD, RANK = dist.get_world_size(), dist.get_rank()
model = resize_fsdp_model(init_device_mesh("cpu", (WORLD,)))
optimizer = resize_optimizer(model.parameters())
step_fn = make_train_step(resize_loss, optimizer, device="cpu")
state = TrainState.create(model, optimizer)

def place(k):
    rows = 8 // WORLD
    return {key: v[RANK * rows:(RANK + 1) * rows]
            for key, v in resize_batch(k).items()}

def tree():
    return {"params": params_tree(model),
            "opt_state": adamw_state_tree(optimizer, model)}

tracker = os.path.join(ckpt_dir, "latest_checkpointed_iteration.txt")

def committed_step():
    try:
        with open(tracker) as f:
            return int(f.read().strip() or -1)
    except (OSError, ValueError):
        return -1

ckpt = Checkpointer(ckpt_dir, replicated=False)
# cross-world restores skip the shm tier (per-node, possibly another
# step) and RESHARD from the committed storage tier
step0, restored = ckpt.load_checkpoint(target_state=tree())
start_step = 0
if step0 is not None:
    start_step = int(step0)
    adamw_state_from_tree(restored["opt_state"], optimizer, model)
    state.step = start_step

trainer = ElasticTrainer(global_batch_size=8, micro_batch_size=8,
                         dp_size=1)
trainer.global_step = start_step

# dynamic data sharding rides along on the lead rank only: the
# lockstep collective loop cannot let members consume different task
# counts, so global rank 0 is the data feeder — exactly-once shard
# accounting across all three world incarnations is still decided
# from shard_ack events alone
SHARD_DATASET = int(os.environ.get("DLROVER_CHAOS_SHARD_DATASET", "0"))
sc = None
if SHARD_DATASET and RANK == 0:
    from dlrover_tpu_torch.agent.sharding_client import ShardingClient

    sc = ShardingClient(
        dataset_name="chaos-ds", batch_size=1, num_epochs=1,
        dataset_size=SHARD_DATASET, shuffle=False,
        num_minibatches_per_shard=1, storage_type="table",
    )

for k in range(start_step, TOTAL_STEPS):
    task = None
    if sc is not None:
        with trainer.profile("data_wait"):
            task = sc.fetch_task()
    try:
        with trainer.profile("compute") as p:
            state, metrics = step_fn(state, place(k + 1))
            loss = metrics["loss"].detach().clone()
            dist.all_reduce(loss)
            p.block(loss)
    except RuntimeError as e:
        # a lost peer surfaces in gloo as an error at the next
        # collective, where the reference's collective wedges: wait here
        # for the agent's drain, as the reference's wedged trainer does,
        # so the master's resize coordinator (not a failure restart)
        # re-forms the world
        print(f"collective failed ({e}); waiting for the drain",
              flush=True)
        while True:
            time.sleep(1.0)
    trainer.report_step({"loss": float(loss) / WORLD})
    if task is not None:
        sc.report_task_done(task.task_id)
    if NNODES and WORLD < NNODES and SHRUNK_SLEEP:
        time.sleep(SHRUNK_SLEEP)
    elif STEP_SLEEP:
        time.sleep(STEP_SLEEP)
    with trainer.profile("checkpoint"):
        if DISK_EVERY and trainer.global_step % DISK_EVERY == 0:
            ckpt.save_checkpoint(
                trainer.global_step, tree(), storage_type=StorageType.DISK,
            )
            ckpt.wait()
            deadline = time.time() + 30
            while (time.time() < deadline
                   and committed_step() < trainer.global_step):
                time.sleep(0.1)
        else:
            ckpt.save_checkpoint(
                trainer.global_step, tree(), storage_type=StorageType.MEMORY,
            )

# final durable save: every rank persists its shard; the lead rank
# waits for the commit (needs every surviving rank's done file)
if RANK == 0:
    deadline = time.time() + 60
    while time.time() < deadline and committed_step() < TOTAL_STEPS:
        ckpt.save_checkpoint(
            TOTAL_STEPS, tree(), storage_type=StorageType.DISK,
        )
        ckpt.wait()
        poll_end = time.time() + 10
        while time.time() < poll_end and committed_step() < TOTAL_STEPS:
            time.sleep(0.2)
    assert committed_step() >= TOTAL_STEPS, (
        "checkpoint commit did not land"
    )
else:
    ckpt.save_checkpoint(
        TOTAL_STEPS, tree(), storage_type=StorageType.DISK,
    )
    ckpt.wait()
ckpt.close()
"""

# Sparse elastic train loop, the torch twin of the reference's: a DeepFM
# job whose embedding lives in a host KvVariable table (GroupAdam slot
# tables riding along, the spill tier armed when DLROVER_CHAOS_KV_SPILL
# sets a DRAM budget).  The SparseStateAdapter registers the tables with
# the flash-checkpoint engine, so every save snapshots keys/values/freq
# and the optimizer slots into the shm segment next to the dense tower's
# train state, and a restore imports them back bit-exact.  The batch at
# step k is a pure function of k and the step is :func:`sparse_step`, so
# :func:`sparse_reference_losses` recomputes the uninterrupted control
# in-process and the harness compares every reported loss against it — a
# restore that lost an embedding row, a frequency count or an Adam moment
# forks the trajectory at the first replayed step.  The dense tower runs
# on DLROVER_CHAOS_SPARSE_DEVICE (cpu).  argv: ckpt_dir
SPARSE_TRAIN_SCRIPT = r"""
import os, sys, time

from dlrover_tpu_torch.chaos.scenarios import sparse_loop, sparse_step
from dlrover_tpu_torch.checkpoint.checkpointer import Checkpointer, StorageType
from dlrover_tpu_torch.checkpoint.sparse import SparseStateAdapter
from dlrover_tpu_torch.trainer.elastic_trainer import (
    ElasticTrainer, TrainState, restore_train_state, train_state_tree,
)

ckpt_dir = sys.argv[1]
DEVICE = os.environ.get("DLROVER_CHAOS_SPARSE_DEVICE", "cpu")
TOTAL_STEPS = int(os.environ.get("DLROVER_CHAOS_TOTAL_STEPS", "12"))
CKPT_EVERY = int(os.environ.get("DLROVER_CHAOS_CKPT_EVERY", "2"))
DISK_EVERY = int(os.environ.get("DLROVER_CHAOS_DISK_EVERY", "0"))
STEP_SLEEP = float(os.environ.get("DLROVER_CHAOS_STEP_SLEEP", "0"))
KV_SPILL = int(os.environ.get("DLROVER_CHAOS_KV_SPILL", "0"))

tracker = os.path.join(ckpt_dir, "latest_checkpointed_iteration.txt")

def committed_step():
    try:
        with open(tracker) as f:
            return int(f.read().strip() or -1)
    except (OSError, ValueError):
        return -1

model, dense_opt, device_step = sparse_loop(DEVICE)
if KV_SPILL:
    # node-local spill files next to (not inside) the shared ckpt dir;
    # O_TRUNC on re-open wipes a dead predecessor's file
    spill_dir = os.path.join(os.path.dirname(ckpt_dir), "kvspill")
    os.makedirs(spill_dir, exist_ok=True)
    model.table.enable_spill(
        os.path.join(spill_dir, "emb.spill"), KV_SPILL
    )
    model.sparse_optimizer.enable_spill(spill_dir, KV_SPILL)

adapter = SparseStateAdapter()
adapter.register_optimizer(model.sparse_optimizer)
ckpt = Checkpointer(ckpt_dir)
ckpt.register_sparse(adapter)

state = TrainState.create(model.dense, dense_opt)
start_step, restored = ckpt.load_checkpoint()
if start_step is None:
    start_step = 0
else:
    # the tower's params AND Adam slots come back into the live module
    # and optimizer; the kv tables were already imported by the engine
    # through the adapter
    restore_train_state(state, restored["dense"])

trainer = ElasticTrainer(global_batch_size=16, micro_batch_size=16,
                         dp_size=1)
trainer.global_step = start_step

for k in range(start_step, TOTAL_STEPS):
    # strict split step: the sparse update retires before the step is
    # reported, so a checkpoint taken after the report is exactly
    # step-consistent across the tower AND the host tables
    with trainer.profile("compute") as p:
        loss = sparse_step(model, device_step, k)
        p.block(loss)
    state.step = k + 1
    trainer.report_step({"loss": float(loss)})
    if STEP_SLEEP:
        time.sleep(STEP_SLEEP)
    with trainer.profile("checkpoint"):
        sd = {"dense": train_state_tree(state),
              "trainer": trainer.state_dict()}
        if DISK_EVERY and trainer.global_step % DISK_EVERY == 0:
            ckpt.save_checkpoint(
                trainer.global_step, sd,
                storage_type=StorageType.DISK,
            )
            ckpt.wait()
            deadline = time.time() + 30
            while (time.time() < deadline
                   and committed_step() < trainer.global_step):
                time.sleep(0.1)
        elif trainer.global_step % CKPT_EVERY == 0:
            ckpt.save_checkpoint(
                trainer.global_step, sd,
                storage_type=StorageType.MEMORY,
            )

final_sd = {"dense": train_state_tree(state),
            "trainer": trainer.state_dict()}
deadline = time.time() + 60
while time.time() < deadline and committed_step() < TOTAL_STEPS:
    ckpt.save_checkpoint(
        TOTAL_STEPS, final_sd, storage_type=StorageType.DISK,
    )
    ckpt.wait()
    poll_end = time.time() + 10
    while time.time() < poll_end and committed_step() < TOTAL_STEPS:
        time.sleep(0.2)
assert committed_step() >= TOTAL_STEPS, (
    "checkpoint commit did not land"
)
ckpt.close()
"""

# Train-to-serve loop, the torch twin of the reference's: the sparse
# DeepFM loop of SPARSE_TRAIN_SCRIPT (its model, data and
# :func:`sparse_step`, so :func:`sparse_reference_losses` is still the
# uninterrupted control) PLUS an EmbeddingPublisher shipping the
# embedding table to a serving replica as committed base/delta
# generations every DLROVER_CHAOS_PUB_EVERY steps.  A fresh
# incarnation's publisher always opens with a base at a NEW generation
# (it cannot know what a dead predecessor half-published), which is what
# makes the trainer-kill-mid-publish scenario's recovery exactly-once by
# construction.  The dense tower runs on DLROVER_CHAOS_SPARSE_DEVICE
# (cpu).  argv: ckpt_dir; serving dir from DLROVER_SERVING_DIR (harness)
# or <workdir>/serving.
SPARSE_SERVING_TRAIN_SCRIPT = r"""
import os, sys, time

from dlrover_tpu_torch.chaos.scenarios import sparse_loop, sparse_step
from dlrover_tpu_torch.checkpoint.checkpointer import Checkpointer, StorageType
from dlrover_tpu_torch.checkpoint.sparse import SparseStateAdapter
from dlrover_tpu_torch.serving import EmbeddingPublisher
from dlrover_tpu_torch.trainer.elastic_trainer import (
    ElasticTrainer, TrainState, restore_train_state, train_state_tree,
)

ckpt_dir = sys.argv[1]
DEVICE = os.environ.get("DLROVER_CHAOS_SPARSE_DEVICE", "cpu")
TOTAL_STEPS = int(os.environ.get("DLROVER_CHAOS_TOTAL_STEPS", "12"))
CKPT_EVERY = int(os.environ.get("DLROVER_CHAOS_CKPT_EVERY", "2"))
PUB_EVERY = int(os.environ.get("DLROVER_CHAOS_PUB_EVERY", "2"))
COMPACT_EVERY = int(os.environ.get("DLROVER_CHAOS_COMPACT_EVERY", "4"))
STEP_SLEEP = float(os.environ.get("DLROVER_CHAOS_STEP_SLEEP", "0"))
serving_dir = os.environ.get("DLROVER_SERVING_DIR") or os.path.join(
    os.path.dirname(ckpt_dir), "serving"
)

tracker = os.path.join(ckpt_dir, "latest_checkpointed_iteration.txt")

def committed_step():
    try:
        with open(tracker) as f:
            return int(f.read().strip() or -1)
    except (OSError, ValueError):
        return -1

model, dense_opt, device_step = sparse_loop(DEVICE)
adapter = SparseStateAdapter()
adapter.register_optimizer(model.sparse_optimizer)
ckpt = Checkpointer(ckpt_dir)
ckpt.register_sparse(adapter)

# serving publishes ONLY the embedding table (replicas have no use
# for optimizer moments); its own adapter shares the table object, so
# dirty tracking is one truth for both planes
serving_adapter = SparseStateAdapter().register_table(model.table)
publisher = EmbeddingPublisher(
    serving_adapter, serving_dir, compact_every=COMPACT_EVERY,
)

state = TrainState.create(model.dense, dense_opt)
start_step, restored = ckpt.load_checkpoint()
if start_step is None:
    start_step = 0
else:
    restore_train_state(state, restored["dense"])

trainer = ElasticTrainer(global_batch_size=16, micro_batch_size=16,
                         dp_size=1)
trainer.global_step = start_step

for k in range(start_step, TOTAL_STEPS):
    with trainer.profile("compute") as p:
        loss = sparse_step(model, device_step, k)
        p.block(loss)
    state.step = k + 1
    trainer.report_step({"loss": float(loss)})
    if STEP_SLEEP:
        time.sleep(STEP_SLEEP)
    with trainer.profile("checkpoint"):
        if trainer.global_step % CKPT_EVERY == 0:
            ckpt.save_checkpoint(
                trainer.global_step,
                {"dense": train_state_tree(state),
                 "trainer": trainer.state_dict()},
                storage_type=StorageType.MEMORY,
            )
    if trainer.global_step % PUB_EVERY == 0:
        publisher.publish(step=trainer.global_step)

# final publish so the replica can converge on the last trained state
if publisher.generation == 0 or TOTAL_STEPS % PUB_EVERY != 0:
    publisher.publish(step=TOTAL_STEPS)

final_sd = {"dense": train_state_tree(state),
            "trainer": trainer.state_dict()}
deadline = time.time() + 60
while time.time() < deadline and committed_step() < TOTAL_STEPS:
    ckpt.save_checkpoint(
        TOTAL_STEPS, final_sd, storage_type=StorageType.DISK,
    )
    ckpt.wait()
    poll_end = time.time() + 10
    while time.time() < poll_end and committed_step() < TOTAL_STEPS:
        time.sleep(0.2)
assert committed_step() >= TOTAL_STEPS, (
    "checkpoint commit did not land"
)
ckpt.close()
"""


# the sparse loop's model, data and step (torch is imported in the
# worker and in the harness's control computation, never with this
# module)
SPARSE_BATCH = 16
SPARSE_VOCAB = 4000


def sparse_loop(device: str = "cpu"):
    """The DeepFM of :data:`SPARSE_TRAIN_SCRIPT` (the reference's
    config and seeds), its tower's Adam (optax.adam's formula, lr 1e-2)
    and the device step."""
    import torch

    from dlrover_tpu_torch.models.deepfm import DeepFM, DeepFMConfig
    from dlrover_tpu_torch.trainer.sparse_pipeline import (
        make_deepfm_device_step,
    )

    cfg = DeepFMConfig(num_sparse_fields=6, num_dense_features=4,
                       embedding_dim=8, hidden_dims=(16,), seed=5)
    model = DeepFM(cfg, device=device)
    dense_opt = torch.optim.Adam(model.dense.parameters(), lr=1e-2,
                                 betas=(0.9, 0.999), eps=1e-8)
    return model, dense_opt, make_deepfm_device_step(model, dense_opt)


def sparse_batch(k: int, cfg):
    """The batch of step ``k`` (the reference's): a pure function of
    ``k``; the label is the parity of the first field's id."""
    import numpy as np

    rng = np.random.default_rng(10_000 + k)
    sparse = rng.integers(
        0, SPARSE_VOCAB, (SPARSE_BATCH, cfg.num_sparse_fields)
    ).astype(np.int64)
    dense = rng.normal(
        size=(SPARSE_BATCH, cfg.num_dense_features)
    ).astype(np.float32)
    labels = (sparse[:, 0] % 2).astype(np.float32)
    return sparse, dense, labels


def sparse_step(model, device_step, k: int):
    """One strict split step of the sparse loop: gather, copy to the
    tower's device, the device step, the gradient back to the host and
    the group update.  Returns the loss (a device scalar)."""
    import torch

    sparse, dense, labels = sparse_batch(k, model.config)
    dev = model.device
    emb = torch.from_numpy(model.gather_embeddings(sparse)).to(dev)
    _, egrads, aux = device_step(
        None, emb, torch.from_numpy(dense).to(dev),
        torch.from_numpy(labels).to(dev))
    model.apply_sparse_gradients(sparse, egrads.cpu().numpy())
    return aux["loss"]


def sparse_reference_losses(total_steps: int, device: str = "cpu"):
    """Uninterrupted-control loss trajectory of
    :data:`SPARSE_TRAIN_SCRIPT`, computed in-process through the same
    :func:`sparse_loop` and :func:`sparse_step`: ``result[k-1]`` is the
    loss step ``k`` must report regardless of kills and flash restores."""
    model, _opt, device_step = sparse_loop(device)
    return [float(sparse_step(model, device_step, k))
            for k in range(total_steps)]


# Streaming-reshard kill loop, the twin of the reference's: a WORLD-1
# job whose checkpoint dir was PRE-SEEDED by the harness with a committed
# world-2 sparse checkpoint.  The very first restore is therefore a
# cross-world STREAMING reshard — `kv.reshard_chunk` fires once per
# window, and the scenario SIGKILLs the worker mid-stream.  Committed
# storage is untouched by the partial reshard (it only mutates
# in-process tables), so the replacement replays the identical reshard
# from the same shards and trains to completion; the exactly-once
# digests are checked against the seeder's JSON.  argv: ckpt_dir
SPARSE_RESHARD_TRAIN_SCRIPT = r"""
import os, sys, time
import numpy as np
import torch

from dlrover_tpu_torch.checkpoint.checkpointer import Checkpointer, StorageType
from dlrover_tpu_torch.checkpoint.sparse import SparseStateAdapter
from dlrover_tpu_torch.ops.kv_variable import GroupAdamOptimizer, KvVariable
from dlrover_tpu_torch.trainer.elastic_trainer import ElasticTrainer

ckpt_dir = sys.argv[1]
TOTAL_STEPS = int(os.environ.get("DLROVER_CHAOS_TOTAL_STEPS", "10"))
CKPT_EVERY = int(os.environ.get("DLROVER_CHAOS_CKPT_EVERY", "2"))
STEP_SLEEP = float(os.environ.get("DLROVER_CHAOS_STEP_SLEEP", "0"))
DIM = int(os.environ.get("DLROVER_CHAOS_RESHARD_KV_DIM", "16"))

tracker = os.path.join(ckpt_dir, "latest_checkpointed_iteration.txt")

def committed_step():
    try:
        with open(tracker) as f:
            return int(f.read().strip() or -1)
    except (OSError, ValueError):
        return -1

table = KvVariable(dim=DIM, seed=17, name="emb")
kv_opt = GroupAdamOptimizer(table, learning_rate=5e-3)
adapter = SparseStateAdapter()
adapter.register_optimizer(kv_opt)
ckpt = Checkpointer(ckpt_dir)
ckpt.register_sparse(adapter)

# the seeded checkpoint is stamped world 2, this job is world 1: the
# load below IS the streaming reshard (kv.reshard_chunk per window —
# the kill rule lands here in incarnation 0, before any train step)
step0, restored = ckpt.load_checkpoint()
assert step0 is not None, "pre-seeded world-2 checkpoint missing"
start_step = int(step0)
w = torch.as_tensor(restored["w"], dtype=torch.float32).clone()

trainer = ElasticTrainer(global_batch_size=8, micro_batch_size=8,
                         dp_size=1)
trainer.global_step = start_step

for k in range(start_step, TOTAL_STEPS):
    krng = np.random.default_rng(5_000 + k)
    keys = krng.integers(0, 1_200, 64).astype(np.int64)
    with trainer.profile("h2d"):
        emb = table.gather(keys)
    with trainer.profile("compute") as p:
        kv_opt.apply_gradients(keys, np.tanh(emb) * 0.1)
        w = w * 0.9
        p.block(w)
    trainer.report_step({"loss": float(w.sum())})
    if STEP_SLEEP:
        time.sleep(STEP_SLEEP)
    with trainer.profile("checkpoint"):
        if trainer.global_step % CKPT_EVERY == 0:
            ckpt.save_checkpoint(
                trainer.global_step, {"w": w.numpy().copy()},
                storage_type=StorageType.MEMORY,
            )

final_sd = {"w": w.numpy().copy()}
deadline = time.time() + 60
while time.time() < deadline and committed_step() < TOTAL_STEPS:
    ckpt.save_checkpoint(
        TOTAL_STEPS, final_sd, storage_type=StorageType.DISK,
    )
    ckpt.wait()
    poll_end = time.time() + 10
    while time.time() < poll_end and committed_step() < TOTAL_STEPS:
        time.sleep(0.2)
assert committed_step() >= TOTAL_STEPS, (
    "checkpoint commit did not land"
)
ckpt.close()
"""


# the resize loop's model, data and optimizer (torch is imported in the
# worker and in the harness's control computation, never with this
# module: the harness process of a single-node run is the agent's)
RESIZE_SEQ = 16


def resize_model():
    """The tiny GPT in fp32, from a fixed seed."""
    import torch

    from dlrover_tpu_torch.models.gpt import GPT, GPTConfig

    return GPT(GPTConfig.tiny(max_seq_len=RESIZE_SEQ, dtype=torch.float32),
               device="cpu", seed=0)


def resize_batch(k: int):
    """The batch of step ``k``: a pure function of ``k``, 8 rows."""
    import numpy as np

    data = np.random.default_rng(1000 + k).integers(
        0, 256, (8, RESIZE_SEQ + 1), dtype=np.int32)
    return {"x": data[:, :-1], "y": data[:, 1:]}


def resize_loss(module, batch):
    from dlrover_tpu_torch.models.gpt import cross_entropy_loss

    return cross_entropy_loss(module(batch["x"]), batch["y"])


def resize_optimizer(params):
    import torch

    return torch.optim.AdamW(params, lr=1e-3, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=0.1)


def resize_fsdp_model(mesh):
    """:func:`resize_model` under FSDP2 over ``mesh`` (each block, then
    the root, as the port's fsdp plan wraps a GPT)."""
    from torch.distributed.fsdp import fully_shard

    model = resize_model()
    for block in model.blocks:
        fully_shard(block, mesh=mesh)
    fully_shard(model, mesh=mesh)
    return model


def resize_reference_losses(total_steps: int):
    """Uninterrupted-control loss trajectory of
    :data:`RESIZE_TRAIN_SCRIPT`'s update rule, computed in-process on
    one process with no group (the plain model and step).
    ``result[k-1]`` is the loss the job must report at step ``k``
    whatever its world size, restarts or resharded restores."""
    from dlrover_tpu_torch.trainer.elastic_trainer import (
        TrainState,
        make_train_step,
    )

    model = resize_model()
    opt = resize_optimizer(model.parameters())
    step = make_train_step(resize_loss, opt, device="cpu")
    state = TrainState.create(model, opt)
    out = []
    for k in range(1, total_steps + 1):
        state, metrics = step(state, resize_batch(k))
        out.append(float(metrics["loss"]))
    return out



def _sparse_resize_script() -> str:
    """:data:`RESIZE_TRAIN_SCRIPT` plus a KvVariable embedding
    partitioned across the world by the SAME key hash the cross-world
    reshard uses (:func:`~dlrover_tpu_torch.checkpoint.sparse.
    owner_of_keys`), registered with the checkpointer, so a 2->1->2
    churn genuinely redistributes hash-table rows from committed storage
    exactly once (the reference's ``SPARSE_RESIZE_TRAIN_SCRIPT``)."""
    script = RESIZE_TRAIN_SCRIPT
    edits = [
        ("from dlrover_tpu_torch.checkpoint.checkpointer import "
         "Checkpointer, StorageType\n",
         "from dlrover_tpu_torch.checkpoint.checkpointer import "
         "Checkpointer, StorageType\n"
         "import numpy as np\n"
         "from dlrover_tpu_torch.checkpoint.sparse import (\n"
         "    SparseStateAdapter, owner_of_keys,\n)\n"
         "from dlrover_tpu_torch.ops.kv_variable import "
         "GroupAdamOptimizer, KvVariable\n"),
        # host-table sparse state, hash-partitioned across the world:
        # this rank's table holds ONLY the keys owner_of_keys assigns
        # it, so each rank's shard is a distinct slice of the table
        ("ckpt = Checkpointer(ckpt_dir, replicated=False)\n",
         "ckpt = Checkpointer(ckpt_dir, replicated=False)\n"
         "table = KvVariable(dim=8, seed=17, name='emb')\n"
         "kv_opt = GroupAdamOptimizer(table, learning_rate=5e-3)\n"
         "adapter = SparseStateAdapter()\n"
         "adapter.register_optimizer(kv_opt)\n"
         "ckpt.register_sparse(adapter)\n"),
        # the sparse leg: a step-indexed global key stream routed to
        # this rank by the owner hash; a row's update depends only on
        # the row, so its trajectory is world-size independent
        ("    try:\n        with trainer.profile(\"compute\") as p:\n",
         "    krng = np.random.default_rng(5_000 + k)\n"
         "    gkeys = krng.integers(0, 3_000, 48).astype(np.int64)\n"
         "    mine = gkeys[owner_of_keys(gkeys, WORLD) == RANK]\n"
         "    if mine.size:\n"
         "        kv_opt.apply_gradients(\n"
         "            mine, np.tanh(table.gather(mine)) * 0.1)\n"
         "    try:\n        with trainer.profile(\"compute\") as p:\n"),
    ]
    for old, new in edits:
        if script.count(old) != 1:
            raise AssertionError(f"resize script anchor moved: {old!r}")
        script = script.replace(old, new)
    return script


# argv: ckpt_dir (SHARED across all nodes)
SPARSE_RESIZE_TRAIN_SCRIPT = _sparse_resize_script()


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


def warm_recovery_cache_hit(seed: int = 73) -> Scenario:
    """Invisible-recovery acceptance (the reference's ISSUE 10):
    SIGKILL the worker mid-run under warm restarts + the job-keyed
    compile cache.  The replacement incarnation must prove — from the
    event log alone — that it resolved its step through the AOT entry
    the first incarnation wrote, that its first post-restore step added
    no kernel library over the cache (``compile_cache`` event), that the
    measured ``retrace + aot`` stayed under the ceiling, and that the
    whole death->first-step budget landed as ``recovery_phase`` slices
    on the assembled timeline."""
    return Scenario.from_dict({
        "name": "warm-recovery-cache-hit",
        "seed": seed,
        "rules": [{
            "name": "kill-midstep",
            "point": "trainer.step",
            "action": "kill",
            "step_window": [5, 6],
            "only_first_incarnation": True,
        }],
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


def elastic_resize_churn(seed: int = 53) -> Scenario:
    """Elastic world-resize acceptance: a NODE LOSS — one of two agents
    dies with its whole worker tree (``kill_node``, no failure report,
    exactly like a vanished VM) — and the job survives by training
    SMALLER: the master's resize coordinator detects the silence,
    decides world 2 -> 1, drains the survivor over the heartbeat-action
    channel, and the re-formed world restores the checkpoint RESHARDED
    (node 1's storage shards redistributed onto node 0).  The harness
    then respawns the lost agent (a replacement host: fresh shm
    namespace, ``DLROVER_AGENT_RESPAWNED`` marks it so the kill rule
    never re-fires) and the job grows back to world 2 the same way.
    Where the reference fires the loss 8 s after the agent starts, here
    it fires once node 1 has trained past step 7 (past the commits of
    steps 3 and 6): an incarnation of the port takes several seconds to
    import torch and set up FSDP2, and a loss before the first commit
    would leave the shrunken world nothing to reshard.  The timeline is
    bounded, not byte-stable."""
    return Scenario.from_dict({
        "name": "elastic-resize-churn",
        "seed": seed,
        "rules": [{
            "name": "node1-loss",
            "point": "agent.monitor",
            "action": "kill_node",
            "after_step": 7,
            "env_equals": {
                "DLROVER_NODE_RANK": "1",
                "DLROVER_AGENT_RESPAWNED": "",
            },
        }],
    })


def master_kill_restart_midround(seed: int = 31) -> Scenario:
    """Master crash recovery acceptance: SIGKILL the MASTER on its 3rd
    shard dispatch — mid-rendezvous-round, with one shard
    journaled-but-undelivered and acks in flight.  The launcher's
    watchdog respawns it on the same port; the new incarnation replays
    the state journal (re-entering rendezvous round 1, re-queueing only
    the un-acked shard), parked agents/trainers session-resync, and
    training completes with no shard lost, none acked twice, and NO
    healthy-worker restart — all decided from telemetry events."""
    return Scenario.from_dict({
        "name": "master-kill-restart-midround",
        "seed": seed,
        "rules": [{
            "name": "kill-master-middispatch",
            "point": "master.task_dispatch",
            "action": "kill",
            "after_calls": 3,
            # the respawned master (DLROVER_RESTART_COUNT=1) must
            # survive replaying the very dispatch that killed its
            # predecessor
            "only_first_incarnation": True,
        }],
    })


def master_respawn_other_host(seed: int = 79) -> Scenario:
    """Host-portable control plane: SIGKILL the master mid-dispatch
    like ``master_kill_restart_midround`` — but the respawn gets a
    FRESH, EMPTY journal dir (what a replacement host has), so recovery
    must come entirely from the async-group-commit journal mirror on
    the checkpoint storage tier.  Exactly-once sharding and the final
    commit are still asserted from events;
    ``master_recovered.from_mirror`` is the witness that the mirror,
    not the local disk, carried the state."""
    return Scenario.from_dict({
        "name": "master-respawn-other-host",
        "seed": seed,
        "rules": [{
            "name": "kill-master-middispatch",
            "point": "master.task_dispatch",
            "action": "kill",
            "after_calls": 3,
            "only_first_incarnation": True,
        }],
    })


def rl_rollout_worker_kill(seed: int = 97) -> Scenario:
    """Elastic RL acceptance: SIGKILL the rollout worker mid-PPO-
    iteration, on the ``rl.rollout`` hook of lease 2, after the batch is
    generated but BEFORE it is buffered, checkpointed or acked.  The
    master requeues the lease (journaled dispatch/ack); the replacement
    restores the four-role state + partial buffer + cursor from the
    flash checkpoint, REPLAYS the interrupted iteration's train steps,
    regenerates the lost lease bit-identically and finishes the budget.
    Exactly-once rollout accounting, the loss trajectory equal to the
    uninterrupted control, and recovery-loss attribution are all
    decided from the event log alone."""
    return Scenario.from_dict({
        "name": "rl-rollout-worker-kill",
        "seed": seed,
        "rules": [{
            "name": "kill-rollout-midlease",
            "point": "rl.rollout",
            "action": "kill",
            # lease 2 = the first lease AFTER a train phase: the
            # restore must land on the post-lease-1 snapshot and
            # replay PPO steps 1-2 (multi-incarnation loss agreement)
            "at_step": 2,
            "only_first_incarnation": True,
        }],
    })


def sparse_kill_restore(seed: int = 61) -> Scenario:
    """Sparse elastic recovery acceptance (reference ``:1740``): SIGKILL
    a DeepFM job mid-run — embedding table, frequency counters and
    GroupAdam slot tables (spill tier ACTIVE: the harness arms a DRAM
    budget so real rows live on the cold tier) must ride the flash
    checkpoint and come back bit-identical: the restored incarnation's
    loss trajectory equals the uninterrupted control, and the
    ``kv_checkpoint`` digests prove every row/freq/slot survived — all
    decided from telemetry events alone."""
    return Scenario.from_dict({
        "name": "sparse-kill-restore",
        "seed": seed,
        "rules": [{
            "name": "kill-sparse-midstep",
            "point": "trainer.step",
            "action": "kill",
            "step_window": [5, 7],
            "only_first_incarnation": True,
        }],
    })


def sparse_spill_io_error(seed: int = 67) -> Scenario:
    """Graceful degradation: the spill tier's disk dies DURING a
    checkpoint export (io_error on the ``kv.spill`` hook).  Stranded
    cold rows drop out of that export; training continues and the
    production write-failure breaker trips on the next spill pass
    (``spill_disabled`` on the following export event); the checkpoint
    of the DRAM-resident rows still commits, and after a kill two steps
    later the restore is valid — round-trip digests still match the
    (post-fault) export."""
    return Scenario.from_dict({
        "name": "sparse-spill-io-error",
        "seed": seed,
        "rules": [
            {
                "name": "spill-disk-dies",
                "point": "kv.spill",
                "action": "io_error",
                "at_step": 4,
                "max_count": 1,
                "only_first_incarnation": True,
            },
            {
                "name": "kill-after-breaker",
                "point": "trainer.step",
                "action": "kill",
                "at_step": 7,
                "only_first_incarnation": True,
            },
        ],
    })


def sparse_resize_churn(seed: int = 71) -> Scenario:
    """Sparse elastic world-resize: a node loss shrinks a two-node
    sparse job to one, and the hash-table embedding (plus its optimizer
    slot tables) is RESHARDED from committed storage — all old ranks'
    kv shards read, rows re-partitioned by key hash, the owned subset
    imported — then the world grows back and reshards again.
    Exactly-once row accounting and the shm-tier refusal across world
    sizes are decided from the ``kv_checkpoint`` events alone."""
    return Scenario.from_dict({
        "name": "sparse-resize-churn",
        "seed": seed,
        "rules": [{
            "name": "node1-loss",
            "point": "agent.monitor",
            "action": "kill_node",
            # progress-based, not wall-clock: the node dies only once
            # its trainer has REPORTED past step 6 (two world-2 disk
            # commits exist)
            "after_step": 6,
            "env_equals": {
                "DLROVER_NODE_RANK": "1",
                "DLROVER_AGENT_RESPAWNED": "",
            },
        }],
    })


def sparse_streaming_reshard_kill(seed: int = 79) -> Scenario:
    """Streaming-reshard crash consistency: the harness pre-seeds a
    committed world-2 sparse checkpoint, the world-1 job's first restore
    streams the cross-world reshard in bounded windows, and the worker
    is SIGKILLed on the 3rd ``kv.reshard_chunk`` — mid-stream, tables
    half-imported.  Committed storage is untouched (the reshard mutates
    only in-process tables), so the replacement replays the identical
    reshard from the same shards; the additive per-table digests on its
    resharded restore event must equal the seeder's per-shard export
    sums with imported rows == the distinct union — no row lost, no
    chunk double-imported."""
    return Scenario.from_dict({
        "name": "sparse-streaming-reshard-kill",
        "seed": seed,
        "rules": [{
            "name": "kill-mid-reshard",
            "point": "kv.reshard_chunk",
            "action": "kill",
            "after_calls": 3,
            "max_count": 1,
            "only_first_incarnation": True,
        }],
    })


def serving_replica_kill_midingest(seed: int = 83) -> Scenario:
    """Serving-plane replica recovery: SIGKILL the serving
    replica INSIDE a generation apply (the ``serving.ingest`` hook
    fires under the swap lock, tables half-applied).  The harness
    respawns it; the fresh replica re-ingests from the newest
    committed base and converges on the trainer's final generation.
    The digest chain on ``serving_ingest`` vs ``serving_publish``
    events proves no torn generation was ever served — the
    half-applied state died with the process and no event claimed
    it."""
    return Scenario.from_dict({
        "name": "serving-replica-kill-midingest",
        "seed": seed,
        "rules": [{
            "name": "kill-replica-midingest",
            "point": "serving.ingest",
            "action": "kill",
            "after_calls": 3,
            "max_count": 1,
            "env_equals": {
                "DLROVER_SERVING_ROLE": "replica",
                "DLROVER_SERVING_RESPAWNED": "",
            },
        }],
    })


def serving_fleet_replica_kill(seed: int = 97) -> Scenario:
    """Serving-fleet routing under fire: against a live
    replica POOL fronted by the lookup router, SIGKILL (a) replica 0
    INSIDE a generation apply (``serving.ingest``, env-pinned to
    ``DLROVER_SERVING_REPLICA_ID=0`` — role alone would kill every
    member) and (b) the ROUTER itself mid-stream (``serving.route``
    fires once per routed lookup).  The router must shed the dead
    replica within the heartbeat window and keep answering from the
    survivors — zero failed and zero stale lookups counted on the
    ``serving_route`` windows — and the respawned router must replay
    its journaled membership to the identical routing table and
    resume routing without restarting any healthy replica.  The
    ``DLROVER_SERVING_RESPAWNED`` guards keep both kills
    single-shot."""
    return Scenario.from_dict({
        "name": "serving-fleet-replica-kill",
        "seed": seed,
        "rules": [{
            "name": "kill-pool-replica-midingest",
            "point": "serving.ingest",
            "action": "kill",
            "after_calls": 3,
            "max_count": 1,
            "env_equals": {
                "DLROVER_SERVING_ROLE": "replica",
                "DLROVER_SERVING_REPLICA_ID": "0",
                "DLROVER_SERVING_RESPAWNED": "",
            },
        }, {
            # time-based, NOT call-count: the router kill must land
            # AFTER the killed replica has been shed and its respawn
            # re-admitted (simultaneous kills would leave no router
            # alive to witness the shed), and the route hook fires
            # continuously under load so the window is hit exactly
            "name": "kill-router-midroute",
            "point": "serving.route",
            "action": "kill",
            "after_time": 5.0,
            "max_count": 1,
            "env_equals": {
                "DLROVER_SERVING_ROLE": "router",
                "DLROVER_SERVING_RESPAWNED": "",
            },
        }],
    })


def serving_trainer_kill_midpublish(seed: int = 89) -> Scenario:
    """Serving-plane publisher exactly-once: SIGKILL the
    trainer between writing a generation's blobs/manifest and its
    ``DONE`` marker (the ``serving.publish`` hook sits exactly
    there).  The half-published generation is never committed — the
    replica keeps serving the previous one — and the respawned
    trainer's publisher opens with a fresh BASE at the next
    generation number: every committed generation is published
    exactly once, provable by counting ``serving_publish`` events."""
    return Scenario.from_dict({
        "name": "serving-trainer-kill-midpublish",
        "seed": seed,
        "rules": [{
            "name": "kill-trainer-midpublish",
            "point": "serving.publish",
            "action": "kill",
            "after_calls": 3,
            "max_count": 1,
            "only_first_incarnation": True,
        }],
    })


SCENARIOS: Dict[str, Callable[[int], Scenario]] = {
    "kill_worker_midstep": kill_worker_midstep,
    "sigterm_worker_midstep": sigterm_worker_midstep,
    "shm_corrupt_storage_fallback": shm_corrupt_storage_fallback,
    "warm_recovery_cache_hit": warm_recovery_cache_hit,
    "warm_template_import_kill": warm_template_import_kill,
    "warm_template_midspawn_kill": warm_template_midspawn_kill,
    "trainer_hang_detected": trainer_hang_detected,
    "elastic_resize_churn": elastic_resize_churn,
    "master_kill_restart_midround": master_kill_restart_midround,
    "master_respawn_other_host": master_respawn_other_host,
    "rl_rollout_worker_kill": rl_rollout_worker_kill,
    "sparse_kill_restore": sparse_kill_restore,
    "sparse_spill_io_error": sparse_spill_io_error,
    "sparse_resize_churn": sparse_resize_churn,
    "sparse_streaming_reshard_kill": sparse_streaming_reshard_kill,
    "serving_replica_kill_midingest": serving_replica_kill_midingest,
    "serving_fleet_replica_kill": serving_fleet_replica_kill,
    "serving_trainer_kill_midpublish": (
        serving_trainer_kill_midpublish
    ),
}


# per-scenario harness knobs, keyed by the SCENARIO's name field, so
# the CLI and the tests drive each scenario the way it needs without
# repeating the recipe: the tier-fallback scenario needs a committed
# disk step to fall back to; the hang scenario shrinks the diagnosis
# thresholds
RUN_OPTIONS: Dict[str, Dict] = {
    "shm-corrupt-storage-fallback": {"disk_every": 4},
    # the master-recovery acceptance drives the sharding path (one
    # shard per step) so shard-loss/duplication is decidable from
    # telemetry; shard_dataset=True sizes the dataset to total_steps
    "master-kill-restart-midround": {"shard_dataset": True},
    # host-portable master: the respawn is forced onto a FRESH
    # journal dir (a replacement host's view) and must seed from the
    # storage-tier mirror (the harness materializes the mirror dir
    # via the journal_mirror knob); shard traffic armed so
    # exactly-once sharding is decidable from events
    "master-respawn-other-host": {
        "shard_dataset": True,
        "journal_mirror": True,
        "extra_env": {
            "DLROVER_MASTER_RESPAWN_FRESH_JOURNAL": "1",
            # tight group-commit window: the kill must not outrun the
            # mirror by more than one shard dispatch
            "DLROVER_JOURNAL_MIRROR_INTERVAL_S": "0.05",
        },
    },
    # the loop is stretched so the kill lands mid-run and disk commits
    # every 3 steps bound the cross-world restore's step loss; rank 0
    # feeds the sharded dataset
    "elastic-resize-churn": {
        "total_steps": 24,
        "disk_every": 3,
        "step_sleep": 0.3,
        # while the world is shrunken the loop crawls: the replacement
        # takes seconds to boot, and at 0.3 s/step the survivor would
        # otherwise finish before the grow-back decision fires
        "shrunk_step_sleep": 1.0,
        "shard_dataset": True,
        "train_script": "resize",
        "extra_env": {
            "DLROVER_MONITOR_REPORT_INTERVAL": "0.5",
            "DLROVER_HANG_DETECTION_S": "2.5",
            "DLROVER_RESIZE_GRACE_S": "1.0",
            "DLROVER_RESIZE_REDELIVER_S": "15.0",
            "DLROVER_RESIZE_STOP_TIMEOUT_S": "1.5",
            "DLROVER_SECONDS_TO_CHECK_HANG": "0.5",
            "DLROVER_BREAKPOINT_COMMIT_TIMEOUT_S": "3",
            # the coordinator owns BOTH resize directions: the
            # agent-side membership fallback would race it on the
            # grow-back and leave the decision un-journaled
            "DLROVER_MEMBERSHIP_SELF_RESTART": "0",
        },
    },
    # elastic RL: 8 rollout leases = 8 PPO train steps (2 leases per
    # iteration), so total_steps doubles as the lease-dataset size and
    # the trainer's step budget; ckpt_every=2 is nominal: the RL loop
    # flash-saves after EVERY lease, and the kill on lease 2 restores
    # the post-lease-1 snapshot and replays PPO steps 1-2 before
    # regenerating the lost lease.  compile_cache gives the respawn
    # the AOT step cache's path for its actor/critic steps.
    "rl-rollout-worker-kill": {
        "total_steps": 8,
        "ckpt_every": 2,
        "train_script": "rl",
        "compile_cache": True,
    },
    # sparse recovery: the toy DeepFM loop (train_script selects it in
    # the harness), per-table content digests armed so the round-trip
    # invariant can decide bit-identity from events alone, and a DRAM
    # budget small enough that real rows live on the spill tier (the
    # control runs DRAM-only — residence is transparent, values equal)
    "sparse-kill-restore": {
        "total_steps": 12,
        "ckpt_every": 2,
        "train_script": "sparse",
        "extra_env": {
            "DLROVER_KV_DIGEST": "1",
            "DLROVER_CHAOS_KV_SPILL": "48",
        },
    },
    # spill-disk death mid-export: same loop + budget; the kill lands
    # at step 7 so the step-6 export (post-breaker, spill_disabled
    # stamped) is the one the restore round-trips
    "sparse-spill-io-error": {
        "total_steps": 12,
        "ckpt_every": 2,
        "train_script": "sparse",
        "extra_env": {
            "DLROVER_KV_DIGEST": "1",
            "DLROVER_CHAOS_KV_SPILL": "48",
        },
    },
    # streaming reshard: the harness pre-seeds a committed world-2
    # sparse checkpoint at step 4 (seed_kv_world), the window is pinned
    # to 200 rows so the ~600-row-per-rank tables stream in several
    # chunks (the kill rule needs a 3rd chunk to land on), and digests
    # are armed for the exactly-once verdict
    "sparse-streaming-reshard-kill": {
        "total_steps": 10,
        "ckpt_every": 2,
        "train_script": "sparse_reshard",
        "seed_kv_world": 2,
        "extra_env": {
            "DLROVER_KV_DIGEST": "1",
            "DLROVER_KV_RESHARD_WINDOW_ROWS": "200",
        },
    },
    # sparse resize: the elastic-resize recipe (the same control-plane
    # knobs as elastic-resize-churn) with the kv-partitioned loop and
    # digests armed; disk commits every 3 steps bound the cross-world
    # restore's step loss AND guarantee a world-1 commit exists before
    # the harness respawns the replacement agent
    "sparse-resize-churn": {
        "total_steps": 24,
        "disk_every": 3,
        "step_sleep": 0.3,
        "shrunk_step_sleep": 1.0,
        "train_script": "sparse_resize",
        "extra_env": {
            "DLROVER_KV_DIGEST": "1",
            "DLROVER_MONITOR_REPORT_INTERVAL": "0.5",
            "DLROVER_HANG_DETECTION_S": "2.5",
            "DLROVER_RESIZE_GRACE_S": "1.0",
            "DLROVER_RESIZE_REDELIVER_S": "15.0",
            "DLROVER_RESIZE_STOP_TIMEOUT_S": "1.5",
            "DLROVER_SECONDS_TO_CHECK_HANG": "0.5",
            "DLROVER_BREAKPOINT_COMMIT_TIMEOUT_S": "3",
            "DLROVER_MEMBERSHIP_SELF_RESTART": "0",
        },
    },
    # serving plane: the sparse loop + publisher shipping the
    # embedding table every 2 steps (digests armed — manifests and
    # the torn-serve invariants need them); the serving runner reads
    # train_script="sparse_serving" and supervises the replica
    # subprocess itself
    "serving-replica-kill-midingest": {
        "total_steps": 12,
        "ckpt_every": 2,
        "train_script": "sparse_serving",
        "extra_env": {
            "DLROVER_KV_DIGEST": "1",
            "DLROVER_CHAOS_PUB_EVERY": "2",
            # slow the loop slightly so several generations commit
            # while the replica is alive on a loaded CI box
            "DLROVER_CHAOS_STEP_SLEEP": "0.2",
        },
    },
    # serving fleet: no trainer subprocess at all — the fleet runner
    # (run_serving_fleet_scenario) publishes in-process and drives
    # real routed load; these knobs shape the run.  compact_every=3
    # forces base generations (= drained re-bases) to land mid-load;
    # the 2 ms lookup floor models the TPU device-gather a CPU-only
    # CI box cannot reproduce, so in-flight requests genuinely
    # overlap across the pool
    "serving-fleet-replica-kill": {
        "pool_size": 3,
        "generations": 10,
        "publish_every_s": 0.35,
        "compact_every": 3,
        "load_streams": 4,
        "lookup_floor_ms": 2.0,
    },
    # ckpt_every=4 vs publish-every-2: the kill (3rd publish = step
    # 6) restores the step-4 snapshot and REPLAYS steps 5-6, so the
    # loss-trajectory invariant's multi-incarnation cross-check has
    # real replayed steps to agree on
    "serving-trainer-kill-midpublish": {
        "total_steps": 12,
        "ckpt_every": 4,
        "train_script": "sparse_serving",
        "extra_env": {
            "DLROVER_KV_DIGEST": "1",
            "DLROVER_CHAOS_PUB_EVERY": "2",
            "DLROVER_CHAOS_STEP_SLEEP": "0.2",
        },
    },
    # invisible recovery: warm restarts + the framework preload so a
    # respawn pays fork+restore+aot only, a workdir-scoped compile-cache
    # dir (the harness materializes it; the AOT cache rides under it)
    # so the FIRST incarnation deterministically writes the step entry
    # its replacement resolves through, and the forkserver template
    # pre-loads the entry (and its kernel libraries) before each fork
    # so the replacement inherits them in memory.  The hit/miss, the
    # retrace+aot ceiling and the cycle are all decided from the event
    # log alone.
    "warm-recovery-cache-hit": {
        "warm_restart": True,
        "total_steps": 12,
        "ckpt_every": 2,
        "compile_cache": True,
        "extra_env": {
            "DLROVER_MONITOR_REPORT_INTERVAL": "0.5",
            "DLROVER_PRELOAD": TRAINER_PRELOAD,
            "DLROVER_AOT_PRETRACE": "1",
        },
    },
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
