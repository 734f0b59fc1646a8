"""Twins of ``tests/test_rl_elastic.py`` for the port (slice 7): lease
derivation and bit-identical replay, the PPO checkpoint adapter's round
trip through the port's ``Checkpointer`` (same world from shm and from
storage, and across world sizes from storage) and its torn-snapshot
refusal, the uninterrupted control's loss trajectory, the bounded
inference cache, and ``resolve_role_steps`` (the reference's
``test_resolve_role_steps_aot_routing``): the trainable roles' steps
resolve through the AOT step cache, and a role step replayed from its
entry equals the eager step.

The lease prompts are the JAX package's bit for bit (numpy, compared
here); the port's lease RNG is a ``torch.Generator`` seeded from
``(seed, lease_id)``, so a lease stays a pure function of its id.
"""

import os
import shutil
import tempfile
import time
import uuid

import numpy as np
import pytest
import torch

from dlrover_tpu.rl.elastic import lease_prompts as jax_lease_prompts
from dlrover_tpu_torch.accel import Strategy
from dlrover_tpu_torch.checkpoint.checkpointer import Checkpointer, StorageType
from dlrover_tpu_torch.checkpoint.engine import CheckpointEngine
from dlrover_tpu_torch.checkpoint.saver import AsyncCheckpointSaver, SaverConfig
from dlrover_tpu_torch.checkpoint.shm_handler import SharedMemoryHandler
from dlrover_tpu_torch.models.gpt import GPT, GPTConfig
from dlrover_tpu_torch.rl.elastic import (
    PPOCursor,
    PPOStateAdapter,
    lease_prompts,
    lease_rng,
    resolve_role_steps,
)
from dlrover_tpu_torch.rl.elastic.adapter import BUFFER_KEY
from dlrover_tpu_torch.rl.model_engine import ModelRole, RLModelEngine, RoleSpec
from dlrover_tpu_torch.rl.rollout import (
    make_actor_loss,
    make_critic_loss,
    make_experience,
    sample_rollout_batch,
    train_on_batch,
)
from dlrover_tpu_torch.rl.trainer import ReplayBuffer
from dlrover_tpu_torch.trainer.elastic_trainer import train_state_tree

B, PROMPT_LEN, MAX_NEW, VOCAB = 8, 4, 8, 32


def _build_engine():
    """The chaos loop's four-role recipe, shrunk for unit pacing."""
    cfg = GPTConfig.tiny(max_seq_len=16, vocab_size=VOCAB)
    actor = GPT(cfg, device="cpu", seed=0)
    critic = GPT(GPTConfig.tiny(max_seq_len=16, vocab_size=VOCAB,
                                head="value"), device="cpu", seed=3)
    ref = GPT(cfg, device="cpu", seed=1)
    sample = sample_rollout_batch(torch.zeros((B, PROMPT_LEN),
                                              dtype=torch.int32), MAX_NEW)
    dp = Strategy(opts=[("parallel_mode", {})])
    return RLModelEngine(sample, {
        ModelRole.ACTOR: RoleSpec(
            model=actor, loss_fn=make_actor_loss(actor, PROMPT_LEN),
            optim_factory=lambda ps: torch.optim.Adam(ps, lr=5e-3),
            strategy=dp),
        ModelRole.CRITIC: RoleSpec(
            model=critic, loss_fn=make_critic_loss(critic, PROMPT_LEN),
            optim_factory=lambda ps: torch.optim.Adam(ps, lr=1e-3),
            strategy=dp),
        ModelRole.REF: RoleSpec(model=ref),
    }, device="cpu").build()


def _reward_fn(sequences):
    return (sequences[:, PROMPT_LEN:] < 16).float().mean(dim=1)


def _lease_batch(engine, lease_id, seed=2):
    batch, _metrics = make_experience(
        engine, torch.from_numpy(lease_prompts(lease_id, B, PROMPT_LEN,
                                               VOCAB)),
        lease_rng(seed, lease_id, device="cpu"), max_new_tokens=MAX_NEW,
        kl_coef=0.01, reward_fn=_reward_fn,
    )
    return batch


def _host_state(engine, role):
    from dlrover_tpu_torch.checkpoint.shm_handler import map_leaves

    return map_leaves(
        lambda _p, leaf: (leaf.detach().clone()
                          if isinstance(leaf, torch.Tensor) else leaf),
        train_state_tree(engine.state(role)))


def _leaves(tree):
    from dlrover_tpu_torch.checkpoint.shm_handler import _flatten_state_dict

    return _flatten_state_dict(tree)


@pytest.fixture(scope="module")
def engine():
    return _build_engine()


@pytest.fixture()
def job(monkeypatch, tmp_path):
    """A shm namespace, a short socket directory and an in-process
    saver of the test's own; the segment unlinked afterwards."""
    sockets = tempfile.mkdtemp(prefix="dlrl")
    monkeypatch.setenv("DLROVER_JOB_NAME", f"rl-{uuid.uuid4().hex[:12]}")
    monkeypatch.setenv("DLROVER_SHARED_DIR", sockets)
    AsyncCheckpointSaver.reset()
    saver = AsyncCheckpointSaver(SaverConfig(
        checkpoint_dir=str(tmp_path), local_shard_num=1,
        global_shard_num=1, node_rank=0))
    AsyncCheckpointSaver._instance = saver
    yield str(tmp_path)
    AsyncCheckpointSaver.reset()
    SharedMemoryHandler(0).unlink()
    shutil.rmtree(sockets, ignore_errors=True)


def test_lease_derivation_is_pure():
    """Prompts and RNG derive from the lease id alone: same id, same
    bits; different ids, different bits.  The prompts are the JAX
    package's."""
    a = lease_prompts(3, B, PROMPT_LEN, VOCAB)
    np.testing.assert_array_equal(a, lease_prompts(3, B, PROMPT_LEN, VOCAB))
    np.testing.assert_array_equal(a, jax_lease_prompts(3, B, PROMPT_LEN,
                                                       VOCAB))
    assert not np.array_equal(a, lease_prompts(4, B, PROMPT_LEN, VOCAB))

    def draws(seed, lease):
        return torch.rand(16, generator=lease_rng(seed, lease,
                                                  device="cpu"))

    torch.testing.assert_close(draws(2, 3), draws(2, 3), rtol=0, atol=0)
    assert not torch.equal(draws(2, 3), draws(2, 4))
    assert not torch.equal(draws(2, 3), draws(3, 3))


def test_lease_replay_bit_identical(engine):
    """A requeued lease regenerated on a REPLACEMENT engine (fresh
    build, identical init) is bit-identical to the original: tokens,
    logprobs, advantages and returns all byte-equal."""
    other = _build_engine()
    first = _lease_batch(engine, lease_id=2)
    replay = _lease_batch(other, lease_id=2)
    assert first.keys() == replay.keys()
    for k in first:
        assert torch.equal(first[k], replay[k]), k


def _round_trip(engine, ckpt_dir, storage):
    """Export (through a Checkpointer save), perturb, restore: every
    role state, the cursor and the partial buffer come back.  One PPO
    step first, so Adam's slots and step counters are in the state."""
    train_on_batch(engine, _lease_batch(engine, 9))
    buffer = ReplayBuffer()
    buffer.add(_lease_batch(engine, 0))
    buffer.add(_lease_batch(engine, 1))
    cursor = PPOCursor(leases_done=2, ppo_updates=0,
                       rng_key=np.asarray([7, 2], np.int64))
    adapter = PPOStateAdapter(engine, buffer, cursor)
    ckpt = Checkpointer(ckpt_dir, local_rank=0, global_rank=0,
                        world_size=1)
    ckpt.register_sparse(adapter)
    snap = {role: _host_state(engine, role)
            for role in ModelRole.TRAINABLE}
    storage_type = StorageType.DISK if storage else StorageType.MEMORY
    assert ckpt.save_checkpoint(4, {"trainer": {"step": 4}},
                                storage_type=storage_type)
    if storage:
        assert ckpt.wait()
        tracker = os.path.join(ckpt_dir,
                               "latest_checkpointed_iteration.txt")
        deadline = time.time() + 30
        while time.time() < deadline and not os.path.exists(tracker):
            time.sleep(0.05)
    # perturb: train on both buffered batches (params, Adam slots and
    # step counters all move), drain the buffer, advance the cursor
    for bt in buffer.batches():
        train_on_batch(engine, bt)
    buffer.reset()
    cursor.leases_done, cursor.ppo_updates, cursor.rng_key = 5, 3, None
    moved = _leaves(_host_state(engine, ModelRole.ACTOR))
    before = _leaves(snap[ModelRole.ACTOR])
    assert set(moved) == set(before) and any(
        isinstance(v, torch.Tensor) and not torch.equal(v, moved[k])
        for k, v in before.items())
    return ckpt, adapter, buffer, cursor, snap


def _check_restored(engine, buffer, cursor, snap):
    for role in ModelRole.TRAINABLE:
        want = _leaves(snap[role])
        got = _leaves(_host_state(engine, role))
        assert set(got) == set(want)
        for k, v in want.items():
            if isinstance(v, torch.Tensor):
                assert torch.equal(got[k], v), (role, k)
            else:
                assert got[k] == v, (role, k)
    assert cursor.leases_done == 2 and cursor.ppo_updates == 0
    np.testing.assert_array_equal(cursor.rng_key, [7, 2])
    assert len(buffer.batches()) == 2 and buffer.num == 2 * B


@pytest.mark.parametrize("tier", ["shm", "storage"])
def test_adapter_round_trip_restores_everything(job, tier):
    """Export under ``__kv__`` of a real flash save (shm, or committed
    storage with the shm segment gone) -> perturb -> ``load_checkpoint``
    restores role params, optimizer slots and steps, the cursor and the
    partial buffer, and reports through the ``kv_*`` extras."""
    engine = _build_engine()
    ckpt, adapter, buffer, cursor, snap = _round_trip(
        engine, job, storage=tier == "storage")
    if tier == "storage":
        ckpt.close()
        SharedMemoryHandler(0).unlink()
        ckpt = Checkpointer(job, local_rank=0, global_rank=0, world_size=1)
        ckpt.register_sparse(adapter)
    step, state = ckpt.load_checkpoint()
    assert step == 4 and state == {"trainer": {"step": 4}}
    phases = ckpt.last_restore_phases
    assert phases["tier"] == tier
    assert phases["rl_roles"] == 2 and phases["kv_rows"] == 2 * B
    _check_restored(engine, buffer, cursor, snap)
    ckpt.close()


def test_adapter_cross_world_restore_from_storage(job):
    """A world of 2 restoring a world-1 checkpoint: the shm snapshot is
    skipped (another world's), and every old rank's subtree goes to
    ``import_shards_streaming`` (the replicated PPO state: rank 0's)."""
    engine = _build_engine()
    ckpt, adapter, buffer, cursor, snap = _round_trip(engine, job,
                                                      storage=True)
    ckpt.close()
    wide = CheckpointEngine(job, replicated=False, local_rank=0,
                            global_rank=0, world_size=2)
    wide.register_sparse(adapter)
    step, state = wide.load()
    assert step == 4 and state == {"trainer": {"step": 4}}
    assert wide.last_restore_phases["tier"] == "storage"
    assert wide.last_restore_phases["rl_from_world"] == 1
    _check_restored(engine, buffer, cursor, snap)
    wide.close()


def test_adapter_detects_torn_snapshot(engine):
    """A snapshot whose cursor claims more buffered batches than the
    subtree carries is torn: the import refuses it rather than resume
    from silently shortened experience."""
    buffer = ReplayBuffer()
    buffer.add(_lease_batch(engine, 0))
    adapter = PPOStateAdapter(engine, buffer, PPOCursor(leases_done=1),
                              include_roles=False)
    exported = adapter.export_state()
    exported.pop(BUFFER_KEY)
    with pytest.raises(RuntimeError, match="torn"):
        adapter.import_state(exported, tier="memory", step=1)


def test_register_sparse_takes_the_adapter_surface(job):
    """Any object with the adapter surface registers; one without it,
    or a replicated engine over several ranks, is refused.  With one
    registered, ``load_sharded`` (whose kv branches came with the
    sparse slice) restores nothing from an empty directory."""
    ckpt = CheckpointEngine(job, replicated=True, local_rank=0,
                            global_rank=0, world_size=1)
    with pytest.raises(TypeError, match="import_state"):
        ckpt.register_sparse(object())
    wide = CheckpointEngine(job, replicated=True, local_rank=0,
                            global_rank=0, world_size=2)
    with pytest.raises(ValueError, match="per-rank shards"):
        wide.register_sparse(PPOStateAdapter(None))
    ckpt.register_sparse(PPOStateAdapter(None, include_roles=False))
    assert ckpt.load_sharded({"w": torch.zeros(2)}) == (None, {})
    ckpt.close()
    wide.close()


def test_reference_losses_shape_and_determinism():
    """The uninterrupted control gives one loss per lease (train steps
    == leases) and is deterministic across calls: what
    LossTrajectoryMatches leans on."""
    from dlrover_tpu_torch.chaos.scenarios import rl_reference_losses

    a = rl_reference_losses(2)
    b = rl_reference_losses(2)
    assert len(a) == 2 and all(np.isfinite(a))
    assert a == b


def test_inference_cache_bounded(engine):
    """``_inference_apply`` memoizes per module (same module -> the
    SAME callable) and its lru_cache stays bounded, so module churn
    cannot pin modules."""
    from dlrover_tpu_torch.rl.rollout import _inference_apply

    critic = engine.state(ModelRole.CRITIC).module
    assert _inference_apply(critic) is _inference_apply(critic)
    info = _inference_apply.cache_info()
    assert info.maxsize == 8
    assert info.currsize <= info.maxsize


def test_resolve_role_steps_aot_routing(tmp_path):
    """Twin of the reference's: each trainable role resolves under its
    own label, a cold resolve writes the role's entry at its first call
    and a second resolve (the respawn's) hits it; the reference's
    routing and labels (``rl_<role>_step``)."""
    cache_dir = str(tmp_path / "aot")
    engine = _build_engine()
    batch = _lease_batch(engine, 1)
    first = resolve_role_steps(engine, batch, cache_dir=cache_dir)
    assert set(first) == set(ModelRole.TRAINABLE)
    assert {r.source for r in first.values()} == {"trace"}
    train_on_batch(engine, batch,
                   steps={role: r.fn for role, r in first.items()})
    assert all(r.wrote for r in first.values())
    labels = sorted(f for f in os.listdir(cache_dir) if f.endswith(".idx"))
    assert labels == ["rl_actor_step.idx", "rl_critic_step.idx"]
    again = resolve_role_steps(_build_engine(), batch, cache_dir=cache_dir)
    assert {(r.source, r.hit) for r in again.values()} == {("aot", True)}


def test_role_step_replayed_from_its_entry_equals_the_eager_step(tmp_path):
    """A respawn's role steps, resolved from the entries the first
    incarnation wrote, take the same PPO step as the engine's own eager
    steps on a fresh engine: actor and critic losses and every updated
    parameter equal bit for bit (one CPU process, the same kernels)."""
    cache_dir = str(tmp_path / "aot")

    def experience(engine):
        return _lease_batch(engine, 3)

    writer = _build_engine()
    batch = experience(writer)
    resolved = resolve_role_steps(writer, batch, cache_dir=cache_dir)
    train_on_batch(writer, batch,
                   steps={role: r.fn for role, r in resolved.items()})

    replay, eager = _build_engine(), _build_engine()
    hits = resolve_role_steps(replay, experience(replay), cache_dir=cache_dir)
    assert all(r.hit for r in hits.values())
    got = train_on_batch(replay, experience(replay),
                         steps={role: r.fn for role, r in hits.items()})
    want = train_on_batch(eager, experience(eager))
    assert got == want
    for role in ModelRole.TRAINABLE:
        a = replay.state(role).module.state_dict()
        b = eager.state(role).module.state_dict()
        assert all(torch.equal(a[k], b[k]) for k in b), role


def test_rlhf_example_runs_on_the_cpu():
    """The twin of ``examples/rlhf_ppo.py`` at its tiny size on the CPU:
    both tiers run (hand-rolled iterations, then the trainer loop's
    buffer-then-train phases) with finite losses, the critic's strategy
    searched."""
    from dlrover_tpu_torch.examples import rlhf_ppo

    iterations, history = rlhf_ppo.main(
        ["--device", "cpu", "--iterations", "2", "--epochs", "1"])
    assert len(iterations) == 2
    assert all(np.isfinite(m["actor_loss"]) and np.isfinite(m["critic_loss"])
               for m in iterations)
    # 2 prompt batches x 16 = 32 rollouts = one training phase
    assert len(history) == 1 and history[0]["ppo_steps"] == 4
