"""The sharded flash checkpoint of the port over DTensors on gloo.

Twins of the reference's sharded and reshard tests
(``tests/test_sharded_ckpt.py``, ``tests/test_restore_pipeline.py::
test_load_sharded_pipeline_reshard_bit_identical``,
``::test_reshard_save_restore_grid_bit_identical``,
``::test_reshard_round_trip_2_1_2`` and ``tests/test_resize.py::
test_engine_skips_shm_tier_across_world_change``).  Where the reference
shards over the 8 virtual devices of one process, a world of N here is
N spawned processes (this file with ``--worker``), each with its own
shm namespace and in-process saver (a node of its own, sharing one
checkpoint directory: node 0's saver commits once every rank's shard
is written).  The single-rank cases run in this process on a one-rank
gloo group.

Every restored byte is compared exactly with the saved state, and the
serial restore (``DLROVER_RESTORE_WORKERS=1``) with the pipelined one.

Across the packages: the JAX package saves a tiny GPT's
``{"params", "opt_state"}`` (``optax.adamw(3e-4, weight_decay=0.1)``
after two steps, fp32) sharded on mesh ``{fsdp: 4}``; the port restores
it at world 2 under FSDP2 through ``load_checkpoint(target_state=...)``
bit for bit and takes the third step, whose loss and params are held to
the JAX package's third step at rtol 1e-4 / atol 1e-5, except that an
element whose JAX gradient was below 1e-7 at some step (rounding noise,
which Adam's g / (|g| + eps) turns into a step of up to lr) is held to
Adam's bound of 2 * steps * lr, as in ``test_torch_accelerate_dist.py``.
The port's world-2 checkpoint of the same model restores bit for bit in
the JAX package onto ``{data: 2, fsdp: 4}``.

The spawned rounds run once for the module (fixture ``rounds``) and the
cases read their results; each round has a timeout of its own.
"""

import os
import pickle
import shutil
import socket
import subprocess
import sys
import tempfile
import time
import uuid

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEQ, BATCH, VOCAB, LR, WD = 16, 8, 250, 3e-4, 0.1
GRAD_QUIET = 1e-7
WORLDS = (1, 2, 4)
ROUND_TIMEOUT_S = 300
TRACKER = "latest_checkpointed_iteration.txt"


def _src():
    return np.random.default_rng(11).normal(size=(64, 8)).astype(np.float32)


def _bias():
    return np.arange(8, dtype=np.float32)


def _batches():
    rng = np.random.default_rng(0)
    out = []
    for _ in range(3):
        data = rng.integers(0, VOCAB, (BATCH, SEQ + 1), dtype=np.int32)
        out.append({"x": data[:, :-1], "y": data[:, 1:]})
    return out


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _wait_commit(path, step, timeout=60.0):
    tracker = os.path.join(str(path), TRACKER)
    deadline = time.time() + timeout
    while time.time() < deadline:
        try:
            with open(tracker) as f:
                if int(f.read().strip() or -1) >= step:
                    return
        except (OSError, ValueError):
            pass
        time.sleep(0.05)
    raise AssertionError(f"step {step} not committed in {path}")


# -- the port, in each rank of a spawned world --------------------------------


def _engine(path, world, rank):
    from dlrover_tpu_torch.checkpoint.engine import CheckpointEngine
    from dlrover_tpu_torch.checkpoint.saver import AsyncCheckpointSaver

    # a fresh in-process saver for each checkpoint directory
    AsyncCheckpointSaver.reset()
    return CheckpointEngine(str(path), replicated=False, local_rank=0,
                            global_rank=rank, world_size=world)


def _bytes(t):
    from torch.distributed.tensor import DTensor

    full = t.full_tensor() if isinstance(t, DTensor) else t
    return full.detach().contiguous().numpy().tobytes()


def _grid_state(mesh, world):
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    return {"w": distribute_tensor(torch.from_numpy(_src()), mesh,
                                   [Shard(0)]),
            "b": distribute_tensor(torch.from_numpy(_bias()), mesh,
                                   [Replicate()]),
            "step": 3}


def _zeros_like_tree(state):
    from torch.distributed.tensor import DTensor, distribute_tensor

    out = {}
    for k, v in state.items():
        if isinstance(v, DTensor):
            out[k] = distribute_tensor(torch.zeros(v.shape, dtype=v.dtype),
                                       v.device_mesh, v.placements)
        else:
            out[k] = 0
    return out


def _phase_save(rank, world, job, res):
    """Save the grid state under FSDP-style Shard(0) at this world to
    storage; restore it from this rank's shm onto the same boxes (a 2-D
    mesh at world 4), serially and pipelined; record the local boxes."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from dlrover_tpu_torch.checkpoint import restore as restore_mod
    from dlrover_tpu_torch.checkpoint.sharded import (
        dedupe_boxes,
        is_sharded_leaf,
        local_shards,
    )

    mesh = init_device_mesh("cpu", (world,))
    state = _grid_state(mesh, world)
    path = os.path.join(job, f"save_{world}")
    eng = _engine(path, world, rank)
    assert eng.save_to_storage(3, state)
    assert eng.wait_async(timeout=60)
    _wait_commit(path, 3)
    # same world: this rank's shm covers its own box; at world 4 the
    # target is a (2, 2) mesh whose (Shard(0), Shard(0)) boxes are the
    # saved ones
    if world == 4:
        mesh2 = init_device_mesh("cpu", (2, 2))
        target = {"w": distribute_tensor(torch.zeros(64, 8), mesh2,
                                         [Shard(0), Shard(0)]),
                  "b": distribute_tensor(torch.zeros(8), mesh2,
                                         [Replicate(), Replicate()]),
                  "step": 0}
    else:
        target = _zeros_like_tree(state)
    out = {}
    for workers in ("1", "4"):
        os.environ[restore_mod.RESTORE_WORKERS_ENV] = workers
        step, got = eng.load_sharded(target)
        out[workers] = {"step": step, "w": _bytes(got["w"]),
                        "b": _bytes(got["b"]), "tier":
                        eng.last_restore_phases["tier"],
                        "in_place": got["w"] is target["w"],
                        "placements": str(got["w"].placements),
                        "steps": got["step"]}
    # no aliasing: the restored tensors own their bytes
    before = _bytes(target["w"])
    shm = eng._shm_handler._attach()
    shm.buf[:min(shm.size, 4096)] = b"\xaa" * min(shm.size, 4096)
    out["unaliased"] = _bytes(target["w"]) == before
    eng.close()
    # local boxes: Shard(0) over the world, and at world 4 HSDP's
    # (Replicate, Shard(0)) on a (2, 2) mesh, whose copies dedupe to the
    # lowest rank
    boxes = [None] * world
    dist.all_gather_object(boxes, local_shards(state["w"])[0][0])
    out["boxes"] = boxes
    out["replicated_is_sharded"] = is_sharded_leaf(state["b"])
    if world == 4:
        mesh2 = init_device_mesh("cpu", (2, 2))
        hsdp = distribute_tensor(torch.zeros(16, 4), mesh2,
                                 [Replicate(), Shard(0)])
        pairs = [None] * world
        dist.all_gather_object(pairs, (rank, local_shards(hsdp)[0][0]))
        out["hsdp_boxes"] = [box for _, box in sorted(pairs)]
        out["hsdp_dedup"] = dedupe_boxes(sorted(
            (box, r) for r, box in pairs))
    res["save"] = out


def _phase_restore(rank, world, job, res):
    """Restore every world's save at this world from storage (a new
    process: no shm snapshot), serially and pipelined; world 1 resaves
    its restore of save_2 (the round trip's middle hop) and world 2
    restores that."""
    from torch.distributed.device_mesh import init_device_mesh

    from dlrover_tpu_torch.checkpoint import restore as restore_mod

    mesh = init_device_mesh("cpu", (world,))
    grid = {}
    for saved in WORLDS:
        eng = _engine(os.path.join(job, f"save_{saved}"), world, rank)
        got_by = {}
        for workers in ("1", "4"):
            os.environ[restore_mod.RESTORE_WORKERS_ENV] = workers
            target = _zeros_like_tree(_grid_state(mesh, world))
            step, got = eng.load_sharded(target)
            got_by[workers] = {"step": step, "w": _bytes(got["w"]),
                               "b": _bytes(got["b"]), "steps": got["step"],
                               "tier": eng.last_restore_phases["tier"]}
        grid[saved] = got_by
        eng.close()
    res["grid"] = grid
    rt = os.path.join(job, "round_trip_1")
    if world == 1:
        eng = _engine(os.path.join(job, "save_2"), 1, rank)
        target = _zeros_like_tree(_grid_state(mesh, 1))
        step, got = eng.load_sharded(target)
        eng.close()
        eng = _engine(rt, 1, rank)
        assert eng.save_to_storage(4, {"w": got["w"], "b": got["b"],
                                       "step": 4})
        assert eng.wait_async(timeout=60)
        _wait_commit(rt, 4)
        eng.close()
    elif world == 2:
        _wait_commit(rt, 4, timeout=ROUND_TIMEOUT_S / 2)
        eng = _engine(rt, 2, rank)
        target = _zeros_like_tree(_grid_state(mesh, 2))
        step, got = eng.load_sharded(target)
        res["round_trip"] = {"step": step, "w": _bytes(got["w"]),
                             "tier": eng.last_restore_phases["tier"]}
        eng.close()


def _gpt_plan(params, batch):
    from dlrover_tpu_torch.accel import Strategy, auto_accelerate
    from dlrover_tpu_torch.models.gpt import GPT, GPTConfig, cross_entropy_loss
    from dlrover_tpu_torch.utils.convert import params_from_jax

    model = GPT(GPTConfig.tiny(dtype=torch.float32, vocab_size=VOCAB),
                device="cpu")
    model.load_state_dict(params_from_jax(params))
    return auto_accelerate(
        model, lambda ps: torch.optim.AdamW(
            ps, lr=LR, betas=(0.9, 0.999), eps=1e-8, weight_decay=WD),
        lambda m, b: cross_entropy_loss(m(b["x"]), b["y"]), batch,
        strategy=Strategy(opts=[("fsdp", {}),
                                ("amp_native", {"dtype": "float32"})]),
        device="cpu")


def _tree(res):
    from dlrover_tpu_torch.utils.convert import adamw_state_tree, params_tree

    return {"params": params_tree(res.model),
            "opt_state": adamw_state_tree(res.state.optimizer, res.model)}


def _full_flat(tree):
    from torch.distributed.tensor import DTensor

    from dlrover_tpu_torch.checkpoint.shm_handler import _flatten_state_dict

    out = {}
    for k, v in _flatten_state_dict(tree).items():
        v = v.full_tensor() if isinstance(v, DTensor) else v
        out[k] = v.detach().clone().numpy()
    return out


def _phase_gpt(rank, world, job, res):
    """World 2: restore the JAX package's checkpoint and take the third
    step; then take two steps from the JAX init and save them for the
    JAX package to restore."""
    from dlrover_tpu_torch.checkpoint.checkpointer import (
        Checkpointer,
        StorageType,
    )
    from dlrover_tpu_torch.checkpoint.saver import AsyncCheckpointSaver
    from dlrover_tpu_torch.common.device import is_dtensor
    from dlrover_tpu_torch.utils.convert import adamw_state_from_tree

    with open(os.path.join(job, "in.pkl"), "rb") as f:
        job_in = pickle.load(f)
    batches = job_in["batches"]
    plan = _gpt_plan(job_in["init"], batches[0])
    AsyncCheckpointSaver.reset()
    ckpt = Checkpointer(os.path.join(job, "jax"), replicated=False)
    target = _tree(plan)
    step, restored = ckpt.load_checkpoint(target_state=target)
    ckpt.close()
    adamw_state_from_tree(restored["opt_state"], plan.state.optimizer,
                          plan.model)
    got = _full_flat(restored)
    state, metrics = plan.train_step(plan.state,
                                     plan.place_batch(batches[2]))
    params = {k: v for k, v in _full_flat(_tree(plan)).items()
              if k.startswith("params/")}
    res["jax2port"] = {
        "step": step, "restored": got, "loss": float(metrics["loss"]),
        "params": params, "tier": ckpt.last_restore_phases["tier"],
        "dtensor": all(is_dtensor(p) for p in plan.model.parameters()),
        "adam_step": float(next(iter(
            plan.state.optimizer.state.values()))["step"]),
    }
    plan = _gpt_plan(job_in["init"], batches[0])
    state = plan.state
    for batch in batches[:2]:
        state, _ = plan.train_step(state, plan.place_batch(batch))
    AsyncCheckpointSaver.reset()
    path = os.path.join(job, "port")
    ckpt = Checkpointer(path, replicated=False)
    assert ckpt.save_checkpoint(2, _tree(plan), storage_type=StorageType.DISK)
    assert ckpt.wait()
    _wait_commit(path, 2)
    ckpt.close()
    res["port2jax"] = _full_flat(_tree(plan))


def _worker(rank, world, port, job, phase):
    import torch.distributed as dist

    from dlrover_tpu_torch.checkpoint.saver import AsyncCheckpointSaver
    from dlrover_tpu_torch.checkpoint.shm_handler import SharedMemoryHandler

    torch.set_num_threads(1)
    sockets = tempfile.mkdtemp(prefix="dlsk")
    os.environ.update({
        "DLROVER_SHARED_DIR": sockets,
        "DLROVER_JOB_NAME": f"sk-{uuid.uuid4().hex[:10]}",
        "DLROVER_NODE_RANK": str(rank),
        "DLROVER_RANK": str(rank),
        "DLROVER_WORLD_SIZE": str(world),
        # one node's mesh (the fsdp plan keeps fsdp inside a node), each
        # rank with a shm namespace and saver of its own
        "DLROVER_LOCAL_WORLD_SIZE": str(world),
    })
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    res = {}
    try:
        if phase == "save":
            _phase_save(rank, world, job, res)
            if world == 2:
                _phase_gpt(rank, world, job, res)
        else:
            _phase_restore(rank, world, job, res)
        dist.barrier()
    finally:
        AsyncCheckpointSaver.reset()
        SharedMemoryHandler(0).unlink()
        shutil.rmtree(sockets, ignore_errors=True)
    dist.destroy_process_group()
    if rank == 0:
        with open(os.path.join(job, f"{phase}_{world}.pkl"), "wb") as f:
            pickle.dump(res, f)


def _spawn_round(job, phase):
    """Run the worlds of a round one after another (at most 4 processes
    at once; world 1's round trip hop precedes world 2's); rank 0's
    results by world."""
    env = {**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "1",
           "DLROVER_LOG_LEVEL": "ERROR"}
    out = {}
    deadline = time.time() + ROUND_TIMEOUT_S
    for world in WORLDS:
        port = _free_port()
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--worker",
             str(rank), str(world), str(port), job, phase],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True) for rank in range(world)]
        for p in procs:
            try:
                log = p.communicate(
                    timeout=max(1.0, deadline - time.time()))[0]
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                raise AssertionError(f"{phase} round timed out")
            assert p.returncode == 0, log[-4000:]
        with open(os.path.join(job, f"{phase}_{world}.pkl"), "rb") as f:
            out[world] = pickle.load(f)
    return out


# -- the JAX package, in this process -----------------------------------------


def _jax_model():
    import jax.numpy as jnp

    from dlrover_tpu.models import gpt as jax_gpt

    return jax_gpt.GPT(jax_gpt.GPTConfig.tiny(dtype=jnp.float32,
                                              vocab_size=VOCAB))


def _jax_plan(opts, devices):
    import jax.numpy as jnp
    import optax

    from dlrover_tpu.accel import Strategy, auto_accelerate
    from dlrover_tpu.models import gpt as jax_gpt

    jmodel = _jax_model()

    def loss_fn(p, batch, model=jmodel):
        return jax_gpt.cross_entropy_loss(
            model.apply({"params": p}, batch["x"]), batch["y"])

    batch0 = {k: jnp.asarray(v) for k, v in _batches()[0].items()}
    res = auto_accelerate(
        jmodel, lambda: optax.adamw(LR, weight_decay=WD), loss_fn, batch0,
        strategy=Strategy(opts=opts), devices=devices)
    return res, loss_fn


def _jax_flat(tree):
    import jax

    from dlrover_tpu.checkpoint.shm_handler import _flatten_state_dict

    return {k: np.asarray(v) for k, v in _flatten_state_dict(
        jax.tree.map(np.asarray, tree)).items()}


def _jax_side(job):
    """The JAX package's run: init, two steps under fsdp 4, the save,
    the third step and the gradients of all three."""
    import jax
    import jax.numpy as jnp

    from dlrover_tpu.checkpoint.checkpointer import Checkpointer

    init = jax.tree.map(np.asarray,
                        _jax_model().init_params(jax.random.PRNGKey(0)))
    res, loss_fn = _jax_plan(
        [("fsdp", {}), ("amp_native", {"dtype": "float32"})],
        jax.devices()[:4])
    grad_fn = jax.jit(jax.grad(loss_fn))
    state, grads, batches = res.state, [], _batches()
    for i, batch in enumerate(batches):
        batch = {k: jnp.asarray(v) for k, v in batch.items()}
        grads.append(jax.tree.map(np.asarray, grad_fn(
            jax.tree.map(np.asarray, state.params), batch)))
        if i == 2:
            saved = _jax_flat({"params": state.params,
                               "opt_state": state.opt_state})
            ckpt = Checkpointer(os.path.join(job, "jax"), replicated=False)
            assert ckpt.save_checkpoint(2, {"params": state.params,
                                            "opt_state": state.opt_state})
            assert ckpt.wait()
            _wait_commit(os.path.join(job, "jax"), 2)
            ckpt.close()
        state, metrics = res.train_step(state, res.place_batch(batch))
        loss = float(metrics["loss"])
    with open(os.path.join(job, "in.pkl"), "wb") as f:
        pickle.dump({"init": init, "batches": batches}, f)
    return {"saved": saved, "loss": loss, "grads": grads,
            "params": _jax_flat({"params": state.params})}


@pytest.fixture(scope="module")
def rounds():
    """The JAX package's save, then the save round (worlds 1, 2 and 4)
    and the restore round."""
    from dlrover_tpu.checkpoint.saver import AsyncCheckpointSaver as JaxSaver

    job = tempfile.mkdtemp(prefix="dlsk_job")
    sockets = tempfile.mkdtemp(prefix="dlsj")
    old = {k: os.environ.get(k)
           for k in ("DLROVER_SHARED_DIR", "DLROVER_JOB_NAME")}
    os.environ["DLROVER_SHARED_DIR"] = sockets
    os.environ["DLROVER_JOB_NAME"] = f"skj-{uuid.uuid4().hex[:10]}"
    try:
        JaxSaver.reset()
        jax_run = _jax_side(job)
        JaxSaver.reset()
        from dlrover_tpu.checkpoint.shm_handler import (
            SharedMemoryHandler as JaxShm,
        )

        JaxShm(0).unlink()
        saves = _spawn_round(job, "save")
        restores = _spawn_round(job, "restore")
        yield {"job": job, "jax": jax_run, "save": saves,
               "restore": restores}
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(sockets, ignore_errors=True)
        shutil.rmtree(job, ignore_errors=True)


# -- twins of tests/test_sharded_ckpt.py --------------------------------------


def test_local_shards_dedup_replicated(rounds):
    """Shard(0) over N ranks: rank r's box is rows 64/N * r onward; a
    DTensor replicated everywhere is a whole leaf, not a sharded one;
    HSDP's copies along the replicated mesh dim dedupe to the lowest
    rank."""
    for world in WORLDS:
        got = rounds["save"][world]["save"]
        rows = 64 // world
        assert got["boxes"] == [((r * rows, (r + 1) * rows), (0, 8))
                                for r in range(world)]
        assert got["replicated_is_sharded"] is False
    got = rounds["save"][4]["save"]
    assert got["hsdp_boxes"] == [((0, 8), (0, 4)), ((8, 16), (0, 4)),
                                 ((0, 8), (0, 4)), ((8, 16), (0, 4))]
    assert got["hsdp_dedup"] == [(((0, 8), (0, 4)), 0),
                                 (((8, 16), (0, 4)), 1)]


def test_assemble_shard_overlaps():
    from dlrover_tpu_torch.checkpoint.sharded import assemble_shard

    entries = [
        (((0, 2), (0, 4)), torch.full((2, 4), 1.0)),
        (((2, 4), (0, 4)), torch.full((2, 4), 2.0)),
    ]
    out = assemble_shard(((1, 3), (0, 4)), torch.float32, entries)
    assert torch.equal(out[0], torch.full((4,), 1.0))
    assert torch.equal(out[1], torch.full((4,), 2.0))
    # incomplete coverage -> None
    assert assemble_shard(((0, 5), (0, 4)), torch.float32, entries) is None
    # overlapping boxes: coverage by mask
    entries.append((((1, 3), (0, 4)), torch.full((2, 4), 3.0)))
    out = assemble_shard(((0, 4), (0, 4)), torch.float32, entries)
    assert out is not None and torch.equal(out[3], torch.full((4,), 2.0))


@pytest.mark.parametrize("world", WORLDS)
def test_shm_sharded_roundtrip_same_mesh(rounds, world):
    """Same world: each rank restores its own box from its shm snapshot,
    in place, placements kept, bit for bit."""
    got = rounds["save"][world]["save"]["4"]
    assert got["step"] == 3 and got["steps"] == 3
    assert got["tier"] == "shm" and got["in_place"]
    assert got["w"] == _src().tobytes() and got["b"] == _bias().tobytes()
    if world == 4:
        assert got["placements"] == "(Shard(dim=0), Shard(dim=0))"
    else:
        assert got["placements"] == "(Shard(dim=0),)"


@pytest.mark.parametrize("saved,restored", [(4, 2), (4, 1), (2, 4)])
def test_storage_sharded_restore_at_different_mesh(rounds, saved,
                                                   restored):
    """Save on N ranks, restore on M from storage: the tensors and the
    scalar leaf come back."""
    got = rounds["restore"][restored]["grid"][saved]["4"]
    assert got["step"] == 3 and got["steps"] == 3
    assert got["tier"] == "storage"
    assert got["w"] == _src().tobytes() and got["b"] == _bias().tobytes()


def _one_rank_group(tmp_path):
    import torch.distributed as dist

    dist.init_process_group(
        "gloo", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
        world_size=1)


@pytest.fixture()
def group(tmp_path, monkeypatch):
    """A one-rank gloo group, a shm namespace and socket directory of the
    test's own, the in-process savers stopped afterwards."""
    import torch.distributed as dist

    from dlrover_tpu_torch.checkpoint.saver import AsyncCheckpointSaver
    from dlrover_tpu_torch.checkpoint.shm_handler import SharedMemoryHandler

    sockets = tempfile.mkdtemp(prefix="dlsg")
    monkeypatch.setenv("DLROVER_SHARED_DIR", sockets)
    monkeypatch.setenv("DLROVER_JOB_NAME", f"skg-{uuid.uuid4().hex[:10]}")
    AsyncCheckpointSaver.reset()
    _one_rank_group(tmp_path)
    from torch.distributed.device_mesh import init_device_mesh

    try:
        yield init_device_mesh("cpu", (1,))
    finally:
        dist.destroy_process_group()
        AsyncCheckpointSaver.reset()
        SharedMemoryHandler(0).unlink()
        shutil.rmtree(sockets, ignore_errors=True)


def _saver(path, shards=1):
    from dlrover_tpu_torch.checkpoint.saver import (
        AsyncCheckpointSaver,
        SaverConfig,
    )

    AsyncCheckpointSaver._instance = AsyncCheckpointSaver(SaverConfig(
        checkpoint_dir=str(path), local_shard_num=1,
        global_shard_num=shards, node_rank=0))


def test_orbax_fallback_when_storage_empty(group, tmp_path):
    """No shm, no flash storage: load_sharded falls through to the orbax
    tier (DCP here), onto the target's DTensors."""
    from dlrover_tpu_torch.checkpoint.engine import CheckpointEngine
    from dlrover_tpu_torch.checkpoint.orbax_compat import GlobalCheckpointer

    state = _grid_state(group, 1)
    orbax_dir = str(tmp_path / "orbax")
    ckptr = GlobalCheckpointer(orbax_dir)
    ckptr.save(7, state, wait=True)
    ckptr.close()
    _saver(tmp_path / "flash")
    engine = CheckpointEngine(str(tmp_path / "flash"), replicated=False,
                              local_rank=0, global_rank=0, world_size=1)
    target = _zeros_like_tree(state)
    step, restored = engine.load_sharded(target, orbax_dir=orbax_dir)
    assert step == 7 and restored["step"] == 3
    assert _bytes(restored["w"]) == _src().tobytes()
    assert restored["w"] is target["w"]
    assert engine.last_restore_phases["tier"] == "orbax"
    engine.close()


def test_checkpointer_orbax_tier_roundtrip(group, tmp_path):
    """Checkpointer writes every Nth save through the orbax tier and
    load_checkpoint(target) falls back to it when the flash tier is
    gone (the two-tier deployment shape)."""
    from dlrover_tpu_torch.checkpoint.checkpointer import Checkpointer
    from dlrover_tpu_torch.checkpoint.shm_handler import SharedMemoryHandler

    state = _grid_state(group, 1)
    _saver(tmp_path / "flash")
    ckpt = Checkpointer(str(tmp_path / "flash"), replicated=False,
                        local_rank=0, global_rank=0, world_size=1,
                        orbax_dir=str(tmp_path / "orbax"), orbax_every=2)
    assert ckpt.save_checkpoint(2, state)  # the first save goes to orbax
    assert ckpt.wait(timeout=60)
    ckpt.close()
    shutil.rmtree(str(tmp_path / "flash"), ignore_errors=True)
    SharedMemoryHandler(0).unlink()
    ckpt2 = Checkpointer(str(tmp_path / "flash2"), replicated=False,
                         local_rank=0, global_rank=0, world_size=1,
                         orbax_dir=str(tmp_path / "orbax"))
    step, restored = ckpt2.load_checkpoint(target_state=_zeros_like_tree(
        state))
    assert step == 2
    assert _bytes(restored["w"]) == _src().tobytes()
    ckpt2.close()


# -- twins of tests/test_restore_pipeline.py and tests/test_resize.py ---------


def test_load_sharded_pipeline_reshard_bit_identical(rounds):
    """At world 4 the shm restore onto a (2, 2) mesh: serial and
    pipelined bit-identical, and the restored tensors do not alias the
    segment (overwriting it afterwards changes nothing)."""
    got = rounds["save"][4]["save"]
    assert got["1"]["w"] == got["4"]["w"] == _src().tobytes()
    assert got["1"]["tier"] == got["4"]["tier"] == "shm"
    assert got["unaliased"]


@pytest.mark.parametrize("saved", WORLDS)
@pytest.mark.parametrize("restored", WORLDS)
def test_reshard_save_restore_grid_bit_identical(rounds, saved, restored):
    """N-rank save -> M-rank restore, bit-identical to the source for
    N, M in {1, 2, 4}, serially and pipelined."""
    got = rounds["restore"][restored]["grid"][saved]
    for workers in ("1", "4"):
        assert got[workers]["step"] == 3
        assert got[workers]["w"] == _src().tobytes()
        assert got[workers]["b"] == _bias().tobytes()
        assert got[workers]["tier"] == "storage"


def test_reshard_round_trip_2_1_2(rounds):
    """The elastic churn arc in miniature: saved over 2 ranks, restored
    and resaved over 1, restored over 2 again, every hop from storage,
    the bytes the source's."""
    assert rounds["restore"][1]["grid"][2]["1"]["tier"] == "storage"
    got = rounds["restore"][2]["round_trip"]
    assert got["step"] == 4 and got["tier"] == "storage"
    assert got["w"] == _src().tobytes()


def test_engine_skips_shm_tier_across_world_change(group, tmp_path):
    """An engine of world 2 saves to shm and storage; the same world
    restores from shm, a world of 1 refuses the shm snapshot and
    reshards from storage."""
    from dlrover_tpu_torch.checkpoint.engine import CheckpointEngine

    state = _grid_state(group, 1)
    _saver(tmp_path)
    engine2 = CheckpointEngine(str(tmp_path), replicated=False,
                               local_rank=0, global_rank=0, world_size=2)
    assert engine2.save_to_memory(6, state)
    assert engine2.save_to_storage(6, state)
    assert engine2.wait_async(timeout=30.0)
    _wait_commit(tmp_path, 6)
    step, restored = engine2.load_sharded(_zeros_like_tree(state))
    assert step == 6 and engine2.last_restore_phases["tier"] == "shm"
    engine1 = CheckpointEngine(str(tmp_path), replicated=False,
                               local_rank=0, global_rank=0, world_size=1)
    step, restored = engine1.load_sharded(_zeros_like_tree(state))
    assert step == 6
    assert engine1.last_restore_phases["tier"] == "storage"
    assert _bytes(restored["w"]) == _src().tobytes()
    engine1.close()
    engine2.close()


def test_a_restore_no_tier_covers_raises(group, tmp_path):
    """A checkpoint whose boxes miss the target on every tier raises
    (no silent fresh start); no checkpoint at all is a fresh start."""
    from torch.distributed.tensor import Shard, distribute_tensor

    from dlrover_tpu_torch.checkpoint.engine import CheckpointEngine

    _saver(tmp_path)
    engine = CheckpointEngine(str(tmp_path), replicated=False, local_rank=0,
                              global_rank=0, world_size=1)
    assert engine.load_sharded(_zeros_like_tree(_grid_state(group, 1))) == (
        None, {})
    assert engine.save_to_memory(1, {"w": torch.zeros(4)})
    wrong = {"w": distribute_tensor(torch.zeros(8), group, [Shard(0)])}
    with pytest.raises(RuntimeError, match="no checkpoint tier covers"):
        engine.load_sharded(wrong)
    engine.close()


def test_restore_to_template_takes_dtensor_templates(group):
    from dlrover_tpu_torch.checkpoint.checkpointer import restore_to_template

    state = _zeros_like_tree(_grid_state(group, 1))
    out = restore_to_template(
        {"w": state["w"]}, {"w": torch.from_numpy(_src())})
    assert out["w"] is state["w"]
    assert _bytes(out["w"]) == _src().tobytes()


# -- across the packages -------------------------------------------------------


def test_jax_sharded_train_state_resumes_in_the_port_at_world_2(rounds):
    """The JAX package's {fsdp: 4} checkpoint of params and AdamW moments
    restores bit for bit onto the port's FSDP2 DTensors at world 2; the
    next step matches the JAX package's."""
    jax_run, got = rounds["jax"], rounds["save"][2]["jax2port"]
    assert got["step"] == 2 and got["tier"] == "storage" and got["dtensor"]
    assert got["adam_step"] == 3.0
    assert set(got["restored"]) == set(jax_run["saved"])
    for key, want in jax_run["saved"].items():
        assert got["restored"][key].tobytes() == np.asarray(
            want).tobytes(), key
    np.testing.assert_allclose(got["loss"], jax_run["loss"], rtol=1e-4,
                               atol=1e-5)
    quiet = _quiet(jax_run["grads"])
    steps, exempt, total = 3, 0, 0
    for key, want in jax_run["params"].items():
        diff = np.abs(got["params"][key] - want)
        held = diff <= 1e-5 + 1e-4 * np.abs(want)
        noisy = quiet[key]
        assert np.all(held | (noisy & (diff <= 2 * steps * LR))), key
        exempt += int((noisy & ~held).sum())
        total += want.size
    print(f"jax -> port at world 2: {exempt} of {total} elements held "
          "to Adam's bound")


def _quiet(grads):
    """flat param key -> elements whose JAX gradient was below
    GRAD_QUIET at some step."""
    from dlrover_tpu.checkpoint.shm_handler import _flatten_state_dict

    out = {}
    for g in grads:
        for key, v in _flatten_state_dict({"params": g}).items():
            q = np.abs(np.asarray(v)) < GRAD_QUIET
            out[key] = out.get(key, np.zeros_like(q)) | q
    return out


def test_port_world_2_checkpoint_restores_in_the_jax_package(rounds):
    """The port's world-2 checkpoint (two rank files of FSDP2 shards)
    restores bit for bit in the JAX package onto {data: 2, fsdp: 4}."""
    import jax

    from dlrover_tpu.checkpoint.checkpointer import Checkpointer
    from dlrover_tpu.checkpoint.saver import AsyncCheckpointSaver as JaxSaver

    res, _ = _jax_plan([("mixed_parallel", {"data": 2, "fsdp": 4}),
                        ("amp_native", {"dtype": "float32"})],
                       jax.devices()[:8])
    JaxSaver.reset()
    ckpt = Checkpointer(os.path.join(rounds["job"], "port"),
                        replicated=False)
    target = {"params": res.state.params, "opt_state": res.state.opt_state}
    step, restored = ckpt.load_checkpoint(target_state=target)
    ckpt.close()
    JaxSaver.reset()
    assert step == 2
    assert ckpt.last_restore_phases["tier"] == "storage"
    got = _jax_flat(restored)
    want = rounds["save"][2]["port2jax"]
    assert set(got) == set(want)
    for key in want:
        assert got[key].tobytes() == want[key].tobytes(), key
    mesh_axes = {a: n for a, n in res.mesh.shape.items() if n > 1}
    assert mesh_axes == {"data": 2, "fsdp": 4}
    leaf = jax.tree.leaves(restored["params"])[0]
    assert len(leaf.sharding.device_set) == 8


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        rank, world, port = (int(a) for a in sys.argv[2:5])
        _worker(rank, world, port, sys.argv[5], sys.argv[6])
    else:
        sys.exit(pytest.main([__file__, "-q", "-s"]))
