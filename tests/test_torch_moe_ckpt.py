"""The flash checkpoint of expert-parallel MoE state, across expert
worlds and across the packages.

The port's MoE experts are DTensors (``Shard(0)`` over ``expert``,
``parallel/moe.py``), so the sharded flash checkpoint saves each rank's
box of them and restores any box from any saved ones, as it does for
FSDP2's shards.  Three gloo worlds run one after another (this file
with ``--worker``), on the tiny MoE GPT (four experts in every second
block) in fp32:

- data 2 x expert 2 (world 4): the JAX package's checkpoint of the same
  model, saved from its own expert mesh (``{data: 2, expert: 2}`` on 4
  virtual CPU devices, ``moe_rules``), restores onto the port's DTensors
  bit for bit; two SGD steps through ``auto_accelerate``; a save to shm
  and storage; the same world restores it from its shm segment bit for
  bit;
- expert 1 (world 1, the plain model): the world-4 save restores from
  storage bit for bit, takes one more step and is saved again, then
  takes the next step;
- expert 2 (world 2): the world-1 save restores bit for bit onto the
  experts sharded again, and its next step's loss equals the expert-1
  run's at rtol 1e-6.

Then the port's world-4 checkpoint restores in the JAX package onto its
expert mesh, bit for bit.
"""

import os
import pickle
import shutil
import subprocess
import sys
import tempfile
import time
import uuid

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRACKER = "latest_checkpointed_iteration.txt"
TIMEOUT_S = 300
FP32 = ("amp_native", {"dtype": "float32"})
PLANS = {4: [("mixed_parallel", {"expert": 2, "data": -1}), FP32],
         1: None,
         2: [("mixed_parallel", {"expert": 2, "data": -1}), FP32]}


def _batch(seed):
    data = np.random.default_rng(seed).integers(0, 256, (8, 17),
                                                dtype=np.int32)
    return {"x": data[:, :-1], "y": data[:, 1:]}


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


def _loss_fn(module, batch):
    from dlrover_tpu_torch.models.gpt import cross_entropy_loss
    from dlrover_tpu_torch.parallel.moe import collect_moe_aux_loss

    return cross_entropy_loss(module(batch["x"]), batch["y"]) + \
        0.01 * collect_moe_aux_loss(module)


def _plan(world, init):
    import torch

    from dlrover_tpu_torch.accel import Strategy, auto_accelerate
    from dlrover_tpu_torch.models.gpt import GPT, GPTConfig
    from dlrover_tpu_torch.utils.convert import params_from_jax

    model = GPT(GPTConfig.tiny(moe_experts=4, moe_every=2,
                               dtype=torch.float32), device="cpu")
    model.load_state_dict(params_from_jax(init))
    return auto_accelerate(
        model, lambda ps: torch.optim.SGD(ps, lr=0.1), _loss_fn, _batch(0),
        strategy=Strategy(opts=PLANS[world] or [FP32]), device="cpu")


def _full(tree):
    from torch.distributed.tensor import DTensor

    from dlrover_tpu_torch.checkpoint.shm_handler import _flatten_state_dict

    return {k: (v.full_tensor() if isinstance(v, DTensor) else v)
            .detach().contiguous().numpy().copy()
            for k, v in _flatten_state_dict(tree).items()}


def _restore(path, target):
    from dlrover_tpu_torch.checkpoint.checkpointer import Checkpointer
    from dlrover_tpu_torch.checkpoint.saver import AsyncCheckpointSaver

    AsyncCheckpointSaver.reset()
    ckpt = Checkpointer(path, replicated=False)
    step, restored = ckpt.load_checkpoint(target_state=target)
    tier = ckpt.last_restore_phases["tier"]
    ckpt.close()
    return step, restored, tier


def _save(path, step, tree, storage_type):
    from dlrover_tpu_torch.checkpoint.checkpointer import Checkpointer
    from dlrover_tpu_torch.checkpoint.saver import AsyncCheckpointSaver

    AsyncCheckpointSaver.reset()
    ckpt = Checkpointer(path, replicated=False)
    assert ckpt.save_checkpoint(step, tree, storage_type=storage_type)
    assert ckpt.wait()
    return ckpt


def _run(rank, world, job):
    from dlrover_tpu_torch.checkpoint.checkpointer import StorageType
    from dlrover_tpu_torch.common.device import is_dtensor
    from dlrover_tpu_torch.utils.convert import params_tree

    with open(os.path.join(job, "in.pkl"), "rb") as f:
        init = pickle.load(f)["init"]
    res = _plan(world, init)
    kernel = res.model.blocks[1].moe.experts_w_in
    out = {"dtensor": is_dtensor(kernel), "local_experts": (
        kernel.to_local() if is_dtensor(kernel) else kernel).shape[0],
        "placements": str(getattr(kernel, "placements", None))}
    state = res.state
    if world == 4:
        step, restored, tier = _restore(os.path.join(job, "jax"),
                                        {"params": params_tree(res.model)})
        out["jax2port"] = {"step": step, "tier": tier,
                           "params": _full(restored)}
        for seed in (1, 2):
            state, _ = res.train_step(state, res.place_batch(_batch(seed)))
        tree = {"params": params_tree(res.model)}
        out["saved"] = _full(tree)
        path = os.path.join(job, "ep2")
        ckpt = _save(path, 2, tree, StorageType.DISK)
        _wait_commit(path, 2)
        # the same world restores from its own shm segment
        step, restored = ckpt.load_checkpoint(
            target_state={"params": params_tree(res.model)})
        out["shm"] = {"step": step, "tier": ckpt.last_restore_phases["tier"],
                      "params": _full(restored)}
        ckpt.close()
        return out
    source = {1: "ep2", 2: "ep1"}[world]
    step, restored, tier = _restore(os.path.join(job, source),
                                    {"params": params_tree(res.model)})
    out["restored"] = {"step": step, "tier": tier, "params": _full(restored)}
    if world == 1:
        state, _ = res.train_step(state, res.place_batch(_batch(3)))
        tree = {"params": params_tree(res.model)}
        out["saved"] = _full(tree)
        path = os.path.join(job, "ep1")
        _save(path, 3, tree, StorageType.DISK).close()
        _wait_commit(path, 3)
    # the next step from the expert-1 save, at expert 1 and at expert 2
    state, metrics = res.train_step(state, res.place_batch(_batch(4)))
    out["loss"] = float(metrics["loss"])
    return out


def _worker(rank, world, port, job):
    import torch
    import torch.distributed as dist

    from dlrover_tpu_torch.checkpoint.saver import AsyncCheckpointSaver
    from dlrover_tpu_torch.checkpoint.shm_handler import SharedMemoryHandler

    torch.set_num_threads(1)
    sockets = tempfile.mkdtemp(prefix="dlmk")
    os.environ.update({
        "DLROVER_SHARED_DIR": sockets,
        "DLROVER_JOB_NAME": f"mk-{uuid.uuid4().hex[:10]}",
        "DLROVER_NODE_RANK": str(rank), "DLROVER_RANK": str(rank),
        "DLROVER_WORLD_SIZE": str(world),
        "DLROVER_LOCAL_WORLD_SIZE": str(world),
    })
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    try:
        res = _run(rank, world, job)
        dist.barrier()
    finally:
        AsyncCheckpointSaver.reset()
        SharedMemoryHandler(0).unlink()
        shutil.rmtree(sockets, ignore_errors=True)
    dist.destroy_process_group()
    if rank == 0:
        with open(os.path.join(job, f"world_{world}.pkl"), "wb") as f:
            pickle.dump(res, f)


def _spawn(job, world):
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from torch_gloo import free_port

    env = {**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "1",
           "DLROVER_LOG_LEVEL": "ERROR"}
    port = free_port()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--worker", str(rank),
         str(world), str(port), job],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for rank in range(world)]
    try:
        logs = [p.communicate(timeout=TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    with open(os.path.join(job, f"world_{world}.pkl"), "rb") as f:
        return pickle.load(f)


# -- the JAX package, in this process -----------------------------------------


def _jax_expert_plan():
    import jax

    from dlrover_tpu.models.gpt import GPT, GPTConfig
    from dlrover_tpu.parallel.mesh import MeshConfig, build_mesh
    from dlrover_tpu.parallel.sharding import moe_rules, sharding_tree

    import jax.numpy as jnp

    model = GPT(GPTConfig.tiny(moe_experts=4, moe_every=2,
                               dtype=jnp.float32))
    params = model.init_params(jax.random.PRNGKey(0))
    mesh = build_mesh(MeshConfig(data=2, expert=2),
                      devices=jax.devices()[:4])
    return params, sharding_tree(params, mesh, moe_rules())


def _jax_flat(tree):
    import jax

    from dlrover_tpu.checkpoint.shm_handler import _flatten_state_dict

    return {k: np.asarray(v) for k, v in _flatten_state_dict(
        jax.tree.map(np.asarray, tree)).items()}


@pytest.fixture(scope="module")
def moe_rounds():
    import jax

    from dlrover_tpu.checkpoint.checkpointer import Checkpointer
    from dlrover_tpu.checkpoint.saver import AsyncCheckpointSaver as JaxSaver
    from dlrover_tpu.checkpoint.shm_handler import (
        SharedMemoryHandler as JaxShm,
    )

    job = tempfile.mkdtemp(prefix="dlmk_job")
    sockets = tempfile.mkdtemp(prefix="dlmj")
    old = {k: os.environ.get(k)
           for k in ("DLROVER_SHARED_DIR", "DLROVER_JOB_NAME")}
    os.environ["DLROVER_SHARED_DIR"] = sockets
    os.environ["DLROVER_JOB_NAME"] = f"mkj-{uuid.uuid4().hex[:10]}"
    try:
        params, shardings = _jax_expert_plan()
        placed = jax.device_put(params, shardings)
        JaxSaver.reset()
        ckpt = Checkpointer(os.path.join(job, "jax"), replicated=False)
        assert ckpt.save_checkpoint(1, {"params": placed})
        assert ckpt.wait()
        _wait_commit(os.path.join(job, "jax"), 1)
        ckpt.close()
        JaxSaver.reset()
        JaxShm(0).unlink()
        with open(os.path.join(job, "in.pkl"), "wb") as f:
            pickle.dump({"init": jax.tree.map(np.asarray, params)}, f)
        worlds = {world: _spawn(job, world) for world in (4, 1, 2)}
        # the port's world-4 checkpoint in the JAX package
        JaxSaver.reset()
        ckpt = Checkpointer(os.path.join(job, "ep2"), replicated=False)
        step, restored = ckpt.load_checkpoint(
            target_state={"params": placed})
        port2jax = {"step": step, "tier": ckpt.last_restore_phases["tier"],
                    "params": _jax_flat(restored),
                    "devices": len(jax.tree.leaves(
                        restored["params"])[0].sharding.device_set)}
        ckpt.close()
        JaxSaver.reset()
        yield {"worlds": worlds, "init": _jax_flat({"params": params}),
               "port2jax": port2jax}
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(sockets, ignore_errors=True)
        shutil.rmtree(job, ignore_errors=True)


def _same(got, want):
    assert set(got) == set(want)
    assert any("experts_w_in" in k for k in want)
    for key in want:
        assert got[key].tobytes() == np.asarray(want[key]).tobytes(), key


def test_jax_moe_checkpoint_restores_onto_expert_dtensors(moe_rounds):
    got = moe_rounds["worlds"][4]
    assert got["dtensor"] and got["local_experts"] == 2
    assert got["jax2port"]["step"] == 1
    assert got["jax2port"]["tier"] == "storage"
    _same(got["jax2port"]["params"], moe_rounds["init"])


def test_expert_checkpoint_restores_from_shm_at_the_same_world(moe_rounds):
    got = moe_rounds["worlds"][4]
    assert got["shm"]["step"] == 2 and got["shm"]["tier"] == "shm"
    _same(got["shm"]["params"], got["saved"])


def test_expert_checkpoint_restores_at_expert_1(moe_rounds):
    got = moe_rounds["worlds"][1]
    assert not got["dtensor"] and got["local_experts"] == 4
    assert got["restored"]["step"] == 2
    assert got["restored"]["tier"] == "storage"
    _same(got["restored"]["params"], moe_rounds["worlds"][4]["saved"])


def test_expert_checkpoint_restores_back_at_expert_2(moe_rounds):
    one, two = moe_rounds["worlds"][1], moe_rounds["worlds"][2]
    assert two["dtensor"] and two["local_experts"] == 2
    assert two["restored"]["step"] == 3
    assert two["restored"]["tier"] == "storage"
    _same(two["restored"]["params"], one["saved"])
    np.testing.assert_allclose(two["loss"], one["loss"], rtol=1e-6)


def test_port_moe_checkpoint_restores_in_the_jax_package(moe_rounds):
    got = moe_rounds["port2jax"]
    assert got["step"] == 2 and got["tier"] == "storage"
    assert got["devices"] == 4
    _same(got["params"], moe_rounds["worlds"][4]["saved"])


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        rank, world, port = (int(a) for a in sys.argv[2:5])
        _worker(rank, world, port, sys.argv[5])
