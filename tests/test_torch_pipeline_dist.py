"""The port's pipeline on gloo ranks against the JAX package.

One module-scoped spawn of this file (world 4, gloo over
``tcp://127.0.0.1``) runs the rank form of the pipeline, one stage a
rank, its activations and gradients sent point to point:

- the twins of ``tests/test_pipeline.py`` that use ``data``
  (``test_1f1b_with_data_parallel_matches_sequential``,
  ``test_1f1b_head_and_input_grads_under_data_parallel``) at pipeline 2
  x data 2, and GPipe and 1F1B at pipeline 4, against the JAX
  package's ``pipeline_apply`` / ``pipeline_train_step_1f1b`` on the
  virtual CPU devices, within 1e-5 in fp32;
- ``auto_accelerate`` with ``pipeline_parallel`` at pipeline 4 and at
  pipeline 2 x data 2 under both schedules (the twins of
  ``test_auto_accelerate_pipeline_strategy`` and
  ``test_auto_accelerate_1f1b_schedule_matches_gpipe``), a tiny GPT and
  a tiny Llama from the JAX init, SGD in fp32 for 4 steps: every step's
  loss equals the JAX package's unpipelined run's at rtol 1e-5 (and
  the JAX package's own pipeline 2 1F1B run's), the parameters after
  the last step at rtol 1e-4 / atol 1e-5, equal on every replica;
- the example twin (``dlrover_tpu_torch/examples/train_pipelined_lm.py``)
  on the spawn's group: its loss falls as the reference's does;
- the flash checkpoint of a pipelined state (pipeline 2 x data 2,
  AdamW): the stage-sharded ``blocks`` (DTensors) and the replicated
  embed and head saved by each rank, restored bit for bit onto a fresh
  plan; the JAX package's pipelined checkpoint restored bit for bit in
  the port, and the port's in the JAX package.
"""

import os
import pickle
import shutil
import sys
import tempfile
import time
import uuid

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_gloo import spawn  # noqa: E402

DIM, SEQ, BATCH, STEPS, LR = 8, 32, 8, 4, 0.05
CK_LR, CK_WD = 3e-4, 0.1
FP32 = ("amp_native", {"dtype": "float32"})
# (label, family, pipeline size, schedule); the rest of the world is data
PLANS = (("gpt_pp4_gpipe", "gpt", 4, "gpipe"),
         ("gpt_pp4_1f1b", "gpt", 4, "1f1b"),
         ("gpt_pp2dp2_gpipe", "gpt", 2, "gpipe"),
         ("gpt_pp2dp2_1f1b", "gpt", 2, "1f1b"),
         ("llama_pp2dp2_1f1b", "llama", 2, "1f1b"),
         ("llama_pp4_gpipe", "llama", 4, "gpipe"))
TRACKER = "latest_checkpointed_iteration.txt"


def _stage_np(n, seed):
    rng = np.random.default_rng(seed)
    return [{"w": (rng.normal(size=(DIM, DIM)) * 0.5).astype(np.float32),
             "b": (rng.normal(size=(DIM,)) * 0.1).astype(np.float32)}
            for _ in range(n)]


def _normal(seed, shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _functions_job():
    """The inputs of the function-level cases."""
    vocab = 16
    return {
        "pp4": {"stages": _stage_np(4, 4), "x": _normal(5, (8, DIM))},
        "pp4_head": {"stages": _stage_np(4, 40), "x": _normal(41, (8, DIM)),
                     "head": _normal(42, (DIM, vocab)) * 0.5,
                     "y": np.random.default_rng(43).integers(
                         0, vocab, (8,)).astype(np.int32)},
        "dp": {"stages": _stage_np(2, 30), "x": _normal(31, (16, DIM)),
               "y": _normal(32, (16, DIM))},
        "dp_head": {"stages": _stage_np(2, 50), "x": _normal(51, (16, DIM)),
                    "head": _normal(52, (DIM, vocab)) * 0.5,
                    "y": np.random.default_rng(53).integers(
                        0, vocab, (16,)).astype(np.int32)},
    }


def _batch():
    data = np.random.default_rng(0).integers(0, 256, (BATCH, SEQ + 1),
                                             dtype=np.int32)
    return {"x": data[:, :-1], "y": data[:, 1:]}


def _ck_batches():
    rng = np.random.default_rng(7)
    out = []
    for _ in range(2):
        data = rng.integers(0, 256, (BATCH, SEQ + 1), dtype=np.int32)
        out.append({"x": data[:, :-1], "y": data[:, 1:]})
    return out


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


# -- the port, in each rank -------------------------------------------------------


def _gather(t):
    import torch.distributed as dist

    t = t.detach().contiguous()
    out = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(out, t)
    return [o.numpy() for o in out]


def _port_stage_fn(params, x):
    return torch.tanh(x @ params["w"] + params["b"])


def _port_mse(out, y_mb):
    return torch.mean((out - y_mb) ** 2)


def _port_ce(hp, out, y_mb):
    return torch.nn.functional.cross_entropy(out @ hp["w"], y_mb.long())


def _functions(job):
    from dlrover_tpu_torch.parallel import pipeline as pp
    from dlrover_tpu_torch.parallel.mesh import MeshConfig, build_mesh

    res = {}
    for name, axes in (("pp4", dict(data=1, pipeline=4)),
                       ("pp4_head", dict(data=1, pipeline=4)),
                       ("dp", dict(data=2, pipeline=2)),
                       ("dp_head", dict(data=2, pipeline=2))):
        case = job["functions"][name]
        mesh = build_mesh(MeshConfig(**axes), device_type="cpu")
        coord = mesh.coordinate()
        s, d = coord["pipeline"], coord["data"]
        own = {k: torch.from_numpy(v) for k, v in case["stages"][s].items()}
        stacked = {k: v[None].clone().requires_grad_() for k, v in own.items()}
        rows = case["x"].shape[0] // axes["data"]
        x = torch.from_numpy(case["x"][d * rows:(d + 1) * rows])
        out = {"coord": _gather(torch.tensor([s, d]))}
        if name == "pp4":
            x = x.clone().requires_grad_()
            y = pp.pipeline_apply(_port_stage_fn, stacked, x, mesh,
                                  num_microbatches=2)
            (y ** 2).sum().backward()
            out.update(out=_gather(y), x_grad=_gather(x.grad),
                       **{k: _gather(v.grad) for k, v in stacked.items()})
        else:
            head = ({"w": torch.from_numpy(case["head"])} if "head" in case
                    else None)
            yall = torch.from_numpy(case["y"])
            y = yall[d * rows:(d + 1) * rows]
            r = pp.pipeline_train_step_1f1b(
                _port_stage_fn, _port_ce if head else _port_mse, stacked, x,
                y, mesh, num_microbatches=2 if axes["data"] > 1 else 4,
                batch_axis="data" if axes["data"] > 1 else None,
                head_params=head)
            out.update(loss=_gather(r.loss.reshape(1)),
                       input_grads=_gather(r.input_grads),
                       **{k: _gather(v) for k, v in r.stage_grads.items()})
            if head:
                out["head"] = _gather(r.head_grads["w"])
        res[name] = out
    return res


def _port_model(family, params):
    from dlrover_tpu_torch.models.gpt import GPT, GPTConfig
    from dlrover_tpu_torch.models.llama import Llama, LlamaConfig
    from dlrover_tpu_torch.utils.convert import params_from_jax

    if family == "gpt":
        model = GPT(GPTConfig.tiny(max_seq_len=SEQ, dtype=torch.float32),
                    device="cpu")
    else:
        model = Llama(LlamaConfig.tiny(dtype=torch.float32), device="cpu")
    model.load_state_dict(params_from_jax(params))
    return model


def _plan(family, params, stages, schedule, optimizer, batch):
    from dlrover_tpu_torch.accel import Strategy, auto_accelerate
    from dlrover_tpu_torch.models.gpt import cross_entropy_loss

    return auto_accelerate(
        _port_model(family, params), optimizer,
        lambda m, b: cross_entropy_loss(m(b["x"]), b["y"]), batch,
        strategy=Strategy(opts=[("pipeline_parallel", {
            "size": stages, "microbatches": 2, "schedule": schedule}),
            FP32]), device="cpu")


def _full_params(model):
    """Every parameter whole (a DTensor gathered), by flax path."""
    from dlrover_tpu_torch.utils.convert import flax_path

    out = {}
    for n, p in model.named_parameters():
        t = p.full_tensor() if hasattr(p, "full_tensor") else p
        out["/".join(flax_path(n))] = t.detach().numpy().copy()
    return out


def _plans(job):
    import torch.distributed as dist

    from dlrover_tpu_torch.common.device import is_dtensor

    res = {}
    for label, family, stages, schedule in PLANS:
        r = _plan(family, job[family], stages, schedule,
                  lambda ps: torch.optim.SGD(ps, lr=LR), job["batch"])
        placed = r.place_batch(job["batch"])
        state, losses = r.state, []
        for _ in range(STEPS):
            state, metrics = r.train_step(state, placed)
            losses.append(float(metrics["loss"]))
        flat = torch.cat([(p.to_local() if is_dtensor(p) else p)
                          .detach().reshape(-1)
                          for n, p in r.model.named_parameters()
                          if not n.startswith("blocks.")])
        spread = max(float(np.abs(e - flat.numpy()).max())
                     for e in _gather(flat))
        res[label] = {
            "losses": losses, "mesh": dict(r.mesh.shape),
            "notes": list(r.plan.notes), "placed": tuple(placed["x"].shape),
            "blocks_dtensor": all(is_dtensor(p) for n, p in
                                  r.model.named_parameters()
                                  if n.startswith("blocks.")),
            "replica_spread": spread,
            "params": _full_params(r.model)}
        dist.barrier()
    return res


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


def _adamw(ps):
    return torch.optim.AdamW(ps, lr=CK_LR, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=CK_WD)


def _checkpoint(job):
    """Restore the JAX package's pipelined checkpoint; train two steps
    from the init, save, restore onto a fresh plan."""
    from dlrover_tpu_torch.checkpoint.checkpointer import (
        Checkpointer,
        StorageType,
    )
    from dlrover_tpu_torch.checkpoint.saver import AsyncCheckpointSaver
    from dlrover_tpu_torch.utils.convert import adamw_state_from_tree

    batches = job["ck_batches"]
    res = {}
    plan = _plan("gpt", job["gpt"], 2, "gpipe", _adamw, batches[0])
    AsyncCheckpointSaver.reset()
    ckpt = Checkpointer(os.path.join(job["dir"], "jax"), replicated=False)
    step, restored = ckpt.load_checkpoint(target_state=_tree(plan))
    ckpt.close()
    adamw_state_from_tree(restored["opt_state"], plan.state.optimizer,
                          plan.model)
    res["jax2port"] = {"step": step, "restored": _full_flat(restored),
                       "tier": ckpt.last_restore_phases["tier"]}
    plan = _plan("gpt", job["gpt"], 2, "gpipe", _adamw, batches[0])
    state = plan.state
    for batch in batches:
        state, _ = plan.train_step(state, plan.place_batch(batch))
    AsyncCheckpointSaver.reset()
    path = os.path.join(job["dir"], "port")
    ckpt = Checkpointer(path, replicated=False)
    assert ckpt.save_checkpoint(2, _tree(plan), storage_type=StorageType.DISK)
    assert ckpt.wait()
    _wait_commit(path, 2)
    ckpt.close()
    res["saved"] = _full_flat(_tree(plan))
    fresh = _plan("gpt", job["gpt"], 2, "gpipe", _adamw, batches[0])
    AsyncCheckpointSaver.reset()
    ckpt = Checkpointer(path, replicated=False)
    step, restored = ckpt.load_checkpoint(target_state=_tree(fresh))
    ckpt.close()
    adamw_state_from_tree(restored["opt_state"], fresh.state.optimizer,
                          fresh.model)
    res["restored"] = {"step": step, "flat": _full_flat(_tree(fresh))}
    return res


def _worker(rank, world, port, in_path, out_path):
    import torch.distributed as dist

    from dlrover_tpu_torch.checkpoint.saver import AsyncCheckpointSaver
    from dlrover_tpu_torch.checkpoint.shm_handler import SharedMemoryHandler
    from dlrover_tpu_torch.examples import train_pipelined_lm

    torch.set_num_threads(1)
    sockets = tempfile.mkdtemp(prefix="dlpp")
    os.environ.update({
        "DLROVER_SHARED_DIR": sockets,
        "DLROVER_JOB_NAME": f"pp-{uuid.uuid4().hex[:10]}",
        "DLROVER_NODE_RANK": str(rank), "DLROVER_RANK": str(rank),
        "DLROVER_WORLD_SIZE": str(world),
        "DLROVER_LOCAL_WORLD_SIZE": str(world),
    })
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    with open(in_path, "rb") as f:
        job = pickle.load(f)
    try:
        res = {"functions": _functions(job), "plans": _plans(job),
               "example": train_pipelined_lm.main(["--device", "cpu"]),
               "checkpoint": _checkpoint(job)}
        dist.barrier()
    finally:
        AsyncCheckpointSaver.reset()
        SharedMemoryHandler(0).unlink()
        shutil.rmtree(sockets, ignore_errors=True)
    dist.destroy_process_group()
    if rank == 0:
        with open(out_path, "wb") as f:
            pickle.dump(res, f)


# -- the JAX package, in this process ----------------------------------------------


def _jax_functions(job):
    import jax
    import jax.numpy as jnp

    from dlrover_tpu.parallel.mesh import MeshConfig, build_mesh
    from dlrover_tpu.parallel.pipeline import (
        pipeline_apply,
        pipeline_train_step_1f1b,
        stack_stage_params,
    )

    def stage_fn(params, x):
        return jnp.tanh(x @ params["w"] + params["b"])

    def mse(out, y):
        return jnp.mean((out - y) ** 2)

    def ce(hp, out, y):
        logp = jax.nn.log_softmax(out @ hp["w"], axis=-1)
        return -jnp.take_along_axis(logp, y[:, None], axis=-1).mean()

    def stacked(case):
        return stack_stage_params([{k: jnp.asarray(v) for k, v in s.items()}
                                   for s in case["stages"]])

    out = {}
    case = job["pp4"]
    mesh = build_mesh(MeshConfig(data=-1, pipeline=4))

    def loss(p, x):
        return (pipeline_apply(stage_fn, p, x, mesh,
                               num_microbatches=2) ** 2).sum()

    y = pipeline_apply(stage_fn, stacked(case), jnp.asarray(case["x"]),
                       mesh, num_microbatches=2)
    g, gx = jax.grad(loss, argnums=(0, 1))(stacked(case),
                                           jnp.asarray(case["x"]))
    out["pp4"] = {"out": np.asarray(y), "x_grad": np.asarray(gx),
                  **{k: np.asarray(v) for k, v in g.items()}}
    for name, axes, micro, batch_axis in (
            ("pp4_head", dict(data=-1, pipeline=4), 4, None),
            ("dp", dict(data=2, pipeline=2), 2, "data"),
            ("dp_head", dict(data=2, pipeline=2), 2, "data")):
        case = job[name]
        n = axes["data"] * axes["pipeline"] if axes["data"] > 0 else 8
        mesh = build_mesh(MeshConfig(**axes), devices=jax.devices()[:n])
        head = {"w": jnp.asarray(case["head"])} if "head" in case else None
        r = pipeline_train_step_1f1b(
            stage_fn, ce if head else mse, stacked(case),
            jnp.asarray(case["x"]), jnp.asarray(case["y"]), mesh,
            num_microbatches=micro, batch_axis=batch_axis, head_params=head)
        out[name] = {"loss": float(r.loss),
                     "input_grads": np.asarray(r.input_grads),
                     **{k: np.asarray(v) for k, v in r.stage_grads.items()}}
        if head:
            out[name]["head"] = np.asarray(r.head_grads["w"])
    return out


def _jax_model(family):
    import jax.numpy as jnp

    from dlrover_tpu.models import gpt as jax_gpt
    from dlrover_tpu.models import llama as jax_llama

    if family == "gpt":
        return jax_gpt.GPT(jax_gpt.GPTConfig.tiny(max_seq_len=SEQ,
                                                  dtype=jnp.float32))
    return jax_llama.Llama(jax_llama.LlamaConfig.tiny(dtype=jnp.float32))


def _jax_accelerate(family, params, opts, devices, optimizer, batch):
    import jax
    import jax.numpy as jnp

    from dlrover_tpu.accel import Strategy, auto_accelerate
    from dlrover_tpu.models import gpt as jax_gpt

    # the context draws the init from PRNGKey(0), as ``params`` was
    model = _jax_model(family)

    def loss_fn(p, b, model=model):
        return jax_gpt.cross_entropy_loss(model.apply({"params": p}, b["x"]),
                                          b["y"])

    return auto_accelerate(
        model, optimizer, loss_fn, jax.tree.map(jnp.asarray, batch),
        strategy=Strategy(opts=opts), devices=devices)


def _jax_flat(tree):
    import jax

    from dlrover_tpu.checkpoint.shm_handler import _flatten_state_dict

    return {k: np.asarray(v) for k, v in _flatten_state_dict(
        jax.tree.map(np.asarray, tree)).items()}


def _jax_runs(job):
    """The unpipelined runs of both families and the pipeline 2 1F1B GPT
    run (SGD), then the pipelined AdamW run whose step 2 is saved."""
    import jax
    import optax

    from dlrover_tpu.checkpoint.checkpointer import Checkpointer
    from dlrover_tpu.models.gpt import partition_pipeline_params

    out = {}
    for label, family, opts, n in (
            ("gpt_dense", "gpt", [("parallel_mode", {}), FP32], 1),
            ("llama_dense", "llama", [("parallel_mode", {}), FP32], 1),
            ("gpt_pp2_1f1b", "gpt", [("pipeline_parallel", {
                "size": 2, "microbatches": 2, "schedule": "1f1b"}), FP32], 4)):
        r = _jax_accelerate(family, job[family], opts, jax.devices()[:n],
                            lambda: optax.sgd(LR), job["batch"])
        state, losses = r.state, []
        placed = r.place_batch(jax.tree.map(np.asarray, job["batch"]))
        for _ in range(STEPS):
            state, m = r.train_step(state, placed)
            losses.append(float(m["loss"]))
        params = state.params
        if n == 1:
            layers = r.model.config.num_layers
            params = {s: partition_pipeline_params(params, s, layers)
                      for s in (2, 4)}
        out[label] = {"losses": losses,
                      "params": jax.tree.map(np.asarray, params)}
    r = _jax_accelerate("gpt", job["gpt"], [("pipeline_parallel", {
        "size": 2, "microbatches": 2}), FP32], jax.devices()[:4],
        lambda: optax.adamw(CK_LR, weight_decay=CK_WD), job["ck_batches"][0])
    state = r.state
    for batch in job["ck_batches"]:
        state, _ = r.train_step(state, r.place_batch(
            jax.tree.map(np.asarray, batch)))
    tree = {"params": state.params, "opt_state": state.opt_state}
    ckpt = Checkpointer(os.path.join(job["dir"], "jax"), replicated=False)
    assert ckpt.save_checkpoint(2, tree)
    assert ckpt.wait()
    _wait_commit(os.path.join(job["dir"], "jax"), 2)
    ckpt.close()
    out["ckpt_saved"] = _jax_flat(tree)
    return out


@pytest.fixture(scope="module")
def world():
    import jax

    from dlrover_tpu.checkpoint.saver import AsyncCheckpointSaver as JaxSaver
    from dlrover_tpu.checkpoint.shm_handler import (
        SharedMemoryHandler as JaxShm,
    )

    job_dir = tempfile.mkdtemp(prefix="dlpp_job")
    sockets = tempfile.mkdtemp(prefix="dlppj")
    old = {k: os.environ.get(k)
           for k in ("DLROVER_SHARED_DIR", "DLROVER_JOB_NAME")}
    os.environ["DLROVER_SHARED_DIR"] = sockets
    os.environ["DLROVER_JOB_NAME"] = f"ppj-{uuid.uuid4().hex[:10]}"
    try:
        job = {"functions": _functions_job(), "batch": _batch(),
               "ck_batches": _ck_batches(), "dir": job_dir}
        for family in ("gpt", "llama"):
            job[family] = jax.tree.map(np.asarray, _jax_model(
                family).init_params(jax.random.PRNGKey(0)))
        JaxSaver.reset()
        ref = {"functions": _jax_functions(job["functions"]),
               **_jax_runs(job)}
        JaxSaver.reset()
        JaxShm(0).unlink()
        got = spawn(job, os.path.abspath(__file__), world=4, timeout=420)
        yield {"job": job, "ref": ref, "got": got}
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(sockets, ignore_errors=True)
        shutil.rmtree(job_dir, ignore_errors=True)


TOL = dict(rtol=1e-5, atol=1e-5)


def _by_stage(gathered, coords, stages, data=0):
    """One value a stage from all-gathered per-rank values."""
    return np.stack([gathered[i][0] for s in range(stages)
                     for i, (cs, cd) in enumerate(coords)
                     if cs == s and cd == data])


def test_pipeline_rank_form_matches_the_reference(world):
    """GPipe (output, stage and input gradients) and 1F1B with a head
    (loss, stage, head and input gradients) at pipeline 4, one stage a
    rank."""
    got, want = world["got"]["functions"], world["ref"]["functions"]
    g, w = got["pp4"], want["pp4"]
    coords = [tuple(c) for c in g["coord"]]
    for out in g["out"]:  # replicated over the stages
        np.testing.assert_allclose(out, w["out"], **TOL)
    for x_grad in g["x_grad"]:
        np.testing.assert_allclose(x_grad, w["x_grad"], **TOL)
    for k in ("w", "b"):
        np.testing.assert_allclose(_by_stage(g[k], coords, 4), w[k], **TOL)
    g, w = got["pp4_head"], want["pp4_head"]
    for k in ("w", "b"):
        np.testing.assert_allclose(_by_stage(g[k], coords, 4), w[k], **TOL)
    for r in range(4):
        np.testing.assert_allclose(g["loss"][r][0], w["loss"], rtol=1e-5)
        np.testing.assert_allclose(g["head"][r], w["head"], **TOL)
        np.testing.assert_allclose(g["input_grads"][r], w["input_grads"],
                                   **TOL)


@pytest.mark.parametrize("case", ["dp", "dp_head"])
def test_1f1b_under_data_parallel_matches_the_reference(world, case):
    """Twins of ``test_1f1b_with_data_parallel_matches_sequential`` and
    ``test_1f1b_head_and_input_grads_under_data_parallel`` at pipeline 2
    x data 2: the loss and gradients are the global mean, the input
    gradients each data row's, carrying 1/dp."""
    g, w = world["got"]["functions"][case], world["ref"]["functions"][case]
    coords = [tuple(c) for c in g["coord"]]
    for k in ("w", "b"):
        for d in (0, 1):
            np.testing.assert_allclose(_by_stage(g[k], coords, 2, d), w[k],
                                       **TOL)
    for r, (s, d) in enumerate(coords):
        np.testing.assert_allclose(g["loss"][r][0], w["loss"], rtol=1e-5)
        rows = w["input_grads"].shape[0] // 2
        np.testing.assert_allclose(g["input_grads"][r],
                                   w["input_grads"][d * rows:(d + 1) * rows],
                                   **TOL)
        if "head" in g:
            np.testing.assert_allclose(g["head"][r], w["head"], **TOL)


@pytest.mark.parametrize("label,family,stages,schedule", PLANS,
                         ids=[p[0] for p in PLANS])
def test_auto_accelerate_pipeline_plans_match_the_reference(
        world, label, family, stages, schedule):
    """Twins of ``test_auto_accelerate_pipeline_strategy`` and
    ``test_auto_accelerate_1f1b_schedule_matches_gpipe``: the plan's
    mesh, the stage-sharded blocks, every step's loss against the JAX
    package's unpipelined run (and its pipeline 2 1F1B run), the
    parameters after 4 SGD steps, equal on every replica."""
    got = world["got"]["plans"][label]
    ref = world["ref"]
    assert got["mesh"]["pipeline"] == stages
    assert got["mesh"]["data"] == 4 // stages
    assert got["blocks_dtensor"]
    assert got["placed"] == (BATCH * stages // 4, SEQ)
    assert got["replica_spread"] == 0.0
    if schedule == "1f1b":
        assert "1f1b: user loss_fn bypassed (fused next-token CE)" in \
            got["notes"]
    dense = ref[f"{family}_dense"]
    np.testing.assert_allclose(got["losses"], dense["losses"], rtol=1e-5)
    assert got["losses"][-1] < got["losses"][0]
    if label == "gpt_pp2dp2_1f1b":
        np.testing.assert_allclose(got["losses"],
                                   ref["gpt_pp2_1f1b"]["losses"], rtol=1e-5)
    want = {}

    def flat(tree, prefix=()):
        for k, v in tree.items():
            if isinstance(v, dict):
                flat(v, prefix + (k,))
            else:
                want["/".join(prefix + (k,))] = v

    flat(dense["params"][stages])
    assert set(got["params"]) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got["params"][k], v, rtol=1e-4,
                                   atol=1e-5, err_msg=k)


def test_example_twin_learns_its_mapping(world):
    """``train_pipelined_lm.py`` at pipeline 4 on the spawn's group: the
    reference's 60 steps of Adam on ``label = token + 1``."""
    losses = world["got"]["example"]
    assert len(losses) == 60 and all(np.isfinite(losses))
    assert losses[-1] < 0.05 * losses[0], losses


def test_pipelined_checkpoint_restores_bit_for_bit(world):
    """The port's pipelined state (stage-sharded blocks, replicated
    embed and head, AdamW moments) saved at pipeline 2 x data 2 and
    restored onto a fresh plan of the same layout."""
    ck = world["got"]["checkpoint"]
    assert ck["restored"]["step"] == 2
    saved, got = ck["saved"], ck["restored"]["flat"]
    assert set(got) == set(saved)
    assert any(k.startswith("params/blocks/") for k in saved)
    for k in saved:
        assert got[k].tobytes() == saved[k].tobytes(), k


def test_pipelined_checkpoint_crosses_the_packages(world):
    """The JAX package's pipelined checkpoint (pipeline 2 on 4 devices)
    restores bit for bit in the port; the port's in the JAX package,
    onto its own pipelined state."""
    import jax
    import optax

    from dlrover_tpu.checkpoint.checkpointer import Checkpointer
    from dlrover_tpu.checkpoint.saver import AsyncCheckpointSaver as JaxSaver

    ck = world["got"]["checkpoint"]["jax2port"]
    want = world["ref"]["ckpt_saved"]
    assert ck["step"] == 2 and ck["tier"] == "storage"
    assert set(ck["restored"]) == set(want)
    for k in want:
        assert ck["restored"][k].tobytes() == want[k].tobytes(), k

    job = world["job"]
    r = _jax_accelerate("gpt", job["gpt"], [("pipeline_parallel", {
        "size": 2, "microbatches": 2}), FP32], jax.devices()[:4],
        lambda: optax.adamw(CK_LR, weight_decay=CK_WD), job["ck_batches"][0])
    JaxSaver.reset()
    ckpt = Checkpointer(os.path.join(job["dir"], "port"), replicated=False)
    step, restored = ckpt.load_checkpoint(target_state={
        "params": r.state.params, "opt_state": r.state.opt_state})
    ckpt.close()
    JaxSaver.reset()
    assert step == 2
    got = _jax_flat(restored)
    saved = world["got"]["checkpoint"]["saved"]
    assert set(got) == set(saved)
    for k in saved:
        assert got[k].tobytes() == saved[k].tobytes(), k


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        _worker(int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]),
                sys.argv[5], sys.argv[6])
