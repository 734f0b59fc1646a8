"""The port's MoE layer against the JAX package's.

Twins of ``tests/test_moe.py``: the gating math (top-1 and top-2,
slots across choices, capacity dropping) held against the reference's
``top_k_gating`` on the same numpy logits (dispatch and combine exact,
the aux loss at 1e-6), ``MoEMLP`` forward, aux loss and gradients in
fp32 against the reference's from its own init (atol 1e-5; gradients
1e-5 relative to their size), and the MoE GPT on an expert mesh.  The
logits are drawn from a continuous distribution, so top-k meets no tie
(``jax.lax.top_k`` and ``torch.topk`` may break ties differently).

Added: the expert kernels' init std (within 3% of 1/sqrt(fan-in) for
each expert), ``no_drop``'s capacity, and a gloo run of world 4 (data 2
x expert 2, one spawn of this file) whose loss and gradients must match
the reference's ``MoEMLP`` on a 4-device mesh over the same global
batch, at a capacity factor of 1.0 so that tokens drop: a port that
gated each rank's tokens on their own would drop others.  The same
spawn runs the MoE GPT's first step under ``auto_accelerate`` at
expert 4 against the reference's loss on the same params, and the
strategy search's expert and ring variants composed with FSDP2 (and
Ulysses with data parallelism) against one process's losses, and a
``Trainer`` over expert-sharded plans, which trains and checkpoints
them (the expert kernels DTensors; ``test_torch_moe_ckpt.py`` restores
such checkpoints across expert worlds).
"""

import os
import pickle
import sys
import tempfile

import numpy as np
import pytest
import torch
from torch_gloo import spawn

WORLD = 4
# the gloo parity: (b, s, d, mlp, e, k, capacity factor)
PARITY = (4, 16, 32, 64, 4, 2, 1.0)
# plans of the strategy search's expert and ring variants (the tensor
# slot of a factorization taken by expert or sequence parallelism)
COMPOSED = {
    "fsdp2_expert2": [("mixed_parallel", {"fsdp": 2, "expert": 2,
                                          "data": -1})],
    "fsdp2_ring2": [("fsdp", {"size": 2}),
                    ("sequence_parallel", {"size": 2, "mode": "ring"})],
    "data2_ulysses2": [("parallel_mode", {}),
                       ("sequence_parallel", {"size": 2,
                                              "mode": "ulysses"})],
}
# expert-sharded plans whose Trainer checkpoints the expert DTensors
REFUSED = {
    "data2_expert2": [("mixed_parallel", {"expert": 2, "data": -1})],
    "fsdp2_expert2": COMPOSED["fsdp2_expert2"],
}


def _logits(t, e, seed):
    return np.random.default_rng(seed).standard_normal((t, e)).astype(
        np.float32)


def _gating(logits, k, cap):
    import jax.numpy as jnp

    from dlrover_tpu.parallel.moe import top_k_gating as jax_gating
    from dlrover_tpu_torch.parallel.moe import top_k_gating

    ref = [np.asarray(x) for x in jax_gating(jnp.asarray(logits), k, cap)]
    got = [x.detach().numpy() for x in top_k_gating(
        torch.from_numpy(logits), k, cap)]
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_allclose(got[1], ref[1], atol=1e-7, rtol=0)
    np.testing.assert_allclose(got[2], ref[2], rtol=1e-6)
    return got


def test_top1_gating_routes_every_token_with_capacity():
    logits = _logits(16, 4, 0)
    dispatch, combine, aux = _gating(logits, 1, 16)
    np.testing.assert_allclose(dispatch.sum(axis=(1, 2)), np.ones(16))
    gates = torch.softmax(torch.from_numpy(logits), -1).numpy()
    np.testing.assert_allclose(combine.sum(axis=(1, 2)), gates.max(-1),
                               atol=1e-6)
    assert float(aux) > 0


def test_top2_combine_weights_normalized():
    dispatch, combine, _ = _gating(_logits(32, 4, 1), 2, 32)
    np.testing.assert_allclose(combine.sum(axis=(1, 2)), np.ones(32),
                               atol=1e-5)
    assert dispatch.sum(axis=(1, 2)).max() <= 2 + 1e-6


def test_top2_slots_never_collide_across_choices():
    dispatch, _, _ = _gating(_logits(64, 4, 7), 2, 64)
    assert dispatch.sum(axis=0).max() <= 1 + 1e-6
    np.testing.assert_allclose(dispatch.sum(axis=(1, 2)), np.full(64, 2.0))


def test_capacity_drops_overflow_tokens():
    t = 16
    logits = np.stack([np.full(t, 10.0), np.full(t, -10.0)],
                      axis=1).astype(np.float32)
    dispatch, combine, _ = _gating(logits, 1, 4)
    assert float(dispatch[:, 0].sum()) == 4.0
    assert (combine.sum(axis=(1, 2)) > 0).sum() == 4


def _jax_layer(gated, e=4, d=32, h=64, k=2, cf=1.25, seed=3, x=None):
    import jax
    import jax.numpy as jnp

    from dlrover_tpu.parallel.moe import MoEMLP as JaxMoE

    layer = JaxMoE(num_experts=e, hidden_dim=d, mlp_dim=h, top_k=k,
                   capacity_factor=cf, gated=gated, dtype=jnp.float32,
                   param_dtype=jnp.float32)
    params = layer.init(jax.random.PRNGKey(seed), jnp.asarray(x))["params"]
    return layer, jax.tree.map(np.asarray, params)


def _port_layer(params, gated, e=4, d=32, h=64, k=2, cf=1.25):
    from dlrover_tpu_torch.parallel.moe import MoEMLP

    layer = MoEMLP(num_experts=e, hidden_dim=d, mlp_dim=h, top_k=k,
                   capacity_factor=cf, gated=gated, dtype=torch.float32,
                   device="cpu")
    with torch.no_grad():
        layer.router.weight.copy_(torch.tensor(params["router"]["kernel"]))
        for name in layer.expert_kernels():
            getattr(layer, name).copy_(torch.tensor(params[name]))
    return layer


@pytest.mark.parametrize("gated", [False, True])
def test_moe_mlp_forward_and_grad(gated):
    import jax
    import jax.numpy as jnp

    from dlrover_tpu.parallel.moe import collect_moe_aux_loss as jax_aux
    from dlrover_tpu_torch.parallel.moe import collect_moe_aux_loss

    x = np.random.default_rng(2).standard_normal((2, 16, 32)).astype(
        np.float32)
    layer, params = _jax_layer(gated, x=x)

    def loss(p):
        y, st = layer.apply({"params": p}, jnp.asarray(x),
                            mutable=["intermediates"])
        return (y ** 2).sum(), (y, jax_aux(st["intermediates"]))

    (_, (y_ref, aux_ref)), g_ref = jax.jit(jax.value_and_grad(
        loss, has_aux=True))(params)
    port = _port_layer(params, gated)
    y = port(torch.from_numpy(x))
    aux = collect_moe_aux_loss(port)
    assert y.shape == x.shape and float(aux.detach()) > 0
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_ref),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(float(aux.detach()), float(aux_ref),
                               rtol=1e-6)
    (y ** 2).sum().backward()
    want = {"router": g_ref["router"]["kernel"],
            **{n: g_ref[n] for n in port.expert_kernels()}}
    got = {"router": port.router.weight.grad,
           **{n: getattr(port, n).grad for n in port.expert_kernels()}}
    for name, ref in want.items():
        ref = np.asarray(ref)
        assert np.isfinite(got[name].numpy()).all()
        np.testing.assert_allclose(got[name].numpy(), ref, rtol=1e-4,
                                   atol=1e-5 * np.abs(ref).max(),
                                   err_msg=name)


def test_expert_init_std_is_per_expert_fan_in():
    """Each expert's kernel has std 1/sqrt(its fan-in) within 3% (the
    expert dim is a batch axis: counting it in the fan-in would shrink
    the std by sqrt(e)), as the reference's ``variance_scaling``."""
    from dlrover_tpu_torch.models.gpt import init_flax_weights
    from dlrover_tpu_torch.parallel.moe import MoEMLP

    layer = MoEMLP(num_experts=8, hidden_dim=256, mlp_dim=512, gated=True,
                   device="cpu")
    init_flax_weights(layer, torch.Generator().manual_seed(0))
    for name, fan_in in (("experts_w_in", 256), ("experts_w_gate", 256),
                         ("experts_w_out", 512)):
        w = getattr(layer, name).detach()
        for i in range(8):
            std = float(w[i].std())
            assert abs(std * fan_in ** 0.5 - 1.0) < 0.03, (name, i, std)
            assert float(w[i].abs().max()) <= 2 / 0.8796256610342398 / \
                fan_in ** 0.5 + 1e-6


@pytest.mark.parametrize("b,s,want", [
    (2, 1, 2),        # one-token steps: every token keeps its slots
    (2, 8, 16),       # a chunk under 512 tokens: t slots
    (4, 256, 640),    # 1024 tokens: the trained capacity (2*1024*1.25/4)
])
def test_no_drop_capacity(b, s, want):
    from dlrover_tpu_torch.parallel.moe import MoEMLP

    layer = MoEMLP(num_experts=4, hidden_dim=8, mlp_dim=16, no_drop=True,
                   device="cpu")
    assert layer._capacity(b * s, s) == max(want, min(b * s, 512 if s > 1
                                                      else 2048))
    plain = MoEMLP(num_experts=4, hidden_dim=8, mlp_dim=16, device="cpu")
    assert plain._capacity(b * s, s) == max(1, int(2 * b * s * 1.25 / 4))


# -- gloo world 4 -------------------------------------------------------------


def _parity_inputs():
    b, s, d, h, e, k, cf = PARITY
    x = np.random.default_rng(11).standard_normal((b, s, d)).astype(
        np.float32)
    return x


def _worker(rank, world, port, in_path, out_path):
    import torch.distributed as dist

    from dlrover_tpu_torch.accel import Strategy, auto_accelerate
    from dlrover_tpu_torch.accel.accelerate import _grad_allreduce
    from dlrover_tpu_torch.models.gpt import GPT, GPTConfig, cross_entropy_loss
    from dlrover_tpu_torch.parallel.mesh import MeshConfig, build_mesh
    from dlrover_tpu_torch.parallel.moe import (
        attach_mesh,
        collect_moe_aux_loss,
    )
    from dlrover_tpu_torch.utils.convert import params_from_jax

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    with open(in_path, "rb") as f:
        job = pickle.load(f)
    results = {}

    # MoEMLP at data 2 x expert 2: the global batch's rows over data
    b, s, d, h, e, k, cf = PARITY
    mesh = build_mesh(MeshConfig(data=2, expert=2), device_type="cpu")
    layer = _port_layer(job["moe_params"], True, e, d, h, k, cf)
    attach_mesh(layer, mesh)
    coord = mesh.coordinate()
    rows = b // 2
    x = torch.from_numpy(job["x"][coord["data"] * rows:
                                  (coord["data"] + 1) * rows])
    y = layer(x)
    loss = (y ** 2).mean() + 0.01 * collect_moe_aux_loss(layer)
    loss.backward()
    _grad_allreduce(mesh, ["data"])(layer)
    total = loss.detach().clone()
    dist.all_reduce(total, group=mesh.group("data"))
    grads = {"router": layer.router.weight.grad}
    for name in layer.expert_kernels():
        # the experts are DTensors over the expert axis: their gradient
        # gathered over it
        grads[name] = getattr(layer, name).grad.full_tensor()
    results["moe"] = {"loss": float(total) / 2,
                      "local_experts": layer.experts_w_in.to_local().shape[0],
                      "grads": {n: g.numpy() for n, g in grads.items()}}

    # the MoE GPT at expert 4 through auto_accelerate, fp32
    cfg = GPTConfig.tiny(moe_experts=4, moe_every=2, dtype=torch.float32)
    model = GPT(cfg, device="cpu")
    model.load_state_dict(params_from_jax(job["gpt_params"]))

    def loss_fn(module, batch):
        ce = cross_entropy_loss(module(batch["x"]), batch["y"])
        return ce + 0.01 * collect_moe_aux_loss(module)

    res = auto_accelerate(
        model, lambda ps: torch.optim.Adam(ps, lr=1e-3), loss_fn,
        job["gpt_batch"], strategy=Strategy(opts=[
            ("mixed_parallel", {"expert": 4, "data": -1}),
            ("amp_native", {"dtype": "float32"})]), device="cpu")
    state, metrics = res.train_step(res.state, res.place_batch(
        job["gpt_batch"]))
    results["gpt"] = {"loss": float(metrics["loss"]),
                      "mesh": dict(res.mesh.shape),
                      "local_experts": res.model.blocks[1].moe
                      .experts_w_in.to_local().shape[0]}

    # the search's expert and ring variants composed with FSDP2, and
    # Ulysses with data parallelism: three SGD steps of the MoE GPT
    data = job["composed_batch"]
    batch = {"x": data[:, :-1], "y": data[:, 1:]}
    results["composed"] = {}
    for label, opts in COMPOSED.items():
        model = GPT(GPTConfig.tiny(max_seq_len=64, moe_experts=4,
                                   moe_every=2), device="cpu", seed=0)
        res = auto_accelerate(
            model, lambda ps: torch.optim.SGD(ps, lr=0.1), loss_fn, batch,
            strategy=Strategy(opts=opts + [
                ("amp_native", {"dtype": "float32"})]), device="cpu")
        state, placed, losses = res.state, res.place_batch(batch), []
        for _ in range(3):
            state, metrics = res.train_step(state, placed)
            losses.append(float(metrics["loss"]))
        results["composed"][label] = {"losses": losses,
                                      "mesh": dict(res.mesh.shape)}

    # the Trainer trains and checkpoints expert-sharded state, the experts
    # DTensors over the expert axis (and fsdp under FSDP2)
    from dlrover_tpu_torch.common.device import is_dtensor
    from dlrover_tpu_torch.trainer.trainer import Trainer, TrainingArguments

    import shutil
    import time
    import uuid

    from dlrover_tpu_torch.checkpoint.saver import AsyncCheckpointSaver
    from dlrover_tpu_torch.checkpoint.shm_handler import SharedMemoryHandler

    # each rank a node of its own with its own saver, sharing one output
    # directory (as tests/test_torch_sharded_ckpt.py runs them)
    sockets = tempfile.mkdtemp(prefix="dlmo")
    os.environ.update({"DLROVER_SHARED_DIR": sockets,
                       "DLROVER_NODE_RANK": str(rank),
                       "DLROVER_RANK": str(rank),
                       "DLROVER_WORLD_SIZE": str(world),
                       "DLROVER_LOCAL_WORLD_SIZE": str(world)})
    results["refused"] = {}
    for label, opts in REFUSED.items():
        os.environ["DLROVER_JOB_NAME"] = f"mo-{uuid.uuid4().hex[:10]}"
        out_dir = [tempfile.mkdtemp(prefix="moe_trainer_")]
        dist.broadcast_object_list(out_dir)
        out_dir = out_dir[0]
        trainer = Trainer(
            GPT(GPTConfig.tiny(max_seq_len=64, moe_experts=4, moe_every=2),
                device="cpu", seed=0),
            TrainingArguments(output_dir=out_dir, max_steps=2, save_steps=1,
                              resume_from_checkpoint=False,
                              strategy=Strategy(opts=opts + [
                                  ("amp_native", {"dtype": "float32"})])),
            [batch], loss_fn, device="cpu")
        try:
            out = trainer.train()
            error = None
        except NotImplementedError as e:
            error, out = str(e), {}
        tracker = os.path.join(out_dir, "latest_checkpointed_iteration.txt")
        deadline = time.time() + 60
        while rank == 0 and not os.path.exists(tracker) \
                and time.time() < deadline:
            time.sleep(0.05)
        dist.barrier()
        kernel = trainer.model.blocks[1].moe.experts_w_in
        results["refused"][label] = {
            "error": error, "written": sorted(os.listdir(out_dir)),
            "losses": out.get("losses"),
            "dtensor": is_dtensor(kernel), "local_experts": (
                kernel.to_local() if is_dtensor(kernel) else kernel).shape[0]}
        AsyncCheckpointSaver.reset()
        SharedMemoryHandler(0).unlink()
    shutil.rmtree(sockets, ignore_errors=True)
    dist.barrier()
    dist.destroy_process_group()
    if rank == 0:
        with open(out_path, "wb") as f:
            pickle.dump(results, f)


def _gpt_job():
    import jax
    import jax.numpy as jnp

    from dlrover_tpu.models.gpt import GPT, GPTConfig

    model = GPT(GPTConfig.tiny(moe_experts=4, moe_every=2,
                               dtype=jnp.float32))
    params = jax.tree.map(np.asarray,
                          model.init_params(jax.random.PRNGKey(0)))
    data = np.random.default_rng(0).integers(0, 256, (8, 17),
                                             dtype=np.int32)
    return model, params, {"x": data[:, :-1], "y": data[:, 1:]}


@pytest.fixture(scope="module")
def world4():
    """The jobs, the gloo spawn's results and the reference's values."""
    x = _parity_inputs()
    b, s, d, h, e, k, cf = PARITY
    layer, moe_params = _jax_layer(True, e, d, h, k, cf, seed=5, x=x)
    gpt, gpt_params, gpt_batch = _gpt_job()
    composed = np.random.default_rng(0).integers(0, 256, (8, 65),
                                                 dtype=np.int32)
    got = spawn({"x": x, "moe_params": moe_params, "gpt_params": gpt_params,
                 "gpt_batch": gpt_batch, "composed_batch": composed},
                os.path.abspath(__file__))
    return got, (layer, moe_params, x), (gpt, gpt_params, gpt_batch)


def test_moe_parity_on_data_and_expert_mesh(world4):
    """Data 2 x expert 2 on gloo against the reference's MoEMLP on a
    4-device (data 2, expert 2) mesh over the same global batch: the
    loss (mean of y^2 plus 0.01 aux) at rtol 1e-5, the router's and
    every expert's gradient at atol 1e-5 of their size."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from dlrover_tpu.parallel.mesh import MeshConfig, build_mesh
    from dlrover_tpu.parallel.moe import collect_moe_aux_loss as jax_aux
    from dlrover_tpu.parallel.sharding import moe_rules, sharding_tree

    got, (layer, params, x), _ = world4
    mesh = build_mesh(MeshConfig(data=2, expert=2),
                      devices=jax.devices()[:4])

    def loss(p, x):
        y, st = layer.apply({"params": p}, x, mutable=["intermediates"])
        return (y ** 2).mean() + 0.01 * jax_aux(st["intermediates"])

    p = jax.device_put(params, sharding_tree(params, mesh, moe_rules()))
    xs = jax.device_put(jnp.asarray(x), NamedSharding(mesh, P("data")))
    ref_loss, g = jax.jit(jax.value_and_grad(loss))(p, xs)
    moe = got["moe"]
    assert moe["local_experts"] == PARITY[4] // 2
    np.testing.assert_allclose(moe["loss"], float(ref_loss), rtol=1e-5)
    want = {"router": g["router"]["kernel"],
            **{n: g[n] for n in ("experts_w_in", "experts_w_gate",
                                 "experts_w_out")}}
    for name, ref in want.items():
        ref = np.asarray(ref)
        np.testing.assert_allclose(moe["grads"][name], ref, rtol=1e-4,
                                   atol=1e-5 * np.abs(ref).max(),
                                   err_msg=name)


def test_moe_parity_needs_global_gating(world4):
    """The parity case drops tokens: gating each data rank's tokens on
    their own (capacity from the local count, positions restarting)
    routes other tokens than the global gating does."""
    import jax.numpy as jnp

    from dlrover_tpu.parallel.moe import top_k_gating as jax_gating

    _, (_, params, x), _ = world4
    b, s, d, h, e, k, cf = PARITY
    logits = x.reshape(-1, d) @ params["router"]["kernel"]
    cap = int(k * b * s * cf / e)
    dispatch = np.asarray(jax_gating(jnp.asarray(logits), k, cap)[0])
    assert dispatch.sum() < k * b * s  # some tokens drop
    half = b * s // 2
    local = [np.asarray(jax_gating(jnp.asarray(part), k, cap // 2)[0])
             for part in (logits[:half], logits[half:])]
    kept = np.concatenate([m.sum(axis=(1, 2)) for m in local])
    assert not np.array_equal(kept, dispatch.sum(axis=(1, 2)))


def test_moe_gpt_trains_on_expert_mesh(world4):
    """The MoE GPT (experts every 2nd block): its MoE params under the
    expert rules, and its first step on gloo at expert 4 (one expert a
    rank) through ``auto_accelerate`` with the reference's loss (cross
    entropy plus 0.01 aux) on the same params and batch, at rtol 1e-5."""
    import jax
    import jax.numpy as jnp

    from dlrover_tpu.models.gpt import cross_entropy_loss
    from dlrover_tpu.parallel.moe import collect_moe_aux_loss as jax_aux
    from dlrover_tpu_torch.models.gpt import GPT, GPTConfig
    from dlrover_tpu_torch.parallel.sharding import moe_rules
    from dlrover_tpu_torch.utils.convert import flax_path

    got, _, (gpt, params, batch) = world4
    model = GPT(GPTConfig.tiny(moe_experts=4, moe_every=2), device="meta")
    paths = ["/".join(flax_path(n)) for n, _ in model.named_parameters()]
    moe_paths = [p for p in paths if "experts_w" in p]
    assert moe_paths and all(p.startswith("block_1/moe/") for p in moe_paths)
    assert tuple(moe_rules().spec_for(moe_paths[0])) == (
        "expert", "fsdp", "tensor")
    def loss(p, x, y):
        logits, st = gpt.apply({"params": p}, x, mutable=["intermediates"])
        return cross_entropy_loss(logits, y) + 0.01 * jax_aux(
            st["intermediates"])

    want = jax.jit(loss)(params, jnp.asarray(batch["x"]),
                         jnp.asarray(batch["y"]))
    assert got["gpt"]["mesh"]["expert"] == 4
    assert got["gpt"]["local_experts"] == 1
    np.testing.assert_allclose(got["gpt"]["loss"], float(want), rtol=1e-5)


@pytest.mark.parametrize("label", list(COMPOSED))
def test_search_variants_build_and_match_one_device(world4, label):
    """FSDP2 x expert, FSDP2 x ring and data x Ulysses (four gloo ranks)
    train the MoE GPT as one process does: the same three losses at
    rtol 1e-5 (fp32, SGD 0.1, seed 0)."""
    from dlrover_tpu_torch.models.gpt import GPT, GPTConfig, cross_entropy_loss
    from dlrover_tpu_torch.parallel.moe import collect_moe_aux_loss

    got = world4[0]["composed"][label]
    axis = {"fsdp2_expert2": "expert"}.get(label, "sequence")
    assert got["mesh"][axis] == 2
    model = GPT(GPTConfig.tiny(max_seq_len=64, moe_experts=4, moe_every=2,
                               dtype=torch.float32), device="cpu", seed=0)
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    data = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (8, 65))).long()
    want = []
    for _ in range(3):
        opt.zero_grad()
        loss = cross_entropy_loss(model(data[:, :-1]), data[:, 1:]) + \
            0.01 * collect_moe_aux_loss(model)
        loss.backward()
        opt.step()
        want.append(float(loss))
    np.testing.assert_allclose(got["losses"], want, rtol=1e-5)


@pytest.mark.parametrize("label", list(REFUSED))
def test_trainer_refuses_to_checkpoint_expert_shards(world4, label):
    """A Trainer whose plan shards the experts over ``expert`` (2 of 4
    experts a rank) no longer refuses: the expert kernels are DTensors
    over the expert axis, so it trains its two steps and writes its
    flash checkpoint (every rank its box of the experts; the restore
    across expert worlds is ``test_torch_moe_ckpt.py``'s).  Both plans
    wrap the model in FSDP2 (HSDP over data x fsdp)."""
    got = world4[0]["refused"][label]
    # the rank's 2 experts; over fsdp 2 FSDP2 keeps 1 of them locally
    assert got["local_experts"] == (1 if label.startswith("fsdp2") else 2)
    assert got["dtensor"]
    assert got["error"] is None
    assert len(got["losses"]) == 2 and np.isfinite(got["losses"]).all()
    assert "latest_checkpointed_iteration.txt" in got["written"], \
        got["written"]


def test_count_tier_counts_expert_and_ring_variants():
    """The strategy search over four devices offers a MoE Llama at a
    long sequence its expert and ring variants, and the count tier
    (``meta`` device) estimates every one: the attention of a ring plan
    counted as the whole sequence's through the flash kernels (the FLOPs
    of the dense plan with flash), the experts' state divided over
    ``fsdp`` x ``expert``."""
    import dataclasses

    from dlrover_tpu_torch.accel import ModelContext, OptimizationLibrary
    from dlrover_tpu_torch.accel import strategy_search
    from dlrover_tpu_torch.accel.dry_runner import count_step, estimate_plan
    from dlrover_tpu_torch.models.gpt import cross_entropy_loss
    from dlrover_tpu_torch.models.llama import Llama, LlamaConfig
    from dlrover_tpu_torch.parallel.moe import collect_moe_aux_loss

    model = Llama(LlamaConfig.tiny(moe_experts=4), device="cpu")
    data = np.random.default_rng(0).integers(0, 256, (8, 129),
                                             dtype=np.int32)

    def loss_fn(module, batch):
        return cross_entropy_loss(module(batch["x"]), batch["y"]) + \
            0.01 * collect_moe_aux_loss(module)

    ctx = ModelContext(
        model=model, optim_factory=lambda ps: torch.optim.AdamW(ps),
        loss_fn=loss_fn, sample_batch={"x": data[:, :-1], "y": data[:, 1:]},
        device=torch.device("cpu"))
    cands = strategy_search.generate_candidates(ctx, 4,
                                                long_seq_threshold=64)
    kinds = {(c.expert > 1, c.sequence > 1) for c in cands}
    assert {(True, False), (False, True), (False, False)} <= kinds
    lib = OptimizationLibrary()
    costs = {}
    for cand in cands:
        if cand.half or cand.remat or cand.grad_accum > 1 or cand.fsdp > 1:
            continue
        plan = lib.apply_strategy(cand.strategy, ctx)
        est = estimate_plan(plan, ctx, num_devices=4)
        assert est.ok and est.est_step_time_s > 0
        costs[(cand.expert, cand.sequence)] = (count_step(plan, ctx), est,
                                               plan)
    dense, ring, expert = costs[(1, 1)], costs[(1, 4)], costs[(4, 1)]
    flash = count_step(dataclasses.replace(dense[2], attention_impl="flash"),
                       ctx)
    assert ring[0]["flops"] == flash["flops"] != dense[0]["flops"]
    experts = sum(p.numel() for n, p in model.named_parameters()
                  if "experts_w" in n)
    assert dense[0]["expert_state_bytes"] == 16 * experts  # fp32 AdamW
    assert expert[1].device_peak_bytes == int(
        dense[0]["state_bytes"] + dense[0]["expert_state_bytes"] / 4)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        rank, world, port = (int(a) for a in sys.argv[2:5])
        _worker(rank, world, port, *sys.argv[5:7])
