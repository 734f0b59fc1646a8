"""Sequence and expert parallelism over NCCL on several GPUs (``cuda``).

Run on a host with 2-4 GPUs:

    python3 -m pytest -q -m cuda -s tests/test_torch_parallel_cuda.py

No JAX here: the references are the port's own whole-sequence kernels
and its one-GPU run.  Each test spawns one process per GPU of this file
(``--worker``; NCCL over ``tcp://127.0.0.1:<free port>``):

- the ring (``ring_attention``, B1-B3 per block) and Ulysses with the
  flash kernels inside, causal, bf16, at Llama-3-8B's attention shape
  (32 q heads over 8 kv heads, d 128) with 8192 tokens a rank, at 2 and
  4 GPUs: rank 0 gathers O, dQ, dK and dV and holds them against the
  whole sequence through B1-B3 on its own GPU by ||got - want|| /
  ||want|| within 8 bf16 unit roundoffs (``chip_smoke.py`` phase 13a's
  limit); the ring's forward and backward are timed beside the whole
  sequence's;
- Mixtral-8x7B at full width cut to 2 layers (batch 8 x 1024, the
  reference's strategy plus flash) at expert 4 on four GPUs against
  expert 1 on rank 0's GPU alone, the same batch, 3 steps of AdamW:
  the first loss within 1e-3 relative, the others within 1e-2;
- the same at expert 2 x tensor 2 (the experts DTensors over both axes,
  the vocab-parallel head) in fp32 compute, against expert 1 in fp32:
  the three losses within 1e-3 (in bf16 the tensor split rounds the
  router's logits otherwise and its top-k sends some tokens elsewhere);
  its flash checkpoint of params and AdamW moments after step 2 (each
  rank's boxes, to a directory on ``/dev/shm``) restores onto a fresh
  plan at expert 4 bit for bit, whose step 3 loss is the expert 2 x
  tensor 2 run's within 1e-3;
- Llama-3-8B at full width and depth (seq 8192, bf16 params, remat,
  flash) at tensor 4 with int8 q-AdamW, the vocab-parallel embedding and
  head and ``chunked_loss_fn(8)``, 3 steps, against tensor 1 on rank
  0's GPU alone: the first loss within 1e-3, the others within 1e-2;
  after step 1 the int8 codes and scales of block 0's ``q_proj``
  (column-parallel, the split-block B6) gathered from the four ranks
  equal those of the unsharded q-AdamW step (the fused B6) on the same
  parameter and tensor 4's gathered gradient, bit for bit; against
  tensor 1's own run, whose bf16 gradient is summed in another order,
  the share of codes that differ is reported; step times and each
  card's peak;
- Llama-3-8B at full width and depth (seq 8192, bf16 params, remat,
  flash, int8 q-AdamW) at pipeline 4 under the 1F1B schedule, 4
  microbatches of one sequence, 3 steps, against pipeline 1 on rank 0's
  GPU alone (the same batch as 4 accumulated micro-batches through
  ``chunked_loss_fn(8)``): the first loss within 1e-3, the others
  within 1e-2 (the tensor-4 test's tolerances); step times and each
  card's peak;
- the pipeline example (``examples/train_pipelined_lm.py``) on NCCL, one
  stage a GPU, and GPT-2 small at pipeline 2 x data 2 (GPipe, AdamW):
  its flash checkpoint after 2 steps (the stage-sharded blocks and the
  replicated embed and head, each rank's file on ``/dev/shm``) restored
  bit for bit onto a fresh plan;
- DiLoCo's outer step over NCCL, one replica a GPU (GPT-2 small's tree),
  each reduce method against the stacked form of the four replicas on
  rank 0: anchors and momenta within rtol 1e-5 / atol 1e-7 but for at
  most 1e-6 of a leaf's elements (a gta sign vote at a tie);
- the RL engine's hybrid rollout engine with GPT-2 XL's actor at full
  width and depth (fp32, flash): trained under FSDP2 over the four
  GPUs, copied into a tensor-4 rollout layout (the MLPs and the vocab-
  parallel ``wte`` sliced; XL's 25 heads do not split over 4, so the
  attention projections stay whole on each rank), one PPO step between
  two reshards; greedy sequences of 8 prompts of 32 tokens, 32 new,
  equal to one GPU's from the same weights, and the logprobs within
  1e-3; each reshard's seconds.
"""

import json
import os
import sys
import tempfile
import time

import pytest

import torch

SEQ_PER_RANK, HEADS, KV_HEADS, HEAD_DIM = 8192, 32, 8, 128
REL_NORM = 8 * 2.0 ** -8
MIXTRAL_STEPS = 3


def _needs(world):
    if not torch.cuda.is_available():
        pytest.skip("needs NVIDIA GPUs: the CUDA kernels run only there")
    if torch.cuda.device_count() < world:
        pytest.skip(f"needs {world} GPUs, the host has "
                    f"{torch.cuda.device_count()}")


def _rel(got, want):
    return float((got.float() - want.float()).norm() / want.float().norm())


def _time(attend, dout, barrier) -> dict:
    """Host-clock ms of the forward, and of forward plus backward, the
    mean of 3 after one warm-up, the GPUs synchronised."""
    ms = {}
    for name, fn in (("fwd", attend),
                     ("fwd_bwd", lambda: attend().backward(dout))):
        fn()
        torch.cuda.synchronize()
        barrier()
        t0 = time.perf_counter()
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        ms[name] = (time.perf_counter() - t0) / 3 * 1e3
    return ms


def _attention_worker(rank, world, out_path):
    import torch.distributed as dist

    from dlrover_tpu_torch.ops.flash_attention import flash_attention
    from dlrover_tpu_torch.parallel.mesh import MeshConfig, build_mesh
    from dlrover_tpu_torch.parallel.sequence import (
        ring_attention,
        ulysses_attention,
    )

    mesh = build_mesh(MeshConfig(data=1, sequence=world))
    s = SEQ_PER_RANK * world
    gen = torch.Generator(device="cuda").manual_seed(5)
    full = [torch.randn(1, s, h, HEAD_DIM, generator=gen, device="cuda",
                        dtype=torch.bfloat16)
            for h in (HEADS, KV_HEADS, KV_HEADS, HEADS)]
    lo = rank * SEQ_PER_RANK
    results = {}
    for impl in ("ring", "ulysses_flash"):
        q, k, v = (x[:, lo:lo + SEQ_PER_RANK].clone().requires_grad_()
                   for x in full[:3])
        dout = full[3][:, lo:lo + SEQ_PER_RANK]

        def attend(q, k, v):
            if impl == "ring":
                return ring_attention(q, k, v, mesh)
            group = HEADS // KV_HEADS  # Ulysses takes the repeated k, v
            return ulysses_attention(
                flash_attention, q, k.repeat_interleave(group, dim=2),
                v.repeat_interleave(group, dim=2), mesh)

        out = attend(q, k, v)
        out.backward(dout)
        got = {}
        for name, x in (("out", out), ("dq", q.grad), ("dk", k.grad),
                        ("dv", v.grad)):
            parts = [torch.empty_like(x) for _ in range(world)]
            dist.all_gather(parts, x.detach().contiguous())
            got[name] = torch.cat(parts, dim=1)
        results[impl] = {"got": got, "ms": _time(
            lambda: attend(q, k, v), dout, dist.barrier)}
    if rank == 0:
        q, k, v = (x.clone().requires_grad_() for x in full[:3])
        out = flash_attention(q, k, v)
        out.backward(full[3])
        want = {"out": out.detach(), "dq": q.grad.clone(),
                "dk": k.grad.clone(), "dv": v.grad.clone()}
        report = {impl: {"rel": {n: _rel(r["got"][n], want[n])
                                 for n in want},
                         "ms": r["ms"]} for impl, r in results.items()}
        report["whole_ms"] = _time(lambda: flash_attention(q, k, v),
                                   full[3], lambda: None)
        report["card"] = torch.cuda.get_device_name(0)
        with open(out_path, "w") as f:
            json.dump(report, f)


def _mixtral_worker(rank, world, out_path):
    import torch.distributed as dist

    from dlrover_tpu_torch.accel import Strategy
    from dlrover_tpu_torch.examples import train_mixtral as tm
    from dlrover_tpu_torch.models.llama import LlamaConfig

    cfg = LlamaConfig.mixtral_8x7b(num_layers=2)
    b, s = tm.batch_shape(False)
    flash = [("module_replace", {"attention": "flash"})]
    # the reference's plan at an expert axis over every card
    plan = Strategy(opts=[
        ("mixed_parallel", {"expert": world, "data": -1}),
        ("amp_native", {}), ("checkpoint", {}), *flash])
    run = tm.train(cfg, b, s, MIXTRAL_STEPS, plan=plan, log_every=0)
    report = {"expert4": run["losses"], "mesh": run["mesh"],
              "expert4_s": run["seconds"]}
    del run
    torch.cuda.empty_cache()
    dist.barrier()
    dist.destroy_process_group()
    if rank == 0:
        # expert 1: rank 0's GPU alone, with no process group
        one = tm.train(cfg, b, s, MIXTRAL_STEPS,
                       plan=tm.strategy(cfg.moe_experts, 1, flash),
                       log_every=0)
        report.update({"expert1": one["losses"], "expert1_s": one["seconds"],
                       "card": torch.cuda.get_device_name(0)})
        with open(out_path, "w") as f:
            json.dump(report, f)


def _mixtral_eptp_worker(rank, world, out_path):
    """Expert 2 x tensor 2, its checkpoint restored at expert 4, and
    expert 1 on rank 0 alone."""
    import gc
    import shutil

    import numpy as np
    import torch.distributed as dist

    from dlrover_tpu_torch.accel import Strategy
    from dlrover_tpu_torch.checkpoint.checkpointer import (
        Checkpointer,
        StorageType,
    )
    from dlrover_tpu_torch.checkpoint.saver import AsyncCheckpointSaver
    from dlrover_tpu_torch.examples import train_mixtral as tm
    from dlrover_tpu_torch.models.llama import LlamaConfig
    from dlrover_tpu_torch.utils.convert import (
        adamw_state_from_tree,
        adamw_state_tree,
        params_tree,
    )

    cfg = LlamaConfig.mixtral_8x7b(num_layers=2)
    b, s = tm.batch_shape(False)
    flash = [("module_replace", {"attention": "flash"})]

    def plan(mesh):
        # fp32 compute: the plans partition the matmuls otherwise, and in
        # bf16 the routers' top-k turns that rounding into other tokens'
        # experts (2.9e-2 apart at step 3 on four H100s, PERF.md §6)
        return Strategy(opts=[("mixed_parallel", {**mesh, "data": -1}),
                              ("amp_native", {"dtype": "float32"}),
                              ("checkpoint", {}), *flash])

    def tree(result):
        return {"params": params_tree(result.model),
                "opt_state": adamw_state_tree(result.state.optimizer,
                                              result.model)}

    def full(t):
        t = t.full_tensor() if hasattr(t, "full_tensor") else t
        return t.detach().float().cpu()

    def mark(what):
        print(f"rank {rank} {what}: "
              f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated, "
              f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
              flush=True)

    # every rank a node of its own (its own sockets and saver), sharing a
    # checkpoint directory on /dev/shm
    sockets = tempfile.mkdtemp(prefix="eptp_sock")
    os.environ.update({"DLROVER_NODE_RANK": str(rank),
                       "DLROVER_RANK": str(rank),
                       "DLROVER_WORLD_SIZE": str(world),
                       "DLROVER_LOCAL_WORLD_SIZE": str(world),
                       "DLROVER_SHARED_DIR": sockets,
                       "DLROVER_JOB_NAME": f"eptp{os.getppid()}_{rank}"})
    path = [tempfile.mkdtemp(prefix="eptp_", dir="/dev/shm")
            if rank == 0 else None]
    dist.broadcast_object_list(path)
    path = path[0]
    report = {}
    try:
        run = tm.train(cfg, b, s, 2, plan=plan({"expert": 2, "tensor": 2}),
                       log_every=0)
        mark("expert 2 x tensor 2, 2 steps")
        res, state = run["result"], run["state"]
        experts = res.model.blocks[0].moe.experts_w_in
        report["eptp_placements"] = str(experts.placements)
        report["head_placements"] = str(res.model.lm_head.weight.placements)
        AsyncCheckpointSaver.reset()
        # a synchronous snapshot: no copy of the state on the card
        ckpt = Checkpointer(path, replicated=False, async_snapshot=False)
        assert ckpt.save_checkpoint(2, tree(res),
                                    storage_type=StorageType.DISK)
        assert ckpt.wait()
        saved = {k: full(v) for k, v in
                 tree(res)["params"]["block_0"]["moe"].items()
                 if k.startswith("experts")}
        placed = res.place_batch(run["batch"])
        state, metrics = res.train_step(state, placed)
        report["eptp"] = run["losses"] + [float(metrics["loss"])]
        report["eptp_s"] = run["seconds"]
        ckpt.close()
        batch = run["batch"]
        del run, res, state, placed, metrics, ckpt
        gc.collect()
        torch.cuda.empty_cache()
        mark("expert 2 x tensor 2 freed")
        # the step-2 commit, then a fresh plan at expert 4 restores it
        deadline = time.time() + 600
        tracker = os.path.join(path, "latest_checkpointed_iteration.txt")
        while not os.path.exists(tracker) and time.time() < deadline:
            time.sleep(0.1)
        dist.barrier()
        fresh = tm.train(cfg, b, s, 0, plan=plan({"expert": 4}), seed=1,
                         log_every=0)
        res = fresh["result"]
        AsyncCheckpointSaver.reset()
        ckpt = Checkpointer(path, replicated=False)
        step, restored = ckpt.load_checkpoint(target_state=tree(res))
        adamw_state_from_tree(restored["opt_state"], res.state.optimizer,
                              res.model)
        report["restore"] = {"step": step,
                             "tier": ckpt.last_restore_phases["tier"]}
        got = {k: full(v) for k, v in
               tree(res)["params"]["block_0"]["moe"].items()
               if k.startswith("experts")}
        report["restored_equal"] = all(torch.equal(got[k], saved[k])
                                       for k in saved)
        ckpt.close()
        del restored, got
        state, metrics = res.train_step(res.state, res.place_batch(batch))
        report["expert4_step3"] = float(metrics["loss"])
        report["expert4_placements"] = str(
            res.model.blocks[0].moe.experts_w_in.placements)
        del fresh, res, state, metrics, ckpt
        gc.collect()
        torch.cuda.empty_cache()
        mark("expert 4 freed")
        dist.barrier()
    finally:
        from dlrover_tpu_torch.checkpoint.shm_handler import (
            SharedMemoryHandler,
        )

        AsyncCheckpointSaver.reset()
        SharedMemoryHandler(0).unlink()
        shutil.rmtree(sockets, ignore_errors=True)
        if rank == 0:
            shutil.rmtree(path, ignore_errors=True)
    dist.destroy_process_group()
    if rank == 0:
        one = tm.train(cfg, b, s, 3, plan=plan({"expert": 1}), log_every=0)
        report.update({"expert1": one["losses"], "expert1_s": one["seconds"],
                       "card": torch.cuda.get_device_name(0)})
        assert np.isfinite(report["eptp"]).all()
        with open(out_path, "w") as f:
            json.dump(report, f)


LLAMA_TP_STEPS = 3
LLAMA_SEQ = 8192


def _llama_tp_worker(rank, world, out_path):
    """Llama-3-8B at tensor 4 with int8 q-AdamW, then tensor 1 on rank 0
    alone; block 0's q_proj state after step 1 against the unsharded
    q-AdamW step on the same parameter and gradient."""
    import numpy as np
    import torch.distributed as dist

    from dlrover_tpu_torch.accel import Strategy, auto_accelerate
    from dlrover_tpu_torch.models.llama import Llama, LlamaConfig
    from dlrover_tpu_torch.models.losses import chunked_loss_fn
    from dlrover_tpu_torch.optim import q_adamw
    from dlrover_tpu_torch.optim.low_bit import PieceGrid

    cfg = LlamaConfig.llama3_8b(param_dtype=torch.bfloat16)
    data = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (1, LLAMA_SEQ + 1), dtype=np.int32)
    batch = {"x": data[:, :-1], "y": data[:, 1:]}
    opts = [("half", {}), ("checkpoint", {}),
            ("module_replace", {"attention": "flash"}),
            ("low_bit_opt", {"bits": 8, "learning_rate": 3e-4,
                             "weight_decay": 0.1})]

    def full(t):
        return (t.full_tensor() if hasattr(t, "full_tensor") else t
                ).detach().clone()

    def state_of(opt, p):
        """q_proj's codes and scales on the global grid: (flat index of
        each code, mu and nu codes, global block of each scale row, mu
        and nu scales)."""
        st, grid = opt.state[p], opt._layout(p)
        out = [st[k].reshape(-1).cpu().numpy().copy() for k in (
            "mu_values", "nu_values", "mu_scales", "nu_scales")]
        if isinstance(grid, PieceGrid):
            flat = np.concatenate([np.arange(s0, s0 + n) for s0, n in zip(
                grid.starts, grid.layout.table["len"])])
            return flat, out[0], out[1], grid.blocks, out[2], out[3]
        n = p.numel()
        return (np.arange(n), out[0][:n], out[1][:n],
                np.arange(len(out[2])), out[2], out[3])

    def run(first):
        torch.cuda.reset_peak_memory_stats()
        res = auto_accelerate(
            Llama(cfg, seed=0), lambda ps: torch.optim.AdamW(ps),
            chunked_loss_fn(num_chunks=8), batch,
            strategy=Strategy(opts=[first] + opts))
        state, placed = res.state, res.place_batch(batch)
        p = res.model.blocks[0].attn.q_proj.weight
        p0 = full(p)
        losses, secs = [], []
        for step in range(LLAMA_TP_STEPS):
            t0 = time.perf_counter()
            state, metrics = res.train_step(state, placed)
            losses.append(float(metrics["loss"]))
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            if step == 0:
                g0, codes = full(p.grad), state_of(state.optimizer, p)
        peak = torch.cuda.max_memory_allocated()
        mesh = dict(res.mesh.shape)
        head = str(getattr(res.model.lm_head.weight, "placements", None))
        del res, state, placed, p
        torch.cuda.empty_cache()
        return losses, secs, codes, peak, mesh, head, p0, g0

    losses, secs, codes, peak, mesh, head, p0, g0 = run(
        ("tensor_parallel", {"size": world}))
    gathered = [None] * world
    dist.all_gather_object(gathered, (codes, peak))
    dist.destroy_process_group()
    if rank != 0:
        return
    numel = p0.numel()

    def assemble(parts):
        """The ranks' codes and scales on the global grid."""
        mu = np.full(numel, -999, np.int64)
        nu = np.full(numel, -999, np.int64)
        rows = -(-numel // 2048)
        mu_s = np.full(rows, np.nan, np.float32)
        nu_s = np.full(rows, np.nan, np.float32)
        for flat, m, n_, blocks, ms, ns in parts:
            mu[flat], nu[flat] = m[:len(flat)], n_[:len(flat)]
            mu_s[blocks], nu_s[blocks] = ms, ns
        return mu, nu, mu_s, nu_s

    got = assemble([c for c, _ in gathered])
    # the unsharded step on the same parameter and gradient: the fused B6
    # against the ranks' split-block B6
    ref = torch.nn.Parameter(p0.clone())
    ref.grad = g0
    opt = q_adamw([ref], lr=3e-4, weight_decay=0.1)
    opt.step()
    want = assemble([state_of(opt, ref)])
    same = [int((a != b).sum()) for a, b in zip(got, want)]
    del ref, opt
    torch.cuda.empty_cache()
    one_losses, one_secs, one_codes, one_peak, _, _, _, _ = run(
        ("parallel_mode", {}))
    one = assemble([one_codes])
    report = {
        "tensor4": losses, "tensor4_s": secs, "tensor1": one_losses,
        "tensor1_s": one_secs, "mesh": mesh, "head": head,
        "peaks_gib": [pk / 2**30 for _, pk in gathered],
        "tensor1_peak_gib": one_peak / 2**30,
        # mismatches of mu codes, nu codes, mu scales, nu scales against
        # the unsharded step on tensor 4's own gradient
        "same_gradient_mismatches": same,
        "unfilled": int((got[0] == -999).sum()),
        # against tensor 1's own run, whose bf16 gradient is summed in
        # another order: the share of mu codes that differ, and by most
        "tensor1_code_share": float((got[0] != one[0]).mean()),
        "tensor1_code_max": int(np.abs(got[0] - one[0]).max()),
        "tensor1_scale_max_rel": float(np.nanmax(
            np.abs(got[2] - one[2]) / np.abs(one[2]))),
        "card": torch.cuda.get_device_name(0)}
    with open(out_path, "w") as f:
        json.dump(report, f)


LLAMA_PP_MICRO = 4


def _llama_pp_worker(rank, world, out_path):
    """Llama-3-8B at pipeline ``world`` (1F1B, int8 q-AdamW), then
    pipeline 1 on rank 0 alone over the same batch."""
    import gc

    import numpy as np
    import torch.distributed as dist

    from dlrover_tpu_torch.accel import Strategy, auto_accelerate
    from dlrover_tpu_torch.models.llama import Llama, LlamaConfig
    from dlrover_tpu_torch.models.losses import chunked_loss_fn

    cfg = LlamaConfig.llama3_8b(param_dtype=torch.bfloat16)
    data = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (LLAMA_PP_MICRO, LLAMA_SEQ + 1), dtype=np.int32)
    batch = {"x": data[:, :-1], "y": data[:, 1:]}
    opts = [("half", {}), ("checkpoint", {}),
            ("module_replace", {"attention": "flash"}),
            ("low_bit_opt", {"bits": 8, "learning_rate": 3e-4,
                             "weight_decay": 0.1})]

    def run(first, grad_accum):
        torch.cuda.reset_peak_memory_stats()
        res = auto_accelerate(
            Llama(cfg, seed=0), lambda ps: torch.optim.AdamW(ps),
            chunked_loss_fn(num_chunks=8), batch,
            strategy=Strategy(opts=[first] + opts), grad_accum=grad_accum)
        state, placed = res.state, res.place_batch(batch)
        losses, secs = [], []
        for _ in range(LLAMA_TP_STEPS):
            t0 = time.perf_counter()
            state, metrics = res.train_step(state, placed)
            losses.append(float(metrics["loss"]))
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        info = {"losses": losses, "secs": secs,
                "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                "mesh": dict(res.mesh.shape), "notes": list(res.plan.notes),
                "model": type(res.model).__name__}
        del res, state, placed
        gc.collect()
        torch.cuda.empty_cache()
        return info

    pp = run(("pipeline_parallel", {"size": world,
                                    "microbatches": LLAMA_PP_MICRO,
                                    "schedule": "1f1b"}), 1)
    gathered = [None] * world
    dist.all_gather_object(gathered, (pp["losses"], pp["peak_gib"]))
    dist.destroy_process_group()
    if rank != 0:
        return
    one = run(("parallel_mode", {}), LLAMA_PP_MICRO)
    report = {"pipeline": pp, "pipeline1": one,
              "losses_by_rank": [g[0] for g in gathered],
              "peaks_gib": [g[1] for g in gathered],
              "card": torch.cuda.get_device_name(0)}
    with open(out_path, "w") as f:
        json.dump(report, f)


def _pp_misc_worker(rank, world, out_path):
    """The pipeline example on NCCL, then GPT-2 small at pipeline 2 x
    data 2 through its flash checkpoint."""
    import gc
    import shutil

    import numpy as np
    import torch.distributed as dist

    from dlrover_tpu_torch.accel import Strategy, auto_accelerate
    from dlrover_tpu_torch.checkpoint.checkpointer import (
        Checkpointer,
        StorageType,
    )
    from dlrover_tpu_torch.checkpoint.saver import AsyncCheckpointSaver
    from dlrover_tpu_torch.examples import train_pipelined_lm
    from dlrover_tpu_torch.models.gpt import GPT, GPTConfig, cross_entropy_loss
    from dlrover_tpu_torch.utils.convert import (
        adamw_state_from_tree,
        adamw_state_tree,
        params_tree,
    )

    report = {"example": train_pipelined_lm.main([])}
    cfg = GPTConfig.gpt2_small(attention_impl="flash")
    data = np.random.default_rng(0).integers(0, cfg.vocab_size, (8, 1025),
                                             dtype=np.int32)
    batch = {"x": data[:, :-1], "y": data[:, 1:]}

    def plan():
        return auto_accelerate(
            GPT(cfg, seed=0), lambda ps: torch.optim.AdamW(ps, lr=3e-4),
            lambda m, b: cross_entropy_loss(m(b["x"]), b["y"]), batch,
            strategy=Strategy(opts=[("pipeline_parallel", {
                "size": 2, "microbatches": 2}), ("amp_native", {})]))

    def tree(res):
        return {"params": params_tree(res.model),
                "opt_state": adamw_state_tree(res.state.optimizer,
                                              res.model)}

    def flat(t, prefix=""):
        out = {}
        for k, v in (t.items() if isinstance(t, dict) else
                     enumerate(t) if isinstance(t, (list, tuple)) else []):
            out.update(flat(v, f"{prefix}/{k}"))
        if torch.is_tensor(t):
            v = t.full_tensor() if hasattr(t, "full_tensor") else t
            out[prefix] = v.detach().cpu().reshape(-1).view(torch.uint8)
        return out

    sockets = tempfile.mkdtemp(prefix="pp_sock")
    os.environ.update({"DLROVER_NODE_RANK": str(rank),
                       "DLROVER_RANK": str(rank),
                       "DLROVER_WORLD_SIZE": str(world),
                       "DLROVER_LOCAL_WORLD_SIZE": str(world),
                       "DLROVER_SHARED_DIR": sockets,
                       "DLROVER_JOB_NAME": f"ppck{os.getppid()}_{rank}"})
    path = [tempfile.mkdtemp(prefix="ppck_", dir="/dev/shm")
            if rank == 0 else None]
    dist.broadcast_object_list(path)
    path = path[0]
    try:
        res = plan()
        state = res.state
        losses = []
        for _ in range(2):
            state, metrics = res.train_step(state, res.place_batch(batch))
            losses.append(float(metrics["loss"]))
        AsyncCheckpointSaver.reset()
        ckpt = Checkpointer(path, replicated=False)
        assert ckpt.save_checkpoint(2, tree(res),
                                    storage_type=StorageType.DISK)
        assert ckpt.wait()
        saved = flat(tree(res))
        ckpt.close()
        del res, state
        gc.collect()
        tracker = os.path.join(path, "latest_checkpointed_iteration.txt")
        deadline = time.time() + 300
        while not os.path.exists(tracker) and time.time() < deadline:
            time.sleep(0.1)
        dist.barrier()
        fresh = plan()
        AsyncCheckpointSaver.reset()
        ckpt = Checkpointer(path, replicated=False)
        step, restored = ckpt.load_checkpoint(target_state=tree(fresh))
        adamw_state_from_tree(restored["opt_state"], fresh.state.optimizer,
                              fresh.model)
        got = flat(tree(fresh))
        ckpt.close()
        report.update({
            "losses": losses, "restore_step": step,
            "tier": ckpt.last_restore_phases["tier"],
            "keys": len(saved), "same_keys": set(got) == set(saved),
            "unequal": sorted(k for k in saved
                              if k in got and not torch.equal(got[k],
                                                              saved[k])),
            "blocks_placements": str(dict(
                fresh.model.named_parameters())[
                    "blocks.attn.qkv.weight"].placements)})
        dist.barrier()
    finally:
        from dlrover_tpu_torch.checkpoint.shm_handler import (
            SharedMemoryHandler,
        )

        AsyncCheckpointSaver.reset()
        SharedMemoryHandler(0).unlink()
        shutil.rmtree(sockets, ignore_errors=True)
        if rank == 0:
            shutil.rmtree(path, ignore_errors=True)
    if rank == 0:
        report["card"] = torch.cuda.get_device_name(0)
        with open(out_path, "w") as f:
            json.dump(report, f)


DILOCO_METHODS = {
    "linear": dict(reduce_method="linear"),
    "gta_sum": dict(reduce_method="gta", consensus="sum"),
    "gta_count": dict(reduce_method="gta", consensus="count"),
    "sparsify_magnitude": dict(reduce_method="sparsify", density=0.1),
}


def _diloco_worker(rank, world, out_path):
    """One DiLoCo replica a GPU over NCCL against the stacked form of all
    of them on rank 0."""
    import torch.distributed as dist

    from dlrover_tpu_torch.models.gpt import GPT, GPTConfig
    from dlrover_tpu_torch.optim.local_sgd import (
        diloco_outer_step,
        diloco_outer_step_dist,
        init_diloco,
    )

    shapes = {n: tuple(p.shape) for n, p in GPT(
        GPTConfig.gpt2_small(), device="meta").named_parameters()}

    def replica(r):
        gen = torch.Generator(device="cuda").manual_seed(100 + r)
        return {n: anchor[n] + torch.randn(sh, generator=gen,
                                           device="cuda") * 1e-3
                for n, sh in shapes.items()}

    gen = torch.Generator(device="cuda").manual_seed(7)
    anchor = {n: torch.randn(sh, generator=gen, device="cuda") * 0.02
              for n, sh in shapes.items()}
    mine = replica(rank)
    report = {}
    for label, kw in DILOCO_METHODS.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, state = diloco_outer_step_dist(mine, init_diloco(anchor), **kw)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        if rank == 0:
            stacked = {n: torch.stack([replica(r)[n] for r in range(world)])
                       for n in shapes} if label == "linear" else stacked
            _, want = diloco_outer_step(stacked, init_diloco(anchor), **kw)
            worst_share, worst = 0.0, 0.0
            for which in ("anchor_params", "momentum"):
                for n in shapes:
                    got = getattr(state, which)[n]
                    ref = getattr(want, which)[n]
                    bad = ~torch.isclose(got, ref, rtol=1e-5, atol=1e-7)
                    worst_share = max(worst_share, float(bad.float().mean()))
                    worst = max(worst, float((got - ref).abs().max()))
            report[label] = {"ms": ms, "worst_share": worst_share,
                             "max_abs": worst}
            del want
        dist.barrier()
    if rank == 0:
        report["card"] = torch.cuda.get_device_name(0)
        with open(out_path, "w") as f:
            json.dump(report, f)


HYBRID_BATCH, HYBRID_PROMPT, HYBRID_NEW = 8, 32, 32


def _hybrid_xl_worker(rank, world, out_path):
    """GPT-2 XL's actor trained under FSDP2 over every GPU, generating
    greedily on a tensor-``world`` rollout copy; rank 0 also generates
    from the same weights on its GPU alone."""
    import dataclasses

    import numpy as np
    import torch.distributed as dist

    from dlrover_tpu_torch.accel import Strategy
    from dlrover_tpu_torch.models.gpt import GPT, GPTConfig
    from dlrover_tpu_torch.parallel.mesh import MeshConfig, build_mesh
    from dlrover_tpu_torch.parallel.sharding import (
        PartitionRules,
        gpt_tp_rules,
    )
    from dlrover_tpu_torch.rl.generation import (
        decode_variant,
        generate,
        rollout_params,
    )
    from dlrover_tpu_torch.rl.hybrid_engine import HybridRolloutEngine
    from dlrover_tpu_torch.rl.model_engine import (
        ModelRole,
        RLModelEngine,
        RoleSpec,
    )
    from dlrover_tpu_torch.rl.rollout import (
        make_actor_loss,
        sample_rollout_batch,
    )

    cfg = GPTConfig.gpt2_xl(attention_impl="flash", dtype=torch.float32)
    prompts = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (HYBRID_BATCH, HYBRID_PROMPT), dtype=np.int32))
    actor = GPT(cfg, seed=0)
    engine = RLModelEngine(
        sample_rollout_batch(prompts, HYBRID_NEW),
        {ModelRole.ACTOR: RoleSpec(
            model=actor, loss_fn=make_actor_loss(actor, HYBRID_PROMPT),
            optim_factory=lambda ps: torch.optim.AdamW(ps, lr=1e-5),
            strategy=Strategy(opts=[("fsdp", {}), ("amp_native",
                                                   {"dtype": "float32"})]))},
    ).build()
    del actor
    # XL's 25 heads do not split over 4 ranks: the attention
    # projections stay whole, the MLPs and the vocab are sliced
    rules = PartitionRules(
        rules=[(pat.replace("qkv|", "").replace("o_proj|", ""), spec)
               for pat, spec in gpt_tp_rules().rules],
        default=())
    mesh = build_mesh(MeshConfig(data=1, tensor=world))
    hybrid = HybridRolloutEngine(engine, mesh, rules)
    report = {}
    runs = []
    for turn in range(2):
        params = hybrid.reshard_actor_for_rollout()
        seq, lp = generate(hybrid.rollout_model, params, prompts.cuda(), None,
                           max_new_tokens=HYBRID_NEW, temperature=0.0)
        runs.append((seq.cpu().numpy().tolist(), lp.cpu().numpy().tolist()))
        if turn == 0:
            batch = {"tokens": seq,
                     "old_logprobs": lp,
                     "advantages": torch.ones_like(lp),
                     "returns": torch.ones_like(lp)}
            state, metrics = engine.train_step(ModelRole.ACTOR)(
                engine.state(ModelRole.ACTOR),
                engine.place_batch(ModelRole.ACTOR, batch))
            engine.set_state(ModelRole.ACTOR, state)
            report["loss"] = float(metrics["loss"])
        del params
    report["sharded"] = sorted(
        n for n, p in hybrid.rollout_model.named_parameters()
        if "Shard" in str(getattr(p, "placements", "")))
    report["reshard_s"] = hybrid.reshard_times
    # rank 0's one-GPU reference: the train state's weights, gathered
    module = engine.state(ModelRole.ACTOR).module
    full = rollout_params(module)
    if rank == 0:
        one = dataclasses.replace(cfg, dtype=torch.float32)
        dec = decode_variant(GPT(one, device="meta"))
        seq, lp = generate(dec, full, prompts.cuda(), None,
                           max_new_tokens=HYBRID_NEW, temperature=0.0)
        report["one_gpu"] = (seq.cpu().numpy().tolist(),
                             lp.cpu().numpy().tolist())
        report["hybrid"] = runs[-1]
        report["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        report["card"] = torch.cuda.get_device_name(0)
        with open(out_path, "w") as f:
            json.dump(report, f)
    dist.barrier()


def _spawn(kind, world, tmp_path, timeout):
    import subprocess

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from torch_gloo import free_port

    out_path = str(tmp_path / f"{kind}_{world}.json")
    port = free_port()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "PYTHONPATH": root}
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--worker", kind,
         str(rank), str(world), str(port), out_path],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in range(world)]
    try:
        logs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-12000:]
    with open(out_path) as f:
        return json.load(f)


@pytest.mark.cuda
@pytest.mark.parametrize("world", [2, 4])
def test_ring_and_ulysses_match_the_whole_sequence(world, tmp_path):
    _needs(world)
    report = _spawn("attention", world, tmp_path, 600)
    print(f"sequence parallel over {world} GPUs, {SEQ_PER_RANK} tokens a "
          f"rank: {json.dumps(report)}")
    for impl in ("ring", "ulysses_flash"):
        for name, rel in report[impl]["rel"].items():
            assert rel <= REL_NORM, (impl, name, rel)


@pytest.mark.cuda
def test_mixtral_expert4_matches_expert1(tmp_path):
    _needs(4)
    report = _spawn("mixtral", 4, tmp_path, 1200)
    print(f"Mixtral-8x7B 2 layers, expert 4 against expert 1: "
          f"{json.dumps(report)}")
    assert report["mesh"]["expert"] == 4
    e4, e1 = report["expert4"], report["expert1"]
    assert abs(e4[0] - e1[0]) <= 1e-3 * abs(e1[0]), (e4, e1)
    for a, b in zip(e4[1:], e1[1:]):
        assert abs(a - b) <= 1e-2 * abs(b), (e4, e1)
    assert e4[-1] < e4[0]


@pytest.mark.cuda
def test_mixtral_expert2_tensor2_and_its_checkpoint_at_expert4(tmp_path):
    import numpy as np

    _needs(4)
    report = _spawn("mixtral_eptp", 4, tmp_path, 1500)
    print(f"Mixtral-8x7B 2 layers, expert 2 x tensor 2: "
          f"{json.dumps(report)}")
    assert report["eptp_placements"].endswith(
        "Shard(dim=0), Shard(dim=2))"), report["eptp_placements"]
    e, e1 = report["eptp"], report["expert1"]
    np.testing.assert_allclose(e, e1, rtol=1e-3)
    assert e[-1] < e[0]
    assert report["restore"] == {"step": 2, "tier": "storage"}
    assert report["restored_equal"]
    assert abs(report["expert4_step3"] - e[2]) <= 1e-3 * abs(e[2]), report


@pytest.mark.cuda
def test_llama3_8b_tensor4_int8_matches_tensor1(tmp_path):
    _needs(4)
    report = _spawn("llama_tp", 4, tmp_path, 1500)
    print(f"Llama-3-8B tensor 4 int8 q-AdamW: {json.dumps(report)}")
    assert report["mesh"]["tensor"] == 4
    assert "Shard(dim=1)" in report["head"], report["head"]
    t4, t1 = report["tensor4"], report["tensor1"]
    assert abs(t4[0] - t1[0]) <= 1e-3 * abs(t1[0]), (t4, t1)
    for a, b in zip(t4[1:], t1[1:]):
        assert abs(a - b) <= 1e-2 * abs(b), (t4, t1)
    assert report["unfilled"] == 0
    # the split-block state is the unsharded step's on the same gradient
    assert report["same_gradient_mismatches"] == [0, 0, 0, 0], report


@pytest.mark.cuda
def test_llama3_8b_pipeline4_1f1b_int8_matches_pipeline1(tmp_path):
    _needs(4)
    report = _spawn("llama_pp", 4, tmp_path, 1800)
    print(f"Llama-3-8B pipeline 4 1F1B int8 q-AdamW: {json.dumps(report)}")
    pp, one = report["pipeline"], report["pipeline1"]
    assert pp["mesh"]["pipeline"] == 4 and pp["model"] == "PipelinedLlama"
    for losses in report["losses_by_rank"]:
        assert losses == pp["losses"]
    p4, p1 = pp["losses"], one["losses"]
    assert abs(p4[0] - p1[0]) <= 1e-3 * abs(p1[0]), (p4, p1)
    for a, b in zip(p4[1:], p1[1:]):
        assert abs(a - b) <= 1e-2 * abs(b), (p4, p1)
    assert p4[-1] < p4[0]


@pytest.mark.cuda
def test_pipeline_example_and_checkpoint_over_nccl(tmp_path):
    _needs(4)
    report = _spawn("pp_misc", 4, tmp_path, 900)
    print(f"pipeline example and checkpoint over NCCL: {json.dumps(report)}")
    example = report["example"]
    assert len(example) == 60 and example[-1] < 0.05 * example[0], example
    assert report["restore_step"] == 2 and report["tier"] == "storage"
    assert report["same_keys"] and report["unequal"] == [], report
    assert "Shard(dim=0)" in report["blocks_placements"]


@pytest.mark.cuda
def test_diloco_over_nccl_equals_the_stacked_form(tmp_path):
    _needs(4)
    report = _spawn("diloco", 4, tmp_path, 600)
    print(f"DiLoCo over NCCL, 4 replicas of GPT-2 small: "
          f"{json.dumps(report)}")
    for label in DILOCO_METHODS:
        assert report[label]["worst_share"] <= 1e-6, (label, report[label])


@pytest.mark.cuda
def test_hybrid_rollout_of_gpt2_xl_fsdp4_to_tensor4(tmp_path):
    _needs(4)
    import subprocess

    report = _spawn("hybrid_xl", 4, tmp_path, 1200)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip().splitlines()
    print(f"hybrid rollout engine, GPT-2 XL FSDP2 4 -> tensor 4: "
          f"reshards {report['reshard_s']} s, PPO step loss "
          f"{report['loss']}, {len(report['sharded'])} sliced params, "
          f"peak {report['peak_gib']:.2f} GiB on rank 0 {card}")
    assert report["sharded"], "the rollout layout sliced nothing"
    assert len(report["reshard_s"]) == 2
    one_seq, one_lp = report["one_gpu"]
    seq, lp = report["hybrid"]
    assert seq == one_seq
    assert max(abs(a - b) for ra, rb in zip(lp, one_lp)
               for a, b in zip(ra, rb)) <= 1e-3


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        import torch.distributed as dist

        kind = sys.argv[2]
        rank, world, port = (int(a) for a in sys.argv[3:6])
        torch.cuda.set_device(rank)
        dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                                world_size=world, rank=rank,
                                device_id=torch.device("cuda", rank))
        worker = {"attention": _attention_worker,
                  "mixtral": _mixtral_worker,
                  "mixtral_eptp": _mixtral_eptp_worker,
                  "llama_tp": _llama_tp_worker,
                  "llama_pp": _llama_pp_worker,
                  "pp_misc": _pp_misc_worker,
                  "diloco": _diloco_worker,
                  "hybrid_xl": _hybrid_xl_worker}[kind]
        worker(rank, world, sys.argv[6])
        if dist.is_initialized():
            dist.destroy_process_group()
