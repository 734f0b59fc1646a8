"""Pipelined LM training with the interleaved (1F1B) schedule.

Reference: ``examples/train_pipelined_lm.py``, the JAX package's recipe
over ``dlrover_tpu/parallel/pipeline.py``.  embed -> stages over
the ``pipeline`` mesh axis (one stage a rank) -> head, trained through
:func:`~dlrover_tpu_torch.parallel.pipeline.pipeline_train_step_1f1b`:
one forward and one backward microbatch a tick, the activation stash
capped at 2S - 1 stage inputs.  Embed gradients chain through the
returned ``input_grads``.  The toy model, its sizes, its learnable
mapping (``label = token + 1``), Adam at 3e-3 and the printed lines are
the reference's; the weights are drawn from numpy's generator (seed 0)
where the reference draws from ``jax.random``.

    python -m dlrover_tpu_torch.run --nproc_per_node 4 \\
        dlrover_tpu_torch/examples/train_pipelined_lm.py      # NCCL, 4 GPUs
    python -m dlrover_tpu_torch.run --nproc_per_node 4 \\
        dlrover_tpu_torch/examples/train_pipelined_lm.py --device cpu  # gloo

The world is ``--stages`` stages (4) times the data ranks: with more
processes than stages the batch is split over ``data`` too.
:func:`main` returns the losses of every step; it uses the caller's
process group when one exists.
"""

import argparse
from typing import List, Optional, Sequence

import numpy as np
import torch

DIM, VOCAB, STAGES, BATCH, MICRO = 32, 64, 4, 16, 4


def stage_fn(p, h):
    return torch.tanh(h @ p["w"] + p["b"]) + h


def head_loss(hp, out, y_mb):
    return torch.nn.functional.cross_entropy(out @ hp["w"], y_mb.long())


def init_params(n_stages: int = STAGES, seed: int = 0):
    """The reference's shapes and scales, drawn from numpy."""
    rng = np.random.default_rng(seed)
    stages = [{"w": rng.normal(size=(DIM, DIM)) * 0.3, "b": np.zeros(DIM)}
              for _ in range(n_stages)]
    embed = {"table": rng.normal(size=(VOCAB, DIM)) * 0.3}
    head = {"w": rng.normal(size=(DIM, VOCAB)) * 0.3}
    f32 = lambda tree: {k: v.astype(np.float32) for k, v in tree.items()}
    return [f32(s) for s in stages], f32(embed), f32(head)


def main(argv: Optional[Sequence[str]] = None) -> List[float]:
    import torch.distributed as dist

    from dlrover_tpu_torch.common.device import resolve_device
    from dlrover_tpu_torch.parallel.mesh import MeshConfig, build_mesh
    from dlrover_tpu_torch.parallel.pipeline import (
        batch_groups,
        pipeline_train_step_1f1b,
        stack_stage_params,
    )
    from dlrover_tpu_torch.parallel.sharding import batch_shard
    from dlrover_tpu_torch.trainer.elastic_trainer import (
        init_torch_distributed,
    )

    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default=None,
                        help="cuda (default) or cpu")
    parser.add_argument("--steps", type=int, default=60)
    parser.add_argument("--stages", type=int, default=STAGES)
    args = parser.parse_args(argv)
    if not dist.is_initialized():
        init_torch_distributed(args.device)
    device = resolve_device(args.device)
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    mesh = build_mesh(MeshConfig(data=-1, pipeline=args.stages),
                      device_type=device.type)
    stage = mesh.coordinate()["pipeline"]
    stages, embed, head = init_params(args.stages)
    own = stack_stage_params([{k: torch.from_numpy(v) for k, v in
                               stages[stage].items()}])
    params = {
        "stages": {k: v.to(device).requires_grad_() for k, v in own.items()},
        "embed": {k: torch.from_numpy(v).to(device).requires_grad_()
                  for k, v in embed.items()},
        "head": {k: torch.from_numpy(v).to(device).requires_grad_()
                 for k, v in head.items()},
    }
    leaves = [p for part in params.values() for p in part.values()]
    opt = torch.optim.Adam(leaves, lr=3e-3)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, VOCAB, (BATCH,)).astype(np.int64)
    mine = batch_shard({"x": tokens, "y": (tokens + 1) % VOCAB}, mesh)
    x_tok = torch.as_tensor(mine["x"], device=device)
    labels = torch.as_tensor(mine["y"], device=device)
    groups, _ = batch_groups(mesh, "data")
    losses = []
    for step in range(args.steps):
        opt.zero_grad(set_to_none=True)
        x_act = params["embed"]["table"][x_tok]
        res = pipeline_train_step_1f1b(
            stage_fn, head_loss, params["stages"], x_act.detach(), labels,
            mesh, num_microbatches=MICRO, batch_axis="data",
            head_params=params["head"])
        x_act.backward(res.input_grads)
        for group in groups:  # each data row's share of the embedding
            dist.all_reduce(params["embed"]["table"].grad, group=group)
        for part, grads in (("stages", res.stage_grads),
                            ("head", res.head_grads)):
            for k, g in grads.items():
                params[part][k].grad = g
        opt.step()
        losses.append(float(res.loss))
        if (step % 10 == 0 or step == args.steps - 1) and (
                not dist.is_initialized() or dist.get_rank() == 0):
            print(f"step {step}: loss {losses[-1]:.4f}", flush=True)
    return losses


if __name__ == "__main__":
    main()
