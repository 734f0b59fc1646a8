"""Mixtral-class sparse-MoE Llama with expert parallelism.

Reference: ``examples/train_mixtral.py``, the JAX package's recipe over
``dlrover_tpu/parallel/moe.py``.  Gated (SwiGLU) experts replace every
block's MLP (:mod:`dlrover_tpu_torch.parallel.moe`); the
expert kernels shard over the ``expert`` mesh axis through
``auto_accelerate``'s ``mixed_parallel(expert=min(e, max(1, n // 2)),
data=-1)`` with ``amp_native`` and ``checkpoint``; the loss is cross
entropy plus 0.01 times the routers' aux loss, AdamW at 3e-4 (optax's
``adamw`` defaults otherwise: weight decay 1e-4).

    python -m dlrover_tpu_torch.examples.train_mixtral --smoke   # one GPU
    torchrun --nproc_per_node=4 -m dlrover_tpu_torch.examples.train_mixtral

``--smoke`` is ``LlamaConfig.tiny(moe_experts=2, moe_top_k=2)`` at batch
16 x 32; without it ``LlamaConfig.mixtral_8x7b()`` at batch 8 x 1024.
Under ``torchrun`` each process takes the GPU of its local rank and the
world forms one NCCL group.  :func:`train` is the body, for a config of
the caller's (a reduced depth) and any device.
"""

import argparse
import os
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from dlrover_tpu_torch.accel import Strategy, auto_accelerate
from dlrover_tpu_torch.models.gpt import cross_entropy_loss
from dlrover_tpu_torch.models.llama import Llama, LlamaConfig
from dlrover_tpu_torch.parallel.moe import collect_moe_aux_loss

AUX_WEIGHT = 0.01


def config(smoke: bool) -> LlamaConfig:
    if smoke:
        return LlamaConfig.tiny(moe_experts=2, moe_top_k=2)
    return LlamaConfig.mixtral_8x7b()


def batch_shape(smoke: bool):
    return (16, 32) if smoke else (8, 1024)


def loss_fn(module, batch):
    ce = cross_entropy_loss(module(batch["x"]), batch["y"])
    return ce + AUX_WEIGHT * collect_moe_aux_loss(module)


def adamw(params):
    """optax's ``adamw(3e-4)``: weight decay 1e-4; fused on the card
    (no temporaries the size of the parameters)."""
    params = list(params)
    return torch.optim.AdamW(params, lr=3e-4, weight_decay=1e-4,
                             fused=params[0].device.type == "cuda")


def strategy(num_experts: int, world: int, extra: Sequence = ()) -> Strategy:
    """The reference's plan: experts over half the devices (at most
    one a device), data over the rest, bf16 compute, remat; then
    ``extra``."""
    expert = min(num_experts, max(1, world // 2))
    return Strategy(opts=[
        ("mixed_parallel", {"expert": expert, "data": -1}),
        ("amp_native", {}), ("checkpoint", {}), *extra])


def train(cfg: LlamaConfig, batch_size: int, seq: int, steps: int,
          device=None, plan: Optional[Strategy] = None, seed: int = 0,
          log_every: int = 5) -> Dict:
    """Build the model from ``seed``, one fixed batch of seeded random
    tokens, ``auto_accelerate`` with ``plan`` (by default
    :func:`strategy` over the process group's world, 1 without one),
    and ``steps`` steps.  Returns the losses, each step's seconds (host
    clock, the card synchronised), the mesh, the accelerate result, the
    state after the last step and the batch."""
    import torch.distributed as dist

    if plan is None:
        world = dist.get_world_size() if dist.is_initialized() else 1
        plan = strategy(cfg.moe_experts, world)
    model = Llama(cfg, device=device, seed=seed)
    data = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (batch_size, seq + 1), dtype=np.int32)
    batch = {"x": data[:, :-1], "y": data[:, 1:]}
    result = auto_accelerate(
        model, adamw, loss_fn, batch, strategy=plan, device=device)
    del model
    cuda = result.model.lm_head.weight.device.type == "cuda"
    state, placed = result.state, result.place_batch(batch)
    losses, seconds = [], []
    for step in range(steps):
        t0 = time.perf_counter()
        state, metrics = result.train_step(state, placed)
        losses.append(float(metrics["loss"]))  # waits for the step
        if cuda:
            torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        if log_every and (step % log_every == 0 or step == steps - 1):
            print(f"step {step}: loss {losses[-1]:.4f}", flush=True)
    return {"losses": losses, "seconds": seconds,
            "mesh": dict(result.mesh.shape), "result": result,
            "state": state, "batch": batch}


def main(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=20)
    args = ap.parse_args(argv)
    import torch.distributed as dist

    if "LOCAL_RANK" in os.environ and not dist.is_initialized():
        torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
        dist.init_process_group("nccl")
    cfg = config(args.smoke)
    b, s = batch_shape(args.smoke)
    out = train(cfg, b, s, args.steps)
    print("mesh:", out["mesh"])
    if dist.is_initialized():
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
