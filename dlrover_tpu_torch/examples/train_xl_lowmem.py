"""GPT-2 XL (1.56B params) training on one GPU with int8 AdamW moments.

Reference: ``examples/train_xl_lowmem.py``, the JAX package's recipe
over ``dlrover_tpu/optim/low_bit.py``.  The same memory stack,
through the port's ``Trainer``: bf16 params (2 B/param), blockwise-int8
AdamW moments through the fused CUDA step of
:mod:`dlrover_tpu_torch.ops.quantization` (2 B/param for both moments,
plus one fp32 scale per 2048), flash attention and per-block remat.
fp32 AdamW would hold 16 B/param (fp32 master params, gradients and
two moments) before activations: 25 GB for this model.

    python -m dlrover_tpu_torch.examples.train_xl_lowmem        # on the GPU
    python -m dlrover_tpu_torch.examples.train_xl_lowmem --smoke --device cpu

The Trainer flash-checkpoints into ``--output-dir`` and resumes from
the last checkpoint of the job (its shm segment, else that directory).
"""

import argparse
from typing import Optional

import numpy as np
import torch

from dlrover_tpu_torch.models.gpt import (
    GPT,
    GPTConfig,
    count_params,
    cross_entropy_loss,
)
from dlrover_tpu_torch.optim import q_adamw
from dlrover_tpu_torch.trainer.trainer import Trainer, TrainingArguments


def config(smoke: bool) -> GPTConfig:
    if smoke:
        return GPTConfig.tiny(max_seq_len=64, param_dtype=torch.bfloat16,
                              remat=True)
    return GPTConfig.gpt2_xl(attention_impl="flash", remat=True,
                             param_dtype=torch.bfloat16)


def loss_fn(module, batch):
    return cross_entropy_loss(module(batch["x"]), batch["y"])


def build_trainer(smoke: bool, steps: int, device=None, batch: int = 4,
                  logging_steps: int = 5,
                  output_dir: Optional[str] = None) -> Trainer:
    """The model, one fixed batch of seeded random tokens, and the
    port's ``Trainer`` with ``q_adamw(lr=3e-4, weight_decay=0.1)``,
    checkpointing into ``output_dir`` (the Trainer's default when
    None)."""
    cfg = config(smoke)
    seq = cfg.max_seq_len
    model = GPT(cfg, device=device, seed=0)
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (batch, seq + 1), dtype=np.int32
    )
    args = TrainingArguments(
        max_steps=steps, global_batch_size=batch, micro_batch_size=batch,
        logging_steps=logging_steps,
    )
    if output_dir is not None:
        args.output_dir = output_dir
    return Trainer(
        model, args, [{"x": tokens[:, :-1], "y": tokens[:, 1:]}], loss_fn,
        optim_factory=lambda ps: q_adamw(ps, lr=3e-4, weight_decay=0.1),
        device=device,
    )


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--device", default=None,
                    help="cpu, or a CUDA device (default: the GPU)")
    ap.add_argument("--output-dir", default=None,
                    help="checkpoint directory (default: the Trainer's)")
    args = ap.parse_args(argv)

    trainer = build_trainer(args.smoke, args.steps, args.device,
                            output_dir=args.output_dir)
    print(f"params: {count_params(trainer.model) / 1e9:.2f}B")
    result = trainer.train()
    for i, (loss, seconds) in enumerate(zip(result["losses"],
                                            result["step_seconds"])):
        if i % 5 == 0 or i == args.steps - 1:
            print(f"step {i}: loss {loss:.4f} ({seconds:.2f}s)")
    return result


if __name__ == "__main__":
    main()
