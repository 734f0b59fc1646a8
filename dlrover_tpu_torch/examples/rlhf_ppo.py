"""RLHF PPO on the four-role engine (toy reward).

Reference: ``examples/rlhf_ppo.py``, the JAX package's recipe over the
RL engine of ``dlrover_tpu/rl/``.  A tiny GPT actor (``amp_native``
over data parallelism), a value-head critic that SEARCHES its own
strategy (cost-model ranked), and a frozen ref holding the actor's
initial weights; the reward favours low token ids.  Two tiers:

- hand-rolled iterations (``ppo_iteration``: one experience phase and
  one PPO step for each role, the quick-start shape);
- the trainer loop (``PPOTrainer``: fill a replay buffer with rollouts,
  then PPO epochs over shuffled minibatches; add
  ``hybrid=HybridRolloutEngine(engine, mesh)`` to generate on a
  tensor-parallel layout).

    python -m dlrover_tpu_torch.examples.rlhf_ppo                 # GPU
    python -m dlrover_tpu_torch.examples.rlhf_ppo --device cpu

:func:`main` returns the iterations' metrics and the trainer's history.
"""

import argparse
from typing import Optional, Sequence

import numpy as np
import torch

from dlrover_tpu_torch.accel import Strategy
from dlrover_tpu_torch.models.gpt import GPT, GPTConfig
from dlrover_tpu_torch.rl.model_engine import ModelRole, RLModelEngine, RoleSpec
from dlrover_tpu_torch.rl.rollout import (
    make_actor_loss,
    make_critic_loss,
    ppo_iteration,
    sample_rollout_batch,
)
from dlrover_tpu_torch.rl.trainer import PPOTrainer, RLTrainConfig

PROMPT_LEN, MAX_NEW = 8, 16


def main(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="the GPU unless 'cpu' is named")
    ap.add_argument("--iterations", type=int, default=5)
    ap.add_argument("--epochs", type=int, default=4)
    args = ap.parse_args(argv)
    device = args.device

    cfg = GPTConfig.tiny(max_seq_len=64, vocab_size=64)
    actor = GPT(cfg, device=device, seed=0)
    critic = GPT(GPTConfig.tiny(max_seq_len=64, vocab_size=64,
                                head="value"), device=device, seed=1)
    ref = GPT(cfg, device=device, seed=2)
    prompts = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (16, PROMPT_LEN), dtype=np.int32))
    # PER-ROLE strategies (the reference ModelEngine accelerates each
    # model type with its own): the actor declares a plan, the critic
    # SEARCHES its own (cost-model ranked, chip-free), the frozen ref
    # could take a tensor-sliced inference layout with
    # RoleSpec(mesh=..., rules=...)
    engine = RLModelEngine(
        sample_rollout_batch(prompts, MAX_NEW),
        {
            ModelRole.ACTOR: RoleSpec(
                model=actor, loss_fn=make_actor_loss(actor, PROMPT_LEN),
                optim_factory=lambda ps: torch.optim.Adam(ps, lr=5e-3),
                strategy=Strategy(opts=[("parallel_mode", {}),
                                        ("amp_native", {})]),
            ),
            ModelRole.CRITIC: RoleSpec(
                model=critic, loss_fn=make_critic_loss(critic, PROMPT_LEN),
                optim_factory=lambda ps: torch.optim.Adam(ps, lr=1e-3),
                search=True, rank_mode="cost_model",
            ),
            ModelRole.REF: RoleSpec(model=ref, params=actor.state_dict()),
        },
        device=device,
    ).build()
    print("role report:", engine.role_report())

    def reward_fn(sequences):  # favour low token ids
        return (sequences[:, PROMPT_LEN:] < 16).float().mean(dim=1)

    # tier 1: hand-rolled iterations (one experience + one PPO step)
    generator = torch.Generator(device=engine.device).manual_seed(2)
    iterations = []
    for it in range(args.iterations):
        metrics = ppo_iteration(
            engine, prompts, generator, max_new_tokens=MAX_NEW,
            kl_coef=0.02, reward_fn=reward_fn,
        )
        iterations.append(metrics)
        print(f"iter {it}: {metrics}")

    # tier 2: the trainer loop (the reference's shape)
    trainer = PPOTrainer(
        engine,
        RLTrainConfig(
            epochs=args.epochs, num_rollouts=32, ppo_epochs=2,
            train_batch_size=16, max_new_tokens=MAX_NEW, kl_coef=0.02,
        ),
        reward_fn=reward_fn,
    )
    history = trainer.train([prompts, prompts])
    for h in history:
        print(h)
    return iterations, history


if __name__ == "__main__":
    main()
