"""RLHF engine (reference: ``dlrover_tpu/rl/``; ``atorch/atorch/rl/``:
``ModelEngine`` managing actor/critic/ref/reward models each with its
own acceleration strategy, the DeepSpeed-hybrid-engine re-implementation,
PPO utilities).  Every entry point runs on the card unless
``device="cpu"`` is passed."""

from dlrover_tpu_torch.rl.hybrid_engine import HybridRolloutEngine
from dlrover_tpu_torch.rl.model_engine import ModelRole, RLModelEngine
from dlrover_tpu_torch.rl.ppo import (
    gae_advantages,
    ppo_critic_loss,
    ppo_policy_loss,
)
from dlrover_tpu_torch.rl.trainer import (
    PPOTrainer,
    ReplayBuffer,
    RLTrainConfig,
    RLTrainer,
)

__all__ = [
    "HybridRolloutEngine",
    "ModelRole",
    "PPOTrainer",
    "ReplayBuffer",
    "RLTrainConfig",
    "RLTrainer",
    "RLModelEngine",
    "gae_advantages",
    "ppo_critic_loss",
    "ppo_policy_loss",
]
