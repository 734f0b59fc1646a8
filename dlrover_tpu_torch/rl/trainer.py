"""RL trainer loop: experience generation -> replay buffer -> PPO
epochs, with engine layout transitions.

Reference: ``dlrover_tpu/rl/trainer.py`` (``atorch/rl/trainer/
rl_trainer.py``'s make-experience / rl-training cycle with pre/post
hooks and a replay buffer filled to ``num_rollouts`` before each
training phase, ``atorch/rl/replay_buffer/replay_buffer.py`` and the
YAML-loaded ``atorch/rl/config.py``).

Experience batches are host numpy dicts (the buffer is host memory, as
the reference's); PPO epochs place shuffled minibatches through the
roles' train steps, and with a
:class:`~dlrover_tpu_torch.rl.hybrid_engine.HybridRolloutEngine`
attached the actor is copied into its rollout layout ONCE per
experience phase (amortized across every rollout of the phase).
Sampling draws from one ``torch.Generator`` seeded with
``config.seed`` on the engine's device, continued across rollouts.
"""

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.rl.model_engine import RLModelEngine
from dlrover_tpu_torch.rl.rollout import make_experience, train_on_batch


def _host(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


class ReplayBuffer:
    """Host-side experience store (reference: ReplayBuffer).

    Samples are dicts of equal-leading-dim arrays (tensors are copied
    to host numpy); minibatches come back shuffled across everything
    accumulated in the phase.
    """

    def __init__(self):
        self._batches: List[Dict[str, np.ndarray]] = []
        self._merged: Optional[Dict[str, np.ndarray]] = None
        self.num = 0

    def add(self, batch: Dict[str, Any]) -> None:
        host = {k: _host(v) for k, v in batch.items()}
        n = next(iter(host.values())).shape[0]
        for k, v in host.items():
            if v.shape[0] != n:
                raise ValueError(
                    f"ragged batch: {k} has leading dim "
                    f"{v.shape[0]} != {n}"
                )
        self._batches.append(host)
        self._merged = None
        self.num += n

    def reset(self) -> None:
        self._batches = []
        self._merged = None
        self.num = 0

    def batches(self) -> List[Dict[str, np.ndarray]]:
        """The accumulated batches in INSERTION order: the elastic
        plane's checkpoint adapter exports these, and the deterministic
        chaos loop trains on them in this order so a restored
        incarnation replays identical PPO steps."""
        return list(self._batches)

    def minibatches(self, batch_size: int, rng: np.random.Generator):
        """Shuffled minibatches over the whole buffer; a short final
        remainder is dropped (every step sees the planned batch)."""
        if not self._batches:
            return
        if self._merged is None:
            keys = self._batches[0].keys()
            self._merged = {
                k: np.concatenate([b[k] for b in self._batches])
                for k in keys
            }
        data = self._merged
        order = rng.permutation(self.num)
        for i in range(self.num // batch_size):
            idx = order[i * batch_size:(i + 1) * batch_size]
            yield {k: v[idx] for k, v in data.items()}


@dataclass
class RLTrainConfig:
    """Training-loop knobs (reference: atorch/rl/config.py train +
    ppo_config sections; YAML-loadable via :meth:`from_yaml`)."""

    epochs: int = 1
    num_rollouts: int = 64        # buffer fill before each training
    ppo_epochs: int = 4           # passes over the buffer per phase
    train_batch_size: int = 8
    max_new_tokens: int = 16
    temperature: float = 1.0
    kl_coef: float = 0.05
    gamma: float = 1.0
    lam: float = 0.95
    seed: int = 0
    extra: Dict[str, Any] = field(default_factory=dict)

    @classmethod
    def from_yaml(cls, path: str) -> "RLTrainConfig":
        import yaml

        with open(path) as f:
            raw = yaml.safe_load(f) or {}
        known = {
            k: v for k, v in raw.items()
            if k in cls.__dataclass_fields__ and k != "extra"
        }
        extra = {
            k: v for k, v in raw.items()
            if k not in cls.__dataclass_fields__
        }
        return cls(**known, extra=extra)


class RLTrainer:
    """The experience/training cycle (reference: RLTrainer.train).

    Subclasses implement :meth:`make_experience` (fill the buffer from
    a prompt batch) and :meth:`rl_training` (consume the buffer); hooks
    mark the phase transitions, and the hybrid layout copy lives in
    them.
    """

    def __init__(self, engine: RLModelEngine, config: RLTrainConfig,
                 hybrid=None):
        self.engine = engine
        self.config = config
        self.hybrid = hybrid
        self.replay_buffer = ReplayBuffer()
        self.metrics_history: List[Dict[str, float]] = []
        self._np_rng = np.random.default_rng(config.seed)
        self._rollout_params = None

    # -- phase hooks ---------------------------------------------------------

    def pre_experience_hook(self):
        """Entering the experience phase: copy the actor into its
        rollout layout ONCE; every rollout of the phase reuses the copy
        (the actor only trains between phases)."""
        if self.hybrid is not None:
            self._rollout_params = self.hybrid.reshard_actor_for_rollout()

    def post_experience_hook(self):
        # drop the rollout-layout param copy (full actor size)
        self._rollout_params = None

    def pre_training_hook(self):
        pass

    def post_training_hook(self):
        self.replay_buffer.reset()

    # -- to be implemented by subclasses -------------------------------------

    def make_experience(self, prompts, generator) -> Dict[str, float]:
        raise NotImplementedError

    def rl_training(self) -> Dict[str, float]:
        raise NotImplementedError

    # -- the cycle -----------------------------------------------------------

    def train(self, prompt_batches) -> List[Dict[str, float]]:
        """Run ``config.epochs`` passes over ``prompt_batches`` (an
        iterable of prompt arrays): fill the buffer to
        ``num_rollouts``, then run ``ppo_epochs`` of training, and
        repeat (reference: RLTrainer.train's loop)."""
        # a generator would be exhausted after epoch 0 and epochs 1..n
        # would silently train on nothing
        prompt_list = list(prompt_batches)
        generator = torch.Generator(device=self.engine.device).manual_seed(
            int(self.config.seed))
        in_experience = False
        try:
            for epoch in range(self.config.epochs):
                for prompts in prompt_list:
                    if not in_experience:
                        self.pre_experience_hook()
                        in_experience = True
                    exp_metrics = self.make_experience(prompts, generator)
                    if self.replay_buffer.num >= self.config.num_rollouts:
                        self.post_experience_hook()
                        in_experience = False
                        self.pre_training_hook()
                        train_metrics = self.rl_training()
                        self.post_training_hook()
                        self.metrics_history.append(
                            {"epoch": epoch, **exp_metrics, **train_metrics})
                # drain a partial buffer at epoch end
                if self.replay_buffer.num > 0:
                    if in_experience:
                        self.post_experience_hook()
                        in_experience = False
                    self.pre_training_hook()
                    train_metrics = self.rl_training()
                    self.post_training_hook()
                    self.metrics_history.append(
                        {"epoch": epoch, **train_metrics})
        finally:
            if in_experience:
                # never retain the rollout-layout param copy
                self.post_experience_hook()
        return self.metrics_history


class PPOTrainer(RLTrainer):
    """PPO over the four-role engine (reference: PPOTrainer).

    ``reward_fn(sequences) -> [b]`` overrides the reward role.
    """

    def __init__(self, engine: RLModelEngine, config: RLTrainConfig,
                 reward_fn: Optional[Callable] = None, hybrid=None):
        super().__init__(engine, config, hybrid=hybrid)
        self.reward_fn = reward_fn
        sample = getattr(engine, "_sample_batch", None)
        if isinstance(sample, dict) and "tokens" in sample:
            built_b = sample["tokens"].shape[0]
            if config.train_batch_size != built_b:
                raise ValueError(
                    f"train_batch_size {config.train_batch_size} != "
                    f"the engine's built batch dim {built_b}: the roles' "
                    "plans were searched and sized for that batch; build "
                    "the engine with a sample batch of the training "
                    "minibatch size"
                )

    def make_experience(self, prompts, generator) -> Dict[str, float]:
        cfg = self.config
        batch, metrics = make_experience(
            self.engine, prompts, generator,
            max_new_tokens=cfg.max_new_tokens,
            temperature=cfg.temperature,
            kl_coef=cfg.kl_coef, gamma=cfg.gamma, lam=cfg.lam,
            reward_fn=self.reward_fn,
            # the phase hook resharded once; every rollout of the phase
            # reuses that copy
            hybrid=self.hybrid,
            rollout_params=self._rollout_params,
        )
        self.replay_buffer.add(batch)
        return metrics

    def rl_training(self) -> Dict[str, float]:
        cfg = self.config
        losses: Dict[str, List[float]] = {}
        steps = 0
        for _ in range(cfg.ppo_epochs):
            for mb in self.replay_buffer.minibatches(
                cfg.train_batch_size, self._np_rng
            ):
                out = train_on_batch(self.engine, mb)
                steps += 1
                for k, v in out.items():
                    losses.setdefault(k, []).append(v)
        if steps == 0:
            logger.warning(
                "rl_training ran with an empty buffer (buffer %d < "
                "train_batch_size %d?)",
                self.replay_buffer.num, cfg.train_batch_size,
            )
            return {"ppo_steps": 0}
        out = {k: float(np.mean(v)) for k, v in losses.items()}
        out["ppo_steps"] = steps
        return out
