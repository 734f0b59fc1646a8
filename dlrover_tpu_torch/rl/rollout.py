"""End-to-end PPO iteration over the four-role engine.

Reference: ``dlrover_tpu/rl/rollout.py`` (the RLHF loop the ATorch
engine drives, ``atorch/rl/model_engine/model_engine.py:35`` + ppo
utils): the actor generates rollouts, reward and ref score them, critic
values + GAE turn them into advantages, actor and critic take PPO steps.
The heavy parts run on the roles' devices (generation through the
decode variant's KV cache, the train steps through the roles' plans);
the glue is plain Python per iteration, and each phase is timed to the
end of its device work.
"""

import functools
import time
from typing import Callable, Dict, Optional

import torch

from dlrover_tpu_torch.rl import generation as _generation
from dlrover_tpu_torch.rl.generation import decode_variant, generate
from dlrover_tpu_torch.rl.model_engine import ModelRole, RLModelEngine, _sync
from dlrover_tpu_torch.rl.ppo import (
    gae_advantages,
    kl_penalty,
    ppo_critic_loss,
    ppo_policy_loss,
    token_logprobs,
)


@functools.lru_cache(maxsize=8)
def _inference_apply(model):
    """One inference callable per module (the reference's per-module
    ``_jitted_apply``): ``fn(params, x)`` runs ``model`` under
    ``no_grad`` on ``params`` (a name -> tensor mapping, bound as
    ``torch.func.functional_call`` binds it) or on its own weights when
    ``params`` is None.  Bounded, so module churn cannot pin modules."""

    @torch.no_grad()
    def apply(params, x):
        if params is None:
            return model(x)
        return torch.func.functional_call(model, dict(params), (x,))

    return apply


@functools.lru_cache(maxsize=8)
def _decode_model(model):
    """The decode variant of a role's module (shapes only, on meta),
    built once per module."""
    return decode_variant(model)


def make_actor_loss(model, prompt_len: int, clip_ratio: float = 0.2):
    """PPO-clip policy loss over the response region of the rollout
    batch ``{"tokens", "old_logprobs", "advantages"}``, as
    ``loss_fn(module, batch)``: ``module`` is the plan's model the step
    passes (``model`` names the role's module, as the reference's
    closure does)."""

    def loss_fn(module, batch):
        tokens = batch["tokens"]
        logits = module(tokens[:, :-1])
        lp = token_logprobs(logits, tokens[:, 1:])
        return ppo_policy_loss(
            lp[:, prompt_len - 1:], batch["old_logprobs"],
            batch["advantages"], clip_ratio=clip_ratio,
        )

    return loss_fn


def make_critic_loss(model, prompt_len: int):
    """Value regression over the response region of ``{"tokens",
    "returns"}``; the module has ``head="value"``."""

    def loss_fn(module, batch):
        values = module(batch["tokens"][:, :-1])
        return ppo_critic_loss(values[:, prompt_len - 1:], batch["returns"])

    return loss_fn


def sample_rollout_batch(prompts, max_new_tokens: int) -> Dict:
    """A batch shaped as ppo_iteration's real batches (CPU tensors of
    zeros): what the engine needs at build time to plan, and search,
    the train steps."""
    b, prompt_len = prompts.shape
    total = prompt_len + max_new_tokens
    dtype = torch.as_tensor(prompts).dtype
    return {
        "tokens": torch.zeros((b, total), dtype=dtype),
        "old_logprobs": torch.zeros((b, max_new_tokens)),
        "advantages": torch.zeros((b, max_new_tokens)),
        "returns": torch.zeros((b, max_new_tokens)),
    }


def make_experience(
    engine: RLModelEngine,
    prompts,
    generator: Optional[torch.Generator] = None,
    max_new_tokens: int = 16,
    temperature: float = 1.0,
    kl_coef: float = 0.05,
    gamma: float = 1.0,
    lam: float = 0.95,
    reward_fn: Callable = None,
    hybrid=None,
    rollout_params=None,
):
    """EXPERIENCE phase of one PPO cycle (reference
    ``make_experience``): rollout -> ref-KL scoring -> reward -> GAE,
    producing the training batch WITHOUT a gradient step, so a trainer
    can fill a replay buffer with several rollouts first.

    ``generator`` (a ``torch.Generator`` on the engine's device) drives
    sampling.  ``hybrid`` generates on the actor's rollout layout
    (:class:`~dlrover_tpu_torch.rl.hybrid_engine.HybridRolloutEngine`);
    ``rollout_params`` (params already in that layout, from a phase
    hook) skips the per-call reshard.  Without ``hybrid`` the actor
    generates on its train parameters (a sharded one gathered whole).
    The critic's values come from its plan's module (its kernels, its
    layout).  Returns (batch dict of tensors on the engine's device,
    metrics); the metrics carry the phase seconds (``rollout_s`` =
    generation, ``score_s`` = ref-KL + reward, ``gae_s`` = critic
    values + GAE), each to the end of its device work."""
    device = engine.device
    prompts = torch.as_tensor(prompts).to(device)
    b, prompt_len = prompts.shape
    fresh_reshard = False
    if hybrid is not None:
        decode_model = hybrid.rollout_model
        if rollout_params is not None:
            params = rollout_params
        else:
            params = hybrid.reshard_actor_for_rollout()
            fresh_reshard = True
        local_prompts = hybrid.place_rollout_batch(prompts)
    else:
        actor = engine.state(ModelRole.ACTOR).module
        decode_model = _decode_model(actor)
        params = _generation.rollout_params(actor)
        local_prompts = prompts

    t0 = time.perf_counter()
    sequences, old_logps = generate(
        decode_model, params, local_prompts, generator,
        max_new_tokens=max_new_tokens, temperature=temperature,
    )
    if hybrid is not None:
        sequences, old_logps = hybrid.gather_rollout_batch(
            sequences, old_logps)
    _sync(device)
    t_rollout = time.perf_counter()

    with torch.no_grad():
        # reference logprobs over the response region (KL anchor)
        ref_logits = engine.infer(ModelRole.REF, sequences[:, :-1])
        ref_lp = token_logprobs(
            ref_logits, sequences[:, 1:])[:, prompt_len - 1:]
        del ref_logits
        if reward_fn is not None:
            seq_reward = reward_fn(sequences)
        else:
            # reward model: per-token values, the last token scores
            # the sequence
            seq_reward = engine.infer(ModelRole.REWARD, sequences)[:, -1]
        seq_reward = torch.as_tensor(seq_reward, dtype=torch.float32,
                                     device=device)
        # per-token reward = -KL penalty, the sequence's reward on its
        # last token
        kl = kl_penalty(old_logps, ref_lp, kl_coef)
        rewards = -kl
        rewards[:, -1] += seq_reward
        _sync(device)
        t_score = time.perf_counter()

        critic = engine.state(ModelRole.CRITIC).module
        values = _inference_apply(critic)(
            None, sequences[:, :-1])[:, prompt_len - 1:]
        dones = torch.zeros_like(rewards)
        dones[:, -1] = 1.0
        advantages, returns = gae_advantages(
            rewards, values, dones, gamma=gamma, lam=lam)
    batch = {
        "tokens": sequences,
        "old_logprobs": old_logps,
        "advantages": advantages,
        "returns": returns,
    }
    _sync(device)
    t_gae = time.perf_counter()
    metrics = {
        "mean_reward": float(seq_reward.mean()),
        "mean_kl": float(kl.mean()),
        "rollout_s": round(t_rollout - t0, 4),
        "score_s": round(t_score - t_rollout, 4),
        "gae_s": round(t_gae - t_score, 4),
    }
    if fresh_reshard:
        metrics["reshard_s"] = hybrid.reshard_times[-1]
    return batch, metrics


def train_on_batch(
    engine: RLModelEngine, batch: Dict, steps: Dict = None
) -> Dict[str, float]:
    """TRAINING phase: one actor + one critic PPO step on an experience
    batch (reference: ``RLTrainer.rl_training``'s inner update).
    ``steps`` optionally maps role -> step callable in place of the
    engine's steps (same signature)."""
    losses = {}
    for role in (ModelRole.ACTOR, ModelRole.CRITIC):
        placed = engine.place_batch(role, batch)
        step_fn = (steps[role] if steps and role in steps
                   else engine.train_step(role))
        state, metrics = step_fn(engine.state(role), placed)
        engine.set_state(role, state)
        losses[f"{role}_loss"] = float(metrics["loss"])
    return losses


def ppo_iteration(
    engine: RLModelEngine,
    prompts,
    generator: Optional[torch.Generator] = None,
    max_new_tokens: int = 16,
    temperature: float = 1.0,
    kl_coef: float = 0.05,
    gamma: float = 1.0,
    lam: float = 0.95,
    reward_fn: Callable = None,
    hybrid=None,
) -> Dict[str, float]:
    """One full PPO iteration: make_experience + train_on_batch.
    ``reward_fn(sequences) -> [b]`` overrides the reward role
    (otherwise the reward model scores the final token).  Returns the
    metrics, the mean sequence reward among them, with ``train_s``, the
    seconds of the two train steps."""
    batch, metrics = make_experience(
        engine, prompts, generator, max_new_tokens=max_new_tokens,
        temperature=temperature, kl_coef=kl_coef, gamma=gamma,
        lam=lam, reward_fn=reward_fn, hybrid=hybrid,
    )
    t0 = time.perf_counter()
    metrics.update(train_on_batch(engine, batch))
    _sync(engine.device)
    metrics["train_s"] = round(time.perf_counter() - t0, 4)
    return metrics
