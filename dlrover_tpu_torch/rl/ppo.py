"""PPO math for RLHF (pure functions on tensors).

Reference: ``dlrover_tpu/rl/ppo.py`` (ATorch's PPO utilities under
``atorch/rl/``).  Standard PPO-clip with GAE, batched over ``[batch,
time]``, in fp32; the reverse scan of GAE is a loop over time steps.
"""

from typing import Optional, Tuple

import torch


def gae_advantages(
    rewards: torch.Tensor,   # [b, t]
    values: torch.Tensor,    # [b, t]
    dones: torch.Tensor,     # [b, t] 1.0 where the episode ends
    gamma: float = 0.99,
    lam: float = 0.95,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Generalized advantage estimation, propagated backwards in time.

    Returns (advantages ``[b, t]``, normalized to zero mean and unit
    population std as the reference does, returns ``[b, t]``)."""
    rewards, values, dones = (x.float() for x in (rewards, values, dones))
    b, t = rewards.shape
    next_values = torch.cat(
        [values[:, 1:], torch.zeros(b, 1, device=values.device)], dim=1)
    not_done = 1.0 - dones
    deltas = rewards + gamma * next_values * not_done - values
    carry = torch.zeros(b, device=rewards.device)
    adv = []
    for i in range(t - 1, -1, -1):
        carry = deltas[:, i] + gamma * lam * not_done[:, i] * carry
        adv.append(carry)
    advantages = torch.stack(adv[::-1], dim=1)
    returns = advantages + values
    advantages = (advantages - advantages.mean()) / (
        advantages.std(unbiased=False) + 1e-8)
    return advantages, returns


def ppo_policy_loss(
    logprobs: torch.Tensor,      # [b, t] new log pi(a|s)
    old_logprobs: torch.Tensor,  # [b, t]
    advantages: torch.Tensor,    # [b, t]
    clip_ratio: float = 0.2,
    mask: Optional[torch.Tensor] = None,  # [b, t] valid-token mask
) -> torch.Tensor:
    ratio = torch.exp(logprobs - old_logprobs)
    clipped = torch.clamp(ratio, 1 - clip_ratio, 1 + clip_ratio)
    loss = -torch.minimum(ratio * advantages, clipped * advantages)
    if mask is not None:
        return (loss * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return loss.mean()


def ppo_critic_loss(
    values: torch.Tensor,    # [b, t]
    returns: torch.Tensor,   # [b, t]
    old_values: Optional[torch.Tensor] = None,
    clip_value: float = 0.2,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    if old_values is not None:
        v_clipped = old_values + torch.clamp(
            values - old_values, -clip_value, clip_value)
        loss = torch.maximum((values - returns) ** 2,
                             (v_clipped - returns) ** 2)
    else:
        loss = (values - returns) ** 2
    if mask is not None:
        return 0.5 * (loss * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return 0.5 * loss.mean()


def kl_penalty(logprobs: torch.Tensor, ref_logprobs: torch.Tensor,
               kl_coef: float) -> torch.Tensor:
    """Per-token KL penalty against the frozen reference policy."""
    return kl_coef * (logprobs - ref_logprobs)


def token_logprobs(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """log pi of the taken tokens: ``[b, t, v] x [b, t] -> [b, t]``, the
    log-softmax in fp32."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return torch.gather(logp, -1, tokens.long()[..., None])[..., 0]
