"""Autoregressive rollout generation with a KV cache.

Reference: ``dlrover_tpu/rl/generation.py`` (the RLHF engine's actor
generation, ``atorch/rl/model_engine/model_engine.py:35``).  The model
runs in decode mode (``config.decode=True``: each attention layer keeps
a KV cache, :class:`~dlrover_tpu_torch.models.gpt.DecodeCache`): one
prefill call over the prompt, then one call a token.  Where the
reference scans the steps inside one jit, here the host drives the
loop, one chain of launches a token.  Sampling draws from an explicit
``torch.Generator`` (Gumbel-max over ``logits / temperature``, as
``jax.random.categorical`` samples); ``temperature <= 0`` is argmax.
Returns the sequences and the per-token logprobs of the sampled tokens
under the untempered logits (the "old" policy logprobs PPO needs).
"""

import contextlib
import dataclasses
from typing import Mapping, Optional, Tuple

import torch
from torch import nn
from torch.nn.utils.stateless import _reparametrize_module

from dlrover_tpu_torch.common.device import is_dtensor


def _module_class(model: nn.Module) -> type:
    """The model's own class under FSDP2's wrapper class (``FSDPGPT``
    derives from ``FSDPModule`` and ``GPT``)."""
    try:
        from torch.distributed.fsdp import FSDPModule
    except ImportError:  # a torch built without distributed
        return type(model)
    for cls in type(model).__mro__:
        if issubclass(cls, nn.Module) and not issubclass(cls, FSDPModule):
            return cls
    return type(model)


def decode_variant(model: nn.Module, device="meta") -> nn.Module:
    """The same architecture with the KV-cache decode path, built on
    ``device`` (``"meta"`` by default: shapes only, as the reference's
    unbound flax module; :func:`generate` then runs it on the params it
    is given).  Its params are declared in the compute dtype (the
    layernorms stay fp32, an fp8 model keeps its own): every token step
    reads its weights in that dtype anyway, and :func:`generate` casts
    each param once a call instead of once a step."""
    cfg = model.config
    updates = {"decode": True}
    if not getattr(cfg, "fp8", False) and getattr(cfg, "head", "lm") == "lm":
        updates["param_dtype"] = cfg.dtype
    return _module_class(model)(dataclasses.replace(cfg, **updates),
                                device=device)


def rollout_params(model: nn.Module) -> dict:
    """``model``'s parameters by name as plain tensors to generate with:
    a plain parameter as it is (no copy: generation reads it under
    ``no_grad``), a DTensor (FSDP2, tensor parallel) gathered whole."""
    return {
        name: (p.full_tensor() if is_dtensor(p) else p).detach()
        for name, p in model.named_parameters()
    }


def _sample(logits_last: torch.Tensor, generator, temperature: float):
    if is_dtensor(logits_last):
        # vocab-parallel logits (a tensor-parallel head): every rank
        # samples the same token from the whole row
        logits_last = logits_last.full_tensor()
    logits_last = logits_last.float()
    if temperature <= 0.0:
        tok = torch.argmax(logits_last, dim=-1)
    else:
        u = torch.rand(logits_last.shape, generator=generator,
                       device=logits_last.device)
        gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))
        tok = torch.argmax(logits_last / temperature + gumbel, dim=-1)
    logp = torch.log_softmax(logits_last, dim=-1)
    return tok, torch.gather(logp, -1, tok[:, None])[:, 0]


def bind_params(model: nn.Module,
                params: Optional[Mapping[str, torch.Tensor]]):
    """A context that runs ``model`` on ``params`` (what
    ``torch.func.functional_call`` does for one call, here for a whole
    loop), each cast to the dtype the model declares for it; ``None``
    keeps the model's own weights."""
    if params is None:
        return contextlib.nullcontext()
    own = dict(model.named_parameters())
    return _reparametrize_module(model, {
        n: p.to(own[n].dtype) if n in own else p for n, p in params.items()})


@torch.no_grad()
def generate(
    model: nn.Module,
    params: Optional[Mapping[str, torch.Tensor]],
    prompts: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    max_new_tokens: int = 16,
    temperature: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sample continuations of ``prompts`` ``[b, prompt_len]``.

    Returns (sequences ``[b, prompt_len + max_new_tokens]``, logprobs
    ``[b, max_new_tokens]`` of the sampled tokens).  ``model`` must be
    the decode variant (:func:`decode_variant`); it runs on ``params``
    (a name -> tensor mapping, :func:`rollout_params`, each cast to the
    dtype the model declares for it and bound as
    ``torch.func.functional_call`` binds them), or on its own weights when
    ``params`` is None.  Its caches are reset before the prefill and
    after the last step.  ``generator`` (on the prompts' device) is
    needed when ``temperature > 0``."""
    b, prompt_len = prompts.shape
    max_len = model.config.max_seq_len
    if prompt_len + max_new_tokens > max_len:
        raise ValueError(
            f"prompt {prompt_len} + {max_new_tokens} new tokens "
            f"exceeds max_seq_len {max_len}: the KV cache would "
            "silently clamp and corrupt decoding"
        )
    if temperature > 0.0 and generator is None:
        raise ValueError("sampling at temperature > 0 needs a generator")

    model.reset_cache()
    try:
        with bind_params(model, params):
            # prefill: one pass writes the prompt into the cache
            logits = model(prompts)
            tok, logp = _sample(logits[:, -1], generator, temperature)
            toks, logps = [tok], [logp]
            for _ in range(max_new_tokens - 1):
                logits = model(tok[:, None].to(prompts.dtype))
                tok, logp = _sample(logits[:, -1], generator, temperature)
                toks.append(tok)
                logps.append(logp)
    finally:
        model.reset_cache()
    new_tokens = torch.stack(toks, dim=1).to(prompts.dtype)
    return (torch.cat([prompts, new_tokens], dim=1),
            torch.stack(logps, dim=1))
