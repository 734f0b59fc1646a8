"""HuggingFace checkpoint interop: HF GPT-2 and Llama state dicts <->
the port's models.

Copy of ``dlrover_tpu/utils/torch_compat.py``, whose functions map HF
state dicts onto the JAX package's flax trees; here the same maps land
on the state dicts of :class:`dlrover_tpu_torch.models.gpt.GPT` and
:class:`dlrover_tpu_torch.models.llama.Llama` (the flax tree's names
under :mod:`dlrover_tpu_torch.utils.convert`'s rules), so a user can
bring a GPT-2 or Llama checkpoint and keep training:

- :func:`gpt2_params_from_torch` — HF ``gpt2`` family
  (``GPT2LMHeadModel``; Conv1D kernels are stored ``[in, out]``, the
  layout of the port's ``Dense``, and map unchanged);
- :func:`llama_params_from_torch` — HF ``LlamaForCausalLM`` family
  incl. GQA (``nn.Linear`` weights are ``[out, in]`` and transpose);
- :func:`gpt2_params_to_torch`, :func:`llama_params_to_torch` — the
  port's state dicts back to HF names.

Each accepts a ``state_dict``-like mapping of torch tensors or numpy
arrays and returns tensors (copies, their dtype kept: a bf16 checkpoint
stays bf16, where the reference goes through fp32 for numpy), so
``model.load_state_dict(...)`` takes the result as it is.
``transformers`` is never imported here.
"""

from typing import Any, Dict, Mapping

import numpy as np
import torch


def _t(x) -> torch.Tensor:
    if isinstance(x, np.ndarray):
        return torch.from_numpy(np.array(x, copy=True))
    return x.detach().cpu().clone()


def _lin(x) -> torch.Tensor:
    """``nn.Linear`` ``[out, in]`` <-> ``Dense`` ``[in, out]``."""
    return _t(x).t().contiguous()


def _strip_prefix(sd: Mapping[str, Any], prefixes=("transformer.",
                                                   "model.")) -> Dict[str, Any]:
    out = {}
    for k, v in sd.items():
        for p in prefixes:
            if k.startswith(p):
                k = k[len(p):]
                break
        out[k] = v
    return out


# (port module, HF module) inside a GPT-2 block
_GPT2_BLOCK = (("ln_attn", "ln_1"), ("attn.qkv", "attn.c_attn"),
               ("attn.o_proj", "attn.c_proj"), ("ln_mlp", "ln_2"),
               ("mlp.fc_in", "mlp.c_fc"), ("mlp.fc_out", "mlp.c_proj"))
_LLAMA_ATTN = ("q_proj", "k_proj", "v_proj", "o_proj")
_LLAMA_MLP = (("gate", "gate_proj"), ("up", "up_proj"),
              ("down", "down_proj"))


def gpt2_params_from_torch(state_dict: Mapping[str, Any]
                           ) -> Dict[str, torch.Tensor]:
    """HF GPT-2 state dict -> the state dict of :class:`GPT`
    (``tie_embeddings=True``; the lm head reuses ``wte``)."""
    sd = _strip_prefix(state_dict)
    out = {"wte.weight": _t(sd["wte.weight"]),
           "wpe.weight": _t(sd["wpe.weight"]),
           "ln_f.weight": _t(sd["ln_f.weight"]),
           "ln_f.bias": _t(sd["ln_f.bias"])}
    i = 0
    while f"h.{i}.ln_1.weight" in sd:
        for ours, theirs in _GPT2_BLOCK:
            for leaf in ("weight", "bias"):
                out[f"blocks.{i}.{ours}.{leaf}"] = _t(
                    sd[f"h.{i}.{theirs}.{leaf}"])
        i += 1
    return out


def llama_params_from_torch(state_dict: Mapping[str, Any]
                            ) -> Dict[str, torch.Tensor]:
    """HF Llama (incl. GQA) state dict -> the state dict of
    :class:`Llama`."""
    sd = _strip_prefix(state_dict)
    out = {"wte.weight": _t(sd["embed_tokens.weight"]),
           "ln_f.weight": _t(sd["norm.weight"]),
           # tied-embedding checkpoints reuse the input embedding
           "lm_head.weight": _lin(sd.get("lm_head.weight",
                                         sd["embed_tokens.weight"]))}
    i = 0
    while f"layers.{i}.input_layernorm.weight" in sd:
        blk, ours = f"layers.{i}.", f"blocks.{i}."
        out[ours + "ln_attn.weight"] = _t(sd[blk + "input_layernorm.weight"])
        for name in _LLAMA_ATTN:
            out[ours + f"attn.{name}.weight"] = _lin(
                sd[blk + f"self_attn.{name}.weight"])
        out[ours + "ln_mlp.weight"] = _t(
            sd[blk + "post_attention_layernorm.weight"])
        for mine, theirs in _LLAMA_MLP:
            out[ours + f"mlp.{mine}.weight"] = _lin(
                sd[blk + f"mlp.{theirs}.weight"])
        i += 1
    return out


# -- inverse direction: export to the torch ecosystem -------------------


def gpt2_params_to_torch(state_dict: Mapping[str, Any]
                         ) -> Dict[str, torch.Tensor]:
    """The state dict of :class:`GPT` -> HF GPT-2 state dict (loads
    into ``GPT2LMHeadModel``)."""
    sd: Dict[str, torch.Tensor] = {
        f"transformer.{name}": _t(state_dict[name])
        for name in ("wte.weight", "wpe.weight", "ln_f.weight", "ln_f.bias")}
    sd["lm_head.weight"] = _t(state_dict["wte.weight"])
    i = 0
    while f"blocks.{i}.ln_attn.weight" in state_dict:
        for ours, theirs in _GPT2_BLOCK:
            for leaf in ("weight", "bias"):
                sd[f"transformer.h.{i}.{theirs}.{leaf}"] = _t(
                    state_dict[f"blocks.{i}.{ours}.{leaf}"])
        i += 1
    return sd


def llama_params_to_torch(state_dict: Mapping[str, Any]
                          ) -> Dict[str, torch.Tensor]:
    """The state dict of :class:`Llama` -> HF Llama state dict."""
    sd: Dict[str, torch.Tensor] = {
        "model.embed_tokens.weight": _t(state_dict["wte.weight"]),
        "model.norm.weight": _t(state_dict["ln_f.weight"]),
        "lm_head.weight": _lin(state_dict["lm_head.weight"]),
    }
    i = 0
    while f"blocks.{i}.ln_attn.weight" in state_dict:
        blk, ours = f"model.layers.{i}.", f"blocks.{i}."
        sd[blk + "input_layernorm.weight"] = _t(
            state_dict[ours + "ln_attn.weight"])
        for name in _LLAMA_ATTN:
            sd[blk + f"self_attn.{name}.weight"] = _lin(
                state_dict[ours + f"attn.{name}.weight"])
        sd[blk + "post_attention_layernorm.weight"] = _t(
            state_dict[ours + "ln_mlp.weight"])
        for mine, theirs in _LLAMA_MLP:
            sd[blk + f"mlp.{theirs}.weight"] = _lin(
                state_dict[ours + f"mlp.{mine}.weight"])
        i += 1
    return sd
