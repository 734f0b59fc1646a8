"""BERT-family bidirectional encoder in PyTorch.

Reference: ``dlrover_tpu/models/bert.py`` (flax).  The same model with
the same numerics policy and the parameter naming contract of
:mod:`dlrover_tpu_torch.models.gpt` (``qkv``/``o_proj``/``fc_in``/
``fc_out``/``wte``), so ``gpt_tp_rules`` place it unchanged and
:func:`dlrover_tpu_torch.utils.convert.params_from_jax` maps the flax
tree onto it (``block_i/qkv`` is ``blocks.i.qkv``; there is no ``attn``
or ``mlp`` sub-module, as in the reference):

- compute in ``config.dtype`` (bf16 by default) over ``param_dtype``
  params; fp32 layernorms whose params stay fp32, with flax's default
  epsilon 1e-6 (the reference passes none; GPT's ``ln_eps`` is 1e-5);
- ``wte``, ``wpe`` and the segment table ``wse`` drawn as flax's
  ``nn.Embed`` draws them (:func:`~dlrover_tpu_torch.models.gpt.init_flax_weights`),
  each lookup in the compute dtype and summed in that order;
- attention is :func:`bidirectional_attention`: plain ATen math, the
  reference's einsum and masked softmax (no Pallas kernel there, so no
  hand kernel here): fp32 logits, ``-1e30`` where the padding mask is
  0, the probabilities cast to ``dtype`` before the product with v;
- GELU is the tanh approximation (flax's ``nn.gelu``);
- ``remat=True`` recomputes each block in the backward
  (``torch.utils.checkpoint``);
- the MLM logits come from the tied ``wte`` (``wte.attend``, returned
  as fp32); ``num_labels > 0`` ends in a ``[CLS]`` pooler (tanh, the
  compute dtype) and an fp32 ``classifier`` instead;
- under tensor parallelism the qkv output is split by heads as GPT's
  is, ``wte`` is split by vocab and the logits are a DTensor sharded on
  vocab, which :func:`mlm_loss` reduces without gathering.
"""

from dataclasses import dataclass
from typing import Optional, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from dlrover_tpu_torch.common.device import is_dtensor, resolve_device
from dlrover_tpu_torch.models.gpt import Dense, _local_heads, init_flax_weights
from dlrover_tpu_torch.models.losses import vocab_parallel_nll
from dlrover_tpu_torch.parallel.sharding import (
    vocab_logits,
    vocab_parallel_embedding,
)

# flax nn.LayerNorm's default epsilon
LN_EPS = 1e-6


@dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30528  # padded to a multiple of 64
    max_seq_len: int = 512
    num_layers: int = 12
    num_heads: int = 12
    hidden_dim: int = 768
    mlp_ratio: int = 4
    num_segments: int = 2
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    remat: bool = False
    num_labels: int = 0  # >0 adds a classification head

    @property
    def head_dim(self) -> int:
        return self.hidden_dim // self.num_heads

    @classmethod
    def tiny(cls, **kw) -> "BertConfig":
        defaults = dict(
            vocab_size=256, max_seq_len=128, num_layers=2,
            num_heads=4, hidden_dim=64,
        )
        defaults.update(kw)
        return cls(**defaults)

    @classmethod
    def base(cls, **kw) -> "BertConfig":
        return cls(**kw)


def bidirectional_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    mask: Optional[torch.Tensor] = None, dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """Full (non-causal) attention over ``[batch, seq, heads, head_dim]``;
    ``mask`` ``[batch, seq]`` marks the valid keys (nonzero)."""
    # fp32 products of the inputs' values (the reference's
    # preferred_element_type=float32), differentiable: the product with
    # an fp32 output alone (gpt._fp32_bmm) has no derivative
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * (
        q.shape[-1] ** -0.5)
    if mask is not None:
        logits = logits.masked_fill(~mask.bool()[:, None, None, :], -1e30)
    probs = torch.softmax(logits, dim=-1).to(dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v.to(dtype))


def _layer_norm(config: BertConfig, device) -> nn.LayerNorm:
    return nn.LayerNorm(config.hidden_dim, eps=LN_EPS, dtype=torch.float32,
                        device=device)


class EncoderBlock(nn.Module):
    def __init__(self, config: BertConfig, device=None):
        super().__init__()
        self.config = config
        d, pd = config.hidden_dim, config.param_dtype
        self.ln_attn = _layer_norm(config, device)
        self.qkv = Dense(d, 3 * d, dtype=pd, device=device)
        self.o_proj = Dense(d, d, dtype=pd, device=device)
        self.ln_mlp = _layer_norm(config, device)
        self.fc_in = Dense(d, config.mlp_ratio * d, dtype=pd, device=device)
        self.fc_out = Dense(config.mlp_ratio * d, d, dtype=pd, device=device)

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        cfg = self.config
        b, s, d = x.shape
        qkv = self.qkv(self.ln_attn(x.float()).to(cfg.dtype), cfg.dtype)
        if is_dtensor(qkv):
            # tensor parallel: each rank takes its own heads of q, k, v
            q, k, v = (_local_heads(t.reshape(b, s, cfg.num_heads,
                                              cfg.head_dim))
                       for t in qkv.split(d, dim=-1))
        else:
            q, k, v = (t.reshape(b, s, -1, cfg.head_dim)
                       for t in qkv.split(d, dim=-1))
        attn = bidirectional_attention(q, k, v, mask=mask, dtype=cfg.dtype)
        x = x + self.o_proj(attn.reshape(b, s, -1), cfg.dtype)
        h = self.fc_in(self.ln_mlp(x.float()).to(cfg.dtype), cfg.dtype)
        # flax nn.gelu defaults to the tanh approximation
        return x + self.fc_out(F.gelu(h, approximate="tanh"), cfg.dtype)


class Bert(nn.Module):
    """BERT over ``[batch, seq]`` int tokens -> fp32 MLM logits ``[batch,
    seq, vocab]`` (or ``[batch, num_labels]`` with a classifier head).

    Built on ``device`` (the GPU unless ``"cpu"`` is passed; ``"meta"``
    for shapes only), its weights drawn from ``seed`` as the
    reference's initializers draw them."""

    def __init__(
        self,
        config: BertConfig,
        device: Optional[Union[str, torch.device]] = None,
        seed: int = 0,
    ):
        super().__init__()
        self.config = config
        device = resolve_device(device)
        pd, d = config.param_dtype, config.hidden_dim
        self.wte = nn.Embedding(config.vocab_size, d, dtype=pd, device=device)
        self.wpe = nn.Embedding(config.max_seq_len, d, dtype=pd,
                                device=device)
        self.wse = nn.Embedding(config.num_segments, d, dtype=pd,
                                device=device)
        self.blocks = nn.ModuleList(
            EncoderBlock(config, device) for _ in range(config.num_layers))
        self.ln_f = _layer_norm(config, device)
        if config.num_labels:
            self.pooler = Dense(d, d, dtype=pd, device=device)
            self.classifier = Dense(d, config.num_labels, dtype=pd,
                                    device=device)
        if device.type != "meta":
            init_flax_weights(
                self, torch.Generator(device=device).manual_seed(seed))

    def forward(self, tokens: torch.Tensor,
                segment_ids: Optional[torch.Tensor] = None,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        cfg = self.config
        s = tokens.shape[1]
        if segment_ids is None:
            segment_ids = torch.zeros_like(tokens)
        pos = torch.arange(s, device=tokens.device)
        # flax Embed(dtype=...) casts the table; casting the gathered
        # rows gives the same values
        x = (
            vocab_parallel_embedding(tokens, self.wte.weight).to(cfg.dtype)
            + F.embedding(pos, self.wpe.weight).to(cfg.dtype)[None]
            + F.embedding(segment_ids, self.wse.weight).to(cfg.dtype)
        )
        for block in self.blocks:
            if cfg.remat and torch.is_grad_enabled():
                x = checkpoint(block, x, mask, use_reentrant=False)
            else:
                x = block(x, mask)
        x = self.ln_f(x.float())
        if cfg.num_labels:
            # [CLS]-style pooled classification head
            pooled = torch.tanh(self.pooler(x[:, 0].to(cfg.dtype), cfg.dtype))
            return self.classifier(pooled, torch.float32)
        # MLM logits over the tied vocabulary
        return vocab_logits(x.to(cfg.dtype), self.wte.weight.to(cfg.dtype),
                            transpose=True).float()


def mlm_loss(logits: torch.Tensor, targets: torch.Tensor,
             mask: torch.Tensor) -> torch.Tensor:
    """Masked-LM cross entropy over the masked positions only (fp32).
    Logits sharded on vocab (tensor parallelism) are reduced over the
    tensor group, never gathered."""
    if is_dtensor(logits):
        nll = vocab_parallel_nll(logits.float(), targets.long())
    else:
        logp = torch.log_softmax(logits.float(), dim=-1)
        nll = -logp.gather(-1, targets.long()[..., None])[..., 0]
    mask = mask.float()
    return (nll * mask).sum() / mask.sum().clamp_min(1.0)
