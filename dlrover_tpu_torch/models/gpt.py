"""Decoder-only transformer (GPT family) in PyTorch.

Reference: ``dlrover_tpu/models/gpt.py`` (flax).  The same model with
the same numerics policy:

- compute in ``config.dtype`` (bf16 by default) over
  ``config.param_dtype`` params (fp32 master params by default; Dense
  and Embed weights take ``param_dtype``), with fp32 layernorms on the
  residual stream whose params stay fp32 whatever ``param_dtype`` is,
  as flax's ``nn.LayerNorm`` takes none;
- Dense weights in flax's layout, ``[in, out]`` (:class:`Dense`), so a
  weight flattens as the reference's kernel does and blockwise
  optimizer state over it is the reference's, code for code;
- one fused qkv projection, split q|k|v;
- tied ``wte`` head (``wte.attend``: logits = x @ wte^T in the
  compute dtype, returned as fp32);
- attention is pluggable: ``"flash"`` runs the CUDA flash kernels of
  :mod:`dlrover_tpu_torch.ops.flash_attention`; ``"xla"`` keeps its
  name for config parity and is the plain PyTorch math of
  ``xla_causal_attention``;
- ``remat=True`` recomputes each block in the backward through
  ``torch.utils.checkpoint`` (the ``"full"`` policy).

Parameter names follow the flax tree (``block_i/attn/qkv`` is
``blocks.i.attn.qkv``), so :mod:`dlrover_tpu_torch.utils.convert`
maps one onto the other.  Decode with a KV cache, the value head, MoE,
fp8, the offload/save_attn remat policies and pipeline parallelism are
later slices of the port and raise ``NotImplementedError``.
"""

import math
from dataclasses import dataclass
from typing import Optional, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from dlrover_tpu_torch.common.device import resolve_device

_MODEL_ZOO_SLICE = "slice 5 of the port (model zoo and long context)"


@dataclass(frozen=True)
class GPTConfig:
    vocab_size: int = 50304  # GPT-2 vocab padded to a multiple of 128
    max_seq_len: int = 1024
    num_layers: int = 12
    num_heads: int = 12
    hidden_dim: int = 768
    mlp_ratio: int = 4
    # GPT-2's canonical layernorm epsilon (HF checkpoint fidelity)
    ln_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16       # activation/compute dtype
    param_dtype: torch.dtype = torch.float32  # master params
    remat: bool = False
    remat_policy: str = "full"
    # "xla" = plain attention math; "flash" = the CUDA flash kernels
    attention_impl: str = "xla"
    tie_embeddings: bool = True
    decode: bool = False
    head: str = "lm"
    fp8: bool = False
    moe_experts: int = 0

    @property
    def head_dim(self) -> int:
        return self.hidden_dim // self.num_heads

    def __post_init__(self):
        if self.remat_policy not in ("full", "offload", "save_attn"):
            raise ValueError(
                f"unknown remat_policy {self.remat_policy!r} "
                "(full | offload | save_attn)"
            )
        if self.remat_policy != "full" and not self.remat:
            raise ValueError(
                f"remat_policy={self.remat_policy!r} requires "
                "remat=True (the policy chooses WHAT/WHERE to "
                "checkpoint; remat creates the checkpoints)"
            )

    @classmethod
    def tiny(cls, **kw) -> "GPTConfig":
        defaults = dict(
            vocab_size=256, max_seq_len=128, num_layers=2, num_heads=4,
            hidden_dim=64,
        )
        defaults.update(kw)
        return cls(**defaults)

    @classmethod
    def gpt2_small(cls, **kw) -> "GPTConfig":
        return cls(num_layers=12, num_heads=12, hidden_dim=768, **kw)

    @classmethod
    def gpt2_xl(cls, **kw) -> "GPTConfig":
        return cls(
            num_layers=48, num_heads=25, hidden_dim=1600,
            max_seq_len=1024, **kw,
        )


def _check_supported(cfg: GPTConfig):
    """Options of the reference that later slices of the port bring."""
    unsupported = [
        (cfg.decode, "decode (KV-cache attention)", _MODEL_ZOO_SLICE),
        (cfg.head != "lm", f"head={cfg.head!r}",
         "slice 7 of the port (RL)"),
        (cfg.moe_experts > 0, "moe_experts > 0", _MODEL_ZOO_SLICE),
        (cfg.fp8, "fp8 matmuls", _MODEL_ZOO_SLICE),
        (cfg.remat_policy != "full",
         f"remat_policy={cfg.remat_policy!r}", _MODEL_ZOO_SLICE),
        (cfg.attention_impl not in ("xla", "flash"),
         f"attention_impl={cfg.attention_impl!r}", _MODEL_ZOO_SLICE),
    ]
    for bad, what, where in unsupported:
        if bad:
            raise NotImplementedError(
                f"GPT {what} is not ported yet: it comes with {where}"
            )


def xla_causal_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """Plain causal attention; the reference leaves it to XLA.

    q,k,v: [batch, seq, heads, head_dim] -> same shape out.
    """
    seq = q.shape[1]
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    mask = torch.tril(torch.ones(seq, seq, dtype=torch.bool, device=q.device))
    logits = torch.where(mask, logits, torch.full_like(logits, -1e30))
    probs = torch.softmax(logits, dim=-1).to(dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v.to(dtype))


def get_attention_fn(impl: str):
    """xla | flash (sequence-parallel impls come with a later slice)."""
    if impl == "flash":
        from dlrover_tpu_torch.ops.flash_attention import flash_attention

        return flash_attention
    return xla_causal_attention


class Dense(nn.Module):
    """flax ``nn.Dense``: ``weight`` is flax's kernel, ``[in, out]``
    (``nn.Linear`` keeps ``[out, in]``)."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True, dtype=torch.float32, device=None):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.weight = nn.Parameter(torch.empty(
            in_features, out_features, dtype=dtype, device=device))
        self.bias = nn.Parameter(torch.empty(
            out_features, dtype=dtype, device=device)) if bias else None


def _linear(x, layer: Dense, dtype):
    """flax ``Dense(dtype=...)``: input, kernel and bias cast to the
    compute dtype."""
    x, w = x.to(dtype), layer.weight.to(dtype)
    if layer.bias is None:
        return x @ w
    out = torch.addmm(layer.bias.to(dtype), x.reshape(-1, x.shape[-1]), w)
    return out.reshape(*x.shape[:-1], w.shape[-1])


class Attention(nn.Module):
    def __init__(self, config: GPTConfig, device=None):
        super().__init__()
        self.config = config
        d, pd = config.hidden_dim, config.param_dtype
        self.qkv = Dense(d, 3 * d, dtype=pd, device=device)
        self.o_proj = Dense(d, d, dtype=pd, device=device)
        self._attn = get_attention_fn(config.attention_impl)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        b, s, d = x.shape
        qkv = _linear(x, self.qkv, cfg.dtype)
        q, k, v = (
            t.reshape(b, s, cfg.num_heads, cfg.head_dim)
            for t in qkv.split(d, dim=-1)
        )
        out = self._attn(q, k, v, dtype=cfg.dtype)
        return _linear(out.reshape(b, s, d), self.o_proj, cfg.dtype)


class MLP(nn.Module):
    def __init__(self, config: GPTConfig, device=None):
        super().__init__()
        self.config = config
        d, pd = config.hidden_dim, config.param_dtype
        self.fc_in = Dense(d, config.mlp_ratio * d, dtype=pd, device=device)
        self.fc_out = Dense(config.mlp_ratio * d, d, dtype=pd, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = self.config.dtype
        # flax nn.gelu defaults to the tanh approximation
        h = F.gelu(_linear(x, self.fc_in, dtype), approximate="tanh")
        return _linear(h, self.fc_out, dtype)


def _layer_norm(config: GPTConfig, device) -> nn.LayerNorm:
    # fp32 layernorms on the residual stream for stability; their
    # params stay fp32 (flax's nn.LayerNorm takes no param_dtype)
    return nn.LayerNorm(config.hidden_dim, eps=config.ln_eps,
                        dtype=torch.float32, device=device)


class Block(nn.Module):
    def __init__(self, config: GPTConfig, device=None):
        super().__init__()
        self.config = config
        self.ln_attn = _layer_norm(config, device)
        self.attn = Attention(config, device)
        self.ln_mlp = _layer_norm(config, device)
        self.mlp = MLP(config, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = self.config.dtype
        x = x + self.attn(self.ln_attn(x.float()).to(dtype))
        return x + self.mlp(self.ln_mlp(x.float()).to(dtype))


class GPT(nn.Module):
    """GPT over ``[batch, seq]`` int tokens -> fp32 logits.

    Built on ``device`` (the GPU unless ``"cpu"`` is passed), with
    weights drawn from ``seed`` as the reference's initializers draw
    them: lecun-normal Dense kernels, zero biases, fan-in-normal
    embeddings, unit layernorm scales.  The weights are drawn on
    ``device`` by a generator there, so a GPT-2 XL needs no host pass
    over its 1.56B params; one seed therefore gives other weights on
    the card than on the CPU (nothing compares the two).
    """

    def __init__(
        self,
        config: GPTConfig,
        device: Optional[Union[str, torch.device]] = None,
        seed: int = 0,
    ):
        super().__init__()
        _check_supported(config)
        self.config = config
        device = resolve_device(device)
        pd, d = config.param_dtype, config.hidden_dim
        self.wte = nn.Embedding(config.vocab_size, d, dtype=pd, device=device)
        self.wpe = nn.Embedding(config.max_seq_len, d, dtype=pd,
                                device=device)
        self.blocks = nn.ModuleList(
            Block(config, device) for _ in range(config.num_layers)
        )
        self.ln_f = _layer_norm(config, device)
        if not config.tie_embeddings:
            self.lm_head = Dense(d, config.vocab_size, bias=False, dtype=pd,
                                 device=device)
        self._init_weights(torch.Generator(device=device).manual_seed(seed))

    @torch.no_grad()
    def _init_weights(self, gen: torch.Generator):
        # flax truncates its normals at two standard deviations and
        # widens them so the truncated std is the nominal one; drawn in
        # fp32 and rounded once to the param dtype
        def trunc_normal(w, fan_in):
            std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
            draw = torch.empty(w.shape, dtype=torch.float32, device=w.device)
            nn.init.trunc_normal_(draw, std=std, a=-2 * std, b=2 * std,
                                  generator=gen)
            w.copy_(draw)

        for module in self.modules():
            if isinstance(module, Dense):
                trunc_normal(module.weight, module.in_features)
                if module.bias is not None:
                    module.bias.zero_()
            elif isinstance(module, nn.Embedding):
                trunc_normal(module.weight, module.num_embeddings)
            elif isinstance(module, nn.LayerNorm):
                module.weight.fill_(1.0)
                module.bias.zero_()

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        b, s = tokens.shape
        pos = torch.arange(s, device=tokens.device)
        # flax Embed(dtype=...) casts the table; casting the gathered
        # rows is the same values without touching the whole table
        x = (
            F.embedding(tokens, self.wte.weight).to(cfg.dtype)
            + F.embedding(pos, self.wpe.weight).to(cfg.dtype)[None]
        )
        for block in self.blocks:
            if cfg.remat and torch.is_grad_enabled():
                x = checkpoint(block, x, use_reentrant=False)
            else:
                x = block(x)
        x = self.ln_f(x.float()).to(cfg.dtype)
        if cfg.tie_embeddings:
            logits = x @ self.wte.weight.to(cfg.dtype).t()
        else:
            logits = _linear(x, self.lm_head, cfg.dtype)
        return logits.float()


def cross_entropy_loss(
    logits: torch.Tensor, targets: torch.Tensor
) -> torch.Tensor:
    """Mean next-token cross entropy; fp32 for the reduction."""
    return F.cross_entropy(
        logits.float().flatten(0, -2), targets.long().flatten()
    )


def count_params(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())
