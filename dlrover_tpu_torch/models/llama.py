"""Llama-family decoder (RMSNorm + RoPE + SwiGLU + GQA) in PyTorch.

Reference: ``dlrover_tpu/models/llama.py`` (flax).  The same model with
the same numerics policy, sharing the conventions of
:mod:`dlrover_tpu_torch.models.gpt`:

- compute in ``config.dtype`` (bf16 by default) over
  ``config.param_dtype`` params; the residual stream stays in the
  compute dtype; RMSNorm runs in fp32 and casts back to its input's
  dtype, and its ``scale`` stays fp32 whatever ``param_dtype`` is (the
  reference declares it fp32);
- separate ``q_proj``/``k_proj``/``v_proj``/``o_proj`` and SwiGLU
  ``gate``/``up``/``down`` projections with no bias, in flax's
  ``[in, out]`` layout (:class:`~dlrover_tpu_torch.models.gpt.Dense`);
- RoPE in the reference's split-halves form (``x1, x2`` the two halves
  of the head, rotated as ``[x1 cos - x2 sin, x1 sin + x2 cos]``, not
  the interleaved pairs of some other ports), angles in fp32;
- grouped-query attention: ``"flash"`` passes ``kv_heads < heads``
  straight to the CUDA kernels, which read each kv head once per group;
  ``"xla"`` (the plain math) repeats k and v first, as the reference
  does for an attention function that is not GQA-aware;
- an untied ``lm_head``, logits returned as fp32; ``return_hidden``
  gives the final RMSNorm's output for the chunked loss
  (:mod:`dlrover_tpu_torch.models.losses`); under tensor parallelism
  ``wte`` and ``lm_head`` are split by vocab (the logits a DTensor
  sharded on vocab, which the losses reduce without gathering);
- ``remat`` recomputes each block in the backward as GPT's does
  (``"full"``: ``torch.utils.checkpoint``; ``"offload"``: the block's
  input in pinned host memory);
- tensor parallelism: each rank takes ``heads/t`` q heads and the
  ``kv_heads/t`` kv heads they read, so the GQA group is kept; when
  ``t`` does not divide ``kv_heads`` each rank reads the whole k and v
  (gathered) and takes the kv heads its q heads need, their gradients
  summed over the tensor ranks.

Parameter names follow the flax tree (``wte``,
``blocks.i.{ln_attn,attn.{q,k,v,o}_proj,ln_mlp,mlp.{gate,up,down}}``,
``ln_f``, ``lm_head``), so :mod:`dlrover_tpu_torch.utils.convert` maps
one onto the other and the partition rules of
:func:`~dlrover_tpu_torch.parallel.sharding.gpt_tp_rules` apply.

Mixtral: ``moe_experts > 0`` replaces the SwiGLU MLP of every
``moe_every``-th block with gated experts (``moe/router``,
``moe/experts_w_{in,gate,out}``, as the reference names them;
:mod:`dlrover_tpu_torch.parallel.moe`).  Sequence parallelism:
``attention_impl`` ``"ring"`` (GQA-aware, over the flash kernels),
``"ulysses"`` and ``"ulysses_flash"`` (k and v repeated first), RoPE at
each rank's global positions.  Pipeline parallelism:
:meth:`Llama.to_pipelined` gives a :class:`PipelinedLlama` (the stage-
stacked layout of :class:`~dlrover_tpu_torch.models.gpt.
PipelinedDecoder`).  Decode (``decode=True``, reference
``llama.py:152-186``): each attention layer keeps a KV cache at kv-head
granularity (GQA, never repeated;
:class:`~dlrover_tpu_torch.models.gpt.DecodeCache`) and RoPE runs at the
absolute positions the cache index gives; :meth:`Llama.reset_cache`
clears it.
"""

import functools
from dataclasses import dataclass
from typing import Optional, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.autograd.graph import save_on_cpu
from torch.utils.checkpoint import checkpoint

from dlrover_tpu_torch.common.device import is_dtensor, resolve_device
from dlrover_tpu_torch.models.gpt import (
    Dense,
    DecodeCache,
    PipelinedDecoder,
    get_attention_fn,
    init_flax_weights,
    moe_layer,
    reset_cache,
    uses_moe,
)
from dlrover_tpu_torch.parallel.sequence import sequence_offset
from dlrover_tpu_torch.parallel.sharding import vocab_parallel_embedding


@dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    max_seq_len: int = 4096
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 32      # < num_heads -> grouped-query attn
    hidden_dim: int = 4096
    intermediate_dim: int = 11008
    rope_theta: float = 10000.0
    rms_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16       # activation/compute dtype
    param_dtype: torch.dtype = torch.float32  # master params
    remat: bool = False
    remat_policy: str = "full"  # "full" | "offload" (see gpt.py)
    # "xla" = plain attention math; "flash" = the CUDA flash kernels;
    # "ring" | "ulysses" | "ulysses_flash" over the sequence axis
    attention_impl: str = "xla"
    decode: bool = False
    # Mixtral-style sparse MoE: >0 replaces the SwiGLU MLP of every
    # ``moe_every``-th block with gated experts
    moe_experts: int = 0
    moe_top_k: int = 2
    moe_every: int = 1
    moe_capacity_factor: float = 1.25

    def __post_init__(self):
        if self.remat_policy not in ("full", "offload"):
            raise ValueError(
                f"unknown remat_policy {self.remat_policy!r} "
                "(full | offload)"
            )
        if self.remat_policy != "full" and not self.remat:
            raise ValueError(
                "remat_policy='offload' requires remat=True"
            )

    @property
    def head_dim(self) -> int:
        return self.hidden_dim // self.num_heads

    # the reference's presets; a keyword overrides a preset's field
    # (the reference's presets take only the fields they leave free)
    @classmethod
    def tiny(cls, **kw) -> "LlamaConfig":
        return cls(**{**dict(
            vocab_size=256, max_seq_len=128, num_layers=2,
            num_heads=4, num_kv_heads=2, hidden_dim=64,
            intermediate_dim=128), **kw})

    @classmethod
    def llama2_7b(cls, **kw) -> "LlamaConfig":
        return cls(**kw)

    @classmethod
    def llama3_8b(cls, **kw) -> "LlamaConfig":
        return cls(**{**dict(
            vocab_size=128256, max_seq_len=8192, num_layers=32,
            num_heads=32, num_kv_heads=8, hidden_dim=4096,
            intermediate_dim=14336, rope_theta=500000.0), **kw})

    @classmethod
    def mixtral_8x7b(cls, **kw) -> "LlamaConfig":
        """Mixtral-class sparse MoE (8 experts, top-2, GQA)."""
        return cls(**{**dict(
            vocab_size=32000, max_seq_len=4096, num_layers=32,
            num_heads=32, num_kv_heads=8, hidden_dim=4096,
            intermediate_dim=14336, rope_theta=1e6,
            moe_experts=8, moe_top_k=2), **kw})


def _check_supported(cfg: LlamaConfig):
    """The head counts' constraint (every option of the reference's
    Llama is ported)."""
    if cfg.num_heads % cfg.num_kv_heads:
        raise ValueError(f"num_heads {cfg.num_heads} is not a multiple of "
                         f"num_kv_heads {cfg.num_kv_heads}")


class RMSNorm(nn.Module):
    """``x * rsqrt(mean(x^2) + eps) * scale`` in fp32, cast back to
    ``x``'s dtype; ``weight`` is the reference's fp32 ``scale``."""

    def __init__(self, dim: int, eps: float = 1e-5, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(
            torch.ones(dim, dtype=torch.float32, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        norm = x32 * torch.rsqrt(
            (x32 * x32).mean(dim=-1, keepdim=True) + self.eps)
        return (norm * self.weight).to(x.dtype)


def _rope_angles(positions: torch.Tensor, d: int, theta: float):
    """cos and sin of ``positions * theta^(-2i/d)`` in fp32, shaped to
    broadcast over ``[b, s, h, d/2]``."""
    freqs = 1.0 / (theta ** (torch.arange(
        0, d, 2, dtype=torch.float32, device=positions.device) / d))
    angles = positions[:, None].to(torch.float32) * freqs[None, :]
    return torch.cos(angles)[None, :, None, :], torch.sin(angles)[None, :,
                                                                   None, :]


@functools.lru_cache(maxsize=4)
def _decode_angles(start: int, s: int, d: int, theta: float, device):
    """:func:`_rope_angles` at positions ``start .. start + s``: every
    layer of a decode step reads the same ones, computed once."""
    return _rope_angles(torch.arange(s, device=device) + start, d, theta)


def _rotate(x: torch.Tensor, cos, sin) -> torch.Tensor:
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Rotary position embedding on ``[b, s, h, d]``: the two halves of
    each head rotated by ``positions * theta^(-2i/d)``, in fp32."""
    return _rotate(x, *_rope_angles(positions, x.shape[-1], theta))


def _tensor_parallel_heads(q, k, v, cfg: LlamaConfig, b: int, s: int):
    """This rank's q heads and the kv heads they read, as plain
    ``[b, s, heads, head_dim]`` tensors, from the DTensor outputs of the
    column-parallel projections (sharded on their last dim)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    hd = cfg.head_dim
    mesh = q.device_mesh
    t, r = mesh.size(), mesh.get_local_rank()
    if cfg.num_heads % t:
        raise ValueError(f"tensor parallelism over {t} ranks needs the "
                         f"heads ({cfg.num_heads}) divisible by it")
    q = q.reshape(b, s, cfg.num_heads, hd).redistribute(
        placements=[Shard(2)]).to_local()
    kvh, per = cfg.num_kv_heads, cfg.num_heads // t
    group = cfg.num_heads // kvh
    out = [q]
    for x in (k, v):
        if kvh % t == 0 and is_dtensor(x):
            # the rank's own kv_heads / t heads: the GQA group kept
            x = x.reshape(b, s, kvh, hd).redistribute(
                placements=[Shard(2)]).to_local()
        else:
            # kv heads split across ranks: every rank reads k and v whole
            # and takes the heads its q heads read; each rank's gradient
            # is a partial sum over the tensor ranks
            if not is_dtensor(x):
                x = DTensor.from_local(x, mesh, [Replicate()],
                                       run_check=False)
            x = x.redistribute(placements=[Replicate()]).to_local(
                grad_placements=[Partial()])
            lo, hi = r * per // group, ((r + 1) * per - 1) // group + 1
            x = x.reshape(b, s, kvh, hd)[:, :, lo:hi]
        out.append(x)
    return out


class LlamaAttention(nn.Module):
    def __init__(self, config: LlamaConfig, device=None):
        super().__init__()
        self.config = config
        d, hd, pd = config.hidden_dim, config.head_dim, config.param_dtype
        self.q_proj = Dense(d, config.num_heads * hd, bias=False, dtype=pd,
                            device=device)
        self.k_proj = Dense(d, config.num_kv_heads * hd, bias=False,
                            dtype=pd, device=device)
        self.v_proj = Dense(d, config.num_kv_heads * hd, bias=False,
                            dtype=pd, device=device)
        self.o_proj = Dense(config.num_heads * hd, d, bias=False, dtype=pd,
                            device=device)
        self._attn = get_attention_fn(config.attention_impl)
        if config.decode:
            self.cache = DecodeCache(config.max_seq_len)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        b, s, _ = x.shape
        q = self.q_proj(x, cfg.dtype)
        k = self.k_proj(x, cfg.dtype)
        v = self.v_proj(x, cfg.dtype)
        if is_dtensor(q):
            q, k, v = _tensor_parallel_heads(q, k, v, cfg, b, s)
        else:
            q, k, v = (t.reshape(b, s, -1, cfg.head_dim) for t in (q, k, v))
        if cfg.decode:
            # RoPE at the absolute positions that follow the cache's
            angles = _decode_angles(self.cache.cache_index, s, cfg.head_dim,
                                    cfg.rope_theta, x.device)
            q, k = _rotate(q, *angles), _rotate(k, *angles)
            out = self.cache.attend(q, k, v, cfg.dtype)
            return self.o_proj(out.reshape(b, s, -1), cfg.dtype)
        # under sequence parallelism this rank's shard starts later
        positions = torch.arange(s, device=x.device) + sequence_offset(
            cfg.attention_impl, s)
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
        group = q.shape[2] // k.shape[2]
        if group > 1 and not getattr(self._attn, "gqa_aware", False):
            # the plain math and Ulysses need the materialized repeat
            k = k.repeat_interleave(group, dim=2)
            v = v.repeat_interleave(group, dim=2)
        out = self._attn(q, k, v, dtype=cfg.dtype)
        return self.o_proj(out.reshape(b, s, -1), cfg.dtype)


class LlamaMLP(nn.Module):
    """SwiGLU: ``down(silu(gate(x)) * up(x))``."""

    def __init__(self, config: LlamaConfig, device=None):
        super().__init__()
        self.config = config
        d, m, pd = config.hidden_dim, config.intermediate_dim, \
            config.param_dtype
        self.gate = Dense(d, m, bias=False, dtype=pd, device=device)
        self.up = Dense(d, m, bias=False, dtype=pd, device=device)
        self.down = Dense(m, d, bias=False, dtype=pd, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = self.config.dtype
        return self.down(F.silu(self.gate(x, dtype)) * self.up(x, dtype),
                         dtype)


class LlamaBlock(nn.Module):
    def __init__(self, config: LlamaConfig, device=None,
                 use_moe: bool = False):
        super().__init__()
        self.config = config
        self.ln_attn = RMSNorm(config.hidden_dim, config.rms_eps, device)
        self.attn = LlamaAttention(config, device)
        self.ln_mlp = RMSNorm(config.hidden_dim, config.rms_eps, device)
        if use_moe:
            # SwiGLU experts (Mixtral)
            self.moe = moe_layer(config, config.intermediate_dim, True,
                                 device)
        else:
            self.mlp = LlamaMLP(config, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.ln_attn(x))
        mlp = self.moe if hasattr(self, "moe") else self.mlp
        return x + mlp(self.ln_mlp(x))


class Llama(nn.Module):
    """Llama over ``[batch, seq]`` int tokens -> fp32 logits.

    Built on ``device`` (the GPU unless ``"cpu"`` is passed; ``"meta"``
    for shapes only), with weights drawn from ``seed`` on that device as
    flax's default initializers draw them
    (:func:`~dlrover_tpu_torch.models.gpt.init_flax_weights`), so an 8B
    model needs no pass over the host."""

    def __init__(
        self,
        config: LlamaConfig,
        device: Optional[Union[str, torch.device]] = None,
        seed: int = 0,
    ):
        super().__init__()
        _check_supported(config)
        self.config = config
        device = resolve_device(device)
        d, pd = config.hidden_dim, config.param_dtype
        self.wte = nn.Embedding(config.vocab_size, d, dtype=pd, device=device)
        self.blocks = nn.ModuleList(
            LlamaBlock(config, device, uses_moe(config, i))
            for i in range(config.num_layers)
        )
        self.ln_f = RMSNorm(d, config.rms_eps, device)
        self.lm_head = Dense(d, config.vocab_size, bias=False, dtype=pd,
                             device=device)
        if device.type != "meta":
            init_flax_weights(
                self, torch.Generator(device=device).manual_seed(seed))

    def reset_cache(self):
        """Clear the decode caches: the next call prefills."""
        reset_cache(self)

    def forward(self, tokens: torch.Tensor,
                return_hidden: bool = False) -> torch.Tensor:
        """fp32 logits; with ``return_hidden`` the final RMSNorm's output
        in the compute dtype, for the chunked loss."""
        cfg = self.config
        # flax Embed(dtype=...) casts the table, then gathers: the
        # gradient's scatter-add runs in the compute dtype, as there (a
        # no-op cast when the params are already in it)
        x = vocab_parallel_embedding(tokens, self.wte.weight.to(cfg.dtype))
        for block in self.blocks:
            if cfg.remat and torch.is_grad_enabled():
                if cfg.remat_policy == "offload":
                    # the block's input to pinned host memory until the
                    # backward recomputes the block (see gpt.py)
                    with save_on_cpu(pin_memory=True):
                        x = checkpoint(block, x, use_reentrant=True)
                else:
                    x = checkpoint(block, x, use_reentrant=False)
            else:
                x = block(x)
        x = self.ln_f(x)
        if return_hidden:
            return x
        return self.lm_head(x, cfg.dtype).float()

    def to_pipelined(self, num_stages: int, num_microbatches: int,
                     batch_axis=("data", "fsdp")):
        """auto_accelerate protocol hook (build_from_plan calls this
        when the plan's mesh has pipeline > 1)."""
        return PipelinedLlama(self, num_stages, num_microbatches,
                              batch_axis)


class _LlamaEmbed(nn.Module):
    def __init__(self, inner):
        super().__init__()
        self.config = inner.config
        self.wte = inner.wte

    def forward(self, tokens):
        # RoPE blocks need no position embedding at the boundary
        return vocab_parallel_embedding(
            tokens, self.wte.weight.to(self.config.dtype))


class _LlamaHead(nn.Module):
    def __init__(self, inner):
        super().__init__()
        self.config = inner.config
        self.ln_f, self.lm_head = inner.ln_f, inner.lm_head

    def forward(self, h, wte=None):
        return self.lm_head(self.ln_f(h), self.config.dtype).float()


class PipelinedLlama(PipelinedDecoder):
    """Llama family over the pipeline axis (reference:
    ``dlrover_tpu/models/llama.py:307``): RoPE blocks need no position
    embedding at the boundary, RMSNorm and an untied lm head."""

    _embed_cls = _LlamaEmbed
    _head_cls = _LlamaHead
