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
  compute dtype, returned as fp32); under tensor parallelism ``wte``
  is split by vocab (the lookup summed over the tensor group, the
  logits a DTensor sharded on vocab);
- attention is pluggable: ``"flash"`` runs the CUDA flash kernels of
  :mod:`dlrover_tpu_torch.ops.flash_attention`; ``"xla"`` keeps its
  name for config parity and is the plain PyTorch math of
  ``xla_causal_attention``;
- ``remat=True`` recomputes each block in the backward through
  ``torch.utils.checkpoint`` (the ``"full"`` policy); the ``"offload"``
  policy keeps each block's checkpointed input in pinned host memory
  between the forward and the backward
  (``torch.autograd.graph.save_on_cpu``), the reference's
  ``pinned_host`` residuals; the ``"save_attn"`` policy keeps each
  block's attention output (the reference's ``attn_out``, after
  ``o_proj``) and recomputes the rest: the block is checkpointed in two
  halves, split at ``attn_out`` (:meth:`Block.attn_out`,
  :meth:`Block.mlp_out`), because the selective policy of
  ``torch.utils.checkpoint`` sees ATen ops only and the flash forward is
  a ctypes launch.  As in the reference, the backward of the attention
  half still re-runs its forward (the flash VJP needs O and lse, which
  the policy does not keep): B1 twice, B2 and B3 once a layer, as full
  remat; what the policy saves is the MLP half's recompute of
  attention;
- tensor parallelism (:mod:`dlrover_tpu_torch.accel.accelerate`) makes
  the Dense weights DTensors: the fused qkv comes out sharded over the
  tensor axis and is split by heads, so attention (the CUDA kernels
  included) sees each rank's own heads as plain tensors.

Parameter names follow the flax tree (``block_i/attn/qkv`` is
``blocks.i.attn.qkv``), so :mod:`dlrover_tpu_torch.utils.convert`
maps one onto the other.

Sequence and expert parallelism: ``attention_impl`` ``"ring"``,
``"ulysses"`` and ``"ulysses_flash"`` run over the global mesh's
``sequence`` axis (:mod:`dlrover_tpu_torch.parallel.sequence`; the
ring's blocks and Ulysses' inner ``"ulysses_flash"`` on the flash
kernels), each rank's positions offset by its place in the sequence;
``moe_experts > 0`` replaces the MLP of every ``moe_every``-th block
with a :class:`~dlrover_tpu_torch.parallel.moe.MoEMLP` named ``moe``.
``fp8=True`` runs the MLPs' products in e4m3
(:class:`~dlrover_tpu_torch.ops.fp8.Fp8Dense`).  Pipeline parallelism:
:meth:`GPT.to_pipelined` gives a :class:`PipelinedGPT`, the blocks
stage-stacked (``blocks.<name>`` ``[stages, layers/stage, ...]``) and
run through :mod:`dlrover_tpu_torch.parallel.pipeline`.

Decode (``decode=True``, reference ``gpt.py:195-268, 364-371``): each
attention layer keeps a KV cache (``cached_key``, ``cached_value``,
``cache_index``) and the model a ``pos_index``, so a prompt is
prefilled in one call and then continued one token a call at the
absolute positions that follow; :func:`cached_decode_attention` attends
over the whole ``max_seq_len`` cache under the reference's mask.  The
cache lives in non-persistent module buffers (never parameters, never
in a state dict), allocated by the first call at its batch size and
cleared by :meth:`GPT.reset_cache`; the two indices are host ints, so a
step needs no device read.  The cache is laid out ``[b, kv_heads,
max_len, head_dim]`` (the reference's is ``[b, max_len, kv_heads,
head_dim]``; :func:`dlrover_tpu_torch.utils.convert.cache_from_jax`
transposes), so each step's two products read it in place.
``head="value"`` ends in the RLHF critic's scalar ``value_head`` (fp32
Dense, reference ``:406-412``).
"""

import functools
import math
from dataclasses import dataclass
from typing import Optional, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.autograd.graph import save_on_cpu
from torch.utils.checkpoint import checkpoint

from dlrover_tpu_torch.common.device import is_dtensor, resolve_device
from dlrover_tpu_torch.models.losses import vocab_parallel_nll
from dlrover_tpu_torch.parallel.sequence import sequence_offset
from dlrover_tpu_torch.parallel.sharding import (
    vocab_logits,
    vocab_parallel_embedding,
)


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
    # "xla" = plain attention math; "flash" = the CUDA flash kernels;
    # "ring" | "ulysses" | "ulysses_flash" over the sequence axis
    attention_impl: str = "xla"
    tie_embeddings: bool = True
    decode: bool = False
    head: str = "lm"
    fp8: bool = False
    # MoE: 0 = dense; >0 replaces the MLP of every ``moe_every``-th
    # block with an expert-parallel MoEMLP
    moe_experts: int = 0
    moe_top_k: int = 2
    moe_every: int = 2
    moe_capacity_factor: float = 1.25

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
    if cfg.head not in ("lm", "value"):
        raise ValueError(f"unknown head {cfg.head!r} (lm | value)")


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


def _fp32_bmm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with fp32 products and an fp32 result (the reference's
    ``preferred_element_type=jnp.float32``): on the card a bf16 or fp16
    pair goes through the product with an fp32 output, the operands
    never widened in memory (a step reads its whole cache once)."""
    if a.is_cuda and a.dtype in (torch.bfloat16, torch.float16):
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


def decode_mask(q_pos: torch.Tensor, max_len: int) -> torch.Tensor:
    """``[s, max_len]``, True where a query may not look: a later
    position, or the unfilled tail of the cache."""
    return torch.arange(max_len, device=q_pos.device)[None, :] > q_pos[:, None]


@functools.lru_cache(maxsize=4)
def _step_mask(start: int, s: int, max_len: int, device) -> torch.Tensor:
    """:func:`decode_mask` of positions ``start .. start + s``: every
    layer of a decode step reads the same one, built once."""
    return decode_mask(torch.arange(start, start + s, device=device), max_len)


def cached_decode_attention(
    q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
    q_pos: torch.Tensor, dtype: torch.dtype = torch.bfloat16,
    masked: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Chunked decode attention against a KV cache (reference
    ``dlrover_tpu/models/gpt.py:195``, plain math there too).

    ``q``: ``[b, s_new, h, d]`` (a prompt prefill or a 1-token step);
    ``k_cache``/``v_cache``: ``[b, kv_heads, max_len, d]`` with this
    chunk already written (``kv_heads`` may divide ``h``: GQA, the cache
    never repeated; head ``i`` reads kv head ``i // (h // kv_heads)``);
    ``q_pos``: ``[s_new]`` absolute positions.  Masks both causality
    inside the chunk and the unfilled tail of the cache; the logits and
    the softmax in fp32, the probabilities cast to ``dtype`` for the
    product with ``v``.  ``masked`` is :func:`decode_mask` of ``q_pos``
    when the caller has it."""
    b, s, h, d = q.shape
    kvh, max_len = k_cache.shape[1], k_cache.shape[2]
    group = h // kvh
    # rows (group, query) of each kv head
    qg = q.reshape(b, s, kvh, group, d).permute(0, 2, 3, 1, 4).reshape(
        b * kvh, group * s, d)
    logits = _fp32_bmm(
        qg, k_cache.reshape(b * kvh, max_len, d).transpose(1, 2)
    ) * d ** -0.5
    if masked is None:
        masked = decode_mask(q_pos, max_len)
    # in place (the logits are this call's own; a prefill's are the
    # largest tensor of the step), the [s, max_len] mask broadcast
    # over the group
    logits.view(b * kvh, group, s, max_len).masked_fill_(masked, -1e30)
    probs = torch.softmax(logits, dim=-1).to(dtype)
    out = torch.bmm(probs, v_cache.reshape(b * kvh, max_len, d).to(dtype))
    return out.reshape(b, kvh, group, s, d).permute(0, 3, 1, 2, 4).reshape(
        b, s, h, d)


class DecodeCache(nn.Module):
    """The KV cache of one decode-mode attention layer (the reference's
    ``cache`` collection of the layer): ``cached_key`` and
    ``cached_value`` (``[b, kv_heads, max_len, head_dim]``, the dtype of
    k and v; non-persistent buffers, ``None`` until the first call) and
    ``cache_index``, the next position to write."""

    def __init__(self, max_len: int):
        super().__init__()
        self.max_len = max_len
        self.register_buffer("cached_key", None, persistent=False)
        self.register_buffer("cached_value", None, persistent=False)
        self.cache_index = 0

    def reset(self):
        self.cached_key = self.cached_value = None
        self.cache_index = 0

    def attend(self, q, k, v, dtype) -> torch.Tensor:
        """Write this chunk's ``k``/``v`` (``[b, s, kv_heads, d]``) at
        ``cache_index`` and attend ``q`` over the cache."""
        b, s, kvh, d = k.shape
        pos = self.cache_index
        if pos + s > self.max_len:
            raise ValueError(
                f"decode position {pos} + {s} exceeds max_seq_len "
                f"{self.max_len}: reset the cache (reset_cache())")
        if self.cached_key is None:
            shape = (b, kvh, self.max_len, d)
            self.cached_key = torch.zeros(shape, dtype=k.dtype,
                                          device=k.device)
            self.cached_value = torch.zeros(shape, dtype=v.dtype,
                                            device=v.device)
        self.cached_key[:, :, pos:pos + s] = k.transpose(1, 2)
        self.cached_value[:, :, pos:pos + s] = v.transpose(1, 2)
        self.cache_index = pos + s
        masked = _step_mask(pos, s, self.max_len, q.device)
        return cached_decode_attention(q, self.cached_key, self.cached_value,
                                       None, dtype=dtype, masked=masked)


def reset_cache(model: nn.Module):
    """Clear every decode cache of ``model`` (and its ``pos_index``):
    the next call prefills a new batch."""
    for module in model.modules():
        if isinstance(module, DecodeCache):
            module.reset()
        if hasattr(module, "pos_index"):
            module.pos_index = 0


def _local_heads(t):
    """This rank's heads of a replicated-or-sharded DTensor
    ``[b, s, heads, head_dim]``, as a plain tensor: the heads dim
    sharded over the tensor axis (no copy when it was replicated, an
    all-gather of the grads in the backward)."""
    from torch.distributed.tensor import Shard

    return t.redistribute(placements=[Shard(2)]).to_local()


def get_attention_fn(impl: str):
    """xla | flash | ring | ulysses | ulysses_flash.

    ring and ulysses run over the global mesh's ``sequence`` axis
    (registered by ``auto_accelerate``); activations are this rank's
    sequence shard.  The ring is GQA-aware (its blocks are the flash
    kernels); Ulysses is not, as in the reference, so the model repeats
    k and v before it."""
    if impl == "flash":
        from dlrover_tpu_torch.ops.flash_attention import flash_attention

        return flash_attention
    if impl == "ring":
        from dlrover_tpu_torch.parallel.mesh import get_global_mesh
        from dlrover_tpu_torch.parallel.sequence import ring_attention

        def ring(q, k, v, dtype=torch.bfloat16):
            return ring_attention(q, k, v, get_global_mesh(),
                                  causal=True).to(dtype)

        ring.gqa_aware = True
        return ring
    if impl in ("ulysses", "ulysses_flash"):
        from dlrover_tpu_torch.parallel.mesh import get_global_mesh
        from dlrover_tpu_torch.parallel.sequence import ulysses_attention

        inner = (get_attention_fn("flash") if impl == "ulysses_flash"
                 else xla_causal_attention)

        def ulysses(q, k, v, dtype=torch.bfloat16):
            return ulysses_attention(inner, q, k, v, get_global_mesh(),
                                     dtype=dtype)

        return ulysses
    return xla_causal_attention


class Dense(nn.Module):
    """flax ``nn.Dense``: ``weight`` is flax's kernel, ``[in, out]``
    (``nn.Linear`` keeps ``[out, in]``).  Called as ``dense(x, dtype)``
    so that tensor parallelism's module hooks see every projection."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True, dtype=torch.float32, device=None):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.weight = nn.Parameter(torch.empty(
            in_features, out_features, dtype=dtype, device=device))
        self.bias = nn.Parameter(torch.empty(
            out_features, dtype=dtype, device=device)) if bias else None

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return _linear(x, self, dtype)


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
        if config.decode:
            self.cache = DecodeCache(config.max_seq_len)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        b, s, d = x.shape
        qkv = self.qkv(x, cfg.dtype)
        if is_dtensor(qkv):
            # tensor parallel: q|k|v sharded over the tensor axis as a
            # whole; each rank takes its own heads of each
            q, k, v = (_local_heads(t.reshape(b, s, cfg.num_heads,
                                              cfg.head_dim))
                       for t in qkv.split(d, dim=-1))
        else:
            q, k, v = (t.reshape(b, s, -1, cfg.head_dim)
                       for t in qkv.split(d, dim=-1))
        if cfg.decode:
            out = self.cache.attend(q, k, v, cfg.dtype)
        else:
            out = self._attn(q, k, v, dtype=cfg.dtype)
        return self.o_proj(out.reshape(b, s, -1), cfg.dtype)


class MLP(nn.Module):
    """``fc_out(gelu(fc_in(x)))``; with ``config.fp8`` both are
    :class:`~dlrover_tpu_torch.ops.fp8.Fp8Dense` (the same parameter
    names), as the reference's ``MLP`` takes ``Fp8Dense``."""

    def __init__(self, config: GPTConfig, device=None):
        super().__init__()
        self.config = config
        d, pd = config.hidden_dim, config.param_dtype
        dense = Dense
        if config.fp8:
            from dlrover_tpu_torch.ops.fp8 import Fp8Dense as dense
        self.fc_in = dense(d, config.mlp_ratio * d, dtype=pd, device=device)
        self.fc_out = dense(config.mlp_ratio * d, d, dtype=pd, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = self.config.dtype
        # flax nn.gelu defaults to the tanh approximation
        h = F.gelu(self.fc_in(x, dtype), approximate="tanh")
        return self.fc_out(h, dtype)


def _layer_norm(config: GPTConfig, device) -> nn.LayerNorm:
    # fp32 layernorms on the residual stream for stability; their
    # params stay fp32 (flax's nn.LayerNorm takes no param_dtype)
    return nn.LayerNorm(config.hidden_dim, eps=config.ln_eps,
                        dtype=torch.float32, device=device)


def moe_layer(config, mlp_dim: int, gated: bool, device):
    """The MoE block of the GPT and Llama families (``moe``)."""
    from dlrover_tpu_torch.parallel.moe import MoEMLP

    return MoEMLP(
        num_experts=config.moe_experts, hidden_dim=config.hidden_dim,
        mlp_dim=mlp_dim, top_k=config.moe_top_k,
        capacity_factor=config.moe_capacity_factor, gated=gated,
        no_drop=config.decode, dtype=config.dtype,
        param_dtype=config.param_dtype, device=device)


def uses_moe(config, i: int) -> bool:
    """Block ``i`` is an MoE block: every ``moe_every``-th, counting
    from the end of the first stride (shared by GPT and Llama)."""
    return config.moe_experts > 0 and (i + 1) % config.moe_every == 0


class Block(nn.Module):
    def __init__(self, config: GPTConfig, device=None,
                 use_moe: bool = False):
        super().__init__()
        self.config = config
        self.ln_attn = _layer_norm(config, device)
        self.attn = Attention(config, device)
        self.ln_mlp = _layer_norm(config, device)
        if use_moe:
            self.moe = moe_layer(config, config.mlp_ratio * config.hidden_dim,
                                 False, device)
        else:
            self.mlp = MLP(config, device)

    def attn_out(self, x: torch.Tensor) -> torch.Tensor:
        """The attention module's output (the reference's ``attn_out``,
        which the save_attn policy keeps)."""
        return self.attn(self.ln_attn(x.float()).to(self.config.dtype))

    def mlp_out(self, x: torch.Tensor, attn_out: torch.Tensor) -> torch.Tensor:
        """The block's output from its input and :meth:`attn_out`."""
        x = x + attn_out
        mlp = self.moe if hasattr(self, "moe") else self.mlp
        return x + mlp(self.ln_mlp(x.float()).to(self.config.dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.mlp_out(x, self.attn_out(x))


@torch.no_grad()
def init_flax_weights(model: nn.Module, gen: torch.Generator):
    """Draw ``model``'s weights from ``gen`` as flax's default
    initializers draw them: lecun-normal Dense kernels (a normal
    truncated at two standard deviations and widened so that the
    truncated std is 1/sqrt(fan_in)), zero biases, ``nn.Embed``'s plain
    normal of std 1/sqrt(features), unit layernorm scales (a module
    that builds its own scales, as ``RMSNorm``, keeps them), and each
    MoE expert kernel ``[e, in, out]`` as ``e`` Dense kernels of fan-in
    ``in``.  Drawn in fp32 on the weights' device and rounded once to
    their dtype."""

    def draw(w, fan_in, truncated):
        std = math.sqrt(1.0 / fan_in)
        out = torch.empty(w.shape, dtype=torch.float32, device=w.device)
        if truncated:
            std = std / 0.87962566103423978
            nn.init.trunc_normal_(out, std=std, a=-2 * std, b=2 * std,
                                  generator=gen)
        else:
            out.normal_(0.0, std, generator=gen)
        w.copy_(out)

    from dlrover_tpu_torch.ops.fp8 import Fp8Dense
    from dlrover_tpu_torch.parallel.moe import MoEMLP

    for module in model.modules():
        if isinstance(module, (Dense, Fp8Dense)):
            draw(module.weight, module.in_features, True)
            if module.bias is not None:
                module.bias.zero_()
        elif isinstance(module, MoEMLP):
            # variance_scaling(1.0, "fan_in", "truncated_normal",
            # in_axis=-2, out_axis=-1, batch_axis=0): the leading expert
            # dim is a batch axis, not receptive field
            for name in module.expert_kernels():
                w = getattr(module, name)
                draw(w, w.shape[-2], True)
        elif isinstance(module, nn.Embedding):
            draw(module.weight, module.embedding_dim, False)
        elif isinstance(module, nn.LayerNorm):
            module.weight.fill_(1.0)
            module.bias.zero_()


class GPT(nn.Module):
    """GPT over ``[batch, seq]`` int tokens -> fp32 logits.

    Built on ``device`` (the GPU unless ``"cpu"`` is passed), with
    weights drawn from ``seed`` as the reference's initializers draw
    them (:func:`init_flax_weights`): lecun-normal Dense kernels, zero
    biases, unit layernorm scales, and ``wte`` and ``wpe`` as flax's
    ``nn.Embed`` draws them: a plain normal of std 1/sqrt(hidden_dim)
    (``dlrover_tpu/models/gpt.py:356-363``).  The weights are drawn on ``device`` by a generator there,
    so a GPT-2 XL needs no host pass over its 1.56B params; one seed
    therefore gives other weights on the card than on the CPU (nothing
    compares the two).  ``head="value"`` returns fp32 values ``[batch,
    seq]`` instead of logits; ``decode=True`` keeps a KV cache across
    calls (:meth:`reset_cache`).
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
            Block(config, device, uses_moe(config, i))
            for i in range(config.num_layers)
        )
        self.ln_f = _layer_norm(config, device)
        if config.head == "value":
            # scalar value head (RLHF critic / reward models)
            self.value_head = Dense(d, 1, dtype=pd, device=device)
        elif not config.tie_embeddings:
            self.lm_head = Dense(d, config.vocab_size, bias=False, dtype=pd,
                                 device=device)
        # decode: the absolute position of the next token (host int)
        self.pos_index = 0
        if device.type != "meta":  # shapes only (the strategy analyser)
            init_flax_weights(
                self, torch.Generator(device=device).manual_seed(seed))

    def reset_cache(self):
        """Clear the decode caches: the next call prefills."""
        reset_cache(self)

    def forward(self, tokens: torch.Tensor,
                return_hidden: bool = False) -> torch.Tensor:
        """fp32 logits (values with ``head="value"``); with
        ``return_hidden`` the final layernorm's output in the compute
        dtype instead, for losses that apply the head themselves
        (:mod:`dlrover_tpu_torch.models.losses`)."""
        cfg = self.config
        b, s = tokens.shape
        if cfg.decode:
            # absolute positions continue across decode chunks
            offset = self.pos_index
            if offset + s > cfg.max_seq_len:
                raise ValueError(
                    f"decode position {offset} + {s} exceeds max_seq_len "
                    f"{cfg.max_seq_len}: reset the cache (reset_cache())")
            self.pos_index = offset + s
        else:
            # under sequence parallelism this rank's shard starts later
            offset = sequence_offset(cfg.attention_impl, s)
        pos = torch.arange(s, device=tokens.device) + offset
        # flax Embed(dtype=...) casts the table; casting the gathered
        # rows is the same values without touching the whole table
        x = (
            vocab_parallel_embedding(tokens, self.wte.weight).to(cfg.dtype)
            + F.embedding(pos, self.wpe.weight).to(cfg.dtype)[None]
        )
        for block in self.blocks:
            if cfg.remat and torch.is_grad_enabled():
                if cfg.remat_policy == "offload":
                    # the reentrant checkpoint saves the block's input
                    # with save_for_backward, which save_on_cpu moves to
                    # pinned host memory until the backward needs it
                    with save_on_cpu(pin_memory=True):
                        x = checkpoint(block, x, use_reentrant=True)
                elif cfg.remat_policy == "save_attn":
                    # two checkpoints split at attn_out: the second
                    # keeps it (and the block's input) as its inputs
                    attn_out = checkpoint(block.attn_out, x,
                                          use_reentrant=False)
                    x = checkpoint(block.mlp_out, x, attn_out,
                                   use_reentrant=False)
                else:
                    x = checkpoint(block, x, use_reentrant=False)
            else:
                x = block(x)
        x = self.ln_f(x.float()).to(cfg.dtype)
        if return_hidden:
            return x
        if cfg.head == "value":
            return self.value_head(x, torch.float32)[..., 0]
        if cfg.tie_embeddings:
            logits = vocab_logits(x, self.wte.weight.to(cfg.dtype),
                                  transpose=True)
        else:
            logits = self.lm_head(x, cfg.dtype)
        return logits.float()


def cross_entropy_loss(
    logits: torch.Tensor, targets: torch.Tensor
) -> torch.Tensor:
    """Mean next-token cross entropy; fp32 for the reduction.  Logits
    sharded on vocab (tensor parallelism) are reduced over the tensor
    group, never gathered (:func:`~dlrover_tpu_torch.models.losses.
    vocab_parallel_nll`)."""
    if is_dtensor(logits):
        return vocab_parallel_nll(logits.float(), targets).mean()
    return F.cross_entropy(
        logits.float().flatten(0, -2), targets.long().flatten()
    )


def count_params(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


# -- pipeline parallelism ----------------------------------------------------
# Reference: ``dlrover_tpu/models/gpt.py:440-733``.  A params-layout
# transform: block params are stacked [stages, layers/stage, ...] and
# sharded over the ``pipeline`` mesh axis (each rank's DTensor shard its
# own stage); embed and head stay replicated; the block stack runs
# through ``parallel.pipeline`` (GPipe under autograd, or 1F1B).


def layers_per_stage(num_layers: int, num_stages: int) -> int:
    """Stage slot count: ceil(L/S).  Uneven splits pad the last
    stage(s) with zero layers that the stage fn skips."""
    return -(-num_layers // num_stages)


def partition_pipeline_params(state_dict, num_stages: int, num_layers: int,
                              stages=None):
    """A GPT or Llama state dict (``blocks.<i>.<name>``, ``wte``, ...)
    -> the stage-stacked layout: ``embed.<name>``, ``blocks.<name>``
    ``[S, ceil(L/S), ...]`` and ``head.<name>`` (``ln_f``, an untied
    ``lm_head``), the reference's ``{"embed", "blocks", "head"}``.
    Trailing slots of an uneven split are zero.  ``stages`` keeps only
    those stages' rows (a rank's own, in the rank form)."""
    per = layers_per_stage(num_layers, num_stages)
    stages = list(range(num_stages)) if stages is None else list(stages)
    out = {}
    names = sorted({k.split(".", 2)[2] for k in state_dict
                    if k.startswith("blocks.")})
    for name in names:
        first = state_dict[f"blocks.0.{name}"]
        rows = []
        for s in stages:
            for j in range(per):
                i = s * per + j
                rows.append(state_dict[f"blocks.{i}.{name}"].detach()
                            if i < num_layers else torch.zeros_like(first))
        out[f"blocks.{name}"] = torch.stack(rows).reshape(
            (len(stages), per) + tuple(first.shape))
    for key, value in state_dict.items():
        if key.startswith("blocks."):
            continue
        part = "head" if key.split(".")[0] in ("ln_f", "lm_head") else "embed"
        out[f"{part}.{key}"] = value
    return out


class _GPTEmbed(nn.Module):
    def __init__(self, inner):
        super().__init__()
        self.config = inner.config
        self.wte, self.wpe = inner.wte, inner.wpe

    def forward(self, tokens):
        cfg = self.config
        pos = torch.arange(tokens.shape[1], device=tokens.device)
        return (vocab_parallel_embedding(tokens, self.wte.weight).to(cfg.dtype)
                + F.embedding(pos, self.wpe.weight).to(cfg.dtype)[None])


class _GPTHead(nn.Module):
    def __init__(self, inner):
        super().__init__()
        self.config = inner.config
        self.ln_f = inner.ln_f
        if not inner.config.tie_embeddings:
            self.lm_head = inner.lm_head

    def forward(self, h, wte=None):
        cfg = self.config
        x = self.ln_f(h.float()).to(cfg.dtype)
        if cfg.tie_embeddings:
            return vocab_logits(x, wte.to(cfg.dtype), transpose=True).float()
        return self.lm_head(x, cfg.dtype).float()


class PipelinedDecoder(nn.Module):
    """A decoder whose blocks run as pipeline stages.

    Built from an unpipelined model (its weights copied into the
    stage-stacked layout, :func:`partition_pipeline_params`; embed and
    head modules shared).  On a distributed mesh whose ``pipeline`` axis
    is ``num_stages`` (the global mesh), each rank holds its
    own stage: every ``blocks.*`` parameter is a DTensor sharded on the
    stage dim over the ``pipeline`` sub-mesh (a copy on every data
    rank, which the step reduces), so the sharded flash checkpoint and
    the optimizers take the state as it is; otherwise all stages live
    in this process.  ``forward(tokens)`` runs GPipe under autograd
    (any loss); ``loss_and_grads_1f1b(tokens, targets)`` runs the 1F1B
    schedule with next-token CE at the last stage and leaves every
    gradient in ``.grad``.  Constraints shared by all families: uniform
    blocks (no MoE interleave), no sequence-parallel attention, no
    decode."""

    _embed_cls = None
    _head_cls = None

    def __init__(self, inner, num_stages: int, num_microbatches: int,
                 batch_axis=("data", "fsdp")):
        cfg = inner.config
        if getattr(cfg, "moe_experts", 0) > 0:
            raise ValueError(
                "pipeline requires uniform blocks; MoE interleave is "
                "not supported (shard MoE over the expert axis instead)"
            )
        if cfg.attention_impl in ("ring", "ulysses", "ulysses_flash"):
            raise ValueError(
                "sequence-parallel attention cannot nest inside the "
                "pipeline schedule"
            )
        if getattr(cfg, "decode", False):
            raise ValueError(
                "pipeline is a training construct; decode mode "
                "keeps a KV cache and is not supported"
            )
        super().__init__()
        self.config = cfg
        self.num_stages = num_stages
        self.num_microbatches = num_microbatches
        self.batch_axis = batch_axis
        self.per_stage = layers_per_stage(cfg.num_layers, num_stages)
        from dlrover_tpu_torch.parallel import mesh as mesh_mod

        mesh = mesh_mod._GLOBAL_MESH
        ranked = (mesh is not None and mesh.distributed
                  and mesh.shape["pipeline"] > 1)
        if ranked and mesh.shape["pipeline"] != num_stages:
            raise ValueError(f"{num_stages} stages on a pipeline axis of "
                             f"{mesh.shape['pipeline']}")
        self._mesh = mesh if ranked else None
        stages = [mesh.coordinate()["pipeline"]] if ranked else None
        self.embed = self._embed_cls(inner)
        self.head = self._head_cls(inner)
        stacked = partition_pipeline_params(
            {k: v for k, v in inner.state_dict().items()
             if k.startswith("blocks.")},
            num_stages, cfg.num_layers, stages)
        # the block module: its parameters are the stacked tensors; the
        # stage fn calls it with one slot's slices
        self.blocks = type(inner.blocks[0])(cfg, device="meta")
        for key, value in stacked.items():
            module_name, _, leaf = key[len("blocks."):].rpartition(".")
            module = self.blocks.get_submodule(module_name)
            if ranked:
                value = self._stage_dtensor(value)
            setattr(module, leaf, nn.Parameter(value))

    def _stage_dtensor(self, local: torch.Tensor):
        """This rank's stage rows as a DTensor sharded on the stage dim
        over the ``pipeline`` sub-mesh (a copy on every data rank)."""
        from torch.distributed.tensor import DTensor, Shard

        shape = (self.num_stages,) + tuple(local.shape[1:])
        return DTensor.from_local(local, self._mesh["pipeline"], [Shard(0)],
                                  run_check=False, shape=shape,
                                  stride=torch.empty(shape,
                                                     device="meta").stride())

    def _block_params(self):
        return dict(self.blocks.named_parameters())

    def _stage_fn(self):
        cfg = self.config
        per, layers = self.per_stage, cfg.num_layers
        block = self.blocks

        def one(params, h):
            return torch.func.functional_call(block, params, (h,))

        def stage_fn(stage_params, h, stage):
            # slots past this stage's real layer count hold zero params
            # and are skipped (identity), as the reference masks them
            n_valid = min(per, max(0, layers - stage * per))
            for j in range(n_valid):
                params = {n: t[j] for n, t in stage_params.items()}
                if cfg.remat and torch.is_grad_enabled():
                    if cfg.remat_policy == "offload":
                        with save_on_cpu(pin_memory=True):
                            h = checkpoint(one, params, h,
                                           use_reentrant=False)
                    else:
                        h = checkpoint(one, params, h, use_reentrant=False)
                else:
                    h = one(params, h)
            return h

        return stage_fn

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """GPipe: fp32 logits on every stage."""
        from dlrover_tpu_torch.parallel.pipeline import pipeline_apply

        x = self.embed(tokens)
        x = pipeline_apply(
            self._stage_fn(), self._block_params(), x, self._mesh,
            num_microbatches=self.num_microbatches,
            batch_axis=self.batch_axis, with_stage=True)
        return self.head(x, wte=self.embed.wte.weight)

    def loss_and_grads_1f1b(self, tokens: torch.Tensor,
                            targets: torch.Tensor) -> torch.Tensor:
        """Next-token CE through the interleaved (1F1B) schedule.

        The head (final norm and lm head, a tied embedding included)
        rides the last stage's turn-around; the embedding's gradients
        chain through the schedule's ``input_grads``; a tied table's
        gradients from both ends are summed.  Every gradient is left in
        ``.grad`` (added to what is there); returns the mean loss,
        detached, averaged over the batch axes' ranks as the
        gradients are."""
        from dlrover_tpu_torch.parallel.pipeline import (
            pipeline_train_step_1f1b,
        )

        with torch.enable_grad():
            x = self.embed(tokens)
        head_names = dict(self.head.named_parameters())
        hp = {"head": head_names}
        tied = getattr(self.config, "tie_embeddings", False)
        if tied:
            hp["wte"] = self.embed.wte.weight

        def head_loss(params, out, y_mb):
            logits = torch.func.functional_call(
                self.head, params["head"], (out,),
                {"wte": params.get("wte")})
            return cross_entropy_loss(logits, y_mb)

        res = pipeline_train_step_1f1b(
            self._stage_fn(), head_loss, self._block_params(), x.detach(),
            targets, self._mesh, num_microbatches=self.num_microbatches,
            batch_axis=self.batch_axis, head_params=hp, with_stage=True)
        if x.requires_grad:
            x.backward(res.input_grads)
            # the input grads carry each row's 1/dp of the global mean:
            # the embedding's gradient is their sum over the batch axes
            import torch.distributed as dist

            from dlrover_tpu_torch.parallel.pipeline import batch_groups

            for group in batch_groups(self._mesh, self.batch_axis)[0]:
                for p in self.embed.parameters():
                    if p.grad is not None:
                        dist.all_reduce(p.grad, group=group)
        grads = [(head_names[n], g) for n, g in res.head_grads["head"].items()]
        if tied:
            grads.append((self.embed.wte.weight, res.head_grads["wte"]))
        for name, p in self.blocks.named_parameters():
            g = res.stage_grads[name]
            if is_dtensor(p):
                g = self._stage_dtensor(g)
            grads.append((p, g))
        for p, g in grads:
            if p.requires_grad:
                p.grad = g if p.grad is None else p.grad + g
        return res.loss


class PipelinedGPT(PipelinedDecoder):
    """GPT family: wte + wpe embed, LayerNorm head, optional tied
    embeddings."""

    _embed_cls = _GPTEmbed
    _head_cls = _GPTHead

    def __init__(self, inner, num_stages, num_microbatches,
                 batch_axis=("data", "fsdp")):
        if inner.config.head != "lm":
            raise ValueError(
                f"pipeline supports the lm head only, not "
                f"{inner.config.head!r} (value heads would be "
                "silently dropped by the stage partitioner)"
            )
        super().__init__(inner, num_stages, num_microbatches, batch_axis)


def to_pipelined(model: "GPT", num_stages: int, num_microbatches: int,
                 batch_axis=("data", "fsdp")) -> PipelinedGPT:
    """auto_accelerate protocol hook (build_from_plan calls this when
    the plan's mesh has pipeline > 1)."""
    return PipelinedGPT(model, num_stages, num_microbatches, batch_axis)


GPT.to_pipelined = to_pipelined
