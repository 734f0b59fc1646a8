"""Sequence/context parallelism over the ``sequence`` mesh axis.

Reference: ``dlrover_tpu/parallel/sequence.py``.  Two schemes:

1. **Ulysses** (:func:`ulysses_attention`): activations are
   sequence-sharded; an all-to-all over the mesh's ``sequence`` group
   swaps sequence sharding for head sharding, ``attn_fn`` runs over the
   whole sequence on ``heads / sp`` heads, and a second all-to-all swaps
   back.  ``heads % sp == 0`` as in the reference.
2. **Ring** (:func:`ring_attention`): each rank keeps its queries while
   the k and v shards rotate around the ring (``batch_isend_irecv``).
   Where the reference computes each block's online-softmax partials in
   jnp, the port runs the flash kernels on each block: B1
   (``fwd_cuda``) gives the block's output and its log-sum-exp, and the
   blocks merge by their lse into an fp32 accumulator
   (:func:`ring_merge`).  With equal shards, rank ``r``'s queries and
   the kv shard of rank ``src`` fall in one of three cases
   (:func:`ring_block_kind`): ``src < r`` wholly visible (``causal=False``),
   ``src == r`` the ordinary causal diagonal in local positions
   (``causal=True``), ``src > r`` wholly masked (skipped), so the
   kernels need no position offsets.  The backward rotates k and v
   again with their dK and dV accumulators (fp32) travelling beside
   them; B2 and B3 run on each visible block with the *merged* lse and
   output, which gives each block's exact share of the gradient, so
   nothing is recomputed (the reference remats each ring step).

The per-block forward (:func:`ring_block_fwd`), the merge and the
per-block backward (:func:`ring_block_bwd`) are plain functions: the
rank loop calls them, and so do :func:`ring_forward_shards` and
:func:`ring_backward_shards`, which drive every shard of a ring in one
process (the tests, and the kernel check on the card).  On CPU tensors
each block takes the kernels' plain versions; on CUDA tensors it
launches B1-B3 or raises.  Activations are ``[batch, seq, heads,
head_dim]`` with ``seq`` this rank's shard; k and v may carry fewer
heads than q (GQA: the kernels read each kv head once per group).

Positions: a sequence-sharded model offsets its positions by
``sequence rank * local seq`` (:func:`sequence_offset`), which the
reference's global shapes under ``jit`` make implicit.
"""

from typing import Callable, List, Optional, Sequence, Tuple

import torch

from dlrover_tpu_torch.ops import flash_attention as fa

SEQUENCE_IMPLS = ("ring", "ulysses", "ulysses_flash")


def _check_divisible(name, value, by):
    if value % by:
        raise ValueError(f"{name}={value} must be divisible by {by}")


def sequence_offset(attention_impl: str, s_local: int) -> int:
    """The global position of this rank's first token: ``sequence rank
    * s_local`` under a sequence-parallel ``attention_impl`` (over the
    global mesh), else 0."""
    if attention_impl not in SEQUENCE_IMPLS:
        return 0
    from dlrover_tpu_torch.parallel.mesh import get_global_mesh
    from dlrover_tpu_torch.parallel.sharding import token_shard

    _, _, col, _ = token_shard(get_global_mesh())
    return col * s_local


# ---------------------------------------------------------------------------
# Ulysses
# ---------------------------------------------------------------------------


class _AllToAll(torch.autograd.Function):
    """``all_to_all_single`` over equal splits of dim 0; with equal
    splits the exchange is its own transpose, so the backward is the
    same exchange of the gradient."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist

        ctx.group = group
        x = x.contiguous()
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return _AllToAll.apply(grad, ctx.group), None


def _seq_to_heads(x, sp, group):
    """``[b, s/sp, h, d]`` -> ``[b, s, h/sp, d]``: head chunk ``j`` to
    rank ``j``, the sequence chunks received in rank order."""
    b, s, h, d = x.shape
    x = x.reshape(b, s, sp, h // sp, d).permute(2, 0, 1, 3, 4)
    x = _AllToAll.apply(x, group)  # [sp (sequence chunk), b, s, h/sp, d]
    return x.permute(1, 0, 2, 3, 4).reshape(b, sp * s, h // sp, d)


def _heads_to_seq(x, sp, group):
    """``[b, s, h/sp, d]`` -> ``[b, s/sp, h, d]``, the inverse."""
    b, s, h, d = x.shape
    x = x.reshape(b, sp, s // sp, h, d).permute(1, 0, 2, 3, 4)
    x = _AllToAll.apply(x, group)  # [sp (head chunk), b, s/sp, h/sp, d]
    return x.permute(1, 2, 0, 3, 4).reshape(b, s // sp, sp * h, d)


def ulysses_attention(attn_fn: Callable, q, k, v, mesh,
                      axis: str = "sequence", **attn_kwargs):
    """Run ``attn_fn(q, k, v, **attn_kwargs)`` under sequence
    parallelism: inputs are this rank's ``[b, s/sp, h, d]`` shard,
    ``attn_fn`` sees the whole sequence on ``h/sp`` heads, the output is
    this rank's shard again."""
    sp = mesh.shape[axis]
    if sp == 1:
        return attn_fn(q, k, v, **attn_kwargs)
    for name, x in (("num_heads", q), ("num_kv_heads", k)):
        _check_divisible(name, x.shape[2], sp)
    group = mesh.group(axis)
    out = attn_fn(*(_seq_to_heads(x, sp, group) for x in (q, k, v)),
                  **attn_kwargs)
    return _heads_to_seq(out, sp, group)


# ---------------------------------------------------------------------------
# Ring: the per-block steps
# ---------------------------------------------------------------------------


def ring_block_kind(rank: int, src: int, causal: bool) -> str:
    """How rank ``rank``'s queries see the kv shard of rank ``src``:
    ``"full"`` (no mask), ``"diag"`` (the causal diagonal, local
    positions) or ``"skip"`` (wholly masked)."""
    if not causal or src < rank:
        return "full"
    return "diag" if src == rank else "skip"


def _plain_block(s: int) -> int:
    return fa._fit_block(s, fa.DEFAULT_BLOCK)


def ring_block_fwd(q, k, v, scale: float, causal: bool):
    """One block's attention: ``(out in q's dtype [b, s, h, d], lse fp32
    [b, h, s])`` through B1 on the card, its plain version on the CPU."""
    if fa._on_cpu(q):
        blk = _plain_block(q.shape[1])
        return fa.fwd_plain(q, k, v, scale, causal, blk, blk)
    return fa.fwd_cuda(q, k, v, scale, causal)


def ring_merge(acc: Optional[torch.Tensor], lse: Optional[torch.Tensor],
               out_blk: torch.Tensor, lse_blk: torch.Tensor):
    """Fold one block's normalised output and lse into the running fp32
    ``(acc [b, s, h, d], lse [b, h, s])`` (None before the first)."""
    if acc is None:
        return out_blk.float(), lse_blk
    new = torch.logaddexp(lse, lse_blk)
    w_old = torch.exp(lse - new).transpose(1, 2)[..., None]
    w_blk = torch.exp(lse_blk - new).transpose(1, 2)[..., None]
    return acc * w_old + out_blk.float() * w_blk, new


def ring_block_bwd(q, k, v, out, dout, lse, scale: float, causal: bool):
    """One block's share of ``(dq, dk, dv)``, in the inputs' dtype,
    given the merged ``out`` and ``lse`` of the whole ring: B2 (which
    also writes Delta = rowsum(out * dout)) and B3 on the card, their
    plain versions on the CPU."""
    if fa._on_cpu(q):
        blk = _plain_block(q.shape[1])
        delta = fa.delta_plain(out, dout)
        dq = fa.bwd_dq_plain(q, k, v, dout, lse, delta, scale, causal, blk,
                             blk)
        dk, dv = fa.bwd_dkv_plain(q, k, v, dout, lse, delta, scale, causal,
                                  blk, blk)
        return dq, dk, dv
    dq, delta = fa.bwd_dq_cuda(q, k, v, out, dout, lse, scale, causal)
    dk, dv = fa.bwd_dkv_cuda(q, k, v, dout, lse, delta, scale, causal)
    return dq, dk, dv


# ---------------------------------------------------------------------------
# Ring: every shard in one process
# ---------------------------------------------------------------------------


def ring_forward_shards(qs: Sequence[torch.Tensor],
                        ks: Sequence[torch.Tensor],
                        vs: Sequence[torch.Tensor], scale: float,
                        causal: bool = True, merge: Callable = ring_merge,
                        block_fwd: Callable = ring_block_fwd
                        ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """The ring's forward for every rank's shard in one process, in the
    order the ranks merge (rank ``r`` takes ``src = r, r-1, ...``):
    ``(fp32 outputs, lses)``, one a rank.  ``merge`` and ``block_fwd``
    are the ring's own unless a check passes others (a planted fault,
    the plain versions on the card)."""
    sp = len(qs)
    outs, lses = [], []
    for r in range(sp):
        acc = lse = None
        for step in range(sp):
            src = (r - step) % sp
            kind = ring_block_kind(r, src, causal)
            if kind == "skip":
                continue
            o, l = block_fwd(qs[r], ks[src], vs[src], scale, kind == "diag")
            acc, lse = merge(acc, lse, o, l)
        outs.append(acc)
        lses.append(lse)
    return outs, lses


def ring_backward_shards(qs, ks, vs, outs, douts, lses, scale: float,
                         causal: bool = True,
                         block_bwd: Callable = ring_block_bwd):
    """The ring's backward for every shard in one process, summed in
    fp32 in the order the rank loop sums: ``(dqs, dks, dvs)``."""
    sp = len(qs)
    dqs = [torch.zeros(q.shape, dtype=torch.float32, device=q.device)
           for q in qs]
    dks = [torch.zeros(k.shape, dtype=torch.float32, device=k.device)
           for k in ks]
    dvs = [torch.zeros_like(d) for d in dks]
    for step in range(sp):
        for src in range(sp):
            r = (src + step) % sp  # the rank holding src's kv at step
            kind = ring_block_kind(r, src, causal)
            if kind == "skip":
                continue
            dq, dk, dv = block_bwd(qs[r], ks[src], vs[src], outs[r],
                                   douts[r], lses[r], scale, kind == "diag")
            dqs[r] += dq
            dks[src] += dk
            dvs[src] += dv
    return dqs, dks, dvs


# ---------------------------------------------------------------------------
# Ring: the rank loop
# ---------------------------------------------------------------------------


def _rotate(tensors, group, nxt: int, prv: int):
    """Send ``tensors`` to rank ``nxt`` and receive their like from
    ``prv`` (global ranks); returns (the works, the receive buffers)."""
    import torch.distributed as dist

    tensors = [t.contiguous() for t in tensors]
    bufs = [torch.empty_like(t) for t in tensors]
    ops = [dist.P2POp(dist.isend, t, nxt, group) for t in tensors]
    ops += [dist.P2POp(dist.irecv, b, prv, group) for b in bufs]
    return dist.batch_isend_irecv(ops), bufs


def _wait(works):
    for w in works:
        w.wait()


class _RingAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, group, causal, scale):
        import torch.distributed as dist

        sp, r = dist.get_world_size(group), dist.get_rank(group)
        nxt = dist.get_global_rank(group, (r + 1) % sp)
        prv = dist.get_global_rank(group, (r - 1) % sp)
        acc = lse = None
        k_cur, v_cur = k, v
        for step in range(sp):
            works = bufs = None
            if step < sp - 1:  # the next shard travels while this computes
                works, bufs = _rotate((k_cur, v_cur), group, nxt, prv)
            src = (r - step) % sp
            kind = ring_block_kind(r, src, causal)
            if kind != "skip":
                o, l = ring_block_fwd(q, k_cur, v_cur, scale, kind == "diag")
                acc, lse = ring_merge(acc, lse, o, l)
            if works is not None:
                _wait(works)
                k_cur, v_cur = bufs
        out = acc.to(q.dtype)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.ring = (group, sp, r, nxt, prv, causal, scale)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        group, sp, r, nxt, prv, causal, scale = ctx.ring
        dout = dout.contiguous()
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv = torch.zeros_like(dk)
        k_cur, v_cur = k, v
        for step in range(sp):
            src = (r - step) % sp
            kind = ring_block_kind(r, src, causal)
            if kind != "skip":
                dq_b, dk_b, dv_b = ring_block_bwd(q, k_cur, v_cur, out, dout,
                                                  lse, scale, kind == "diag")
                dq += dq_b
                dk += dk_b
                dv += dv_b
            # src's accumulators travel on with its shard; after the last
            # step they reach their own rank
            moving = (dk, dv) if step == sp - 1 else (k_cur, v_cur, dk, dv)
            works, bufs = _rotate(moving, group, nxt, prv)
            _wait(works)
            if step < sp - 1:
                k_cur, v_cur, dk, dv = bufs
            else:
                dk, dv = bufs
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None, \
            None


def ring_attention(q, k, v, mesh, axis: str = "sequence",
                   causal: bool = True, scale: Optional[float] = None):
    """Context-parallel attention: k and v rotate around the mesh's
    ``axis`` group while each rank merges its queries' blocks.  Inputs
    and output are this rank's ``[b, s/sp, h, d]`` shard (k and v may
    carry fewer heads).  At ``sp == 1`` there is no ring: the
    whole-sequence flash attention (B1-B3 on the card, their plain
    versions on the CPU)."""
    sp = mesh.shape[axis]
    d = q.shape[-1]
    scale = scale if scale is not None else d ** -0.5
    if sp == 1:
        return fa.flash_attention(q, k, v, causal=causal, scale=scale)
    if fa._on_cpu(q):
        return _RingAttention.apply(q, k, v, mesh.group(axis), causal, scale)
    # the kernels' head_dim, padded once for every block (exact: the
    # padded columns add zeros)
    kd = fa.kernel_head_dim(d)
    q, k, v = (fa.pad_head_dim(x, kd) for x in (q, k, v))
    out = _RingAttention.apply(q, k, v, mesh.group(axis), causal, scale)
    return out[..., :d] if kd != d else out
