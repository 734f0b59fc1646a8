"""Memory-efficient losses: sequence-chunked fused lm_head + CE.

Reference: ``dlrover_tpu/models/losses.py``.  The long-context memory
cliff is the logits tensor: Llama-3-8B at seq 8192 holds ``[1, 8192,
128256]`` fp32 logits (4.2 GB), and as much again for the softmax's
backward.  ``chunked_cross_entropy`` never builds them whole: it walks
the sequence in chunks, projects one chunk through the head and reduces
it to a summed NLL under ``torch.utils.checkpoint`` (non-reentrant),
so the backward recomputes that chunk's logits instead of storing
them.  Peak logits memory drops from ``O(S * V)`` to
``O(S / num_chunks * V)`` for one more head matmul a chunk in the
backward.  The reference scans the chunks under ``jax.checkpoint``; a
Python loop takes the scan's place.

As there, the head matmul runs in the activation dtype and the
log-softmax and the NLL in fp32.  The head matmul and the softmax are
plain torch ops (cuBLAS and ATen on the card), as the reference leaves
them to XLA: no hand kernel replaces a TPU kernel here.

Works with both head layouts of the port: Llama's untied ``lm_head``
(a flax-layout ``[hid, vocab]`` Dense weight) and GPT's tied ``wte``
embedding (``[vocab, hid]``, ``transpose=True``).

Under tensor parallelism the head is split by vocab over the tensor
axis (``gpt_tp_rules``), and so are the logits: :func:`vocab_parallel_nll`
reduces the max and the sum of exponentials over the tensor group and
takes each target's logit on the rank that holds it, so the ``[tokens,
vocab]`` logits are never gathered, and its gradient (softmax minus
the target's one-hot, on each rank's columns) is the unsharded loss's.
The chunked loss runs the same per chunk over the rank's head columns.
"""

import inspect
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from dlrover_tpu_torch.common.device import is_dtensor


class _VocabParallelNLL(torch.autograd.Function):
    """Per-token NLL of fp32 logits split by vocab over ``group``:
    ``logits`` ``[n, v_local]`` holds vocab ids ``start ..``."""

    @staticmethod
    def forward(ctx, logits, targets, start, group):
        import torch.distributed as dist

        n, v = logits.shape
        m = logits.max(dim=-1).values
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
        shifted = logits - m[:, None]
        e = torch.exp(shifted)
        se = e.sum(dim=-1)
        dist.all_reduce(se, group=group)
        ids = targets.long() - start
        inside = (ids >= 0) & (ids < v)
        ids = ids.clamp(0, v - 1)
        target = shifted.gather(-1, ids[:, None])[:, 0] * inside
        dist.all_reduce(target, group=group)
        ctx.save_for_backward(e / se[:, None], ids, inside)
        return torch.log(se) - target

    @staticmethod
    def backward(ctx, grad):
        probs, ids, inside = ctx.saved_tensors
        g = probs.clone()
        rows = torch.arange(g.shape[0], device=g.device)
        g[rows, ids] -= inside.to(g.dtype)
        return g * grad[:, None], None, None, None


def vocab_parallel_nll(logits, targets: torch.Tensor) -> torch.Tensor:
    """The per-token NLL ``[...]`` of fp32 ``logits`` sharded on vocab
    (a DTensor ``Shard(-1)`` over a one-dim tensor mesh, as the
    vocab-parallel heads give them) for int ``targets`` ``[...]``."""
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset,
    )

    mesh = logits.device_mesh
    _, offset = compute_local_shape_and_global_offset(
        logits.shape, mesh, logits.placements)
    local = logits.to_local()
    nll = _VocabParallelNLL.apply(local.reshape(-1, local.shape[-1]),
                                  targets.reshape(-1), int(offset[-1]),
                                  mesh.get_group(0))
    return nll.reshape(targets.shape)


def _chunk_nll(h_chunk, t_chunk, head_weight, transpose: bool, vocab=None):
    # the head in the activation dtype, as the models' own head paths;
    # only the log_softmax reduction is fp32
    w = head_weight.to(h_chunk.dtype)
    logits = (h_chunk @ (w.t() if transpose else w)).float()
    if vocab is not None:  # this rank's vocab columns
        start, group = vocab
        return _VocabParallelNLL.apply(
            logits.reshape(-1, logits.shape[-1]), t_chunk.reshape(-1),
            start, group).sum()
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(-1, t_chunk.long()[..., None]).sum()


def chunked_cross_entropy(
    hidden: torch.Tensor,       # [batch, seq, hid]
    head_weight: torch.Tensor,  # [hid, vocab] (or [vocab, hid] tied)
    targets: torch.Tensor,      # [batch, seq] int
    num_chunks: int = 8,
    transpose: bool = False,
) -> torch.Tensor:
    """Mean next-token CE without materializing full logits.

    ``transpose=True`` treats ``head_weight`` as ``[vocab, hid]`` (a
    tied embedding table).  ``seq`` must be divisible by
    ``num_chunks`` (1 degrades to the unchunked loss).  Returns an fp32
    scalar, the summed NLL over ``batch * seq``."""
    from dlrover_tpu_torch.parallel.sharding import sum_grad_over, vocab_shard

    b, s, _ = hidden.shape
    if s % num_chunks:
        raise ValueError(
            f"seq {s} not divisible by num_chunks {num_chunks}"
        )
    vocab = None
    shard = vocab_shard(head_weight, 0 if transpose else 1)
    if shard is not None:
        # split by vocab over the tensor axis: this rank's columns, the
        # hidden state's gradient summed over the tensor group
        head_weight, group, start = shard
        vocab = (start, group)
        hidden = sum_grad_over(hidden, group)
    elif is_dtensor(head_weight):
        # a sharded head (FSDP2) gathered once, its gradient scattered
        # back by autograd
        head_weight = head_weight.full_tensor()
    c = s // num_chunks
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(num_chunks):
        total = total + checkpoint(
            _chunk_nll, hidden[:, i * c:(i + 1) * c],
            targets[:, i * c:(i + 1) * c], head_weight, transpose, vocab,
            use_reentrant=False)
    return total / (b * s)


def _has_return_hidden(module) -> bool:
    return "return_hidden" in inspect.signature(
        type(module).forward).parameters


def _no_return_hidden(module) -> ValueError:
    return ValueError(
        f"{type(module).__name__} has no return_hidden forward flag; the "
        "chunked loss is incompatible with pipelined models — use the "
        "full cross_entropy_loss there")


def chunked_loss_fn(
    model=None,
    batch_x_key: str = "x",
    batch_y_key: str = "y",
    num_chunks: int = 8,
    head_param: Optional[str] = None,
):
    """A ``loss_fn(module, batch)`` (the port's convention, what
    ``auto_accelerate`` and ``Trainer`` call) for a model with a
    ``return_hidden`` forward flag (GPT, Llama).

    The head is resolved on the module the loss is called with:
    ``lm_head`` when it has one, else the tied ``wte`` table;
    ``head_param`` names another.  ``model`` is the model the loss is
    built for, checked here for the flag (the returned function checks
    the module it is given again, as ``auto_accelerate`` may hand it a
    rebuilt one); the function keeps no reference to it."""
    if model is not None and not _has_return_hidden(model):
        raise _no_return_hidden(model)

    def loss_fn(module, batch):
        if not _has_return_hidden(module):
            raise _no_return_hidden(module)
        hidden = module(batch[batch_x_key], return_hidden=True)
        name = head_param
        if name is None:
            name = "lm_head" if hasattr(module, "lm_head") else "wte"
        weight = getattr(module, name).weight
        return chunked_cross_entropy(
            hidden, weight, batch[batch_y_key], num_chunks=num_chunks,
            transpose=name == "wte")

    return loss_fn
