"""Pipeline parallelism: GPipe and 1F1B over point-to-point sends.

Reference: ``dlrover_tpu/parallel/pipeline.py`` (one ``lax.scan`` over
``ppermute`` in a ``shard_map``; the role of ATorch's PiPPy pipeline,
``distributed_pippy_compiler.py``).  The same functions and schedules:

- stage parameters carry a leading stage dim (:func:`stack_stage_params`);
- :func:`pipeline_apply` runs GPipe: ``num_micro + S - 1`` ticks, at
  tick ``t`` stage ``s`` applies its stage to microbatch ``t - s`` and
  hands the result on; the last stage's outputs are replicated over the
  stages (the reference's psum).  It is differentiable: the backward
  runs the ticks in reverse, each stage's received activation a leaf
  whose ``.grad`` goes back to the previous stage, so any loss trains
  through it (activation memory grows with the microbatch count, as
  under the reference's autodiff; the model's ``remat`` recomputes each
  block);
- :func:`pipeline_train_step_1f1b` runs the interleaved schedule,
  ``num_micro + 2(S - 1)`` ticks: stage ``s`` forwards microbatch
  ``t - s`` and backwards microbatch ``t - 2(S - 1) + s``, the last stage
  turning a microbatch around in the tick it arrives (head loss and
  seed).  A stage stashes only its inputs, detached, at most ``2S - 1``
  at once whatever the microbatch count (``stash_peak`` of the result
  counts them), and each backward recomputes its stage forward, as the
  reference's ``jax.vjp`` does.  Head gradients come from the last
  stage, input gradients from stage 0; both are replicated over the
  stages, then loss and gradients are averaged over the batch axes.

Two forms run one schedule (:class:`_Local`, :class:`_Ranks`: the
tick loop is shared, only the exchange differs):

- the rank form, one stage a rank over the mesh's ``pipeline`` group
  (a distributed mesh with ``pipeline`` > 1): activations and their
  gradients move by ``dist.batch_isend_irecv``, NCCL on the cards and
  gloo on the CPU; every tick each rank posts its sends and receives in
  one batch, in one order on both sides of a link (a send is posted iff
  its peer computes the same microbatch index valid);
- the in-process form, all ``S`` stages in this process (no
  distributed pipeline axis; ``S`` is the stacked params' leading
  dim), as ``parallel/sequence.py`` drives every ring shard in one
  process: a tick's sends are the next tick's receives.

A local stage's parameters are its rows of the stacked tensors: a
plain tensor, or a DTensor sharded on the stage dim over ``pipeline``
(its local shard, one stage).  ``stage_fn(params, h)`` keeps the
activation's shape and dtype; with ``with_stage=True`` it is called as
``stage_fn(params, h, stage)`` (the pipelined models' uneven splits).
"""

from typing import Any, Callable, Dict, List, NamedTuple, Optional

import torch
from torch.utils import _pytree as pytree

from dlrover_tpu_torch.common.device import is_dtensor


def stack_stage_params(params_list):
    """[per-stage pytrees] -> one pytree with a leading stage dim."""
    leaves = [pytree.tree_flatten(p) for p in params_list]
    spec = leaves[0][1]
    stacked = [torch.stack(xs) for xs in zip(*(lv for lv, _ in leaves))]
    return pytree.tree_unflatten(stacked, spec)


def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if is_dtensor(t) else t


def batch_groups(mesh, batch_axis):
    """The process groups of the batch axes that hold more than one
    rank, and the product of their sizes (1 and none in process)."""
    if batch_axis is None or mesh is None or not mesh.distributed:
        return [], 1
    names = (batch_axis,) if isinstance(batch_axis, str) else batch_axis
    names = [a for a in names if mesh.shape[a] > 1]
    dp = 1
    for a in names:
        dp *= mesh.shape[a]
    return [mesh.group(a) for a in names], dp


# -- the two forms --------------------------------------------------------------


class _Local:
    """All ``num_stages`` stages in this process."""

    def __init__(self, num_stages: int):
        self.num_stages = num_stages
        self.stages = list(range(num_stages))
        self.distributed = False

    def index(self, stage: int) -> int:
        """Row of the stacked tensors holding ``stage``."""
        return stage

    def exchange(self, sends: Dict, expects: Dict) -> Dict:
        missing = set(expects) - set(sends)
        if missing:
            raise RuntimeError(f"schedule expects {missing} unsent")
        return sends

    def replicate(self, value, src_stage: int):
        return value


_WARM_GROUPS = set()


class _Ranks:
    """One stage a rank over ``mesh.group(axis)``."""

    def __init__(self, mesh, axis: str):
        import torch.distributed as dist

        self.group = mesh.group(axis)
        self.num_stages = mesh.shape[axis]
        self.stage = mesh.coordinate()[axis]
        self.stages = [self.stage]
        self.distributed = True
        self.ranks = [dist.get_global_rank(self.group, i)
                      for i in range(self.num_stages)]
        self.device = (torch.device("cuda", torch.cuda.current_device())
                       if mesh.device_type == "cuda" else torch.device("cpu"))
        if id(self.group) not in _WARM_GROUPS:
            # one collective over the whole group before its first
            # batched point-to-point call (NCCL requires it)
            dist.all_reduce(torch.zeros(1, device=self.device),
                            group=self.group)
            _WARM_GROUPS.add(id(self.group))

    def index(self, stage: int) -> int:
        return 0

    def exchange(self, sends: Dict, expects: Dict) -> Dict:
        """``sends``: ``{(kind, dst stage): tensor}``; ``expects``:
        ``{(kind, this stage): (src stage, shape, dtype)}``.  One batch
        of point-to-point ops, sorted by key, so both sides of a link
        post their halves in one order."""
        import torch.distributed as dist

        ops, got = [], {}
        for (kind, dst), t in sorted(sends.items()):
            ops.append(dist.P2POp(dist.isend, t.contiguous(),
                                  self.ranks[dst], self.group))
        for key, (src, shape, dtype) in sorted(expects.items()):
            got[key] = torch.empty(shape, dtype=dtype, device=self.device)
            ops.append(dist.P2POp(dist.irecv, got[key], self.ranks[src],
                                  self.group))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return got

    def replicate(self, value, src_stage: int):
        """``value`` (a tensor or a pytree of them, held on
        ``src_stage``; any tensors of the same shapes elsewhere) as the
        source's, on every stage: the reference's psum of the masked
        value."""
        import torch.distributed as dist

        leaves, spec = pytree.tree_flatten(value)
        out = []
        for t in leaves:
            t = t.contiguous()
            dist.broadcast(t, src=self.ranks[src_stage], group=self.group)
            out.append(t)
        return pytree.tree_unflatten(out, spec)


def _link(mesh, axis: str, stacked_leaves: List[torch.Tensor]):
    if (mesh is not None and getattr(mesh, "distributed", False)
            and mesh.shape[axis] > 1):
        link = _Ranks(mesh, axis)
        rows = {_local(t).shape[0] for t in stacked_leaves}
        if rows != {1}:
            raise ValueError(f"a rank holds one stage; its stacked params "
                             f"have leading dims {rows}")
        return link
    if mesh is not None and mesh.distributed and any(
            mesh.shape[a] > 1 for a in mesh.shape if a != axis):
        raise ValueError("the in-process pipeline drives every stage in "
                         "one process and takes no other mesh axis")
    sizes = {_local(t).shape[0] for t in stacked_leaves}
    if len(sizes) != 1:
        raise ValueError(f"stacked params disagree on the stage count: "
                         f"{sizes}")
    return _Local(sizes.pop())


def _stage_params(spec, local_leaves, row: int):
    return pytree.tree_unflatten([t[row] for t in local_leaves], spec)


def _call(stage_fn, with_stage, params, h, stage):
    return stage_fn(params, h, stage) if with_stage else stage_fn(params, h)


def _micro(x: torch.Tensor, m: int, dp: int) -> torch.Tensor:
    if x.shape[0] % m:
        raise ValueError(
            f"batch {x.shape[0] * dp} not divisible by {m} "
            f"microbatches x {dp} data shards")
    return x.reshape((m, x.shape[0] // m) + tuple(x.shape[1:]))


# -- GPipe ----------------------------------------------------------------------


class _GPipeRun:
    """One GPipe pass: the forward ticks keep each (input leaf, output)
    graph; the backward ticks run them in reverse."""

    def __init__(self, stage_fn, spec, link, num_micro, dp, with_stage):
        self.stage_fn, self.spec, self.link = stage_fn, spec, link
        self.m, self.dp, self.with_stage = num_micro, dp, with_stage
        self.graphs: Dict[int, Dict[int, Any]] = {}
        self.leaves: Dict[int, List[torch.Tensor]] = {}

    def forward(self, x, local_leaves):
        link, S, M = self.link, self.link.num_stages, self.m
        micro_x = _micro(x, M, self.dp)
        act = (micro_x.shape[1:], micro_x.dtype)
        outs: List[Optional[torch.Tensor]] = [None] * M
        recv: Dict = {}
        for s in link.stages:
            row = link.index(s)
            self.leaves[s] = [t.detach()[row].requires_grad_(t.requires_grad)
                              for t in local_leaves]
            self.graphs[s] = {}
        for t in range(M + S - 1):
            sends = {}
            for s in link.stages:
                m = t - s
                if not 0 <= m < M:
                    continue
                inp = micro_x[m] if s == 0 else recv[("f", s)]
                leaf = inp.detach().requires_grad_()
                params = pytree.tree_unflatten(self.leaves[s], self.spec)
                with torch.enable_grad():
                    out = _call(self.stage_fn, self.with_stage, params, leaf,
                                s)
                self.graphs[s][m] = (leaf, out)
                if s < S - 1:
                    sends[("f", s + 1)] = out.detach()
                else:
                    outs[m] = out.detach()
            expects = {("f", s): (s - 1,) + act for s in link.stages
                       if s > 0 and 0 <= t - (s - 1) < M}
            recv = link.exchange(sends, expects)
        last = S - 1
        if last in link.stages:
            y = torch.cat(outs)
        else:
            y = torch.empty_like(x)
        return link.replicate(y, last)

    def backward(self, g, x_needs_grad: bool, needs_grad):
        link, S, M = self.link, self.link.num_stages, self.m
        micro_g = _micro(g, M, 1)
        act = (micro_g.shape[1:], micro_g.dtype)
        dx: List[Optional[torch.Tensor]] = [None] * M
        recv: Dict = {}
        for t in range(M + S - 1):
            sends = {}
            for s in link.stages:
                m = t - (S - 1 - s)
                if not 0 <= m < M:
                    continue
                seed = micro_g[m] if s == S - 1 else recv[("b", s)]
                leaf, out = self.graphs[s].pop(m)
                inputs = [leaf] + [p for p in self.leaves[s]
                                   if p.requires_grad]
                torch.autograd.backward(out, seed.to(out.dtype),
                                        inputs=inputs)
                if s > 0:
                    sends[("b", s - 1)] = leaf.grad
                else:
                    dx[m] = leaf.grad
            expects = {("b", s): (s + 1,) + act for s in link.stages
                       if s < S - 1 and 0 <= t - (S - 2 - s) < M}
            recv = link.exchange(sends, expects)
        grads = []
        for i, needed in enumerate(needs_grad):
            if not needed:
                grads.append(None)
                continue
            rows = [self.leaves[s][i].grad for s in link.stages]
            rows = [torch.zeros_like(self.leaves[s][i]) if r is None else r
                    for s, r in zip(link.stages, rows)]
            grads.append(torch.stack(rows))
        self.graphs, self.leaves = {}, {}
        if not x_needs_grad:
            return None, grads
        dx_all = torch.cat(dx) if 0 in link.stages else torch.empty_like(g)
        return link.replicate(dx_all, 0), grads


class _GPipe(torch.autograd.Function):
    @staticmethod
    def forward(ctx, run, x, *local_leaves):
        ctx.run = run
        return run.forward(x, local_leaves)

    @staticmethod
    def backward(ctx, g):
        dx, grads = ctx.run.backward(g, ctx.needs_input_grad[1],
                                     ctx.needs_input_grad[2:])
        return (None, dx, *grads)


def pipeline_apply(
    stage_fn: Callable,
    stacked_params,
    x: torch.Tensor,
    mesh=None,
    num_microbatches: int = 1,
    axis: str = "pipeline",
    batch_axis=None,
    with_stage: bool = False,
) -> torch.Tensor:
    """Run ``stage_fn`` as a GPipe pipeline over the stages.

    ``stacked_params`` leaves have a leading stage dim (each rank's
    shard one stage in the rank form, all ``S`` in process);
    ``x`` is this rank's ``[batch, ...]`` (already split over the batch
    axes), its batch divisible by ``num_microbatches``; the output,
    ``x``'s shape, is on every stage.  Differentiable in ``x`` and the
    stacked params."""
    leaves, spec = pytree.tree_flatten(stacked_params)
    link = _link(mesh, axis, leaves)
    _, dp = batch_groups(mesh, batch_axis)
    run = _GPipeRun(stage_fn, spec, link, num_microbatches, dp, with_stage)
    return _GPipe.apply(run, x, *[_local(t) for t in leaves])


# -- 1F1B -----------------------------------------------------------------------


class PipelineTrainResult(NamedTuple):
    """Outputs of :func:`pipeline_train_step_1f1b`: a full vjp segment,
    so embed layers before and head layers after the pipeline train end
    to end.  ``stage_grads`` are local (this rank's stages, plain
    tensors) and shaped as the local stacked params."""

    loss: torch.Tensor
    stage_grads: Any
    head_grads: Any
    input_grads: torch.Tensor
    # the most stage inputs any local stage held stashed at once
    stash_peak: int = 0


def pipeline_train_step_1f1b(
    stage_fn: Callable,
    loss_fn: Callable,
    stacked_params,
    x: torch.Tensor,
    y: torch.Tensor,
    mesh=None,
    num_microbatches: int = 1,
    axis: str = "pipeline",
    batch_axis=None,
    head_params=None,
    with_stage: bool = False,
) -> PipelineTrainResult:
    """Interleaved (1F1B) pipelined training step.

    ``head_params`` (optional) are weights the loss applies after the
    last stage: ``loss_fn(head_params, out, y_mb)``; without them
    ``loss_fn(out, y_mb)``.  The loss is the mean over microbatches
    (and over the batch axes' ranks).  Returns a
    :class:`PipelineTrainResult`: ``input_grads`` is dLoss/dx, to chain
    into the embedding's backward."""
    leaves, spec = pytree.tree_flatten(stacked_params)
    link = _link(mesh, axis, leaves)
    groups, dp = batch_groups(mesh, batch_axis)
    # every stacked leaf gets its gradient, as under jax.vjp
    local = [_local(t).detach() for t in leaves]
    hp_leaves, hp_spec = pytree.tree_flatten(
        head_params if head_params is not None else {})
    hp_leaves = [_local(t).detach() for t in hp_leaves]
    S, M = link.num_stages, num_microbatches

    def apply_loss(hp, out, y_mb):
        if head_params is None:
            return loss_fn(out, y_mb)
        return loss_fn(pytree.tree_unflatten(hp, hp_spec), out, y_mb)

    micro_x, micro_y = _micro(x.detach(), M, dp), _micro(y, M, dp)
    act = (micro_x.shape[1:], micro_x.dtype)
    # fp32 accumulators, as the reference's
    acc = {s: [torch.zeros(t.shape[1:], dtype=torch.float32,
                           device=t.device) for t in local]
           for s in link.stages}
    head_acc = [torch.zeros_like(t, dtype=torch.float32) for t in hp_leaves]
    loss_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    dx: List[Optional[torch.Tensor]] = [None] * M
    stash: Dict[int, Dict[int, torch.Tensor]] = {s: {} for s in link.stages}
    peak = 0
    seeds: Dict[int, torch.Tensor] = {}
    recv: Dict = {}
    for t in range(M + 2 * (S - 1)):
        sends = {}
        for s in link.stages:
            row = link.index(s)
            params = _stage_params(spec, local, row)
            # ---- forward stream: stage s forwards microbatch t - s
            m = t - s
            if 0 <= m < M:
                inp = micro_x[m] if s == 0 else recv[("f", s)]
                stash[s][m] = inp
                peak = max(peak, len(stash[s]))
                with torch.no_grad():
                    out = _call(stage_fn, with_stage, params, inp, s)
                if s < S - 1:
                    sends[("f", s + 1)] = out
                else:
                    # the last stage turns the microbatch around; each
                    # seed carries the 1/M of the mean
                    out_leaf = out.detach().requires_grad_()
                    hp = [h.detach().requires_grad_() for h in hp_leaves]
                    with torch.enable_grad():
                        loss_t = apply_loss(hp, out_leaf, micro_y[m]) / M
                    grads = torch.autograd.grad(loss_t, [out_leaf] + hp,
                                                allow_unused=True)
                    seeds[m] = grads[0]
                    for a, g in zip(head_acc, grads[1:]):
                        if g is not None:
                            a.add_(g.float())
                    loss_sum = loss_sum + loss_t.detach().float() * M
            # ---- backward stream: stage s backwards t - 2(S-1) + s
            m = t - 2 * (S - 1) + s
            if 0 <= m < M:
                inp = stash[s].pop(m)
                seed = seeds.pop(m) if s == S - 1 else recv[("b", s)]
                leaf = inp.detach().requires_grad_()
                p_leaves = [p[row].requires_grad_() for p in local]
                with torch.enable_grad():
                    out = _call(stage_fn, with_stage,
                                pytree.tree_unflatten(p_leaves, spec), leaf,
                                s)
                torch.autograd.backward(out, seed.to(out.dtype),
                                        inputs=[leaf] + p_leaves)
                for a, p in zip(acc[s], p_leaves):
                    if p.grad is not None:
                        a.add_(p.grad.float())
                if s > 0:
                    sends[("b", s - 1)] = leaf.grad
                else:
                    dx[m] = leaf.grad
        expects = {}
        for s in link.stages:
            if s > 0 and 0 <= t - (s - 1) < M:
                expects[("f", s)] = (s - 1,) + act
            if s < S - 1 and 0 <= t - 2 * (S - 1) + s + 1 < M:
                expects[("b", s)] = (s + 1,) + act
        recv = link.exchange(sends, expects)
    # loss and head grads live on the last stage, input grads on stage
    # 0: replicated over the stages (the reference's psum)
    loss, head_acc = link.replicate((loss_sum / M, head_acc), S - 1)
    dx_all = torch.cat(dx) if 0 in link.stages else torch.empty_like(x)
    dx_all = link.replicate(dx_all, 0)
    stage_grads = [torch.stack([acc[s][i] for s in link.stages])
                   .to(t.dtype) for i, t in enumerate(local)]
    if groups:
        # each data row saw its own batch slice: the global loss and
        # gradient are the mean over rows; input grads stay per row
        # with the 1/dp of the global mean
        import torch.distributed as dist

        for group in groups:
            for v in [loss] + stage_grads + head_acc:
                dist.all_reduce(v, group=group)
        loss = loss / dp
        stage_grads = [g / dp for g in stage_grads]
        head_acc = [g / dp for g in head_acc]
        dx_all = dx_all / dp
    head_grads = None
    if head_params is not None:
        head_grads = pytree.tree_unflatten(
            [g.to(h.dtype) for g, h in zip(head_acc, hp_leaves)], hp_spec)
    return PipelineTrainResult(
        loss=loss, stage_grads=pytree.tree_unflatten(stage_grads, spec),
        head_grads=head_grads, input_grads=dx_all.to(x.dtype),
        stash_peak=peak)
