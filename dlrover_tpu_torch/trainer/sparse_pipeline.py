"""Split-step sparse training pipeline (the parameter-server shape).

Copy of ``dlrover_tpu/trainer/sparse_pipeline.py``.  Reference: TFPlus
trains sparse models with HOST-resident KvVariable tables and CPU
parameter servers (``tfplus/tfplus/kv_variable/ops/kv_variable_ops.cc:37``,
``tfplus/tfplus/training/group_adam.py:28``) — the accelerator only ever
sees dense gathered embeddings.

Each step, in order: the host gather from the C++ table, a pinned copy
to the card, the device step (forward, BCE, backward, dense optimizer),
the embedding gradients back to the host, the C++ group update of the
touched keys.  The loop is double-buffered so the host table work
overlaps the card:

      host:    gather(k+1)   update(k-1)      gather(k+2) ...
      device:  [------ step k ------][------ step k+1 ------]
      D2H:         [egrads k-1 streams during step k]

Step ``k``'s embeddings therefore miss exactly one in-flight update
(staleness 1) — the asynchrony a CPU parameter server has by design.
The device->host gradient copy starts right after the step is queued:
a copy into a pinned host buffer on a side stream that waits for the
step, followed by a CUDA event (the JAX package's
``copy_to_host_async``); the host update waits on that event before it
reads the buffer, so it never sees a torn or stale gradient.
``pipeline=False`` gives strict sequential semantics (gather -> step ->
update); ``pipeline="auto"`` probes the first batches strictly and
stays strict when the measured host share is too small for double
buffering to pay (< 0.2).

With ``timing=True`` the card's time in each step and each gradient
copy is recorded with CUDA events (read once, at
:meth:`SparseTrainPipeline.overlap_report`).
"""

import itertools
import time
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch


class _Fetch:
    """An embedding-gradient copy in flight: the host buffer it lands
    in and the event after which the buffer is complete (None on the
    CPU, where the copy is synchronous)."""

    __slots__ = ("host", "event", "start")

    def __init__(self, host: torch.Tensor, event=None, start=None):
        self.host = host
        self.event = event
        self.start = start


class SparseTrainPipeline:
    """Drive a hybrid host-sparse / device-dense train loop.

    Parameters
    ----------
    table:
        :class:`~dlrover_tpu_torch.ops.kv_variable.KvVariable` hosting
        the embeddings.
    sparse_optimizer:
        a group optimizer over ``table`` (GroupAdam/Adagrad/FTRL) —
        ``apply_gradients(keys, grads)`` updates only touched rows.
    device_step:
        ``(state, emb, *batch_tensors) -> (state, emb_grads, aux)``
        (:func:`make_deepfm_device_step`).  ``emb`` is the dense
        ``[batch, fields, dim]`` gather result on ``device``;
        ``emb_grads`` is the gradient with respect to it; ``aux`` a dict
        of device scalars (loss), read lazily by the caller.
    device:
        where the step runs; the batch arrays after the ids are copied
        there with the embeddings.
    pipeline:
        True (default): staleness-1 double buffering as drawn above.
        False: strict gather -> step -> update per batch.  ``"auto"``:
        probe, then commit to one.
    """

    def __init__(
        self,
        table,
        sparse_optimizer,
        device_step: Callable,
        device: Any = "cuda",
        pipeline=True,
        timing: bool = False,
    ):
        self.table = table
        self.sparse_optimizer = sparse_optimizer
        self.device_step = device_step
        self.device = torch.device(device)
        if pipeline not in (True, False, "auto"):
            raise ValueError(f"pipeline must be bool or 'auto', "
                             f"got {pipeline!r}")
        self.pipeline = pipeline
        self.chosen_mode: Optional[str] = (
            None if pipeline == "auto"
            else ("pipelined" if pipeline else "strict")
        )
        self._cuda = self.device.type == "cuda"
        self._d2h_stream = None
        self._timing = timing and self._cuda
        self._step_events: List[Tuple[Any, Any]] = []
        self._d2h_events: List[Tuple[Any, Any]] = []
        # accounting for the overlap story
        self.stats: Dict[str, float] = {
            "steps": 0,
            "gather_s": 0.0,
            "h2d_s": 0.0,     # host time to stage and queue the copy
            "fetch_s": 0.0,   # blocking wait for device emb_grads
            "update_s": 0.0,  # pure host group-optimizer time
            "dispatch_s": 0.0,
            "wall_s": 0.0,
        }

    # -- the five stages -----------------------------------------------------

    def _gather(self, sparse_ids: np.ndarray) -> torch.Tensor:
        """The rows of a batch's ids, gathered by the C++ store straight
        into a host tensor (pinned when the step runs on a card)."""
        t0 = time.perf_counter()
        b, f = sparse_ids.shape
        out = torch.empty((b * f, self.table.dim), dtype=torch.float32,
                          pin_memory=self._cuda)
        self.table.gather(sparse_ids.reshape(-1), out=out.numpy())
        self.stats["gather_s"] += time.perf_counter() - t0
        return out.view(b, f, self.table.dim)

    def _to_device(self, emb: torch.Tensor, rest) -> Tuple[torch.Tensor,
                                                            list]:
        """The gathered rows and the batch's other arrays on the device,
        each copy queued ``non_blocking`` on the current stream from
        pinned memory when the device is a card."""
        t0 = time.perf_counter()
        out = []
        for t in (emb, *rest):
            if not isinstance(t, torch.Tensor):
                t = torch.from_numpy(np.ascontiguousarray(t))
            if self._cuda and t.device.type == "cpu" and not t.is_pinned():
                t = t.pin_memory()
            out.append(t.to(self.device, non_blocking=True))
        self.stats["h2d_s"] += time.perf_counter() - t0
        return out[0], out[1:]

    def _dispatch(self, state, emb, rest):
        t0 = time.perf_counter()
        if self._timing:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        state, egrads, aux = self.device_step(state, emb, *rest)
        if self._timing:
            end.record()
            self._step_events.append((start, end))
        self.stats["dispatch_s"] += time.perf_counter() - t0
        return state, egrads, aux

    def _start_fetch(self, egrads: torch.Tensor) -> _Fetch:
        """Start the gradient copy to the host without blocking: on a
        side stream that first waits for the step, into a pinned
        buffer, then an event.  The copy streams while the host gathers
        the next batch (and while the card runs it)."""
        egrads = egrads.detach()
        if not egrads.is_cuda:
            return _Fetch(egrads)
        if self._d2h_stream is None:
            self._d2h_stream = torch.cuda.Stream(self.device)
        side = self._d2h_stream
        side.wait_stream(torch.cuda.current_stream(self.device))
        host = torch.empty(egrads.shape, dtype=egrads.dtype,
                           pin_memory=True)
        start = None
        with torch.cuda.stream(side):
            if self._timing:
                start = torch.cuda.Event(enable_timing=True)
                start.record(side)
            host.copy_(egrads, non_blocking=True)
            done = torch.cuda.Event(enable_timing=self._timing)
            done.record(side)
        # the step's allocation must outlive the copy on the side stream
        egrads.record_stream(side)
        return _Fetch(host, done, start)

    def _update(self, sparse_ids: np.ndarray, fetch: _Fetch) -> None:
        t0 = time.perf_counter()
        if fetch.event is not None:
            # the buffer is complete only once the event has: reading
            # it earlier would update with a torn gradient, silently
            fetch.event.synchronize()
            if fetch.start is not None:
                self._d2h_events.append((fetch.start, fetch.event))
        grads = fetch.host.numpy()
        t1 = time.perf_counter()
        self.stats["fetch_s"] += t1 - t0
        b, f = sparse_ids.shape
        self.sparse_optimizer.apply_gradients(
            sparse_ids.reshape(-1),
            grads.reshape(b * f, self.table.dim),
        )
        self.stats["update_s"] += time.perf_counter() - t1

    # -- checkpointing -------------------------------------------------------

    def attach_checkpoint(self, checkpointer):
        """Wire this pipeline's sparse state into a
        :class:`~dlrover_tpu_torch.checkpoint.checkpointer.Checkpointer`:
        a :class:`~dlrover_tpu_torch.checkpoint.sparse.SparseStateAdapter`
        over the embedding table, the optimizer's slot tables and its
        step counter, registered with the flash-checkpoint engine.
        Returns the adapter.

        Checkpoint-consistent snapshots need the table quiescent at the
        save call: save from ``on_step`` in strict mode (no update in
        flight there), or between :meth:`run` calls in pipelined mode
        (the trailing update is drained at return)."""
        from dlrover_tpu_torch.checkpoint.sparse import SparseStateAdapter

        adapter = SparseStateAdapter()
        if hasattr(self.sparse_optimizer, "slot_tables"):
            adapter.register_optimizer(self.sparse_optimizer)
        else:
            adapter.register_table(self.table)
        checkpointer.register_sparse(adapter)
        return adapter

    # -- loops ---------------------------------------------------------------

    def run(
        self,
        state,
        batches: Iterable[Tuple[np.ndarray, ...]],
        on_aux: Optional[Callable[[Any], None]] = None,
        on_step: Optional[Callable[[Any, int], None]] = None,
    ):
        """Consume ``batches`` of ``(sparse_ids, *arrays)``; returns the
        final dense state.  ``on_aux`` receives each step's aux dict of
        device tensors (reading one synchronises with the card).
        ``on_step(state, steps_done)`` runs after each step's sparse
        update retires in strict mode — the table and the dense state
        are step-consistent there (the flash-checkpoint hook point); in
        pipelined mode one update is still in flight (staleness 1)."""
        if self.pipeline == "auto":
            # probe strictly, then commit: a tiny host share means
            # double buffering only adds overhead.  The first batch
            # pays one-time costs (allocator growth, library loads) the
            # steady state never pays, so it runs outside the probe's
            # accounting (it still trains and still counts in stats)
            it = iter(batches)
            warmup = list(itertools.islice(it, 1))
            state = self._run_strict(state, warmup, on_aux, on_step)
            base = {
                k: self.stats[k]
                for k in ("gather_s", "update_s", "dispatch_s",
                          "fetch_s")
            }
            probe = list(itertools.islice(it, 3))
            state = self._run_strict(state, probe, on_aux, on_step)
            host = (
                self.stats["gather_s"] - base["gather_s"]
                + self.stats["update_s"] - base["update_s"]
            )
            busy = host + \
                (self.stats["dispatch_s"] - base["dispatch_s"]) + \
                (self.stats["fetch_s"] - base["fetch_s"])
            frac = host / max(busy, 1e-9)
            self.chosen_mode = (
                "pipelined" if frac >= 0.2 else "strict"
            )
            if self.chosen_mode == "pipelined":
                return self._run_pipelined(state, it, on_aux, on_step)
            return self._run_strict(state, it, on_aux, on_step)
        if self.pipeline:
            return self._run_pipelined(state, batches, on_aux, on_step)
        return self._run_strict(state, batches, on_aux, on_step)

    def _run_strict(self, state, batches, on_aux, on_step=None):
        t_wall = time.perf_counter()
        for sparse_ids, *rest in batches:
            emb, rest = self._to_device(self._gather(sparse_ids), rest)
            state, egrads, aux = self._dispatch(state, emb, rest)
            self._update(sparse_ids, self._start_fetch(egrads))
            self.stats["steps"] += 1
            if on_aux is not None:
                on_aux(aux)
            if on_step is not None:
                on_step(state, int(self.stats["steps"]))
        self.stats["wall_s"] += time.perf_counter() - t_wall
        return state

    def _run_pipelined(self, state, batches, on_aux, on_step=None):
        t_wall = time.perf_counter()
        it = iter(batches)
        try:
            cur = next(it)
        except StopIteration:
            self.stats["wall_s"] += time.perf_counter() - t_wall
            return state
        emb = self._gather(cur[0])
        pending: Optional[Tuple[np.ndarray, _Fetch]] = None
        while True:
            nxt = next(it, None)
            sparse_ids, *rest = cur
            emb_d, rest_d = self._to_device(emb, rest)
            state, egrads, aux = self._dispatch(state, emb_d, rest_d)
            # step k's gradient copy is queued NOW behind the step and
            # streams while the host retires k-1 and gathers k+1
            fetch = self._start_fetch(egrads)
            # while the card runs step k: retire step k-1's sparse
            # update (its gradient copied during our dispatch), then
            # gather step k+1's rows — the table the gather sees
            # includes every update through k-1
            if pending is not None:
                self._update(*pending)
            if nxt is not None:
                next_emb = self._gather(nxt[0])
            pending = (sparse_ids, fetch)
            self.stats["steps"] += 1
            if on_aux is not None:
                on_aux(aux)
            if on_step is not None:
                # staleness 1: this step's own sparse update is still
                # in flight, as documented in :meth:`run`
                on_step(state, int(self.stats["steps"]))
            if nxt is None:
                break
            cur, emb = nxt, next_emb
        # drain the last in-flight update
        self._update(*pending)
        self.stats["wall_s"] += time.perf_counter() - t_wall
        return state

    def overlap_report(self) -> Dict[str, float]:
        """Host-work overlap accounting: in a perfect pipeline the wall
        time approaches max(device, host) instead of their sum.  With
        ``timing`` the card's summed step and copy times are included
        (``device_s``, ``d2h_device_s``)."""
        s = dict(self.stats)
        host = s["gather_s"] + s["update_s"]
        s["host_table_s"] = round(host, 6)
        s["fetch_s"] = round(s["fetch_s"], 6)
        if s["wall_s"] > 0:
            s["host_fraction"] = round(host / s["wall_s"], 6)
        if self.chosen_mode is not None:
            s["mode"] = self.chosen_mode
        if self._step_events:
            torch.cuda.synchronize(self.device)
            s["device_s"] = sum(
                a.elapsed_time(b) for a, b in self._step_events) / 1e3
            s["step_device_ms"] = [
                a.elapsed_time(b) for a, b in self._step_events]
            s["d2h_device_s"] = sum(
                a.elapsed_time(b) for a, b in self._d2h_events) / 1e3
        return s


def make_deepfm_device_step(model, dense_optimizer):
    """The dense step of :class:`~dlrover_tpu_torch.models.deepfm.DeepFM`
    shaped for :class:`SparseTrainPipeline`: takes the gathered
    embeddings, runs the tower, BCE, backward and ``dense_optimizer``
    on the model's device, and returns the embeddings' gradient for
    the host group optimizer.  The tower is updated in place; ``state``
    passes through."""
    from dlrover_tpu_torch.models.deepfm import bce_with_logits

    def device_step(state, emb, dense_x, labels):
        emb = emb.detach().requires_grad_(True)
        dense_optimizer.zero_grad(set_to_none=True)
        loss = bce_with_logits(model.apply(emb, dense_x), labels)
        loss.backward()
        dense_optimizer.step()
        return state, emb.grad, {"loss": loss.detach()}

    return device_step
