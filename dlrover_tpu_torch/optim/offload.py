"""Host-offloaded optimizer states.

Reference: ``dlrover_tpu/optim/offload.py`` (``offload``,
``adamw_offload``; behaviour of ``atorch/optimizers/adam_offload.py``,
PartitionAdam): the optimizer state lives in host memory between steps
to cut accelerator memory, at the price of host<->device traffic each
step.  The reference moves an optax state to the ``pinned_host``
memory space and lets XLA schedule the transfers.

Here :class:`Offload` wraps any ``torch.optim.Optimizer`` and steps it
chunk by chunk over its parameters (``DEFAULT_CHUNK_BYTES`` of state
each): a
chunk's state is copied host->card on a side stream (the next chunk's
copy runs while this chunk updates), updated on the card by the inner
optimizer, and copied back into pinned host buffers on the side stream.
The inner optimizer creates a chunk's state on the card at its first
step and it goes to the host at once, so the full moments never sit on
the card, at init or later (the reference's promise).  Scalars (step
counts) stay where the inner optimizer keeps them.  On the CPU the
host is the device: the chunks step with no copies.  Parameters that
are DTensors (FSDP2, tensor parallel) are not offloaded yet: sharded
states come with slice 4.3 of the port.
"""

from typing import Dict, List

import torch

from dlrover_tpu_torch.common.device import is_dtensor

DEFAULT_CHUNK_BYTES = 256 * 2**20


class Offload(torch.optim.Optimizer):
    """``inner`` with its state in (pinned) host memory between steps."""

    def __init__(self, inner: torch.optim.Optimizer):
        params = [p for g in inner.param_groups for p in g["params"]]
        if any(is_dtensor(p) for p in params):
            raise NotImplementedError(
                "offloading the state of sharded (DTensor) parameters comes "
                "with slice 4.3 of the port")
        super().__init__(params, {})
        self.inner = inner
        self.chunk_bytes = DEFAULT_CHUNK_BYTES
        self._host: Dict[int, Dict[str, torch.Tensor]] = {}
        self._side = None

    # the state and the groups are the inner optimizer's (a scheduler
    # that sets lr here sets it for the inner step); the setters take
    # what torch.optim.Optimizer.__init__ assigns
    @property
    def state(self):
        return self.inner.state

    @state.setter
    def state(self, value):
        pass

    @property
    def param_groups(self):
        return self.inner.param_groups if hasattr(self, "inner") else []

    @param_groups.setter
    def param_groups(self, value):
        pass

    def add_param_group(self, param_group):
        if not hasattr(self, "inner"):
            return  # torch.optim.Optimizer.__init__'s groups: the inner's
        self.inner.add_param_group(param_group)

    def _chunks(self, params: List[torch.Tensor]) -> List[List[torch.Tensor]]:
        chunks, cur, size = [], [], 0
        for p in params:
            # the state of an Adam-family optimizer: two fp32 moments
            nbytes = 2 * p.numel() * 4
            if cur and size + nbytes > self.chunk_bytes:
                chunks.append(cur)
                cur, size = [], 0
            cur.append(p)
            size += nbytes
        if cur:
            chunks.append(cur)
        return chunks

    def _offloaded(self, p, st):
        return [(k, v) for k, v in st.items()
                if torch.is_tensor(v) and v.dim() > 0]

    def _to_device(self, chunk, stream):
        """Queue the chunk's state host->card on ``stream``; returns the
        event after the copies."""
        with torch.cuda.stream(stream):
            for p in chunk:
                st = self.inner.state.get(p)
                if not st:
                    continue
                for k, v in self._offloaded(p, st):
                    if v.device != p.device:
                        st[k] = v.to(p.device, non_blocking=True)
            return stream.record_event()

    def _to_host(self, chunk, stream):
        """Queue the chunk's state card->host on ``stream`` into the
        pinned buffers (made at the chunk's first step)."""
        with torch.cuda.stream(stream):
            for p in chunk:
                st = self.inner.state.get(p)
                if not st:
                    continue
                host = self._host.setdefault(id(p), {})
                for k, v in self._offloaded(p, st):
                    if v.device.type != "cuda":
                        continue
                    buf = host.get(k)
                    if buf is None or buf.shape != v.shape:
                        buf = torch.empty(v.shape, dtype=v.dtype,
                                          pin_memory=True)
                        host[k] = buf
                    buf.copy_(v, non_blocking=True)
                    # the device copy is freed here: keep its memory until
                    # the side stream has read it
                    v.record_stream(stream)
                    st[k] = buf

    def _step_chunk(self, chunk):
        ids = {id(p) for p in chunk}
        saved = [g["params"] for g in self.param_groups]
        try:
            for g in self.param_groups:
                g["params"] = [p for p in g["params"] if id(p) in ids]
            self.inner.step()
        finally:
            for g, ps in zip(self.param_groups, saved):
                g["params"] = ps

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        params = [p for g in self.param_groups for p in g["params"]
                  if p.grad is not None]
        chunks = self._chunks(params)
        if not params or params[0].device.type != "cuda":
            for chunk in chunks:
                self._step_chunk(chunk)
            return loss
        main = torch.cuda.current_stream(params[0].device)
        if self._side is None:
            self._side = torch.cuda.Stream(params[0].device)
        side = self._side
        side.wait_stream(main)  # the host buffers and grads are ready
        ready = self._to_device(chunks[0], side)
        for i, chunk in enumerate(chunks):
            main.wait_event(ready)
            self._step_chunk(chunk)
            if i + 1 < len(chunks):
                ready = self._to_device(chunks[i + 1], side)
            side.wait_event(main.record_event())
            self._to_host(chunk, side)
        main.wait_stream(side)
        return loss

    def zero_grad(self, set_to_none: bool = True):
        self.inner.zero_grad(set_to_none=set_to_none)

    def _synchronize(self):
        if self._side is not None:
            self._side.synchronize()

    def state_dict(self):
        self._synchronize()
        return self.inner.state_dict()

    def load_state_dict(self, state_dict):
        self._synchronize()
        self.inner.load_state_dict(state_dict)


def offload(inner: torch.optim.Optimizer) -> Offload:
    """Wrap ``inner`` so its state lives in host memory between steps."""
    return Offload(inner)


def adamw_offload(params, learning_rate: float = 1e-3, b1: float = 0.9,
                  b2: float = 0.999, eps: float = 1e-8,
                  weight_decay: float = 1e-4) -> Offload:
    """AdamW with host-resident moments (the reference's headline
    offload config: ``offload(optax.adamw(...))``, its defaults and its
    order of operations)."""
    from dlrover_tpu_torch.optim.bf16 import OptaxAdamW

    return Offload(OptaxAdamW(params, lr=learning_rate, b1=b1, b2=b2,
                              eps=eps, weight_decay=weight_decay))
