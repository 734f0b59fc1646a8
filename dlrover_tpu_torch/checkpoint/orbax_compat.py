"""Reshardable global checkpoints through ``torch.distributed.checkpoint``.

Copy of ``dlrover_tpu/checkpoint/orbax_compat.py``: the durable tier
next to the flash checkpoint (reference capability: the FSDP/Megatron
distributed-checkpoint paths, ``flash_checkpoint/fsdp_engine.py``,
``megatron_dist_ckpt.py``, whose value is resharding on load).  Where
the reference writes orbax, this writes DCP (``dcp.async_save`` /
``dcp.load``), torch's own: DTensors are written with their placements
and restored onto a target's placements, so a world-size change
reshards transparently.  The name of the class and of the tier stay the
reference's.

Deviation: this tier's files are DCP's format, not orbax's, so they do
not cross between the packages (the flash tiers, shm and storage, stay
byte-compatible both ways).

Layout: one directory a step, ``<directory>/step_<N>``, complete once
DCP's ``.metadata`` is in it; ``max_to_keep`` complete steps are kept
(rank 0 prunes).  A state is written flat, under the flash layout's
``a/b/0`` keys; numpy leaves as tensors, other leaves as DCP's pickled
objects.  Saves are asynchronous: DCP stages a CPU copy before
``save`` returns (so later in-place updates cannot reach it) and
writes it on a thread.  Under a process group the collectives of that
thread run on a gloo group of this checkpointer's own, never on the
training's group.
"""

import os
import shutil
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from dlrover_tpu_torch.common.log import default_logger as logger

_STEP_PREFIX = "step_"
_METADATA = ".metadata"


def _dist_ready() -> bool:
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


class GlobalCheckpointer:
    """DCP-backed save/restore of (possibly sharded) state trees."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        import torch.distributed as dist

        self._dir = directory
        self._max_to_keep = max(1, int(max_to_keep))
        os.makedirs(directory, exist_ok=True)
        self._pending: List[Tuple[int, Any]] = []
        # a group of its own, so the writer thread's collectives never
        # interleave with the training's on the default group
        self._pg = dist.new_group(backend="gloo") if _dist_ready() else None
        self._rank = dist.get_rank() if _dist_ready() else 0

    # -- steps -------------------------------------------------------------

    def _step_dir(self, step: int) -> str:
        return os.path.join(self._dir, f"{_STEP_PREFIX}{step}")

    def all_steps(self) -> List[int]:
        """Complete steps (DCP's metadata written), ascending."""
        steps = []
        try:
            names = os.listdir(self._dir)
        except FileNotFoundError:
            return []
        for name in names:
            suffix = name[len(_STEP_PREFIX):]
            if (name.startswith(_STEP_PREFIX) and suffix.isdigit()
                    and os.path.exists(os.path.join(self._dir, name,
                                                    _METADATA))):
                steps.append(int(suffix))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    # -- save --------------------------------------------------------------

    def save(self, step: int, state, wait: bool = False):
        """Asynchronous by default: returns once DCP has staged its copy;
        :meth:`wait` blocks until the write is complete."""
        import torch.distributed.checkpoint as dcp

        from dlrover_tpu_torch.checkpoint.shm_handler import (
            _flatten_state_dict,
        )

        flat = {}
        for key, leaf in _flatten_state_dict(state).items():
            if isinstance(leaf, (np.ndarray, np.generic)):
                leaf = torch.from_numpy(np.array(leaf, copy=True))
            flat[key] = leaf
        self._reap()
        fut = dcp.async_save(
            flat, checkpoint_id=self._step_dir(step),
            process_group=self._pg, no_dist=self._pg is None,
        )
        self._pending.append((step, fut))
        if wait:
            self.wait()

    def _reap(self):
        """Collect the finished writes (raising a failed one) and prune
        the complete steps past ``max_to_keep``."""
        still = []
        for step, fut in self._pending:
            if fut.done():
                fut.result()
            else:
                still.append((step, fut))
        self._pending = still
        if self._rank != 0:
            return
        busy = {s for s, _ in self._pending}
        done = [s for s in self.all_steps() if s not in busy]
        for s in done[:-self._max_to_keep]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    def wait(self):
        for _, fut in self._pending:
            fut.result()
        self._pending = []
        self._reap()

    # -- restore -----------------------------------------------------------

    def restore(
        self, target_state: Optional[Any] = None,
        step: Optional[int] = None,
    ) -> Tuple[Optional[int], Any]:
        """Restore the latest (or given) step.  With ``target_state`` (a
        tree of DTensors, tensors and other leaves) every tensor is
        loaded in place onto the target's placements (resharded) and the
        tree comes back in the target's structure; without one, a nested
        dict of full CPU tensors and the saved objects."""
        import torch.distributed.checkpoint as dcp

        from dlrover_tpu_torch.checkpoint.shm_handler import (
            _flatten_state_dict,
            _unflatten_to_nested,
            map_leaves,
        )

        step = step if step is not None else self.latest_step()
        if step is None:
            return None, None
        path = self._step_dir(step)
        if target_state is not None:
            flat = {}
            for key, leaf in _flatten_state_dict(target_state).items():
                if isinstance(leaf, (np.ndarray, np.generic)):
                    leaf = torch.from_numpy(np.array(leaf, copy=True))
                flat[key] = leaf
        else:
            from torch.distributed.checkpoint.metadata import (
                TensorStorageMetadata,
            )

            meta = dcp.FileSystemReader(path).read_metadata()
            flat = {
                key: (torch.empty(tuple(m.size), dtype=m.properties.dtype)
                      if isinstance(m, TensorStorageMetadata) else None)
                for key, m in meta.state_dict_metadata.items()
            }
        with torch.no_grad():
            dcp.load(flat, checkpoint_id=path, process_group=self._pg,
                     no_dist=self._pg is None)
        logger.info("orbax-tier (DCP) restore of step %s complete", step)
        if target_state is None:
            return step, _unflatten_to_nested(flat)

        def put(path_keys, leaf):
            val = flat["/".join(path_keys)]
            if isinstance(leaf, np.ndarray):
                return val.numpy()
            if isinstance(leaf, np.generic):
                return type(leaf)(val.item())
            return val

        return step, map_leaves(put, target_state)

    def close(self):
        self.wait()
