"""State dict <-> shared-memory serialization.

Copy of the flat layout of ``dlrover_tpu/checkpoint/shm_handler.py``
(reference: ``SharedMemoryHandler`` / ``TensorMeta``,
``dlrover/python/elastic_agent/torch/ckpt_saver.py:65,209``): a state
dict is traversed into one flat shared-memory buffer plus a meta dict
(shape/dtype/offset per leaf) published through a ``SharedDict``; the
agent process reads the bytes back without knowing the model.

The layout is byte-compatible with the JAX package's: the same keys in
the same order (``_flatten_state_dict`` walks nested dicts, lists,
tuples and named tuples in ``jax.tree_util``'s order), the same
offsets, numpy's dtype names in ``TensorMeta.dtype``, and the
non-array leaves pickled into a trailing blob.  So a segment or a
``rank_N.ckpt`` file written by one package is read by the other.
Tensors move as raw bytes (``bfloat16`` needs no ``ml_dtypes``).

CUDA tensors go to the host in chunks of 256 MB: a dedicated copy
stream fills two pinned staging buffers in turn with
``copy_(non_blocking=True)`` while the host copies the other buffer
into the segment (a CPU ``copy_``, which runs with the GIL released).

A sharded leaf (a DTensor whose placements are not all ``Replicate``,
like the JAX package's global sharded arrays) is written as this rank's
local tensor under ``key@shardN``, with the shard's global index ranges
and the leaf's global shape in its ``TensorMeta`` (reference ``:42``,
``:115-140``), so a sharded layout written by either package reads the
same.  The untargeted reads assemble those entries into full tensors,
as the reference's ``_assemble_flat`` does; the target-state restore
(``CheckpointEngine.load_sharded``) reads them as views (``load_flat``
/ ``flat_from_raw`` with ``detach=False``) and copies each target box
straight out of them.  The paged base+delta tier (``DLROVER_SHM_PAGED``,
reference ``:425-1058``) comes with the sparse state in slice 6.  A save fires the reference's
``ckpt.shm_save`` chaos hook once its snapshot is published.

torch is imported where a tensor is made or read, not with the module:
the agent's side of it (segments, meta, the raw bytes it persists, the
restore prefetch) runs in the launcher's process, which never loads
torch (a CUDA build maps the CUDA driver's library at ``import torch``).
"""

from __future__ import annotations

import functools
import io
import os
import pickle
import threading
import time
import warnings
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from dlrover_tpu_torch.checkpoint.sharded import SHARD_SEP
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.common.multi_process import (
    PersistentSharedMemory,
    SharedDict,
    get_or_create_shm,
    socket_dir,
)


@dataclass
class TensorMeta:
    """Placement of one array leaf inside the flat buffer
    (reference: ckpt_saver.py:65).  ``global_shape`` and ``index`` carry
    the reassembly metadata of a shard of a sharded tensor (key suffixed
    ``@shardN``); they stay None for a whole leaf."""

    shape: Tuple[int, ...] = ()
    dtype: str = "float32"
    offset: int = 0
    nbytes: int = 0
    global_shape: Optional[Tuple[int, ...]] = None
    index: Optional[Tuple[Tuple[int, int], ...]] = None


@dataclass
class CheckpointConfig:
    """Per-snapshot metadata carried with the shm segment
    (reference: ckpt_saver.py:74)."""

    step: int = 0
    path: str = ""
    rank: int = 0
    world_size: int = 1
    # shards expected globally for the commit protocol
    global_shard_num: int = 1
    writing: bool = False
    extra: Dict[str, Any] = field(default_factory=dict)


@functools.lru_cache(maxsize=None)
def _dtype_tables():
    """numpy's dtype names, which TensorMeta.dtype keeps, and torch's
    dtypes, both ways."""
    import torch

    names = {
        "bool": torch.bool,
        "uint8": torch.uint8,
        "int8": torch.int8,
        "int16": torch.int16,
        "int32": torch.int32,
        "int64": torch.int64,
        "float16": torch.float16,
        "bfloat16": torch.bfloat16,
        "float32": torch.float32,
        "float64": torch.float64,
        "complex64": torch.complex64,
        "complex128": torch.complex128,
        "float8_e4m3fn": torch.float8_e4m3fn,
        "float8_e5m2": torch.float8_e5m2,
    }
    return names, {dt: name for name, dt in names.items()}


def torch_dtype(name: str) -> torch.dtype:
    try:
        return _dtype_tables()[0][name]
    except KeyError:
        raise TypeError(f"checkpoint leaf dtype {name!r} has no torch "
                        "counterpart") from None


def dtype_name(dtype: torch.dtype) -> str:
    try:
        return _dtype_tables()[1][dtype]
    except KeyError:
        raise TypeError(f"torch dtype {dtype} has no checkpoint "
                        "name") from None


# -- pytree walk in jax.tree_util's order ------------------------------------


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(node):
    """``[(key, child)]`` of a container node in ``jax.tree_util``'s
    flatten order, or None for a leaf: dict keys sorted (an
    ``OrderedDict`` keeps its insertion order), sequences by index,
    named tuples by field; None is an empty subtree."""
    if isinstance(node, OrderedDict):
        return list(node.items())
    if isinstance(node, dict):
        return [(k, node[k]) for k in sorted(node)]
    if _is_namedtuple(node):
        return list(zip(node._fields, node))
    if isinstance(node, (list, tuple)):
        return list(enumerate(node))
    if node is None:
        return []
    return None


def _walk(node, prefix: Tuple[str, ...] = ()):
    children = _children(node)
    if children is None:
        yield prefix, node
        return
    for key, child in children:
        yield from _walk(child, prefix + (str(key),))


def _flatten_state_dict(state_dict) -> Dict[str, Any]:
    """Pytree -> {"a/b/0": leaf} with the JAX package's keys and order
    (``jax.tree_util.tree_flatten_with_path`` joined with ``/``)."""
    return {"/".join(path): leaf for path, leaf in _walk(state_dict)}


def map_leaves(fn, node, prefix: Tuple[str, ...] = ()):
    """The same containers with ``fn(path, leaf)`` at every leaf (paths
    as ``_flatten_state_dict`` names them), so a copy flattens in the
    original's order."""
    children = _children(node)
    if children is None:
        return fn(prefix, node)
    if node is None:
        return None
    mapped = [(k, map_leaves(fn, c, prefix + (str(k),)))
              for k, c in children]
    if isinstance(node, dict):
        out = type(node)() if isinstance(node, OrderedDict) else {}
        for k, v in mapped:
            out[k] = v
        return out
    values = [v for _, v in mapped]
    if _is_namedtuple(node):
        return type(node)(*values)
    return type(node)(values)


def _unflatten_to_nested(flat: Dict[str, Any]) -> Dict[str, Any]:
    """{"a/b": v} -> {"a": {"b": v}}; integer-keyed dicts stay dicts
    (exact container types are the caller's concern: see
    :func:`dlrover_tpu_torch.checkpoint.checkpointer.restore_to_template`)."""
    root: Dict[str, Any] = {}
    for key, value in flat.items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return root


def _assemble_flat(flat: Dict[str, Any], metas: Dict[str, Any]):
    """Assemble ``@shardN`` entries into full tensors (raises if the
    visible shards do not cover a leaf: the topology changed across
    hosts; restore with a target state, ``load_sharded``, or from the
    orbax tier)."""
    from dlrover_tpu_torch.checkpoint.sharded import (
        assemble_shard,
        group_shard_entries,
    )

    grouped, plain = group_shard_entries(flat, metas)
    for base, entries in grouped.items():
        meta = next(m for k, m in metas.items()
                    if k.split(SHARD_SEP, 1)[0] == base
                    and m.index is not None)
        gshape = tuple(meta.global_shape)
        full = assemble_shard(tuple((0, d) for d in gshape),
                              torch_dtype(meta.dtype), entries)
        if full is None:
            raise ValueError(
                f"shards of '{base}' do not cover its global shape "
                f"{gshape}: restore with a target state (load_sharded) "
                "or from the orbax tier"
            )
        plain[base] = full
    return plain


class SnapshotLeaf:
    """A leaf of the engine's snapshot: the bytes of a tensor of
    ``shape`` and ``dtype``, copied to ``flat[start:start + nbytes]``, a
    uint8 CUDA buffer that holds the snapshot's leaves back to back."""

    __slots__ = ("flat", "start", "shape", "dtype")

    def __init__(self, flat: torch.Tensor, start: int, shape, dtype):
        self.flat = flat
        self.start = start
        self.shape = tuple(shape)
        self.dtype = dtype


class ShardLeaf:
    """A sharded leaf's local part in a snapshot: ``data`` (a tensor or
    a :class:`SnapshotLeaf`) covering ``index`` of a tensor of
    ``global_shape``."""

    __slots__ = ("data", "index", "global_shape")

    def __init__(self, data, index, global_shape):
        self.data = data
        self.index = tuple(tuple(r) for r in index)
        self.global_shape = tuple(int(d) for d in global_shape)


def _extract_entries(state_dict):
    """Split a state dict into shm-layout entries: ``(entries, scalars,
    shard_info)``, entries ``[(key, leaf)]`` in layout order (tensors
    and snapshot leaves as they are, numpy leaves as contiguous
    arrays), scalars the non-array leaves, shard_info the reassembly
    metadata ``{key@shardN: (global_shape, index)}`` of the local parts
    of sharded leaves (DTensors, :class:`ShardLeaf`).  A DTensor whose
    placements are all ``Replicate`` is a whole leaf (its local
    tensor)."""
    import torch

    from dlrover_tpu_torch.checkpoint.sharded import (
        is_dtensor,
        is_sharded_leaf,
        local_shards,
    )

    entries = []
    scalars: Dict[str, Any] = {}
    shard_info: Dict[str, Tuple[Tuple[int, ...], Tuple]] = {}
    for key, leaf in _flatten_state_dict(state_dict).items():
        if isinstance(leaf, ShardLeaf):
            skey = f"{key}{SHARD_SEP}0"
            entries.append((skey, leaf.data))
            shard_info[skey] = (leaf.global_shape, leaf.index)
        elif is_sharded_leaf(leaf):
            gshape = tuple(int(d) for d in leaf.shape)
            for i, (ranges, data) in enumerate(local_shards(leaf)):
                skey = f"{key}{SHARD_SEP}{i}"
                entries.append((skey, data))
                shard_info[skey] = (gshape, ranges)
        elif is_dtensor(leaf):
            entries.append((key, leaf.to_local()))
        elif isinstance(leaf, (torch.Tensor, SnapshotLeaf)):
            entries.append((key, leaf))
        elif isinstance(leaf, (np.ndarray, np.generic)):
            entries.append((key, np.ascontiguousarray(leaf)))
        else:
            scalars[key] = leaf
    return entries, scalars, shard_info


def _leaf_meta(leaf) -> Tuple[Tuple[int, ...], str, int]:
    """(shape, dtype name, nbytes) of an array leaf."""
    import torch
    shape = tuple(int(d) for d in leaf.shape)
    if isinstance(leaf.dtype, torch.dtype):
        name = dtype_name(leaf.dtype)
        itemsize = leaf.dtype.itemsize
    else:
        name = str(leaf.dtype)
        itemsize = leaf.dtype.itemsize
    count = int(np.prod(shape, dtype=np.int64)) if shape else 1
    return shape, name, count * itemsize


def _add_piece(pieces: list, base: torch.Tensor, start: int, nbytes: int,
               dst: int):
    """Append ``base[start:start + nbytes]`` bound for ``dst`` to
    ``pieces`` (``[base, start, nbytes, dst]`` lists), merged into the
    last piece when both ranges continue it."""
    if pieces:
        last = pieces[-1]
        if (last[0] is base and last[1] + last[2] == start
                and last[3] + last[2] == dst):
            last[2] += nbytes
            return
    pieces.append([base, start, nbytes, dst])


def _as_bytes(t: torch.Tensor) -> torch.Tensor:
    """A tensor's bytes as a flat uint8 tensor (a copy only when it is
    not contiguous)."""
    import torch
    if not t.is_contiguous():
        t = t.contiguous()
    return t.detach().view(-1).view(torch.uint8)


def _buffer_bytes(buf, offset: int, nbytes: int) -> torch.Tensor:
    """``buf[offset:offset + nbytes]`` as a uint8 tensor without a copy
    (a read-only buffer, such as a storage mmap, is only read)."""
    import torch
    if nbytes == 0:
        return torch.empty(0, dtype=torch.uint8)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return torch.frombuffer(buf, dtype=torch.uint8, count=nbytes,
                                offset=offset)


def default_job_suffix() -> str:
    """Namespace shm segments per job so two jobs (or a test run next
    to a live job) on one host never collide: DLROVER_JOB_NAME if set,
    else a hash of the job's IPC socket dir (which agent and trainers
    already share)."""
    import hashlib

    name = os.getenv("DLROVER_JOB_NAME")
    if name:
        return name
    return hashlib.md5(socket_dir().encode()).hexdigest()[:8]


def paged_enabled() -> bool:
    """``DLROVER_SHM_PAGED`` opt-in for the paged hot-save tier, which
    the port does not have yet (slice 6)."""
    return os.environ.get(
        "DLROVER_SHM_PAGED", ""
    ).strip().lower() in ("1", "true", "yes", "on")


# -- meta files ---------------------------------------------------------------

# the meta classes under their own names and under the JAX package's:
# a step dir written by either package is read by the port
_META_CLASSES = {
    (mod, cls.__name__): cls
    for cls in (TensorMeta, CheckpointConfig)
    for mod in (__name__, "dlrover_tpu.checkpoint.shm_handler")
}
_META_BUILTINS = {"dict", "list", "tuple", "set", "frozenset", "int",
                  "float", "str", "bytes", "bool", "complex"}


class _MetaUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if (module, name) in _META_CLASSES:
            return _META_CLASSES[(module, name)]
        if module == "builtins" and name in _META_BUILTINS:
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"forbidden global {module}.{name} in checkpoint meta"
        )


def load_meta(data: bytes) -> Dict[str, Any]:
    """A ``rank_N.meta`` file's dict; the JAX package's ``TensorMeta``
    and ``CheckpointConfig`` come back as the port's classes, and any
    other global is refused."""
    return _MetaUnpickler(io.BytesIO(data)).load()


# -- device -> host staging ---------------------------------------------------

STAGING_BYTES = 256 * 2**20


class _DeviceStager:
    """Copies CUDA tensors into a host buffer through two pinned staging
    buffers on a dedicated copy stream: the card fills one buffer while
    the host copies the other out (``copy_(non_blocking=True)`` into
    pinned memory, then a CPU ``copy_`` into the destination)."""

    def __init__(self, device: torch.device):
        import torch
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self.buffers = [
            torch.empty(STAGING_BYTES, dtype=torch.uint8, pin_memory=True)
            for _ in range(2)
        ]
        self._done = [torch.cuda.Event() for _ in range(2)]
        self._pending: List[Optional[list]] = [None, None]
        self._timing: List[Tuple[torch.cuda.Event, torch.cuda.Event]] = []
        self.wait_s = 0.0     # host waiting on the card's copies
        self.memcpy_s = 0.0   # host copies out of the staging buffers
        self.bytes = 0

    def copy(self, pieces, dst_buf, ready: Optional[List] = None):
        """``pieces``: ``[(src uint8 CUDA tensor, dst offset)]``.  The
        copy stream first waits for ``ready`` (events after which the
        sources are complete) or, without them, for the caller's
        current stream.  Returns when every byte is in ``dst_buf``."""
        import torch
        if ready:
            for ev in ready:
                self.stream.wait_event(ev)
        else:
            self.stream.wait_stream(torch.cuda.current_stream(self.device))
        self.wait_s = self.memcpy_s = 0.0
        self.bytes = 0
        self._timing = []
        cur, fill, batch = 0, 0, []
        for src, dst_off in pieces:
            n, pos = src.numel(), 0
            while pos < n:
                if fill == 0:
                    self._drain(cur, dst_buf)
                    start = torch.cuda.Event(enable_timing=True)
                    start.record(self.stream)
                take = min(n - pos, STAGING_BYTES - fill)
                with torch.cuda.stream(self.stream):
                    self.buffers[cur][fill:fill + take].copy_(
                        src[pos:pos + take], non_blocking=True)
                batch.append((fill, dst_off + pos, take))
                fill += take
                pos += take
                if fill == STAGING_BYTES:
                    self._submit(cur, batch, start)
                    cur, fill, batch = cur ^ 1, 0, []
        if batch:
            self._submit(cur, batch, start)
        self._drain(cur ^ 1, dst_buf)
        self._drain(cur, dst_buf)

    def _submit(self, i, batch, start):
        import torch
        end = torch.cuda.Event(enable_timing=True)
        end.record(self.stream)
        self._timing.append((start, end))
        self._done[i].record(self.stream)
        self._pending[i] = batch
        self.bytes += sum(n for _, _, n in batch)

    def _drain(self, i, dst_buf):
        batch, self._pending[i] = self._pending[i], None
        if not batch:
            return
        t0 = time.perf_counter()
        self._done[i].synchronize()
        t1 = time.perf_counter()
        staging = self.buffers[i]
        for src_off, dst_off, n in batch:
            _buffer_bytes(dst_buf, dst_off, n).copy_(
                staging[src_off:src_off + n])
        self.wait_s += t1 - t0
        self.memcpy_s += time.perf_counter() - t1

    def device_s(self) -> float:
        """The card's time in the last :meth:`copy`'s copies (the gaps
        where the stream waited for the host are not counted)."""
        return sum(s.elapsed_time(e) for s, e in self._timing) / 1e3


class SharedMemoryHandler:
    """Owns one shm segment + meta SharedDict for one local rank."""

    SHM_PREFIX = "dlrover_tpu_ckpt_shm"
    META_PREFIX = "ckpt_meta"

    def __init__(self, local_rank: int, host: bool = False,
                 job_name: str = ""):
        self._rank = local_rank
        job_name = job_name or default_job_suffix()
        suffix = f"{job_name}_{local_rank}" if job_name else str(local_rank)
        self._shm_name = f"{self.SHM_PREFIX}_{suffix}"
        self._meta = SharedDict(
            f"{self.META_PREFIX}_{suffix}", create=host
        )
        self._shm: Optional[PersistentSharedMemory] = None
        self._write_lock = threading.Lock()
        self._stagers: Dict[torch.device, _DeviceStager] = {}
        # phase timings of the last save (seconds): the engine logs
        # them and the chip smoke reports them
        self.last_save_phases: Dict[str, float] = {}

    # -- write (trainer side) ---------------------------------------------

    def _stager(self, device: torch.device) -> _DeviceStager:
        if device not in self._stagers:
            self._stagers[device] = _DeviceStager(device)
        return self._stagers[device]

    def save_state_dict(self, state_dict, config: CheckpointConfig,
                        ready: Optional[List] = None):
        """Serialize the state dict into shm and publish the meta dict.

        The layout (metas) comes from shapes and dtypes alone, before
        any copy.  Host leaves are copied straight into the segment;
        CUDA leaves go through :class:`_DeviceStager`, whose copy stream
        waits for the events in ``ready`` (the engine's snapshot) or,
        without them, for the caller's current stream.  Returns when
        every byte is in shm.  Reference hot path:
        _traverse_copy_to_shm, ckpt_saver.py:174.

        Phase timings land in ``last_save_phases``: ``fetch_s`` is the
        host waiting on device->host copies, ``d2h_device_s`` the
        card's time in them, ``memcpy_s`` the copies into shm.
        """
        entries, scalars, shard_info = _extract_entries(state_dict)
        scalar_blob = pickle.dumps(scalars)
        metas: Dict[str, TensorMeta] = {}
        offset = 0
        for key, leaf in entries:
            shape, name, nbytes = _leaf_meta(leaf)
            gshape, index = shard_info.get(key, (None, None))
            metas[key] = TensorMeta(shape=shape, dtype=name, offset=offset,
                                    nbytes=nbytes, global_shape=gshape,
                                    index=index)
            offset += nbytes
        total = offset + len(scalar_blob)

        t_fetch = t_memcpy = t_device = 0.0
        device_bytes = 0
        with self._write_lock:
            if self._shm is None or self._shm.size < total:
                if self._shm is not None:
                    self._shm.close()
                    self._shm.unlink()
                    self._shm = None
                self._shm = get_or_create_shm(self._shm_name, total)
            config.writing = True
            self._publish_meta(metas, config, offset, len(scalar_blob))
            buf = self._shm.buf
            by_device: Dict[torch.device, list] = {}
            t0 = time.perf_counter()
            for key, leaf in entries:
                off, nbytes = metas[key].offset, metas[key].nbytes
                if isinstance(leaf, np.ndarray):
                    src = leaf.reshape(-1).view(np.uint8)
                    np.frombuffer(buf, dtype=np.uint8, count=src.size,
                                  offset=off)[:] = src
                elif isinstance(leaf, SnapshotLeaf):
                    _add_piece(by_device.setdefault(leaf.flat.device, []),
                               leaf.flat, leaf.start, nbytes, off)
                elif leaf.is_cuda:
                    _add_piece(by_device.setdefault(leaf.device, []),
                               _as_bytes(leaf), 0, nbytes, off)
                else:
                    src = _as_bytes(leaf)
                    _buffer_bytes(buf, off, src.numel()).copy_(src)
            t_memcpy += time.perf_counter() - t0
            for device, pieces in by_device.items():
                stager = self._stager(device)
                stager.copy([(base[lo:lo + n], dst)
                             for base, lo, n, dst in pieces], buf,
                            ready=ready)
                t_fetch += stager.wait_s
                t_memcpy += stager.memcpy_s
                t_device += stager.device_s()
                device_bytes += stager.bytes
            entries = by_device = None
            buf[offset:offset + len(scalar_blob)] = scalar_blob
            config.writing = False
            self._publish_meta(metas, config, offset, len(scalar_blob))
        self.last_save_phases = {
            "fetch_s": round(t_fetch, 6),
            "memcpy_s": round(t_memcpy, 6),
            "d2h_device_s": round(t_device, 6),
            "d2h_bytes": device_bytes,
            "bytes": total,
        }
        # chaos hook: a corrupt_shm rule flips bytes of (or tears) the
        # snapshot that was just published, so restore/persist paths
        # must prove they reject or survive a damaged segment
        from dlrover_tpu_torch import chaos as _chaos

        _chaos.fire("ckpt.shm_save", step=config.step, handler=self)
        logger.debug(
            "rank %s wrote %.1f MB checkpoint step %s to shm "
            "(fetch %.3fs, memcpy %.3fs)",
            self._rank, total / 2**20, config.step, t_fetch, t_memcpy,
        )

    def _publish_meta(
        self, metas: Dict[str, TensorMeta], config: CheckpointConfig,
        scalar_offset: int, scalar_nbytes: int,
    ):
        self._meta.set(
            {
                "tensors": metas,
                "config": config,
                "scalar_offset": scalar_offset,
                "scalar_nbytes": scalar_nbytes,
            }
        )

    # -- read (agent side / restore) --------------------------------------

    def metadata(self) -> Dict[str, Any]:
        return self._meta.get(default_if_absent=True)

    def get_checkpoint_config(self) -> Optional[CheckpointConfig]:
        meta = self._meta.get(default_if_absent=True)
        return meta.get("config") if meta else None

    def _attach(
        self, min_size: int = 0
    ) -> Optional[PersistentSharedMemory]:
        """Attach (cached) to the segment; when the trainer grew and
        recreated it, a cached mapping points at the old unlinked
        inode — re-attach rather than silently slicing a truncated,
        stale snapshot (``min_size`` = bytes the caller needs)."""
        if self._shm is None:
            try:
                self._shm = PersistentSharedMemory(name=self._shm_name)
            except FileNotFoundError:
                return None
        if min_size and self._shm.size < min_size:
            self._shm.close()
            self._shm = None
            try:
                self._shm = PersistentSharedMemory(name=self._shm_name)
            except FileNotFoundError:
                return None
            if self._shm.size < min_size:
                logger.error(
                    "shm segment %s is %d bytes but the snapshot "
                    "metadata claims %d; refusing a truncated read",
                    self._shm_name, self._shm.size, min_size,
                )
                return None
        return self._shm

    def load_flat(
        self, stats=None, detach: bool = True,
    ) -> Tuple[Optional[CheckpointConfig], Dict[str, Any], Dict[str, Any]]:
        """Read the shm snapshot as (config, flat {key: tensor or
        scalar}, {key: TensorMeta}), ``@shardN`` keys kept.  Every leaf
        is copied out of the segment through the staged restore
        pipeline (chunked, parallel, GIL released), so the result stays
        valid when the next save overwrites the segment; with
        ``detach=False`` the tensors are views of the segment instead
        (the target-state restore copies each box out of them once).
        ``stats`` is a :class:`~.restore.RestoreStats` accumulator."""
        from dlrover_tpu_torch.checkpoint.restore import detach_flat

        t0 = time.perf_counter()
        meta = self._meta.get(default_if_absent=True)
        if not meta:
            return None, {}, {}
        config: CheckpointConfig = meta["config"]
        if config.writing:
            logger.warning("shm snapshot is mid-write; refusing to load")
            return None, {}, {}
        shm = self._attach(
            min_size=meta["scalar_offset"] + meta["scalar_nbytes"]
        )
        if shm is None:
            return None, {}, {}
        blob = bytes(
            shm.buf[
                meta["scalar_offset"]:
                meta["scalar_offset"] + meta["scalar_nbytes"]
            ]
        )
        if stats is not None:
            stats.read_s += time.perf_counter() - t0
        if detach:
            flat = detach_flat(meta["tensors"], shm.buf, stats=stats)
        else:
            flat = tensor_views(meta["tensors"], shm.buf, stats=stats)
        flat.update(pickle.loads(blob))
        return config, flat, meta["tensors"]

    def load_state_dict(
        self, stats=None,
    ) -> Tuple[Optional[CheckpointConfig], Any]:
        """Read the shm snapshot back into a nested dict of private CPU
        tensors and scalars (the caller copies them to its devices);
        shard entries are assembled into full tensors."""
        config, flat, metas = self.load_flat(stats=stats)
        if config is None:
            return None, {}
        return config, _unflatten_to_nested(_assemble(flat, metas, stats))

    def read_raw(self) -> Tuple[Optional[CheckpointConfig], Any, Dict]:
        """Raw snapshot + meta for the agent's persist path (no pytree
        reconstruction).  Returns a PRIVATE ``bytes`` copy: the agent
        takes it under the shard lock (one memcpy) and releases the
        lock before any storage IO, so the trainer's next snapshot is
        never blocked behind a disk write (see saver._save_shard)."""
        meta = self._meta.get(default_if_absent=True)
        if not meta:
            return None, b"", {}
        config: CheckpointConfig = meta["config"]
        total = meta["scalar_offset"] + meta["scalar_nbytes"]
        shm = self._attach(min_size=total)
        if shm is None or config.writing:
            return None, b"", {}
        return config, bytes(shm.buf[:total]), meta

    def prefault(
        self, workers: Optional[int] = None,
        chunk_bytes: int = 64 * 2**20,
    ) -> int:
        """Touch every page of the snapshot so a later read runs warm.

        Page-table population is PER PROCESS: the agent's prefetch
        warms the agent, not the trainer — so the respawned trainer
        runs this itself (engine construction kicks it on a daemon
        thread) while its model build proceeds.  Strided read-only
        touches in parallel ~chunk_bytes pieces: numpy releases the GIL
        for the reductions, so the faults overlap across the (bounded)
        pool.  Returns bytes touched (0 when no snapshot exists)."""
        meta = self._meta.get(default_if_absent=True)
        if not meta:
            return 0
        total = meta["scalar_offset"] + meta["scalar_nbytes"]
        shm = self._attach(min_size=total)
        if shm is None or total <= 0:
            return 0
        workers = workers if workers is not None else prefault_workers()
        flat = np.frombuffer(shm.buf, dtype=np.uint8, count=total)

        def touch(lo: int, hi: int):
            flat[lo:hi:4096].sum()

        spans = [
            (lo, min(lo + chunk_bytes, total))
            for lo in range(0, total, max(1, chunk_bytes))
        ]
        if workers <= 1 or len(spans) <= 1:
            for lo, hi in spans:
                touch(lo, hi)
        else:
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(
                max_workers=workers, thread_name_prefix="shm-prefault"
            ) as pool:
                list(pool.map(lambda s: touch(*s), spans))
        return total

    def close(self):
        if self._shm is not None:
            self._shm.close()
            self._shm = None
        self._meta.close()

    def unlink(self):
        if self._attach() is not None:
            self._shm.unlink()
            self._shm = None


def prefault_workers() -> int:
    """Thread budget for page-in prefetch/prefault work.  PINNED low
    by default: the touches deliberately overlap the trainer's imports
    and model build, and an unbounded pool would starve exactly the
    work it is hiding latency from.  ``DLROVER_PREFETCH_WORKERS``
    overrides."""
    val = os.getenv("DLROVER_PREFETCH_WORKERS", "").strip()
    if val:
        try:
            return max(1, int(val))
        except ValueError:
            pass
    return min(4, max(1, (os.cpu_count() or 2) // 2))


def tensor_views(metas: Dict[str, TensorMeta], buf,
                 stats=None) -> Dict[str, torch.Tensor]:
    """{key: tensor} viewing ``buf`` (a shm segment, raw bytes or an
    mmap) without a copy: free to build, the page-in and copy cost is
    paid by whichever stage reads the view.  The caller keeps ``buf``
    alive while the views are in use."""
    views = {}
    for key, m in metas.items():
        dtype = torch_dtype(m.dtype)
        views[key] = _buffer_bytes(buf, m.offset, m.nbytes).view(
            dtype).reshape(tuple(m.shape))
        if stats is not None:
            stats.bytes += m.nbytes
    return views


def flat_from_raw(meta: Dict, raw, stats=None,
                  detach: bool = True) -> Tuple[Dict, Dict]:
    """(flat {key: tensor/scalar}, {key: TensorMeta}) from raw shm
    bytes — or an mmap view from ``storage.read_view`` — shard keys
    kept, every tensor a private copy (views of ``raw`` with
    ``detach=False``)."""
    from dlrover_tpu_torch.checkpoint.restore import detach_flat

    if detach:
        flat = detach_flat(meta["tensors"], raw, stats=stats)
    else:
        flat = tensor_views(meta["tensors"], raw, stats=stats)
    blob = raw[
        meta["scalar_offset"]:meta["scalar_offset"] + meta["scalar_nbytes"]
    ]
    flat.update(pickle.loads(blob))
    return flat, meta["tensors"]


def state_dict_from_raw(meta: Dict, raw, stats=None):
    """Rebuild the nested dict from raw shm bytes (storage load path);
    the copies run through the staged restore pipeline."""
    flat, metas = flat_from_raw(meta, raw, stats=stats)
    return _unflatten_to_nested(_assemble(flat, metas, stats))


def _assemble(flat, metas, stats):
    t0 = time.perf_counter()
    flat = _assemble_flat(flat, metas)
    if stats is not None:
        stats.assemble_s += time.perf_counter() - t0
    return flat
