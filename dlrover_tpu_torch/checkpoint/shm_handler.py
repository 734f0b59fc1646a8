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
straight out of them.  A save fires the reference's ``ckpt.shm_save``
chaos hook once its snapshot is published.

The paged base+delta tier (``DLROVER_SHM_PAGED``, reference
``:159-1058``, :meth:`SharedMemoryHandler.save_state_dict_paged`) keeps
the JAX package's segment layout byte for byte: a memory save copies
only the dense leaves whose bytes changed and appends the sparse
adapter's delta as a kv page, then flips one byte to publish; a reader
(or the agent's persist, which gets the flat layout back) replays the
page chain.

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
        "uint16": torch.uint16,
        "uint32": torch.uint32,
        "uint64": torch.uint64,
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


# -- paged base+delta shm layout (hot-save tier) ------------------------
#
# Segment anatomy (DLROVER_SHM_PAGED), byte for byte the JAX package's
# (reference ``shm_handler.py:159-183``):
#
#   [ 0: 8]  magic  b"DLRVPG01"
#   [ 8: 9]  active directory slot (0/1) — the ATOMIC publish: a
#            single byte flips after everything the new generation
#            references is in place, so a reader or a SIGKILL
#            mid-write always lands on the previous consistent
#            snapshot
#   [12:16]  dir_cap (u32) — capacity of each directory slot
#   [16            : 16+dir_cap  ]  directory slot 0
#   [16+dir_cap    : 16+2*dir_cap]  directory slot 1
#   [data_off ...]  per-leaf ping-pong extents (A/B copy-on-write: a
#            delta save writes changed leaves to the INACTIVE side
#            and flips per-leaf `active` in the new directory), then
#            two kv arenas (base + delta blob pages bump-allocated;
#            a re-base targets the arena the live directory does NOT
#            reference)
#
# Each directory slot is [len u32 | crc32 u32 | pickled directory];
# the directory carries generation, config, per-leaf {offset, len,
# crc, gen} placement, the pickled scalar blob, and the kv page
# chain — so the segment stands alone even if the meta SharedDict
# host died with the trainer.  The port reads a directory through the
# meta allowlist (:func:`load_meta`), so a JAX-written segment's
# ``CheckpointConfig`` comes back as the port's class.

PAGED_MAGIC = b"DLRVPG01"
_PAGED_HDR = 16
_PAGED_ALIGN = 64


class PagedNeedBase(Exception):
    """The paged segment cannot accept a delta save (no valid epoch,
    leaf layout changed, kv arena or directory slot overflow) — the
    caller must re-export a full kv base and retry."""


def paged_enabled() -> bool:
    """``DLROVER_SHM_PAGED`` opt-in for the paged hot-save tier
    (default off: memory saves write the flat full segment)."""
    return os.environ.get(
        "DLROVER_SHM_PAGED", ""
    ).strip().lower() in ("1", "true", "yes", "on")


def shm_full_every() -> int:
    """Full-base cadence of the paged kv chain: every Nth paged save
    re-bases even without a poison, bounding both the delta replay a
    restore pays and the page directory's growth.  0 = no cadence
    (re-base only on poison/overflow).  ``DLROVER_SHM_FULL_EVERY``."""
    try:
        return max(
            0, int(os.environ.get("DLROVER_SHM_FULL_EVERY", "32"))
        )
    except ValueError:
        return 32


def save_chunk_bytes() -> int:
    """Chunk size of the paged save's parallel memcpy
    (``DLROVER_SAVE_CHUNK_BYTES``; default 64 MB, the restore
    pipeline's)."""
    env = os.environ.get("DLROVER_SAVE_CHUNK_BYTES", "").strip()
    if env:
        try:
            return max(1, int(env))
        except ValueError:
            pass
    return 64 * 2**20


def save_workers() -> int:
    """Threads of the paged save's memcpy (``DLROVER_SAVE_WORKERS``;
    default half the cores, 2 to 8)."""
    env = os.environ.get("DLROVER_SAVE_WORKERS", "").strip()
    if env:
        try:
            return max(1, int(env))
        except ValueError:
            pass
    return min(8, max(2, (os.cpu_count() or 2) // 2))


def _align_up(n: int, a: int = _PAGED_ALIGN) -> int:
    return (n + a - 1) // a * a


def _crc(buf) -> int:
    import zlib

    return zlib.crc32(buf) & 0xFFFFFFFF


def _host_bytes(leaf, nbytes: int) -> np.ndarray:
    """A layout entry's bytes on the host as a flat uint8 array (a view
    for host leaves, a copy for CUDA ones; the caller has ordered the
    copy after the work that wrote the leaf)."""
    if isinstance(leaf, np.ndarray):
        return np.ascontiguousarray(leaf).reshape(-1).view(np.uint8)
    if isinstance(leaf, SnapshotLeaf):
        src = leaf.flat[leaf.start:leaf.start + nbytes]
    else:
        src = _as_bytes(leaf)
    if src.is_cuda:
        src = src.cpu()
    return src.numpy()


def _copy_chunked(dst: np.ndarray, src: np.ndarray, submit,
                  chunk_bytes: int) -> list:
    """``dst[:] = src`` (flat uint8) in ``chunk_bytes`` pieces, each a
    CPU tensor ``copy_`` (the GIL is released for the copy) submitted
    through ``submit`` (inline when None); returns the futures."""
    import torch

    if not src.size:
        return []
    d, s = torch.from_numpy(dst), torch.from_numpy(src)
    if submit is None:
        d.copy_(s)
        return []
    return [submit(d[lo:lo + chunk_bytes].copy_, s[lo:lo + chunk_bytes])
            for lo in range(0, src.size, chunk_bytes)]


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
        self._attach_lock = threading.Lock()
        self._stagers: Dict[torch.device, _DeviceStager] = {}
        # writer-side copy of the last published page directory (paged
        # mode); None = unknown — the next paged save tries to adopt
        # the in-segment directory before starting a fresh epoch
        self._paged_dir: Optional[Dict[str, Any]] = None
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
        # a flat write clobbers any paged epoch in this segment; the
        # next paged save must start a fresh one
        self._paged_dir = None
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

    # -- paged write (trainer side) ----------------------------------------

    def save_state_dict_paged(
        self, state_dict, config: CheckpointConfig,
        kv_payload: Optional[Tuple[str, Dict[str, Any]]] = None,
        workers: Optional[int] = None,
        chunk_bytes: Optional[int] = None,
        ready: Optional[List] = None,
    ) -> Dict[str, Any]:
        """Paged hot save (reference ``shm_handler.py:425``): write only
        what changed, publish with an atomic directory swap.

        Dense leaves are compared bit for bit against their active
        extent and copy-skipped when unchanged; changed leaves go to
        the leaf's INACTIVE extent (per-leaf ping-pong copy-on-write)
        through a chunked parallel copy (``DLROVER_SAVE_WORKERS``).
        CUDA leaves are fetched to the host first, after the events in
        ``ready`` (or the current stream) complete.  ``kv_payload`` is
        the sparse adapter's ``("base"|"delta", state)`` — the blob
        lands in a bump-allocated kv page (a base targets the arena the
        live directory does NOT reference).  Raises
        :class:`PagedNeedBase` when a delta cannot land (no valid epoch,
        layout changed, arena/directory overflow): the caller re-exports
        a full base and retries.  Returns the phase/byte accounting dict
        (also stored in ``last_save_phases``)."""
        import struct

        entries, scalars, shard_info = _extract_entries(state_dict)
        scalars_blob = pickle.dumps(scalars)
        kv_kind = kv_payload[0] if kv_payload else None
        kv_blob = (
            pickle.dumps(kv_payload[1]) if kv_payload else b""
        )
        config.writing = False  # paged publishes are atomic, never torn

        metas: Dict[str, Dict[str, Any]] = {}
        order = []
        for key, leaf in entries:
            gshape, ranges = shard_info.get(key, (None, None))
            shape, name, nbytes = _leaf_meta(leaf)
            metas[key] = {
                "shape": shape, "dtype": name, "nbytes": nbytes,
                "global_shape": gshape, "index": ranges,
            }
            order.append(key)

        if workers is None:
            workers = save_workers()
        if chunk_bytes is None:
            chunk_bytes = save_chunk_bytes()

        with self._write_lock:
            d = self._paged_dir
            if d is None:
                # a respawned writer adopts the in-segment epoch so
                # its first save stays O(touched) and never clobbers
                # the snapshot a concurrent restore may still need
                d = self._read_paged_directory(verify_pages=False)
            epoch_ok = self._paged_epoch_matches(d, order, metas)
            if epoch_ok and kv_kind == "base":
                other = 1 - int(d["kv_active"])
                cap = int(d["kv_arena"][other][1])
                epoch_ok = _align_up(len(kv_blob)) <= cap
            if epoch_ok and kv_kind is None and d.get("kv_pages"):
                # the sparse plane disappeared — pages would go stale
                epoch_ok = False
            if not epoch_ok:
                if kv_kind == "delta":
                    raise PagedNeedBase(
                        "no valid paged epoch for a delta save"
                    )
                prev_gen = int(d.get("generation", 0)) if (
                    isinstance(d, dict)
                ) else 0
                d = self._paged_new_epoch(
                    order, metas, len(kv_blob), len(scalars_blob),
                    prev_gen=prev_gen,
                )
                fresh = True
            else:
                fresh = False
            buf = self._shm.buf
            gen = int(d["generation"]) + (0 if fresh else 1)
            new_leaves = {k: dict(v) for k, v in d["leaves"].items()}

            t_fetch = t_compare = t_memcpy = t_kv = 0.0
            copied = skipped = pages = 0
            futures: list = []
            pool = None
            if workers > 1:
                from concurrent.futures import ThreadPoolExecutor

                pool = ThreadPoolExecutor(
                    max_workers=workers,
                    thread_name_prefix="shm-save",
                )
            submit = pool.submit if pool is not None else None
            if ready:
                t0 = time.perf_counter()
                for ev in ready:
                    ev.synchronize()
                t_fetch += time.perf_counter() - t0

            try:
                for i, (key, leaf) in enumerate(entries):
                    slot = new_leaves[key]
                    nbytes = int(slot["nbytes"])
                    t0 = time.perf_counter()
                    host_b = _host_bytes(leaf, nbytes)
                    t_fetch += time.perf_counter() - t0
                    entries[i] = (key, None)  # free eagerly
                    if not fresh and nbytes:
                        cur_off = (
                            slot["off_a"] if slot["active"] == 0
                            else slot["off_b"]
                        )
                        t0 = time.perf_counter()
                        cur = np.frombuffer(
                            buf, dtype=np.uint8, count=nbytes,
                            offset=cur_off,
                        )
                        same = np.array_equal(cur, host_b)
                        t_compare += time.perf_counter() - t0
                        if same:
                            skipped += nbytes
                            continue
                        side = 1 - int(slot["active"])
                    else:
                        side = 0
                    dst_off = slot["off_a"] if side == 0 else slot["off_b"]
                    dst = np.frombuffer(
                        buf, dtype=np.uint8,
                        count=max(1, nbytes), offset=dst_off,
                    )[:nbytes]
                    t0 = time.perf_counter()
                    futures.extend(_copy_chunked(
                        dst, host_b, submit, chunk_bytes))
                    t_memcpy += time.perf_counter() - t0
                    slot["active"] = side
                    slot["gen"] = gen
                    slot["crc"] = _crc(host_b)
                    copied += nbytes
                    pages += 1
                t0 = time.perf_counter()
                for f in futures:
                    f.result()
                t_memcpy += time.perf_counter() - t0
            finally:
                if pool is not None:
                    pool.shutdown(wait=True)

            # kv blob page (base -> the other arena; delta -> bump)
            kv_pages = list(d.get("kv_pages") or ())
            kv_active = int(d.get("kv_active", 0))
            kv_tail = int(d.get("kv_tail", 0))
            if kv_kind is not None:
                t0 = time.perf_counter()
                if kv_kind == "base":
                    kv_active = 0 if fresh else 1 - kv_active
                    arena_off, arena_cap = d["kv_arena"][kv_active]
                    page_off = int(arena_off)
                    kv_pages = []
                else:
                    arena_off, arena_cap = d["kv_arena"][kv_active]
                    page_off = kv_tail
                    if (
                        page_off + len(kv_blob)
                        > int(arena_off) + int(arena_cap)
                    ):
                        raise PagedNeedBase(
                            "kv delta arena overflow "
                            f"({page_off - int(arena_off)}"
                            f"+{len(kv_blob)} > {arena_cap})"
                        )
                buf[page_off:page_off + len(kv_blob)] = kv_blob
                kv_pages.append({
                    "kind": kv_kind, "step": int(config.step),
                    "off": page_off, "len": len(kv_blob),
                    "crc": _crc(kv_blob), "gen": gen,
                })
                kv_tail = _align_up(page_off + len(kv_blob))
                copied += len(kv_blob)
                pages += 1
                t_kv = time.perf_counter() - t0

            new_dir = {
                "generation": gen,
                "config": config,
                "order": order,
                "leaves": new_leaves,
                "scalars_blob": scalars_blob,
                "kv_pages": kv_pages,
                "kv_arena": d["kv_arena"],
                "kv_active": kv_active,
                "kv_tail": kv_tail,
                "data_end": d["data_end"],
                "dir_cap": d["dir_cap"],
            }
            payload = pickle.dumps(new_dir)
            if len(payload) + 8 > int(d["dir_cap"]):
                if kv_kind == "delta":
                    raise PagedNeedBase("page directory slot overflow")
                raise RuntimeError(
                    "paged directory exceeds its slot even on a "
                    f"fresh epoch ({len(payload)} > {d['dir_cap']})"
                )
            # chaos hook: a kill here lands BETWEEN the data/page
            # writes and the directory publish — the crash-consistency
            # tests prove readers still see the previous generation
            from dlrover_tpu_torch import chaos as _chaos

            _chaos.fire(
                "ckpt.paged_write", step=config.step, handler=self,
                generation=gen, kind="base" if fresh else "delta",
            )
            t0 = time.perf_counter()
            dir_cap = int(d["dir_cap"])
            prev_slot = None if fresh else self._paged_active_slot()
            new_header = fresh or prev_slot is None
            slot_idx = 0 if new_header else 1 - prev_slot
            slot_off = _PAGED_HDR + slot_idx * dir_cap
            buf[slot_off + 8:slot_off + 8 + len(payload)] = payload
            struct.pack_into(
                "<II", buf, slot_off, len(payload), _crc(payload)
            )
            if new_header:
                # invalidate the other slot BEFORE the magic goes in:
                # a reader must never parse pre-epoch garbage
                other_off = _PAGED_HDR + (1 - slot_idx) * dir_cap
                struct.pack_into("<II", buf, other_off, 0, 0)
                struct.pack_into("<I", buf, 12, dir_cap)
                buf[0:8] = PAGED_MAGIC
            buf[8] = slot_idx  # THE atomic publish
            self._paged_dir = new_dir
            self._meta.set({
                "paged": True,
                "tensors": {},
                "config": config,
                "generation": gen,
                "scalar_offset": int(d["data_end"]),
                "scalar_nbytes": 0,
            })
            t_publish = time.perf_counter() - t0

        total = sum(m["nbytes"] for m in metas.values()) + len(kv_blob)
        self.last_save_phases = {
            "fetch_s": round(t_fetch, 6),
            "compare_s": round(t_compare, 6),
            "memcpy_s": round(t_memcpy, 6),
            "kv_s": round(t_kv, 6),
            "publish_s": round(t_publish, 6),
            "paged": True,
            "kind": "base" if fresh else "delta",
            "generation": gen,
            "pages_written": pages,
            "bytes": int(copied),
            "bytes_skipped": int(skipped),
            "bytes_total": int(total),
            "kv_bytes": len(kv_blob),
        }
        _chaos.fire("ckpt.shm_save", step=config.step, handler=self)
        logger.debug(
            "rank %s paged save step %s gen %s: %s, wrote %d pages "
            "%.1f MB (skipped %.1f MB of %.1f MB)",
            self._rank, config.step, gen,
            "base" if fresh else "delta", pages, copied / 2**20,
            skipped / 2**20, total / 2**20,
        )
        return dict(self.last_save_phases)

    def _paged_epoch_matches(
        self, d: Optional[Dict[str, Any]], order, metas,
    ) -> bool:
        """A directory can absorb a delta save only if the dense leaf
        layout is unchanged — same keys in the same order with the
        same shapes/dtypes (their extents are preallocated)."""
        if not isinstance(d, dict) or d.get("order") != order:
            return False
        leaves = d.get("leaves") or {}
        for key in order:
            e = leaves.get(key)
            m = metas[key]
            if (
                e is None
                or tuple(e["shape"]) != tuple(m["shape"])
                or e["dtype"] != m["dtype"]
                or int(e["nbytes"]) != int(m["nbytes"])
            ):
                return False
        return self._attach(min_size=int(d.get("data_end", 0))) is not None

    def _paged_new_epoch(
        self, order, metas, kv_len: int, scalars_len: int,
        prev_gen: int = 0,
    ) -> Dict[str, Any]:
        """Lay out a fresh epoch: directory slots, per-leaf ping-pong
        extents, two kv arenas — and size/(re)create the segment.
        Returns the epoch skeleton (generation = next to publish)."""
        leaves: Dict[str, Dict[str, Any]] = {}
        # directory capacity: a prototype pickle of the fully
        # populated directory, doubled, plus headroom for the kv page
        # chain the epoch will accumulate
        proto = {
            k: {**m, "off_a": 0, "off_b": 0, "active": 0,
                "gen": 0, "crc": 0}
            for k, m in metas.items()
        }
        proto_len = len(pickle.dumps({
            "generation": 0, "config": CheckpointConfig(),
            "order": order, "leaves": proto,
            "scalars_blob": b"\0" * scalars_len,
            "kv_pages": [], "kv_arena": ((0, 0), (0, 0)),
            "kv_active": 0, "kv_tail": 0, "data_end": 0,
            "dir_cap": 0,
        }))
        dir_cap = _align_up(2 * proto_len + 65536)
        off = _align_up(_PAGED_HDR + 2 * dir_cap)
        for key in order:
            m = metas[key]
            ext = _align_up(int(m["nbytes"]))
            leaves[key] = {
                **m, "off_a": off, "off_b": off + ext,
                "active": 0, "gen": 0, "crc": 0,
            }
            off += 2 * ext
        arenas = ((0, 0), (0, 0))
        if kv_len:
            kv_cap = _align_up(kv_len + max(kv_len // 2, 1 << 20))
            arenas = ((off, kv_cap), (off + kv_cap, kv_cap))
            off += 2 * kv_cap
        total = off
        if self._shm is None or self._shm.size < total:
            if self._shm is not None:
                logger.warning(
                    "paged epoch needs %d bytes > segment %d: "
                    "recreating (previous snapshot discarded)",
                    total, self._shm.size,
                )
                self._shm.close()
                self._shm.unlink()
                self._shm = None
            self._shm = get_or_create_shm(self._shm_name, total)
        return {
            "generation": prev_gen + 1,
            "config": None,
            "order": order,
            "leaves": leaves,
            "scalars_blob": b"",
            "kv_pages": [],
            "kv_arena": arenas,
            "kv_active": 0,
            "kv_tail": int(arenas[0][0]),
            "data_end": total,
            "dir_cap": dir_cap,
        }

    def _paged_active_slot(self) -> Optional[int]:
        shm = self._attach(min_size=_PAGED_HDR)
        if shm is None or bytes(shm.buf[0:8]) != PAGED_MAGIC:
            return None
        slot = shm.buf[8]
        return int(slot) if slot in (0, 1) else None

    # -- paged read --------------------------------------------------------

    def _read_paged_directory(
        self, verify_pages: bool = True,
    ) -> Optional[Dict[str, Any]]:
        """Parse the in-segment page directory.  Tries the active
        slot first; a torn slot (bad length/CRC/pickle, or pages that
        fail their CRC) falls back to the other slot — the previous
        generation.  Returns None when neither slot verifies."""
        import struct

        shm = self._attach(min_size=_PAGED_HDR)
        if shm is None or shm.size < _PAGED_HDR:
            return None
        if bytes(shm.buf[0:8]) != PAGED_MAGIC:
            return None
        active = int(shm.buf[8])
        (dir_cap,) = struct.unpack_from("<I", shm.buf, 12)
        if active not in (0, 1) or dir_cap <= 8:
            return None
        if shm.size < _PAGED_HDR + 2 * dir_cap:
            shm = self._attach(min_size=_PAGED_HDR + 2 * dir_cap)
            if shm is None or bytes(shm.buf[0:8]) != PAGED_MAGIC:
                return None
        for slot in (active, 1 - active):
            off = _PAGED_HDR + slot * dir_cap
            ln, crc = struct.unpack_from("<II", shm.buf, off)
            if not 0 < ln <= dir_cap - 8:
                continue
            payload = bytes(shm.buf[off + 8:off + 8 + ln])
            if _crc(payload) != crc:
                logger.warning(
                    "paged directory slot %d torn (crc mismatch)%s",
                    slot,
                    "; falling back to the previous generation"
                    if slot == active else "",
                )
                continue
            try:
                d = load_meta(payload)
            except Exception:  # noqa: BLE001 - a torn slot falls back
                continue
            if not isinstance(d, dict) or "generation" not in d:
                continue
            data_end = int(d.get("data_end", 0))
            if data_end > shm.size:
                shm = self._attach(min_size=data_end)
                if shm is None:
                    continue
            if verify_pages and not self._paged_verify(d, shm.buf):
                logger.warning(
                    "paged generation %s fails page CRC; %s",
                    d.get("generation"),
                    "falling back to the previous generation"
                    if slot == active else "refusing the snapshot",
                )
                continue
            if slot != active:
                logger.warning(
                    "paged restore fell back to previous generation "
                    "%s", d.get("generation"),
                )
            return d
        return None

    def _paged_verify(self, d: Dict[str, Any], buf) -> bool:
        """Every extent/page the directory references must match its
        recorded CRC — a half-written or clobbered generation (e.g. a
        re-epoch that overwrote pages before dying) must not restore."""
        try:
            for key in d["order"]:
                e = d["leaves"][key]
                nbytes = int(e["nbytes"])
                if not nbytes:
                    continue
                off = e["off_a"] if int(e["active"]) == 0 else e["off_b"]
                got = _crc(np.frombuffer(
                    buf, dtype=np.uint8, count=nbytes, offset=int(off)
                ))
                if got != int(e["crc"]):
                    return False
            for p in d.get("kv_pages") or ():
                blob = np.frombuffer(
                    buf, dtype=np.uint8, count=int(p["len"]),
                    offset=int(p["off"]),
                )
                if _crc(blob) != int(p["crc"]):
                    return False
        except (KeyError, TypeError, ValueError, IndexError):
            return False
        return True

    @staticmethod
    def _paged_metas(d: Dict[str, Any]) -> Dict[str, TensorMeta]:
        """Flat-compatible TensorMetas over each leaf's ACTIVE extent
        (offset = extent offset), so every consumer of (views, metas)
        works unchanged."""
        metas: Dict[str, TensorMeta] = {}
        for key in d["order"]:
            e = d["leaves"][key]
            off = int(
                e["off_a"] if int(e["active"]) == 0 else e["off_b"]
            )
            gshape, index = e.get("global_shape"), e.get("index")
            metas[key] = TensorMeta(
                shape=tuple(e["shape"]), dtype=e["dtype"],
                offset=off, nbytes=int(e["nbytes"]),
                global_shape=tuple(gshape) if gshape else None,
                index=tuple(tuple(r) for r in index) if index else None,
            )
        return metas

    def _paged_kv_state(
        self, d: Dict[str, Any], buf,
    ) -> Optional[Dict[str, Any]]:
        """Replay the kv page chain (base + deltas) back to one full
        kv export — bit-identical to what a flat full save would have
        carried."""
        pages = d.get("kv_pages") or []
        if not pages:
            return None
        from dlrover_tpu_torch.checkpoint.sparse import merge_kv_states

        blobs = [
            pickle.loads(bytes(
                buf[int(p["off"]):int(p["off"]) + int(p["len"])]
            ))
            for p in pages
        ]
        return merge_kv_states(blobs[0], blobs[1:])

    def _load_flat_paged(
        self, stats=None, detach: bool = True,
    ) -> Tuple[
        Optional[CheckpointConfig], Dict[str, Any], Dict[str, Any]
    ]:
        from dlrover_tpu_torch.checkpoint.restore import detach_flat
        from dlrover_tpu_torch.checkpoint.sparse import KV_STATE_KEY

        t0 = time.perf_counter()
        d = self._read_paged_directory(verify_pages=True)
        if d is None:
            logger.warning(
                "paged shm snapshot unreadable (torn or absent); "
                "refusing to load"
            )
            return None, {}, {}
        buf = self._shm.buf
        metas = self._paged_metas(d)
        kv = self._paged_kv_state(d, buf)
        if stats is not None:
            stats.read_s += time.perf_counter() - t0
        if detach:
            flat = detach_flat(metas, buf, stats=stats)
        else:
            flat = tensor_views(metas, buf, stats=stats)
        flat.update(pickle.loads(d["scalars_blob"]))
        if kv is not None:
            flat.update(_flatten_state_dict({KV_STATE_KEY: kv}))
        return d["config"], flat, metas

    def _read_raw_paged(
        self,
    ) -> Tuple[Optional[CheckpointConfig], Any, Dict]:
        """Materialize the paged snapshot as FLAT raw bytes + flat
        meta — the agent's persist path (and the breakpoint save)
        consume the exact format a flat save would have produced, so
        the storage tier never learns about pages."""
        from dlrover_tpu_torch.checkpoint.sparse import KV_STATE_KEY

        d = self._read_paged_directory(verify_pages=True)
        if d is None:
            return None, b"", {}
        buf = self._shm.buf
        page_metas = self._paged_metas(d)
        arrays: Dict[str, Any] = {
            key: (m.offset, m.nbytes) for key, m in page_metas.items()
        }
        scalars = dict(pickle.loads(d["scalars_blob"]))
        kv = self._paged_kv_state(d, buf)
        kv_arrays: Dict[str, np.ndarray] = {}
        if kv is not None:
            for k, v in _flatten_state_dict({KV_STATE_KEY: kv}).items():
                if isinstance(v, (np.ndarray, np.generic)):
                    kv_arrays[k] = np.ascontiguousarray(v)
                    arrays[k] = kv_arrays[k]
                else:
                    scalars[k] = v
        metas: Dict[str, TensorMeta] = {}
        offset = 0
        for key in arrays:
            src = page_metas.get(key)
            if src is not None:
                shape, dtype, nbytes = src.shape, src.dtype, src.nbytes
            else:
                arr = kv_arrays[key]
                shape, dtype, nbytes = (tuple(arr.shape), str(arr.dtype),
                                        int(arr.nbytes))
            metas[key] = TensorMeta(
                shape=tuple(shape), dtype=dtype, offset=offset,
                nbytes=nbytes,
                global_shape=src.global_shape if src else None,
                index=src.index if src else None,
            )
            offset += nbytes
        blob = pickle.dumps(scalars)
        raw = bytearray(offset + len(blob))
        for key, val in arrays.items():
            m = metas[key]
            if not m.nbytes:
                continue
            if key in kv_arrays:
                src_b = val.reshape(-1).view(np.uint8)
            else:
                src_b = np.frombuffer(buf, dtype=np.uint8, count=val[1],
                                      offset=val[0])
            np.frombuffer(raw, dtype=np.uint8, count=m.nbytes,
                          offset=m.offset)[:] = src_b
        raw[offset:offset + len(blob)] = blob
        config: CheckpointConfig = d["config"]
        meta = {
            "tensors": metas,
            "config": config,
            "scalar_offset": offset,
            "scalar_nbytes": len(blob),
            "paged_generation": int(d["generation"]),
        }
        return config, bytes(raw), meta

    def paged_generation(self) -> int:
        """Generation of the currently readable paged snapshot (0 if
        none) — test/diagnostic surface."""
        d = self._read_paged_directory(verify_pages=False)
        return int(d["generation"]) if d else 0

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
        stale snapshot (``min_size`` = bytes the caller needs).

        Under a lock: the restore's pre-fault thread and the restore
        attach at once, and a second mapping, dropped by the thread
        whose assignment lost, would unmap under the other's
        ``torch.frombuffer`` views (they hold no buffer export)."""
        with self._attach_lock:
            if self._shm is None:
                try:
                    self._shm = PersistentSharedMemory(name=self._shm_name)
                except FileNotFoundError:
                    return None
            if min_size and self._shm.size < min_size:
                try:
                    self._shm.close()
                except BufferError:  # a reader still holds a view
                    pass
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
            # the meta host may have died with the trainer; a paged
            # segment stands alone (the directory IS the metadata)
            if self._paged_active_slot() is not None:
                return self._load_flat_paged(stats=stats, detach=detach)
            return None, {}, {}
        if meta.get("paged"):
            return self._load_flat_paged(stats=stats, detach=detach)
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
            if self._paged_active_slot() is not None:
                return self._read_raw_paged()
            return None, b"", {}
        if meta.get("paged"):
            return self._read_raw_paged()
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
