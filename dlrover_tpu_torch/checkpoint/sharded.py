"""Shard extraction and assembly for sharded flash checkpoints.

Copy of ``dlrover_tpu/checkpoint/sharded.py`` (reference capability:
``fsdp_engine.py:568``, ``SharedMemoryWriter`` / ``SharedMemoryReader``,
torch-DCP storage over shm with reshard on load), over DTensors where
the reference works on global ``jax.Array``s:

- **save**: each rank takes only its local tensor of a DTensor
  (``to_local()``) with the global index ranges it covers; a sharded
  tensor is never gathered whole (``full_tensor()`` is not called).
- **restore, same or different world**: every target box (this rank's
  local tensor of the target DTensor) is assembled by copying the
  overlapping regions of whatever saved boxes are visible, so a
  checkpoint written under FSDP2 on 4 ranks restores onto 2, or onto a
  plain tensor, as long as the shard files cover the tensors (always
  true on one host or a shared filesystem).  When they do not (per-host
  disks after a topology change), the caller falls back to the orbax
  tier (:mod:`dlrover_tpu_torch.checkpoint.orbax_compat`).

A rank holds one local tensor of a DTensor, so its own entry is one box
and there is nothing to dedupe within a rank.  The copies other ranks
hold along replicated mesh dims (HSDP's ``data`` axis) are saved by
those ranks too: each rank's shm snapshot must cover its own restore,
as each of the reference's processes keeps its lowest replica.  Readers
that see every rank's file (the storage tier) keep the lowest rank's
copy of a box (:func:`dedupe_boxes`), the reference's lowest replica id.

torch is imported where a tensor is made or read, not with the module:
the agent's process, which loads no torch, imports the shm layout that
names :data:`SHARD_SEP`.
"""

from typing import Any, Dict, List, Optional, Tuple

IndexRanges = Tuple[Tuple[int, int], ...]  # ((start, stop) per dim)

SHARD_SEP = "@shard"


def is_dtensor(leaf) -> bool:
    try:
        from torch.distributed.tensor import DTensor
    except ImportError:  # a torch built without distributed
        return False
    return isinstance(leaf, DTensor)


def is_sharded_leaf(leaf) -> bool:
    """A DTensor whose placements are not all ``Replicate``."""
    if not is_dtensor(leaf):
        return False
    from torch.distributed.tensor import Replicate

    return not all(isinstance(p, Replicate) for p in leaf.placements)


def local_box(leaf) -> IndexRanges:
    """The global index ranges of this rank's local tensor of a DTensor
    (FSDP2's uneven dim-0 split included: a short or empty last shard
    gets its true box)."""
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset,
    )

    shape, offset = compute_local_shape_and_global_offset(
        leaf.shape, leaf.device_mesh, leaf.placements)
    return tuple((int(o), int(o) + int(s)) for o, s in zip(offset, shape))


def local_shards(leaf) -> List[Tuple[IndexRanges, Any]]:
    """This rank's distinct shards of a DTensor as (global index ranges,
    local tensor): one entry, the rank's own box."""
    return [(local_box(leaf), leaf.to_local())]


def _overlap(
    a: IndexRanges, b: IndexRanges
) -> Optional[Tuple[IndexRanges, Tuple[slice, ...], Tuple[slice, ...]]]:
    """Intersection of two range boxes; returns (global ranges,
    slices into a-local coords, slices into b-local coords)."""
    inter, a_sl, b_sl = [], [], []
    for (a0, a1), (b0, b1) in zip(a, b):
        lo, hi = max(a0, b0), min(a1, b1)
        if lo >= hi:
            return None
        inter.append((lo, hi))
        a_sl.append(slice(lo - a0, hi - a0))
        b_sl.append(slice(lo - b0, hi - b0))
    return tuple(inter), tuple(a_sl), tuple(b_sl)


def _volume(ranges: IndexRanges) -> int:
    n = 1
    for lo, hi in ranges:
        n *= max(0, hi - lo)
    return n


def exact_entry(target_ranges: IndexRanges, entries):
    """The saved tensor whose box is exactly ``target_ranges`` (the
    same-world restore), else None."""
    for ranges, data in entries:
        if tuple(ranges) == tuple(target_ranges):
            return data
    return None


def assemble_shard(target_ranges: IndexRanges, dtype, entries):
    """Build the target box in a new CPU tensor by copying overlaps from
    saved entries (``[(ranges, tensor)]``); None if the entries do not
    fully cover the box.  The saved boxes of one checkpoint are disjoint
    once :func:`dedupe_boxes` has run, so coverage is the covered volume;
    overlapping boxes fall back to a mask."""
    import torch

    if not entries:
        return None
    shape = tuple(hi - lo for lo, hi in target_ranges)
    out = torch.empty(shape, dtype=dtype)
    hits = []
    for ranges, data in entries:
        ov = _overlap(target_ranges, tuple(ranges))
        if ov is not None:
            hits.append(ov)
            _, t_sl, s_sl = ov
            out[t_sl].copy_(data[s_sl])
    covered = sum(_volume(g) for g, _, _ in hits)
    want = _volume(target_ranges)
    if covered > want:
        mask = torch.zeros(shape, dtype=torch.bool)
        for _, t_sl, _ in hits:
            mask[t_sl] = True
        return out if bool(mask.all()) else None
    return out if covered == want else None


def assemble_target_pieces(global_shape: Tuple[int, ...], dtype, target,
                           entries) -> Optional[List[Tuple[Any, Any]]]:
    """Host-side half of a target-sharded restore: this rank's piece of
    the target DTensor as ``[(device, host tensor)]``, or None when the
    saved entries do not cover it.  CPU copies only, safe on a restore
    worker thread; a piece whose box one saved entry matches exactly is
    that entry's tensor itself (a view of the shm segment or the mmap),
    copied once, by the commit."""
    if tuple(target.shape) != tuple(global_shape):
        return None
    box = local_box(target) if is_dtensor(target) else tuple(
        (0, int(d)) for d in global_shape)
    piece = exact_entry(box, entries)
    if piece is None:
        piece = assemble_shard(box, dtype, entries)
    if piece is None:
        return None
    return [(target.device, piece)]


def commit_target_pieces(target, pieces):
    """Device-side half: copy the piece into the target's own storage
    (``to_local()`` of a DTensor, the tensor itself otherwise), in
    place, and return the target.  A copy to the card from pageable
    memory returns once the bytes are staged, so a piece that views the
    shm segment may be released right after."""
    local = target.to_local() if is_dtensor(target) else target
    for _, piece in pieces:
        if tuple(piece.shape) != tuple(local.shape):
            raise ValueError(
                f"piece {tuple(piece.shape)} does not fit the local "
                f"tensor {tuple(local.shape)}")
        local.detach().copy_(piece, non_blocking=local.is_cuda)
    return target


def assemble_global_array(global_shape: Tuple[int, ...], dtype, target,
                          entries):
    """Assemble this rank's part of ``target`` from saved (ranges,
    tensor) entries, in place; None if coverage is incomplete."""
    pieces = assemble_target_pieces(global_shape, dtype, target, entries)
    if pieces is None:
        return None
    return commit_target_pieces(target, pieces)


def dedupe_boxes(entries):
    """Keep the first entry of each box (the caller lists ranks in
    order, so the lowest rank's copy of a replicated box)."""
    seen, out = set(), []
    for ranges, data in entries:
        key = tuple(ranges)
        if key not in seen:
            seen.add(key)
            out.append((ranges, data))
    return out


def group_shard_entries(
    flat: Dict[str, Any], metas: Dict[str, Any]
) -> Tuple[Dict[str, List[Tuple[IndexRanges, Any]]], Dict[str, Any]]:
    """Split a flat {key or key@shardN: tensor} dict into (sharded
    entries grouped by base key, plain leaves)."""
    grouped: Dict[str, List[Tuple[IndexRanges, Any]]] = {}
    plain: Dict[str, Any] = {}
    for key, arr in flat.items():
        if SHARD_SEP in key:
            base = key.split(SHARD_SEP, 1)[0]
            meta = metas.get(key)
            if meta is None or meta.index is None:
                continue
            grouped.setdefault(base, []).append(
                (tuple(tuple(r) for r in meta.index), arr))
        else:
            plain[key] = arr
    return ({k: dedupe_boxes(v) for k, v in grouped.items()}, plain)
