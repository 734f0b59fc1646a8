"""Peer backup of checkpoint shards.

Copy of ``dlrover_tpu/checkpoint/backup.py`` (reference:
``flash_checkpoint/ckpt_backup.py``, peer-node backup and restore of
checkpoint shards via torch collectives): each rank sends its
checkpoint shard to a partner along the ``data`` axis, so when a node
is lost and replaced, the replacement recovers the shard from the
partner instead of storage.  Where the reference rides a uint8
``ppermute`` inside ``shard_map``, the bytes here go through one
batched send/receive pair on the axis's ``torch.distributed`` group of
the port's :class:`~dlrover_tpu_torch.parallel.mesh.Mesh` (on the card
for an NCCL group, on the host for gloo).
"""

import pickle
from typing import Optional, Tuple

import torch

from dlrover_tpu_torch.common.log import default_logger as logger


def _group_ranks(group):
    import torch.distributed as dist

    return [dist.get_global_rank(group, i)
            for i in range(dist.get_world_size(group))]


def exchange_with_peer(
    payload: bytes,
    mesh,
    axis: str = "data",
    max_bytes: Optional[int] = None,
    shift: int = 1,
) -> Tuple[bytes, int]:
    """Every rank sends ``payload`` to its ``axis`` neighbour +shift
    (a ring) and receives the payload of its neighbour -shift.  Returns
    (peer_payload, peer_len).

    All ranks of the axis call this collectively with the same
    ``max_bytes`` (defaults to a power-of-two bound of the local payload
    when the job has one process; callers agree on it out of band, e.g.
    through the master's KV store)."""
    import torch.distributed as dist

    n = mesh.shape[axis]
    if n == 1:
        return payload, len(payload)
    group = mesh.group(axis)
    if max_bytes is None:
        if dist.get_world_size() > 1:
            # a default from the LOCAL payload lets ranks disagree on
            # the buffer size and wedge the exchange
            raise ValueError(
                "exchange_with_peer requires an explicitly agreed "
                "max_bytes in multi-process runs"
            )
        max_bytes = 1 << len(payload).bit_length()
    if len(payload) > max_bytes:
        # fail fast on every rank's next call instead of dying inside
        # the exchange after peers entered it
        raise ValueError(
            f"payload ({len(payload)} bytes) exceeds the agreed "
            f"max_bytes ({max_bytes}); raise max_bytes collectively"
        )
    device = (torch.device("cuda", torch.cuda.current_device())
              if dist.get_backend(group) == "nccl" else torch.device("cpu"))
    # [size+8] buffer: an 8-byte length header + the padded payload
    send = torch.zeros(max_bytes + 8, dtype=torch.uint8)
    send[:8] = torch.tensor([len(payload)], dtype=torch.int64).view(
        torch.uint8)
    if payload:
        send[8:8 + len(payload)] = torch.frombuffer(
            bytearray(payload), dtype=torch.uint8)
    send = send.to(device)
    recv = torch.empty_like(send)
    ranks = _group_ranks(group)
    me = ranks.index(dist.get_rank())
    ops = [
        dist.P2POp(dist.isend, send, ranks[(me + shift) % n], group),
        dist.P2POp(dist.irecv, recv, ranks[(me - shift) % n], group),
    ]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    recv = recv.cpu()
    length = int(recv[:8].view(torch.int64).item())
    peer = bytes(recv[8:8 + length].numpy().tobytes())
    return peer, len(peer)


class BackupManager:
    """Keeps the partner's shard alongside ours (reference:
    ckpt_backup BackupManger semantics)."""

    def __init__(self, mesh, axis: str = "data"):
        self._mesh = mesh
        self._axis = axis
        self._peer_shard: Optional[bytes] = None

    def backup(self, state_dict, step: int, max_bytes: int):
        payload = pickle.dumps({"step": step, "state": state_dict})
        peer, _ = exchange_with_peer(
            payload, self._mesh, self._axis, max_bytes=max_bytes
        )
        self._peer_shard = peer
        logger.info(
            "backed up step %s shard with peer (%s bytes held)",
            step, len(peer),
        )

    def peer_state(self) -> Optional[Tuple[int, dict]]:
        if self._peer_shard is None:
            return None
        data = pickle.loads(self._peer_shard)
        return data["step"], data["state"]
