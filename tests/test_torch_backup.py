"""Peer backup of checkpoint shards in the port (``checkpoint/backup.py``).

Twin of the reference's peer exchange (``dlrover_tpu/checkpoint/
backup.py``, a uint8 ``ppermute`` over the ``data`` axis): here each
rank of a gloo world (``world`` processes of this file with
``--worker``) sends its payload to its ``data``-axis neighbour +1 and
must receive its neighbour -1's bytes exactly, at world 2 and 4; the
``BackupManager`` round trip gives back the peer's step and tensors bit
for bit.  The spawned worlds have a timeout of their own.
"""

import os
import pickle
import socket
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 180


def _payload(rank: int) -> bytes:
    # ranks differ in length too: the header carries each one's
    return np.random.default_rng(rank).integers(
        0, 256, 1000 + 37 * rank, dtype=np.uint8).tobytes()


def _state(rank: int):
    rng = np.random.default_rng(100 + rank)
    return {"w": torch.from_numpy(rng.normal(size=(5, 3)).astype(np.float32)),
            "k": torch.from_numpy(rng.integers(0, 9, (4,)))}


def _worker(rank, world, port, out_path):
    import torch.distributed as dist

    from dlrover_tpu_torch.checkpoint.backup import (
        BackupManager,
        exchange_with_peer,
    )
    from dlrover_tpu_torch.parallel.mesh import MeshConfig, build_mesh

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    mesh = build_mesh(MeshConfig(num_slices=1), device_type="cpu")
    peer, n = exchange_with_peer(_payload(rank), mesh, max_bytes=4096)
    manager = BackupManager(mesh)
    manager.backup(_state(rank), step=10 + rank, max_bytes=8192)
    step, state = manager.peer_state()
    coord = mesh.coordinate()["data"]
    dist.barrier()
    dist.destroy_process_group()
    with open(out_path, "wb") as f:
        pickle.dump({"rank": rank, "coord": coord, "peer": peer, "n": n,
                     "step": step, "state": state}, f)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("world", [2, 4])
def test_peer_exchange_is_bit_exact(world):
    tmp = tempfile.mkdtemp(prefix="dlbk")
    port = _free_port()
    env = {**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "1",
           "DLROVER_LOG_LEVEL": "ERROR"}
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--worker", str(rank),
         str(world), str(port), os.path.join(tmp, f"{rank}.pkl")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in range(world)]
    try:
        logs = [p.communicate(timeout=TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    for rank in range(world):
        with open(os.path.join(tmp, f"{rank}.pkl"), "rb") as f:
            got = pickle.load(f)
        src = (rank - 1) % world
        assert got["coord"] == rank
        assert got["peer"] == _payload(src) and got["n"] == len(
            _payload(src))
        assert got["step"] == 10 + src
        for key, want in _state(src).items():
            assert torch.equal(got["state"][key], want), key


def test_one_rank_keeps_its_own_payload():
    """A data axis of one rank exchanges nothing."""
    from dlrover_tpu_torch.checkpoint.backup import exchange_with_peer
    from dlrover_tpu_torch.parallel.mesh import build_mesh

    mesh = build_mesh(device_type="cpu")
    assert exchange_with_peer(b"abc", mesh) == (b"abc", 3)


def test_a_payload_over_the_agreed_size_raises():
    from dlrover_tpu_torch.checkpoint.backup import exchange_with_peer
    from dlrover_tpu_torch.parallel.mesh import Mesh

    mesh = Mesh(shape={"data": 2, "fsdp": 1, "tensor": 1, "sequence": 1,
                       "expert": 1, "pipeline": 1}, device_type="cpu")
    with pytest.raises(ValueError, match="exceeds the agreed"):
        exchange_with_peer(b"x" * 10, mesh, max_bytes=4)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        rank, world, port = (int(a) for a in sys.argv[2:5])
        _worker(rank, world, port, sys.argv[5])
