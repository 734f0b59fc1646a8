"""Twin of ``tests/test_common.py``, against the port (:mod:`dlrover_tpu_torch`).

Tests for dlrover_tpu_torch.common: comm transport, IPC primitives,
storage, node model.  Pattern follows the reference's
test_multi_process.py / test_grpc_utils.py (in-process client+server).
"""

import os
import queue
import threading
import time

import numpy as np
import pytest

from dlrover_tpu_torch.common import comm
from dlrover_tpu_torch.common import messages as msg
from dlrover_tpu_torch.common.multi_process import (
    PersistentSharedMemory,
    SharedDict,
    SharedLock,
    SharedQueue,
    get_or_create_shm,
)
from dlrover_tpu_torch.common.node import Node, new_worker
from dlrover_tpu_torch.common.constants import NodeStatus
from dlrover_tpu_torch.common.storage import (
    KeepLatestStepStrategy,
    PosixDiskStorage,
)


class _EchoHandler(comm.RequestHandler):
    def __init__(self):
        self.reports = []

    def report(self, node_id, node_type, message):
        self.reports.append((node_id, type(message).__name__))
        return True

    def get(self, node_id, node_type, message):
        if isinstance(message, msg.KeyValueGetRequest):
            return msg.KeyValuePair(key=message.key, value=b"v")
        return msg.BaseResponse(success=True, message=type(message).__name__)


def test_message_roundtrip():
    handler = _EchoHandler()
    server = comm.MessageServer(0, handler, host="127.0.0.1")
    server.start()
    client = comm.MessageClient(
        f"127.0.0.1:{server.port}", node_id=3, node_type="worker"
    )
    assert client.report(msg.HeartbeatRequest(node_id=3, timestamp=1.0))
    resp = client.get(msg.KeyValueGetRequest(key="k"))
    assert isinstance(resp, msg.KeyValuePair) and resp.value == b"v"
    resp2 = client.get(msg.JoinRendezvousRequest(node_rank=1))
    assert resp2.message == "JoinRendezvousRequest"
    assert handler.reports == [(3, "HeartbeatRequest")]
    client.close()
    server.stop()


def test_message_concurrent_clients():
    handler = _EchoHandler()
    server = comm.MessageServer(0, handler, host="127.0.0.1")
    server.start()
    errs = []

    def hammer(i):
        try:
            c = comm.MessageClient(f"127.0.0.1:{server.port}", node_id=i)
            for _ in range(20):
                c.get(msg.KeyValueGetRequest(key=str(i)))
            c.close()
        except Exception as e:  # pragma: no cover
            errs.append(e)

    threads = [threading.Thread(target=hammer, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errs
    server.stop()


def test_addr_connected():
    handler = _EchoHandler()
    server = comm.MessageServer(0, handler, host="127.0.0.1")
    server.start()
    assert comm.addr_connected(f"127.0.0.1:{server.port}")
    server.stop()
    assert not comm.addr_connected("127.0.0.1:1")


def test_shared_lock():
    name = f"lock-test-{os.getpid()}"
    server_lock = SharedLock(name, create=True)
    client_lock = SharedLock(name, create=False)
    assert client_lock.acquire()
    assert client_lock.locked()
    assert not client_lock.acquire(blocking=False)
    assert client_lock.release()
    assert not server_lock.locked()
    server_lock.close()


def test_shared_queue():
    name = f"queue-test-{os.getpid()}"
    server_q = SharedQueue(name, create=True)
    client_q = SharedQueue(name, create=False)
    client_q.put({"step": 7})
    assert server_q.qsize() == 1
    assert client_q.get(timeout=5) == {"step": 7}
    with pytest.raises(queue.Empty):
        client_q.get(timeout=0.1)
    server_q.close()


def test_shared_dict():
    name = f"dict-test-{os.getpid()}"
    server_d = SharedDict(name, create=True)
    client_d = SharedDict(name, create=False)
    client_d.update({"a": 1})
    client_d.update({"b": np.float32(2.0)})
    got = client_d.get()
    assert got["a"] == 1 and got["b"] == 2.0
    client_d.set({"c": 3})
    assert server_d.get() == {"c": 3}
    server_d.close()


def test_persistent_shared_memory():
    name = f"dlrover-shm-test-{os.getpid()}"
    shm = get_or_create_shm(name, 1024)
    shm.buf[:4] = b"abcd"
    # reattach: content survives
    shm2 = PersistentSharedMemory(name=name)
    assert bytes(shm2.buf[:4]) == b"abcd"
    # grow path: recreate larger
    shm3 = get_or_create_shm(name, 4096)
    assert shm3.size >= 4096
    shm.close()
    shm2.close()
    shm3.close()
    shm3.unlink()


def test_posix_storage(tmp_path):
    storage = PosixDiskStorage(
        KeepLatestStepStrategy(max_to_keep=2, checkpoint_dir=str(tmp_path))
    )
    p = tmp_path / "sub" / "file.bin"
    storage.write(b"hello", str(p))
    assert storage.read(str(p)) == b"hello"
    storage.write("text", str(tmp_path / "t.txt"))
    assert storage.read(str(tmp_path / "t.txt"), "r") == "text"
    # deletion strategy keeps 2 latest step dirs
    for step in (10, 20, 30):
        d = tmp_path / str(step)
        d.mkdir()
        storage.commit(step, True)
    assert not (tmp_path / "10").exists()
    assert (tmp_path / "20").exists() and (tmp_path / "30").exists()


def test_node_model():
    n = new_worker(2, rank=1)
    assert n.is_alive() is False
    n.update_status(NodeStatus.RUNNING)
    assert n.is_alive() and n.start_time > 0
    n.update_status(NodeStatus.FAILED)
    assert n.finish_time > 0
    n.inc_relaunch_count()
    assert not n.exceeded_max_relaunch()
