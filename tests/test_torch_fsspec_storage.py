"""The port's object-store checkpoint backend (``FsspecStorage`` over
fsspec's ``memory://`` filesystem): twins of
``tests/test_gcs_storage.py`` — the factory's dispatch on the URL, the
storage surface, a full flash save -> commit -> restore cycle through
the port's saver and engine, and the deletion strategy — plus the
cross-package check that a step the port committed to the object store
is read by the JAX package's storage reader, byte for byte (the memory
filesystem is one per process, shared by both packages)."""

import os
import shutil
import tempfile
import time
import uuid

import fsspec
import pytest
import torch

from dlrover_tpu.checkpoint.saver import AsyncCheckpointSaver as JaxSaver
from dlrover_tpu.checkpoint.saver import (
    read_last_checkpoint as jax_read_last_checkpoint,
)
from dlrover_tpu_torch.checkpoint.engine import CheckpointEngine
from dlrover_tpu_torch.checkpoint.saver import (
    AsyncCheckpointSaver,
    SaverConfig,
    read_last_checkpoint,
)
from dlrover_tpu_torch.checkpoint.shm_handler import SharedMemoryHandler
from dlrover_tpu_torch.common.constants import CheckpointConstant
from dlrover_tpu_torch.common.storage import (
    FsspecStorage,
    KeepLatestStepStrategy,
    PosixDiskStorage,
    get_checkpoint_storage,
)


@pytest.fixture()
def memfs(monkeypatch):
    """A clean memory filesystem, and a shm namespace and socket
    directory of the test's own (both packages' savers stopped and the
    segment unlinked afterwards)."""
    monkeypatch.setenv("DLROVER_JOB_NAME", f"test-{uuid.uuid4().hex[:12]}")
    sockets = tempfile.mkdtemp(prefix="dls")
    monkeypatch.setenv("DLROVER_SHARED_DIR", sockets)
    fs = fsspec.filesystem("memory")
    # the memory filesystem is process-global; start clean
    for entry in list(fs.ls("/", detail=False)):
        fs.rm(entry, recursive=True)
    AsyncCheckpointSaver.reset()
    JaxSaver.reset()
    yield fs
    AsyncCheckpointSaver.reset()
    JaxSaver.reset()
    SharedMemoryHandler(0).unlink()
    shutil.rmtree(sockets, ignore_errors=True)


def test_factory_dispatches_on_url():
    assert isinstance(get_checkpoint_storage(path="/tmp/x"), PosixDiskStorage)
    assert isinstance(get_checkpoint_storage(path="memory://ckpt"),
                      FsspecStorage)


def test_fsspec_storage_surface(memfs):
    st = FsspecStorage(fs=memfs)
    st.write(b"abc", "memory://bucket/ckpt/rank_0.ckpt")
    assert st.exists("memory://bucket/ckpt/rank_0.ckpt")
    assert st.read("memory://bucket/ckpt/rank_0.ckpt") == b"abc"
    assert bytes(st.read_view("memory://bucket/ckpt/rank_0.ckpt")) == b"abc"
    st.write("5", "memory://bucket/ckpt/tracker")
    assert st.read("memory://bucket/ckpt/tracker", mode="r") == "5"
    assert "rank_0.ckpt" in st.listdir("memory://bucket/ckpt")
    st.safe_rmtree("memory://bucket/ckpt")
    assert not st.exists("memory://bucket/ckpt/rank_0.ckpt")
    # missing files read as None, missing dirs list as empty
    assert st.read("memory://bucket/nope") is None
    assert st.listdir("memory://bucket/nope") == []


def test_flash_ckpt_cycle_through_object_store(memfs):
    """The port's saver persists through the object store, its engine
    restores from it bit for bit, and the JAX package's reader finds the
    same step and the same shard bytes."""
    ckpt_dir = "memory://jobs/myjob/ckpt"
    saver = AsyncCheckpointSaver(SaverConfig(
        checkpoint_dir=ckpt_dir, local_shard_num=1, global_shard_num=1,
        node_rank=0))
    assert isinstance(saver.storage, FsspecStorage)
    AsyncCheckpointSaver._instance = saver
    engine = CheckpointEngine(ckpt_dir, replicated=True, local_rank=0,
                              global_rank=0, world_size=1)
    try:
        w = torch.arange(8, dtype=torch.float32)
        b = torch.randn(3, 5, generator=torch.Generator().manual_seed(0)
                        ).to(torch.bfloat16)
        assert engine.save_to_storage(3, {"w": w, "b": b, "step": 3})
        assert engine.wait_async(timeout=30.0)
        tracker = f"{ckpt_dir}/{CheckpointConstant.TRACKER_FILE}"
        deadline = time.time() + 30
        while time.time() < deadline and not memfs.exists(tracker):
            time.sleep(0.1)
        assert memfs.exists(tracker)
        step, restored = engine.load_from_storage()
        assert step == 3 and restored["step"] == 3
        assert torch.equal(restored["w"], w)
        assert restored["b"].dtype == torch.bfloat16
        assert torch.equal(restored["b"], b)
        step, shards = read_last_checkpoint(ckpt_dir)
        jstep, jshards = jax_read_last_checkpoint(ckpt_dir)
        assert step == jstep == 3 and sorted(shards) == sorted(jshards)
        for rank, (meta, raw) in shards.items():
            assert bytes(jshards[rank][1]) == bytes(raw)
    finally:
        engine.close()


def test_deletion_strategy_on_object_store(memfs):
    st = FsspecStorage(
        deletion_strategy=KeepLatestStepStrategy(2, "memory://b/ck"),
        fs=memfs,
    )
    for step in (1, 2, 3):
        st.write(b"x", f"memory://b/ck/{step}/rank_0.ckpt")
        st.commit(step, True)
    assert not st.exists("memory://b/ck/1/rank_0.ckpt")
    assert st.exists("memory://b/ck/2/rank_0.ckpt")
    assert st.exists("memory://b/ck/3/rank_0.ckpt")


def test_fsspec_is_imported_only_when_a_backend_is_built():
    """The card machines need not have fsspec: importing the storage
    module (and the saver and engine over it) loads none."""
    import json
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ("import json, sys\n"
            "import dlrover_tpu_torch.common.storage\n"
            "import dlrover_tpu_torch.checkpoint.engine\n"
            "print(json.dumps(sorted(sys.modules)))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         env=dict(os.environ, PYTHONPATH=root),
                         capture_output=True, text=True, check=True).stdout
    loaded = json.loads(out.strip().splitlines()[-1])
    assert "dlrover_tpu_torch.common.storage" in loaded
    assert not [m for m in loaded if m.split(".")[0] == "fsspec"]
