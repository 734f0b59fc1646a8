"""The orbax tier of the port: ``GlobalCheckpointer`` over
``torch.distributed.checkpoint`` and the ``Checkpointer``'s
``orbax_dir``/``orbax_every``.

Twins of the reference's orbax cases (``tests/test_sharded_ckpt.py``
``:164``, ``:193`` and the ``Checkpointer`` paths of
``dlrover_tpu/checkpoint/checkpointer.py:73-270``).  The tier's files
are DCP's format, not orbax's, so nothing here crosses to the JAX
package; every comparison is of exact bytes.  The DTensor cases run on
a one-rank gloo group in this process.
"""

import os
import shutil
import tempfile
import uuid

import numpy as np
import pytest
import torch

from dlrover_tpu_torch.checkpoint.checkpointer import Checkpointer
from dlrover_tpu_torch.checkpoint.orbax_compat import GlobalCheckpointer
from dlrover_tpu_torch.checkpoint.saver import (
    AsyncCheckpointSaver,
    SaverConfig,
)
from dlrover_tpu_torch.checkpoint.shm_handler import SharedMemoryHandler


def _state(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "params": {"w": torch.from_numpy(
            rng.normal(size=(6, 4)).astype(np.float32)),
            "bf": torch.from_numpy(rng.normal(size=(5,)).astype(
                np.float32)).to(torch.bfloat16)},
        "opt": (torch.tensor(3, dtype=torch.int32),
                torch.from_numpy(rng.integers(0, 9, (3,)))),
        "n": rng.normal(size=(2,)).astype(np.float32),
        "step": 5,
        "tag": "x",
    }


def _zeros(state):
    from dlrover_tpu_torch.checkpoint.shm_handler import map_leaves

    def zero(path, leaf):
        if isinstance(leaf, torch.Tensor):
            return torch.zeros_like(leaf)
        if isinstance(leaf, np.ndarray):
            return np.zeros_like(leaf)
        return type(leaf)()

    return map_leaves(zero, state)


def _raw(x):
    """dtype name and bytes of a tensor or array (an untargeted restore
    gives numpy leaves back as tensors)."""
    if isinstance(x, torch.Tensor):
        return (str(x.dtype).removeprefix("torch."),
                x.contiguous().view(-1).view(torch.uint8).numpy().tobytes())
    return str(x.dtype), x.tobytes()


def _same(got, want):
    from dlrover_tpu_torch.checkpoint.shm_handler import _flatten_state_dict

    fa, fb = _flatten_state_dict(got), _flatten_state_dict(want)
    assert set(fa) == set(fb)
    for k in fa:
        x, y = fa[k], fb[k]
        if isinstance(y, (torch.Tensor, np.ndarray)):
            assert _raw(x) == _raw(y), k
        else:
            assert x == y, k


@pytest.fixture(autouse=True)
def job(monkeypatch):
    sockets = tempfile.mkdtemp(prefix="dlor")
    monkeypatch.setenv("DLROVER_SHARED_DIR", sockets)
    monkeypatch.setenv("DLROVER_JOB_NAME", f"orb-{uuid.uuid4().hex[:10]}")
    AsyncCheckpointSaver.reset()
    yield
    AsyncCheckpointSaver.reset()
    SharedMemoryHandler(0).unlink()
    shutil.rmtree(sockets, ignore_errors=True)


def _saver(path):
    AsyncCheckpointSaver._instance = AsyncCheckpointSaver(SaverConfig(
        checkpoint_dir=str(path), local_shard_num=1, global_shard_num=1,
        node_rank=0))


def test_dcp_round_trip_with_and_without_a_target(tmp_path):
    state = _state()
    g = GlobalCheckpointer(str(tmp_path))
    g.save(4, state, wait=True)
    assert g.all_steps() == [4] and g.latest_step() == 4
    step, got = g.restore()
    assert step == 4
    assert torch.equal(got["params"]["w"], state["params"]["w"])
    assert got["step"] == 5 and got["tag"] == "x"
    target = _zeros(state)
    step, got = g.restore(target)
    assert step == 4
    assert got["params"]["w"] is target["params"]["w"]
    assert isinstance(got["opt"], tuple) and isinstance(got["n"], np.ndarray)
    _same(got, state)
    g.close()


def test_dcp_round_trip_reshards_a_dtensor(tmp_path):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Shard, distribute_tensor

    dist.init_process_group(
        "gloo", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
        world_size=1)
    try:
        mesh = init_device_mesh("cpu", (1,))
        w = torch.arange(24.0).reshape(6, 4)
        g = GlobalCheckpointer(str(tmp_path / "dcp"))
        g.save(1, {"w": distribute_tensor(w, mesh, [Shard(0)])}, wait=True)
        target = {"w": distribute_tensor(torch.zeros(6, 4), mesh,
                                         [Shard(1)])}
        step, got = g.restore(target)
        g.close()
        assert step == 1 and got["w"] is target["w"]
        assert torch.equal(got["w"].full_tensor(), w)
    finally:
        dist.destroy_process_group()


def test_max_to_keep_prunes_the_oldest_complete_steps(tmp_path):
    g = GlobalCheckpointer(str(tmp_path), max_to_keep=2)
    for step in range(1, 5):
        g.save(step, _state(step))
    g.wait()
    assert g.all_steps() == [3, 4]
    assert sorted(os.listdir(tmp_path)) == ["step_3", "step_4"]
    _same(g.restore()[1], _state(4))
    g.close()


def test_orbax_every_counts_storage_saves(tmp_path):
    """Every Nth storage save (the 1st, the 3rd, ...) goes to the orbax
    tier too; memory saves do not count."""
    from dlrover_tpu_torch.checkpoint.checkpointer import StorageType

    _saver(tmp_path / "flash")
    ckpt = Checkpointer(str(tmp_path / "flash"), local_rank=0,
                        global_rank=0, world_size=1,
                        orbax_dir=str(tmp_path / "orbax"), orbax_every=2)
    for step in range(1, 6):
        ckpt.save_checkpoint(step, _state(step),
                             storage_type=StorageType.MEMORY)
        assert ckpt.save_checkpoint(step, _state(step))
        assert ckpt.wait(timeout=60)
    ckpt.close()
    assert GlobalCheckpointer(str(tmp_path / "orbax")).all_steps() == [
        1, 3, 5]


def test_wait_covers_the_orbax_writes(tmp_path):
    _saver(tmp_path / "flash")
    ckpt = Checkpointer(str(tmp_path / "flash"), local_rank=0,
                        global_rank=0, world_size=1,
                        orbax_dir=str(tmp_path / "orbax"), orbax_every=1)
    assert ckpt.save_checkpoint(9, _state())
    assert ckpt.wait(timeout=60)
    assert os.path.exists(tmp_path / "orbax" / "step_9" / ".metadata")
    ckpt.close()


@pytest.mark.parametrize("with_target", [False, True],
                         ids=["no_target", "target"])
def test_empty_flash_tiers_fall_back_to_the_orbax_tier(tmp_path,
                                                       with_target):
    """Shm and storage empty (a replaced node): the orbax tier is the
    last resort, with a target (in place) and without one."""
    state = _state(7)
    g = GlobalCheckpointer(str(tmp_path / "orbax"))
    g.save(7, state, wait=True)
    g.close()
    _saver(tmp_path / "flash")
    ckpt = Checkpointer(str(tmp_path / "flash"), local_rank=0,
                        global_rank=0, world_size=1,
                        orbax_dir=str(tmp_path / "orbax"))
    if with_target:
        target = _zeros(state)
        step, got = ckpt.load_checkpoint(target_state=target)
        assert got["params"]["w"] is target["params"]["w"]
        assert ckpt.last_restore_phases["tier"] == "orbax"
        _same(got, state)
    else:
        step, got = ckpt.load_checkpoint()
        assert torch.equal(got["params"]["w"], state["params"]["w"])
        assert got["step"] == 5
    assert step == 7
    ckpt.close()


def test_a_per_call_orbax_dir_overrides_the_configured_one(tmp_path):
    g = GlobalCheckpointer(str(tmp_path / "other"))
    g.save(2, _state(2), wait=True)
    g.close()
    _saver(tmp_path / "flash")
    ckpt = Checkpointer(str(tmp_path / "flash"), local_rank=0,
                        global_rank=0, world_size=1,
                        orbax_dir=str(tmp_path / "orbax"))
    step, got = ckpt.load_checkpoint(orbax_dir=str(tmp_path / "other"))
    assert step == 2
    assert torch.equal(got["params"]["w"], _state(2)["params"]["w"])
    ckpt.close()
