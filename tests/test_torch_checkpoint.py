"""Flash checkpoint of the PyTorch port against the JAX package.

The same seeded numpy values go through both packages; every
comparison is of exact bytes.  Round trips on the shm and storage
tiers for fp32, bf16, int8 and int64 leaves with scalar and string
leaves; a step dir written by the port loads through
``dlrover_tpu.checkpoint.Checkpointer`` and one written by the JAX
package loads through the port; the ``rank_0.ckpt`` blob of one state
is byte-identical from both.  Then the port's twins of
``tests/test_checkpoint.py`` (engine memory and storage saves, storage
after the shm is gone, the breakpoint save, ``deletion_keep_latest``,
the async snapshot's integrity against in-place updates, the skip when
busy), the IPC allowlist, the options of later slices, and a
``cuda``-marked test of the side-stream snapshot against an in-place
update on the card.  Trainer side and agent side run in one process
over the real unix-socket IPC, as the reference's tests do.
"""

import os
import pickle
import shutil
import tempfile
import threading
import time
import uuid
from collections import OrderedDict
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlrover_tpu.checkpoint import shm_handler as jax_shm
from dlrover_tpu.checkpoint.checkpointer import Checkpointer as JaxCheckpointer
from dlrover_tpu.checkpoint.saver import (
    AsyncCheckpointSaver as JaxSaver,
)
from dlrover_tpu_torch.checkpoint.checkpointer import (
    Checkpointer,
    StorageType,
    restore_to_template,
)
from dlrover_tpu_torch.checkpoint.engine import CheckpointEngine
from dlrover_tpu_torch.checkpoint.saver import (
    AsyncCheckpointSaver,
    CheckpointEvent,
    SaverConfig,
    read_last_checkpoint,
)
from dlrover_tpu_torch.checkpoint.shm_handler import (
    CheckpointConfig,
    SharedMemoryHandler,
    TensorMeta,
    _flatten_state_dict,
    load_meta,
)
from dlrover_tpu_torch.common import comm
from dlrover_tpu_torch.common.constants import CheckpointConstant
from dlrover_tpu_torch.common.multi_process import (
    SharedDict,
    SharedLock,
    SharedQueue,
)

DTYPES = ["float32", "bfloat16", "int8", "int64"]


@pytest.fixture(autouse=True)
def job(monkeypatch):
    """A shm namespace and a socket directory of the test's own (a
    short ``mkdtemp``: a unix socket's path holds at most 107 bytes);
    both packages' in-process savers stopped, the segment unlinked and
    the directory removed afterwards."""
    name = f"test-{uuid.uuid4().hex[:12]}"
    sockets = tempfile.mkdtemp(prefix="dls")
    monkeypatch.setenv("DLROVER_JOB_NAME", name)
    monkeypatch.setenv("DLROVER_SHARED_DIR", sockets)
    AsyncCheckpointSaver.reset()
    JaxSaver.reset()
    yield name
    AsyncCheckpointSaver.reset()
    JaxSaver.reset()
    SharedMemoryHandler(0).unlink()
    shutil.rmtree(sockets, ignore_errors=True)


@pytest.fixture()
def saver(tmp_path):
    s = AsyncCheckpointSaver(SaverConfig(
        checkpoint_dir=str(tmp_path), local_shard_num=1,
        global_shard_num=1, node_rank=0,
    ))
    AsyncCheckpointSaver._instance = s
    return s


def _engine(tmp_path, **kw):
    return CheckpointEngine(str(tmp_path), replicated=True, local_rank=0,
                            global_rank=0, world_size=1, **kw)


def _numpy_leaf(dtype: str, shape=(3, 5), seed=0):
    """Seeded values of ``dtype``; bf16 as the raw bit patterns of
    rounded fp32 values (numpy's bfloat16 comes from ml_dtypes, which
    JAX imports)."""
    rng = np.random.default_rng(seed)
    if dtype in ("int8", "int64"):
        return rng.integers(-100, 100, shape).astype(dtype)
    x = rng.normal(size=shape).astype(np.float32)
    return x.astype(np.dtype(dtype))


def _to_torch(a: np.ndarray) -> torch.Tensor:
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _bytes(x) -> bytes:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().contiguous().reshape(-1).view(
            torch.uint8).numpy().tobytes()
    return np.ascontiguousarray(np.asarray(x)).tobytes()


def _state(dtype: str = "float32"):
    """One state as numpy values: nested dicts, a list, a tuple, the
    leaf of ``dtype``, a 0-d leaf and scalar and string leaves."""
    return {
        "params": {"w": _numpy_leaf(dtype), "b": _numpy_leaf(dtype, (5,), 1)},
        "opt": [_numpy_leaf("float32", (2, 3), 2),
                (_numpy_leaf("int8", (4,), 3), np.asarray(7, np.int32))],
        "step": 7,
        "note": "hello",
    }


def _port_state(state):
    return jax.tree.map(
        lambda x: _to_torch(x) if isinstance(x, np.ndarray) else x, state)


def _jax_state(state):
    # int64 stays numpy: JAX without x64 would narrow it to int32
    return jax.tree.map(
        lambda x: jnp.asarray(x) if isinstance(x, np.ndarray)
        and x.dtype != np.int64 else x, state)


def _assert_same(got, want):
    """Every leaf of ``got`` bit-equal to ``want``'s, same dtype name,
    same keys."""
    g = _flatten_state_dict(got)
    w = jax_shm._flatten_state_dict(want)
    assert list(g) == list(w)
    for key in w:
        if isinstance(w[key], (np.ndarray, jax.Array, torch.Tensor)):
            gd = (str(g[key].dtype).replace("torch.", "")
                  if isinstance(g[key], torch.Tensor) else str(g[key].dtype))
            assert gd == str(np.asarray(w[key]).dtype), key
            assert tuple(g[key].shape) == tuple(np.shape(w[key])), key
            assert _bytes(g[key]) == _bytes(w[key]), key
        else:
            assert g[key] == w[key], key


def _wait_tracker(path, step, timeout=30.0):
    tracker = os.path.join(str(path), CheckpointConstant.TRACKER_FILE)
    deadline = time.time() + timeout
    while time.time() < deadline:
        if os.path.exists(tracker):
            with open(tracker) as f:
                if f.read().strip() == str(step):
                    return
        time.sleep(0.02)
    raise AssertionError(f"step {step} not committed in {path}")


class Moment(NamedTuple):
    values: np.ndarray
    scales: np.ndarray


def test_flatten_keys_and_order_match_jax_tree_util():
    tree = {
        "b": [1, {"z": 2, "a": (3, 4)}],
        "a-c": Moment(np.zeros(2), np.ones(1)),
        "a": OrderedDict([("y", 5), ("x", 6)]),
        "n": None,
        "i": {10: 8, 2: 9},
    }
    want = list(jax_shm._flatten_state_dict(tree))
    assert list(_flatten_state_dict(tree)) == want
    assert "i/2" in want and "a-c/values" in want
    assert want.index("i/2") < want.index("i/10")


@pytest.mark.parametrize("dtype", DTYPES)
def test_shm_roundtrip(saver, dtype):
    handler = SharedMemoryHandler(0, host=False)
    want = _state(dtype)
    handler.save_state_dict(_port_state(want), CheckpointConfig(step=7))
    cfg, got = handler.load_state_dict()
    assert cfg.step == 7
    _assert_same(got, want)
    handler.close()


def test_concurrent_attach_maps_the_segment_once(saver, monkeypatch):
    """The restore's pre-fault thread and the restore attach to the
    segment at once: both get the one cached mapping.  A second mapping,
    dropped by the thread whose assignment lost, would close (unmap)
    under the other's ``torch.frombuffer`` views; on the card a resumed
    child of ``chip_smoke.py`` phase 6a died of SIGSEGV so."""
    from dlrover_tpu_torch.checkpoint import shm_handler

    writer = SharedMemoryHandler(0, host=False)
    writer.save_state_dict(_port_state(_state(DTYPES[0])),
                           CheckpointConfig(step=3))
    writer.close()

    class SlowAttach(shm_handler.PersistentSharedMemory):
        def __init__(self, *args, **kwargs):
            time.sleep(0.2)  # both threads inside the attach at once
            super().__init__(*args, **kwargs)

    monkeypatch.setattr(shm_handler, "PersistentSharedMemory", SlowAttach)
    reader = SharedMemoryHandler(0, host=False)
    got = []
    threads = [threading.Thread(target=lambda: got.append(reader._attach()))
               for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert got[0] is not None and got[0] is got[1]
    reader.close()


@pytest.mark.parametrize("dtype", DTYPES)
def test_storage_roundtrip(saver, tmp_path, dtype):
    engine = _engine(tmp_path)
    want = _state(dtype)
    assert engine.save_to_storage(5, _port_state(want))
    assert engine.wait_async(30.0)
    _wait_tracker(tmp_path, 5)
    step, got = engine.load_from_storage()
    assert step == 5
    _assert_same(got, want)
    assert engine.last_restore_phases["tier"] == "storage"
    engine.close()


@pytest.mark.parametrize("dtype", DTYPES)
def test_port_step_dir_loads_in_jax(tmp_path, dtype):
    want = _state(dtype)
    ckpt = Checkpointer(str(tmp_path / "port"))
    assert ckpt.save_checkpoint(3, _port_state(want))
    assert ckpt.wait()
    _wait_tracker(tmp_path / "port", 3)
    ckpt.close()
    AsyncCheckpointSaver.reset()
    jax_ckpt = JaxCheckpointer(str(tmp_path / "port"))
    step, got = jax_ckpt.load_checkpoint()
    assert step == 3
    assert jax_ckpt.last_restore_phases["tier"] == "storage"
    jax_ckpt.close()
    g = jax_shm._flatten_state_dict(got)
    for key, w in jax_shm._flatten_state_dict(want).items():
        if isinstance(w, np.ndarray):
            assert g[key].dtype == w.dtype and g[key].tobytes() == w.tobytes()
        else:
            assert g[key] == w


@pytest.mark.parametrize("dtype", DTYPES)
def test_jax_step_dir_loads_in_port(tmp_path, dtype):
    want = _state(dtype)
    jax_ckpt = JaxCheckpointer(str(tmp_path / "jax"))
    assert jax_ckpt.save_checkpoint(3, _jax_state(want))
    assert jax_ckpt.wait()
    _wait_tracker(tmp_path / "jax", 3)
    jax_ckpt.close()
    JaxSaver.reset()
    ckpt = Checkpointer(str(tmp_path / "jax"))
    step, got = ckpt.load_checkpoint()
    assert step == 3 and ckpt.last_restore_phases["tier"] == "storage"
    _assert_same(got, want)
    ckpt.close()


def test_jax_sharded_arrays_load_whole_in_the_port(tmp_path):
    """The JAX package saves a global array sharded over a mesh as one
    entry per shard (``@shardN``); the port assembles the full tensor."""
    from jax.sharding import Mesh, NamedSharding, PartitionSpec

    devices = np.array(jax.devices()[:4]).reshape(2, 2)
    mesh = Mesh(devices, ("a", "b"))
    want = {"w": _numpy_leaf("bfloat16", (8, 6)),
            "v": _numpy_leaf("float32", (4,), 1)}
    state = {
        "w": jax.device_put(want["w"], NamedSharding(
            mesh, PartitionSpec("a", "b"))),
        "v": jax.device_put(want["v"], NamedSharding(
            mesh, PartitionSpec(None))),
    }
    jax_ckpt = JaxCheckpointer(str(tmp_path))
    assert jax_ckpt.save_checkpoint(2, state)
    assert jax_ckpt.wait()
    _wait_tracker(tmp_path, 2)
    jax_ckpt.close()
    metas = load_meta((tmp_path / "checkpoint-2" / "rank_0.meta").read_bytes())
    assert sum("@shard" in k for k in metas["tensors"]) >= 4
    JaxSaver.reset()
    ckpt = Checkpointer(str(tmp_path))
    step, got = ckpt.load_checkpoint()
    ckpt.close()
    assert step == 2
    _assert_same(got, want)


def test_rank_blob_is_byte_identical_from_both_packages(tmp_path):
    want = {"bf16": _state("bfloat16"), "i64": _numpy_leaf("int64"),
            "i8": _numpy_leaf("int8", (7,)), "lr": 0.5, "tag": "x"}
    jax_ckpt = JaxCheckpointer(str(tmp_path / "jax"))
    assert jax_ckpt.save_checkpoint(4, _jax_state(want))
    assert jax_ckpt.wait()
    _wait_tracker(tmp_path / "jax", 4)
    jax_ckpt.close()
    JaxSaver.reset()
    ckpt = Checkpointer(str(tmp_path / "port"))
    assert ckpt.save_checkpoint(4, _port_state(want))
    assert ckpt.wait()
    _wait_tracker(tmp_path / "port", 4)
    ckpt.close()
    blobs = [
        (tmp_path / d / "checkpoint-4" / "rank_0.ckpt").read_bytes()
        for d in ("jax", "port")
    ]
    assert len(blobs[0]) > 0 and blobs[0] == blobs[1]
    metas = [
        load_meta((tmp_path / d / "checkpoint-4" / "rank_0.meta").read_bytes())
        for d in ("jax", "port")
    ]
    assert metas[0]["tensors"] == metas[1]["tensors"]
    assert isinstance(metas[0]["config"], CheckpointConfig)


def test_qadamw_state_tree_loads_in_jax_as_the_reference_lays_it_out(
        tmp_path):
    """The port's q-AdamW state under the reference's ``QAdamWState``
    layout (int8 codes, fp32 scales, int32 count) through the port's
    checkpoint; the JAX package reads the values of
    ``qadamw_state_to_jax`` under the same keys."""
    from dlrover_tpu_torch.models import gpt as port_gpt
    from dlrover_tpu_torch.optim import q_adamw
    from dlrover_tpu_torch.utils.convert import (
        params_tree,
        qadamw_state_to_jax,
        qadamw_state_tree,
    )

    model = port_gpt.GPT(port_gpt.GPTConfig.tiny(dtype=torch.float32),
                         device="cpu", seed=0)
    opt = q_adamw(model.parameters(), lr=1e-3)
    x = torch.from_numpy(
        np.random.default_rng(0).integers(0, 256, (2, 9), dtype=np.int64))
    port_gpt.cross_entropy_loss(model(x[:, :-1]), x[:, 1:]).backward()
    opt.step()
    ckpt = Checkpointer(str(tmp_path))
    state = {"params": params_tree(model),
             "opt_state": qadamw_state_tree(opt, model)}
    assert ckpt.save_checkpoint(1, state)
    assert ckpt.wait()
    _wait_tracker(tmp_path, 1)
    ckpt.close()
    AsyncCheckpointSaver.reset()
    jax_ckpt = JaxCheckpointer(str(tmp_path))
    step, got = jax_ckpt.load_checkpoint()
    jax_ckpt.close()
    want = qadamw_state_to_jax(opt, model)
    g = jax_shm._flatten_state_dict(got["opt_state"])
    w = jax_shm._flatten_state_dict(want)
    # the layout order is the reference's (QMoment fields in order);
    # the restore comes back as plain dicts, so compare it by key
    assert list(_flatten_state_dict(state["opt_state"])) == list(w)
    assert step == 1 and sorted(g) == sorted(w)
    assert any(k.endswith("/values") for k in w)
    for key in w:
        assert g[key].dtype == w[key].dtype, key
        assert g[key].tobytes() == np.asarray(w[key]).tobytes(), key


# -- twins of tests/test_checkpoint.py -------------------------------------


def test_engine_save_to_memory_and_restore(saver, tmp_path):
    engine = _engine(tmp_path)
    want = _state("bfloat16")
    assert engine.save_to_memory(3, _port_state(want))
    step, got = engine.load()
    assert step == 3 and engine.last_restore_phases["tier"] == "shm"
    _assert_same(got, want)
    engine.close()


def test_engine_save_to_storage_commit(saver, tmp_path):
    engine = _engine(tmp_path)
    assert engine.save_to_storage(5, _port_state(_state()))
    _wait_tracker(tmp_path, 5)
    step, shards = read_last_checkpoint(str(tmp_path))
    assert step == 5 and 0 in shards
    engine.close()


def test_storage_load_after_shm_gone(saver, tmp_path):
    engine = _engine(tmp_path)
    want = _state("int8")
    engine.save_to_storage(9, _port_state(want))
    assert engine.wait_async(30.0)
    _wait_tracker(tmp_path, 9)
    engine.close()
    SharedMemoryHandler(0).unlink()
    # a fresh engine, as after a restart: the saver's meta names step
    # 9, but the segment is gone
    engine = _engine(tmp_path)
    step, got = engine.load()
    assert step == 9 and engine.last_restore_phases["tier"] == "storage"
    _assert_same(got, want)
    engine.close()


def test_breakpoint_save(saver, tmp_path):
    """A trainer that wrote shm but died before persisting: the agent's
    breakpoint hook persists the snapshot."""
    engine = _engine(tmp_path)
    engine.save_to_memory(11, _port_state(_state()))
    AsyncCheckpointSaver.save_shm_to_storage()
    step, shards = read_last_checkpoint(str(tmp_path))
    assert step == 11 and 0 in shards
    engine.close()


def test_checkpointer_api(saver, tmp_path):
    ckpt = Checkpointer(str(tmp_path), local_rank=0, global_rank=0,
                        world_size=1)
    want = _state()
    assert ckpt.save_checkpoint(2, _port_state(want),
                                storage_type=StorageType.MEMORY)
    step, got = ckpt.load_checkpoint()
    assert step == 2
    _assert_same(got, want)
    step, got = ckpt.load_checkpoint_async().result(timeout=30)
    assert step == 2
    ckpt.close()


def test_deletion_keeps_latest(tmp_path):
    s = AsyncCheckpointSaver(SaverConfig(
        checkpoint_dir=str(tmp_path), local_shard_num=1,
        global_shard_num=1, node_rank=0, deletion_keep_latest=2,
    ))
    AsyncCheckpointSaver._instance = s
    engine = _engine(tmp_path)
    for step in (1, 2, 3):
        engine.save_to_memory(step, _port_state(_state()))
        s.save_step_checkpoint(step)
    dirs = [d for d in os.listdir(str(tmp_path))
            if d.startswith(CheckpointConstant.CKPT_NAME_PREFIX)]
    assert sorted(dirs) == ["checkpoint-2", "checkpoint-3"]
    engine.close()


def test_a_slow_persist_is_not_replaced_in_shm_before_it_is_durable(
        saver, tmp_path, monkeypatch):
    """The saver takes the shard's shm lock before its first touch of
    the segment (here made slow, as a 1.49 GB segment's is on a slow
    host): the trainer's writer, saving the next step with a blocking
    lock, waits for the copy instead of replacing the step in shm,
    which the persist would then drop ("shm holds step 2, wanted 1")."""
    engine = _engine(tmp_path)
    engine.save_to_memory(1, _port_state(_state()))
    handler = saver._shm_handlers[0]
    real_metadata = handler.metadata

    def slow_metadata():
        time.sleep(1.0)
        return real_metadata()

    monkeypatch.setattr(handler, "metadata", slow_metadata)
    persist = threading.Thread(target=saver.save_step_checkpoint,
                               args=(1,))
    persist.start()
    time.sleep(0.3)
    assert engine.save_to_memory(2, _port_state(_state()), block_lock=True)
    persist.join(timeout=60)
    assert not persist.is_alive()
    assert read_last_checkpoint(str(tmp_path))[0] == 1
    assert handler.get_checkpoint_config().step == 2
    engine.close()


def test_a_memory_save_during_a_slow_storage_write_is_not_skipped(
        saver, tmp_path, monkeypatch):
    """The shard's shm lock is released once the private copy is taken:
    a synchronous memory save of the next step (non-blocking lock)
    lands in shm while the persist's storage write is still running,
    and the persisted step is the one copied."""
    engine = _engine(tmp_path)
    engine.save_to_memory(1, _port_state(_state()))
    handler = saver._shm_handlers[0]
    real_write = saver.storage.write
    writing = threading.Event()

    def slow_write(*args, **kwargs):
        writing.set()
        time.sleep(1.0)
        return real_write(*args, **kwargs)

    monkeypatch.setattr(saver.storage, "write", slow_write)
    persist = threading.Thread(target=saver.save_step_checkpoint,
                               args=(1,))
    persist.start()
    assert writing.wait(timeout=30)
    assert engine.save_to_memory(2, _port_state(_state()))
    assert handler.get_checkpoint_config().step == 2
    persist.join(timeout=60)
    assert not persist.is_alive()
    assert read_last_checkpoint(str(tmp_path))[0] == 1
    engine.close()


def test_async_snapshot_stall_and_integrity(saver, tmp_path):
    """The async flash save returns before the shm write and keeps the
    values of the call: in-place updates of every leaf right after it
    returns do not reach the snapshot."""
    engine = _engine(tmp_path)
    want = _state("bfloat16")
    live = _port_state(want)
    assert engine.save_to_storage(4, live)
    for t in jax.tree_util.tree_leaves(live):
        if isinstance(t, torch.Tensor):
            t.fill_(-123)
    assert engine.wait_async(timeout=30.0)
    assert engine._last_async_error is None
    step, got = engine.load()
    assert step == 4
    _assert_same(got, want)
    engine.close()


def test_async_snapshot_skips_when_busy(saver, tmp_path):
    engine = _engine(tmp_path)
    sd = _port_state(_state())
    # block the writer deterministically: save_to_memory waits on a
    # gate, and a save issued meanwhile is skipped
    gate = threading.Event()
    orig = engine.save_to_memory

    def gated(step, state, path="", **kw):
        gate.wait(timeout=30.0)
        return orig(step, state, path, **kw)

    engine.save_to_memory = gated
    assert engine.save_to_storage(2, sd)
    assert engine.save_to_storage(3, sd) is False
    gate.set()
    assert engine.wait_async(timeout=30.0)
    engine.save_to_memory = orig
    assert engine.save_to_storage(4, sd)
    assert engine.wait_async(timeout=30.0)
    step, _ = engine.load()
    assert step == 4
    engine.close()


def test_restore_to_template_copies_in_place(saver, tmp_path):
    """Restores come back as plain dicts of CPU tensors;
    restore_to_template copies them into the template's own tensors and
    rebuilds its named tuples and tuples."""
    template = {
        "p": torch.zeros(2, 3),
        "m": Moment(torch.zeros(4, dtype=torch.int8), torch.zeros(1)),
        "t": (torch.zeros((), dtype=torch.int64), 5),
    }
    want = {
        "p": torch.arange(6.0).reshape(2, 3),
        "m": Moment(torch.arange(4, dtype=torch.int8), torch.ones(1)),
        "t": (torch.tensor(9), 6),
    }
    engine = _engine(tmp_path)
    assert engine.save_to_memory(1, want)
    _, restored = engine.load()
    p = template["p"]
    rebuilt = restore_to_template(template, restored)
    assert rebuilt["p"] is p and torch.equal(p, want["p"])
    assert isinstance(rebuilt["m"], Moment) and isinstance(rebuilt["t"], tuple)
    assert torch.equal(rebuilt["m"].values, want["m"].values)
    assert int(rebuilt["t"][0]) == 9 and rebuilt["t"][1] == 6
    with pytest.raises(KeyError):
        restore_to_template(template, {"nope": {}})
    with pytest.raises(ValueError, match="template"):
        restore_to_template({"p": torch.zeros(3, 2)}, restored)
    engine.close()


def test_snapshot_packing_arithmetic(monkeypatch):
    """The CUDA snapshot's packing on host tensors: leaves back to back
    in groups of ``_CAT_BYTES``, and D2H pieces merged where two leaves
    are adjacent both in the buffer and in the segment."""
    from dlrover_tpu_torch.checkpoint import engine as port_engine
    from dlrover_tpu_torch.checkpoint import shm_handler

    monkeypatch.setattr(port_engine, "_CAT_BYTES", 10)
    parts = [torch.arange(n, dtype=torch.uint8) for n in (3, 4, 9, 12, 1)]
    flat = torch.empty(29, dtype=torch.uint8)
    port_engine._cat_into(flat, parts)
    assert torch.equal(flat, torch.cat(parts))
    pieces = []
    shm_handler._add_piece(pieces, flat, 0, 3, 100)
    shm_handler._add_piece(pieces, flat, 3, 4, 103)
    shm_handler._add_piece(pieces, flat, 7, 9, 120)
    shm_handler._add_piece(pieces, parts[0], 0, 3, 129)
    assert [p[1:] for p in pieces] == [[0, 7, 100], [7, 9, 120], [0, 3, 129]]


# -- IPC and meta allowlists -------------------------------------------------


@pytest.mark.parametrize("message", [
    SaverConfig(checkpoint_dir="/x", local_shard_num=2),
    CheckpointEvent(step=3),
    {"tensors": {"a": TensorMeta(shape=(2,), offset=8, nbytes=8)},
     "config": CheckpointConfig(step=2)},
    comm.RemoteError("ValueError", "boom"),
])
def test_ipc_frames_carry_the_port_messages(message):
    got = comm._loads(pickle.dumps(message))
    assert type(got) is type(message)
    if not isinstance(message, Exception):
        assert got == message


@pytest.mark.parametrize("forbidden", [
    os.system, JaxSaver, jax_shm.TensorMeta(),
])
def test_ipc_frames_refuse_other_globals(forbidden):
    """A frame naming any global outside the schema is refused, the JAX
    package's classes included (the port allows dlrover_tpu_torch. and
    nothing broader)."""
    with pytest.raises(pickle.UnpicklingError, match="forbidden"):
        comm._loads(pickle.dumps(forbidden))


@pytest.mark.parametrize("kind", [SharedLock, SharedQueue, SharedDict])
def test_ipc_server_thread_ends_on_close(monkeypatch, kind):
    """Closing an agent-side IPC object ends its serving thread, with
    no exception, after it has served a client."""
    errors = []
    monkeypatch.setattr(threading, "excepthook",
                        lambda args: errors.append(args.exc_value))
    name = f"close-{uuid.uuid4().hex[:8]}"
    host = kind(name, create=True)
    client = kind(name, create=False)
    if kind is SharedQueue:
        client.put(1)
    elif kind is SharedDict:
        client.update({"a": 1})
    else:
        assert client.acquire(timeout=5)
    server = next(t for t in threading.enumerate()
                  if t.name == f"ipc-{name}")
    host.close()
    server.join(timeout=5)
    assert not server.is_alive() and errors == []


def test_meta_reader_maps_the_jax_classes_and_refuses_the_rest():
    meta = {"tensors": {"w": jax_shm.TensorMeta(shape=(3,), dtype="int8")},
            "config": jax_shm.CheckpointConfig(step=4, world_size=2)}
    got = load_meta(pickle.dumps(meta))
    assert got["tensors"]["w"] == TensorMeta(shape=(3,), dtype="int8")
    assert got["config"] == CheckpointConfig(step=4, world_size=2)
    with pytest.raises(pickle.UnpicklingError, match="forbidden"):
        load_meta(pickle.dumps({"x": os.system}))


def test_a_lock_whose_holder_died_is_taken_over(tmp_path):
    """A trainer SIGKILLed while its snapshot writer holds the shm lock
    leaves no lock behind: the next acquire (the respawned trainer's
    writer, the agent's persist) takes it over at once."""
    import signal
    import subprocess
    import sys

    server = SharedLock(f"deadholder_{uuid.uuid4().hex[:8]}", create=True)
    child = subprocess.Popen(
        [sys.executable, "-c",
         "import sys, time\n"
         "from dlrover_tpu_torch.common.multi_process import SharedLock\n"
         "lock = SharedLock(sys.argv[1], create=False)\n"
         "assert lock.acquire(blocking=False)\n"
         "print('held', flush=True)\n"
         "time.sleep(60)\n", server._name],
        stdout=subprocess.PIPE, text=True,
        env={**os.environ, "PYTHONPATH": os.path.dirname(
            os.path.dirname(os.path.abspath(__file__)))})
    try:
        assert child.stdout.readline().strip() == "held"
        assert server.locked() and not server.acquire(blocking=False)
        child.send_signal(signal.SIGKILL)
        child.wait(timeout=30)
        assert server.acquire(blocking=True, timeout=5.0)
        assert server.release()
    finally:
        if child.poll() is None:
            child.kill()
        server.close()


# -- what later slices bring ---------------------------------------------------


def _sharded_restore_with_an_adapter(d):
    from dlrover_tpu_torch.rl.elastic import PPOStateAdapter

    engine = _engine(d)
    engine.register_sparse(PPOStateAdapter(None, include_roles=False))
    return engine.load_sharded({"w": torch.zeros(2)})


def test_object_store_path_builds_fsspec_storage(saver):
    """A Checkpointer over a ``proto://`` directory builds on
    ``FsspecStorage`` (``tests/test_torch_fsspec_storage.py`` drives
    it).  The options once refused here came with their slices: the
    target-state restore and the orbax tier with slice 4.2
    (``test_options_of_slice_4_2_no_longer_raise``), the adapter
    contract of ``register_sparse`` with slice 7
    (``tests/test_torch_rl_elastic.py``), a resharded restore with an
    adapter with the sparse slice
    (``test_options_of_the_sparse_slice_no_longer_raise``), and the
    object-store tier with slice 8.3."""
    from dlrover_tpu_torch.common.storage import FsspecStorage

    ckpt = Checkpointer("memory://bucket/run")
    try:
        assert isinstance(ckpt._engine._storage, FsspecStorage)
    finally:
        ckpt.close()


@pytest.mark.parametrize("make", [
    lambda d: _engine(d).load_sharded({}),
    lambda d: Checkpointer(str(d), orbax_dir=str(d / "orbax")).close(),
], ids=["load_sharded", "orbax_dir"])
def test_options_of_slice_4_2_no_longer_raise(saver, tmp_path, make):
    """An empty target restores nothing; a Checkpointer takes an orbax
    directory."""
    out = make(tmp_path)
    assert out in (None, (None, {}))


def test_options_of_the_sparse_slice_no_longer_raise(saver, tmp_path,
                                                     monkeypatch):
    """``load_sharded`` with an adapter registered and nothing saved
    restores nothing; an engine starts under ``DLROVER_SHM_PAGED``."""
    assert _sharded_restore_with_an_adapter(tmp_path) == (None, {})
    monkeypatch.setenv("DLROVER_SHM_PAGED", "1")
    _engine(tmp_path).close()


def test_paged_tier_raises(saver, tmp_path, monkeypatch):
    """The paged tier (``DLROVER_SHM_PAGED``) refuses what it cannot
    hold: a delta page on a segment with no paged epoch raises
    ``PagedNeedBase`` (the engine then re-exports a base); the engine's
    first paged save is a base, and it restores."""
    from dlrover_tpu_torch.checkpoint.shm_handler import PagedNeedBase

    monkeypatch.setenv("DLROVER_SHM_PAGED", "1")
    engine = _engine(tmp_path)
    handler = engine._shm_handler
    with pytest.raises(PagedNeedBase, match="no valid paged epoch"):
        handler.save_state_dict_paged(
            {"w": np.zeros(4, np.float32)}, CheckpointConfig(step=1),
            kv_payload=("delta", {}))
    assert engine.save_to_memory(1, {"w": torch.ones(4)})
    assert engine.last_save_phases["kind"] == "base"
    step, state = engine.load()
    assert step == 1 and torch.equal(state["w"], torch.ones(4))
    handler.unlink()
    engine.close()


# -- on the card ---------------------------------------------------------------


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_side_stream_snapshot_against_in_place_update(saver, tmp_path, cuda):
    """Writes queued on the current stream before a save reach the
    snapshot, and writes queued right after it do not, bit for bit: the
    side stream waits for the current stream, and the current stream for
    the copy.  A sleep kernel holds the current stream while the host
    queues each round, so that both orders are really raced on the
    card, and the current stream has a high priority: once the copy and
    the writes after the save are both ready, the writes' blocks are
    dispatched ahead of the copy's remaining ones.  Four rounds.  A
    first save and a pass of every kernel of the race come first: the
    first launch of a kernel loads its module, which can wait for the
    card to go idle, and the race would then not happen."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    live = {"w": torch.randn(4096, 4096, generator=gen, device=cuda),
            "m": torch.randint(-127, 127, (1 << 22,), generator=gen,
                               device=cuda, dtype=torch.int8)}
    engine = _engine(tmp_path)
    assert engine.save_to_storage(0, live) and engine.wait_async(60.0)
    race = torch.cuda.Stream(priority=-1)
    race.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(race):
        spare = {k: torch.empty_like(v) for k, v in live.items()}
        torch.cuda._sleep(1000)
        spare["w"].fill_(7.0).mul_(1.5).add_(1.0)
        spare["m"].fill_(3).add_(1)
    torch.cuda.synchronize()
    for rnd in range(1, 5):
        with torch.cuda.stream(race):
            torch.cuda._sleep(100_000_000)
            slept = torch.cuda.Event()
            slept.record()
            live["w"].fill_(7.0 * rnd)
            live["m"].fill_(rnd)
            assert engine.save_to_storage(rnd, live)
            for _ in range(8):
                live["w"].mul_(1.5).add_(1.0)
                live["m"].add_(1)
            assert not slept.query(), "the sleep ended before the race"
        assert engine.wait_async(60.0) and engine._last_async_error is None
        step, got = engine.load()
        assert step == rnd
        assert torch.equal(got["w"], torch.full((4096, 4096), 7.0 * rnd))
        assert torch.equal(got["m"], torch.full((1 << 22,), rnd,
                                                dtype=torch.int8))
        w = torch.full((4096, 4096), 7.0 * rnd)
        for _ in range(8):
            w.mul_(1.5).add_(1.0)
        assert torch.equal(live["w"].cpu(), w)
        assert torch.equal(live["m"].cpu(), torch.full((1 << 22,), rnd + 8,
                                                      dtype=torch.int8))
    engine.close()
