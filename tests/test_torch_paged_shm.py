"""The paged shm tier of the PyTorch port (``DLROVER_SHM_PAGED``)
against the JAX package.

- The verify recipe: a child process runs a real ``CheckpointEngine``
  with a ``SparseStateAdapter`` under ``DLROVER_SHM_PAGED=1``, saves a
  base and then a delta after touching 1% of its rows, and SIGKILLs
  itself; the parent builds a FRESH engine and adapter under the same
  job name (the meta host died with the child: the segment stands
  alone) and ``load()`` returns the delta's generation with every row,
  frequency and slot equal to what the child saved (by digest), while
  the ``checkpoint_shm_save`` events show the delta moved at least 10x
  fewer bytes than the base.
- The segment layout is the JAX package's byte for byte: a paged base +
  delta written by either package's handler loads through the other's,
  dense leaves and kv rows bit for bit.
- A paged restore equals a flat restore of the same state; a torn
  directory slot falls back to the previous generation and two torn
  slots refuse the snapshot; the agent's persist gets the flat layout;
  a paged snapshot of another world is refused.
- The tower's tensors on the card in a paged save:
  ``tests/test_torch_sparse_cuda.py``.
"""

import os
import shutil
import struct
import subprocess
import sys
import tempfile
import uuid

import numpy as np
import pytest
import torch

from dlrover_tpu.checkpoint import shm_handler as jax_shm
from dlrover_tpu.checkpoint import sparse as jsp
from dlrover_tpu.checkpoint.saver import AsyncCheckpointSaver as JaxSaver
from dlrover_tpu.ops import kv_variable as jkv
from dlrover_tpu_torch.checkpoint import shm_handler as port_shm
from dlrover_tpu_torch.checkpoint import sparse as tsp
from dlrover_tpu_torch.checkpoint.engine import CheckpointEngine
from dlrover_tpu_torch.checkpoint.saver import AsyncCheckpointSaver
from dlrover_tpu_torch.ops import kv_variable as tkv

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = {"jax": (jkv, jsp, jax_shm), "port": (tkv, tsp, port_shm)}


@pytest.fixture(autouse=True)
def job(monkeypatch):
    name = f"pg-{uuid.uuid4().hex[:12]}"
    sockets = tempfile.mkdtemp(prefix="dlp")
    monkeypatch.setenv("DLROVER_JOB_NAME", name)
    monkeypatch.setenv("DLROVER_SHARED_DIR", sockets)
    AsyncCheckpointSaver.reset()
    JaxSaver.reset()
    yield name
    AsyncCheckpointSaver.reset()
    JaxSaver.reset()
    h = port_shm.SharedMemoryHandler(0)
    h.unlink()
    h.close()
    shutil.rmtree(sockets, ignore_errors=True)


def _adapter(pkg="port", seed=7, n=500, dim=4):
    kv, sp, _ = PKGS[pkg]
    t = kv.KvVariable(dim=dim, initial_capacity=64, seed=seed, name="emb")
    opt = kv.GroupAdamOptimizer(t, learning_rate=1e-2)
    keys = np.arange(n, dtype=np.int64)
    opt.apply_gradients(keys, np.tanh(t.gather(keys)) * 0.1)
    a = sp.SparseStateAdapter(digest=True)
    a.register_optimizer(opt)
    return t, opt, a


def _touch(opt, step, n=500, batch=64):
    keys = np.random.default_rng(1000 + step).integers(
        0, n, batch).astype(np.int64)
    opt.apply_gradients(keys, np.tanh(opt.table.gather(keys)) * 0.1)


def _dense(step):
    rng = np.random.default_rng(100 + step)
    return {
        "w": rng.normal(size=(300,)).astype(np.float32),
        "b": np.full((32,), float(step), np.float32),
        "frozen": np.arange(64, dtype=np.int32),
        "step": step,
    }


def _digests(adapter):
    out = {}
    for name, t in adapter.tables.items():
        k, v, f = t.export()
        out[name] = tsp.rows_digest(k, v, f)
    return out


def _kv_rows(flat, table="emb"):
    k = np.asarray(flat[f"{tsp.KV_STATE_KEY}/{table}/keys"])
    v = np.asarray(flat[f"{tsp.KV_STATE_KEY}/{table}/values"])
    f = np.asarray(flat[f"{tsp.KV_STATE_KEY}/{table}/freq"])
    order = np.argsort(k, kind="stable")
    return k[order], v[order], f[order]


_CHILD = r'''
import json, os, signal, sys
import numpy as np
import torch
from dlrover_tpu_torch.checkpoint.engine import CheckpointEngine
from dlrover_tpu_torch.checkpoint.sparse import SparseStateAdapter, rows_digest
from dlrover_tpu_torch.ops.kv_variable import GroupAdamOptimizer, KvVariable

out = sys.argv[1]
t = KvVariable(dim=8, initial_capacity=64, seed=7, name="emb")
opt = GroupAdamOptimizer(t, learning_rate=1e-2)
keys = np.arange(5000, dtype=np.int64)
opt.apply_gradients(keys, np.tanh(t.gather(keys)) * 0.1)
adapter = SparseStateAdapter(digest=True)
adapter.register_optimizer(opt)
engine = CheckpointEngine(sys.argv[2], replicated=True, local_rank=0,
                          global_rank=0, world_size=1)
engine.register_sparse(adapter)
dense = {"w": torch.zeros(4096), "step": 0}
assert engine.save_to_memory(1, dense)
touched = np.arange(0, 5000, 100, dtype=np.int64)  # 1% of the rows
opt.apply_gradients(touched, np.tanh(t.gather(touched)) * 0.1)
assert engine.save_to_memory(2, dense)
digests = {}
for name, tbl in adapter.tables.items():
    k, v, f = tbl.export()
    digests[name] = rows_digest(k, v, f)
with open(out, "w") as f:
    json.dump({"digests": digests, "step": opt.step}, f)
os.kill(os.getpid(), signal.SIGKILL)
'''


def test_verify_recipe_sigkilled_child_and_a_fresh_engine(tmp_path, job,
                                                          monkeypatch):
    import json

    from dlrover_tpu_torch.telemetry.events import EVENT_LOG_ENV

    evlog = tmp_path / "events.jsonl"
    script = tmp_path / "child.py"
    script.write_text(_CHILD)
    env = dict(os.environ, DLROVER_SHM_PAGED="1", DLROVER_JOB_NAME=job,
               PYTHONPATH=ROOT, **{EVENT_LOG_ENV: str(evlog)})
    child = subprocess.run(  # noqa: S603
        [sys.executable, str(script), str(tmp_path / "saved.json"),
         str(tmp_path / "ckpt")], env=env, timeout=120)
    assert child.returncode == -9  # SIGKILLed itself
    saved = json.loads((tmp_path / "saved.json").read_text())

    ev = [json.loads(line) for line in evlog.read_text().splitlines()]
    saves = [e for e in ev if e.get("type") == "checkpoint_shm_save"]
    assert [e["kind"] for e in saves] == ["base", "delta"]
    base, delta = saves
    assert delta["generation"] == base["generation"] + 1
    assert delta["bytes_skipped"] > 0  # the dense leaf was unchanged
    assert base["bytes"] >= 10 * delta["bytes"], (base, delta)

    # the parent: fresh tables, a fresh engine, the meta host gone
    monkeypatch.setenv("DLROVER_SHM_PAGED", "1")
    t = tkv.KvVariable(dim=8, seed=99, name="emb")
    opt = tkv.GroupAdamOptimizer(t, learning_rate=1e-2)
    adapter = tsp.SparseStateAdapter(digest=True)
    adapter.register_optimizer(opt)
    engine = CheckpointEngine(str(tmp_path / "ckpt"), replicated=True,
                              local_rank=0, global_rank=0, world_size=1)
    engine.register_sparse(adapter)
    assert engine._shm_handler.paged_generation() == delta["generation"]
    step, state = engine.load()
    assert step == 2 and engine.last_restore_phases["tier"] == "shm"
    assert torch.equal(state["w"], torch.zeros(4096))
    assert tsp.KV_STATE_KEY not in state
    assert {n: int(v) for n, v in _digests(adapter).items()} == \
        {n: int(v) for n, v in saved["digests"].items()}
    assert opt.step == saved["step"]
    engine.close()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_a_paged_segment_loads_in_the_other_package(writer, job):
    """Base then delta (a 1% touch, one dense leaf changed) from one
    package's handler; the other package's handler, with a fresh meta
    host, reads generation 2 through the segment's own directory."""
    reader = "port" if writer == "jax" else "jax"
    _, opt, a = _adapter(writer)
    w = PKGS[writer][2].SharedMemoryHandler(0, host=True)
    for step in (1, 2):
        if step == 2:
            _touch(opt, step)
        w.save_state_dict_paged(
            _dense(step), PKGS[writer][2].CheckpointConfig(step=step),
            kv_payload=a.export_for_shm(step=step))
    phases = dict(w.last_save_phases)
    want_rows = a.tables["emb"].export()
    w.close()
    assert phases["kind"] == "delta" and phases["bytes_skipped"] > 0
    r = PKGS[reader][2].SharedMemoryHandler(0, host=True)
    try:
        assert r.paged_generation() == 2
        cfg, flat, _ = r.load_flat()
        assert cfg.step == 2
        for key, val in _dense(2).items():
            if isinstance(val, np.ndarray):
                assert np.asarray(flat[key]).tobytes() == val.tobytes()
            else:
                assert flat[key] == val
        k, v, f = _kv_rows(flat)
        order = np.argsort(want_rows[0], kind="stable")
        np.testing.assert_array_equal(k, want_rows[0][order])
        assert v.tobytes() == want_rows[1][order].tobytes()
        np.testing.assert_array_equal(f, want_rows[2][order])
    finally:
        r.close()


def test_paged_restore_equals_the_flat_restore_and_persists_flat(job):
    """Three paged saves (base, two deltas) and one flat save of the
    same final state read back alike; the agent's ``read_raw`` of the
    paged segment is the flat layout of that state."""
    _, opt, a = _adapter()
    h = port_shm.SharedMemoryHandler(0, host=True)
    for step in (1, 2, 3):
        _touch(opt, step)
        h.save_state_dict_paged(
            _dense(step), port_shm.CheckpointConfig(step=step),
            kv_payload=a.export_for_shm(step=step, full_every=0))
    assert h.last_save_phases["kind"] == "delta"
    _, paged, _ = h.load_flat()
    config, raw, meta = h.read_raw()
    assert meta["paged_generation"] == 3 and config.step == 3
    persisted, _ = port_shm.flat_from_raw(meta, raw)
    state = dict(_dense(3), **{tsp.KV_STATE_KEY: a.export_state()})
    h.save_state_dict(state, port_shm.CheckpointConfig(step=3))
    _, flat, _ = h.load_flat()
    h.unlink()
    h.close()
    for got in (paged, persisted):
        assert set(got) == set(flat)
        for key in ("w", "b", "frozen"):
            assert got[key].numpy().tobytes() == \
                flat[key].numpy().tobytes()
        assert got["step"] == flat["step"] == 3
        for table in a.tables:
            for x, y in zip(_kv_rows(got, table), _kv_rows(flat, table)):
                assert x.tobytes() == y.tobytes()


def test_torn_directory_falls_back_then_refuses(job):
    _, opt, a = _adapter()
    h = port_shm.SharedMemoryHandler(0, host=True)
    for step in (1, 2):
        _touch(opt, step)
        h.save_state_dict_paged(
            _dense(step), port_shm.CheckpointConfig(step=step),
            kv_payload=a.export_for_shm(step=step))
    buf = h._shm.buf
    active = buf[8]
    (dir_cap,) = struct.unpack_from("<I", buf, 12)
    off = port_shm._PAGED_HDR + active * dir_cap
    buf[off + 20] ^= 0xFF  # tear the active slot's pickle
    assert h.paged_generation() == 1
    cfg, flat, _ = h.load_flat()
    assert cfg.step == 1 and flat["b"][0] == 1.0
    other = port_shm._PAGED_HDR + (1 - active) * dir_cap
    buf[other + 20] ^= 0xFF
    assert h.paged_generation() == 0
    assert h.load_flat()[0] is None
    h.unlink()
    h.close()


def test_paged_shm_refused_across_worlds(tmp_path, monkeypatch):
    monkeypatch.setenv("DLROVER_SHM_PAGED", "1")
    _, opt, a = _adapter()
    h = port_shm.SharedMemoryHandler(0, host=True)
    h.save_state_dict_paged(
        _dense(1), port_shm.CheckpointConfig(step=1, world_size=2),
        kv_payload=a.export_for_shm(step=1))
    AsyncCheckpointSaver.reset()
    engine = CheckpointEngine(str(tmp_path / "ckpt"), replicated=True,
                              local_rank=0, global_rank=0, world_size=1)
    engine.register_sparse(a)
    step, _ = engine.load()
    assert step is None
    assert engine.last_restore_phases.get("tier") != "shm"
    h.unlink()
    h.close()
    engine.close()


if __name__ == "__main__":
    sys.exit(pytest.main([__file__, "-q"]))
