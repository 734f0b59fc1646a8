"""The sparse adapter of the PyTorch port and its checkpoint paths
against the JAX package.

Tables made from a seed with numpy are trained alike in both packages
(their stores are one C++ source: ``tests/test_torch_kv_variable.py``).
Held bit for bit (tolerance: none):

- the hash, the owner partition and the digests (``_hash64``,
  ``owner_of_keys``, ``rows_digest``, ``keys_digest``) and
  ``merge_kv_states`` on the same inputs;
- ``SparseStateAdapter`` blobs: full exports, the storage delta chain
  (``export_for_checkpoint`` with delta checkpoints, its link metadata,
  its replay through ``import_chain``), the shm tier's base + delta
  exports;
- the engine: shm and storage round trips that strip ``__kv__``, a
  storage restore in a fresh process, the delta chain replayed from
  committed step dirs, the cross-world reshard that refuses the shm
  tier, and ``load_sharded`` with an adapter on both tiers;
- blobs crossing the packages: the raw bytes of an shm snapshot and a
  committed step dir (a delta chain among them) written by either
  package restore the other package's tables.

Then the chaos invariants' verdicts on hand-made event lists and the
pipeline's ``attach_checkpoint``.
"""

import os
import shutil
import tempfile
import time
import uuid

import numpy as np
import pytest
import torch

from dlrover_tpu.checkpoint import engine as jax_engine
from dlrover_tpu.checkpoint import sparse as jsp
from dlrover_tpu.checkpoint import shm_handler as jax_shm
from dlrover_tpu.checkpoint.saver import AsyncCheckpointSaver as JaxSaver
from dlrover_tpu.checkpoint.saver import SaverConfig as JaxSaverConfig
from dlrover_tpu.ops import kv_variable as jkv
from dlrover_tpu_torch.checkpoint import shm_handler as port_shm
from dlrover_tpu_torch.checkpoint import sparse as tsp
from dlrover_tpu_torch.checkpoint.engine import CheckpointEngine
from dlrover_tpu_torch.checkpoint.saver import (
    AsyncCheckpointSaver,
    SaverConfig,
)
from dlrover_tpu_torch.common.constants import CheckpointConstant
from dlrover_tpu_torch.ops import kv_variable as tkv

PKGS = {"jax": (jkv, jsp), "port": (tkv, tsp)}


@pytest.fixture(autouse=True)
def job(monkeypatch):
    """A shm namespace and a socket directory of the test's own; both
    packages' in-process savers stopped and the segment unlinked
    afterwards."""
    name = f"sp-{uuid.uuid4().hex[:12]}"
    sockets = tempfile.mkdtemp(prefix="dls")
    monkeypatch.setenv("DLROVER_JOB_NAME", name)
    monkeypatch.setenv("DLROVER_SHARED_DIR", sockets)
    AsyncCheckpointSaver.reset()
    JaxSaver.reset()
    yield name
    AsyncCheckpointSaver.reset()
    JaxSaver.reset()
    port_shm.SharedMemoryHandler(0).unlink()
    port_shm.SharedMemoryHandler(1).unlink()
    shutil.rmtree(sockets, ignore_errors=True)


def _sorted(export):
    k, v, f = (np.asarray(x) for x in export)
    order = np.argsort(k)
    return k[order], v[order], f[order]


def _assert_rows_equal(a, b):
    ka, va, fa = _sorted(a)
    kb, vb, fb = _sorted(b)
    np.testing.assert_array_equal(ka, kb)
    assert va.tobytes() == vb.tobytes()
    np.testing.assert_array_equal(fa, fb)


def _assert_tables_equal(a, b):
    _assert_rows_equal(a.export(), b.export())


def _train(opt, steps=6, n_keys=400, batch=96, seed=42):
    krng = np.random.default_rng(seed)
    for _ in range(steps):
        keys = krng.integers(0, n_keys, batch).astype(np.int64)
        opt.apply_gradients(keys, np.tanh(opt.table.gather(keys)) * 0.1)


def _adapter(pkg="port", seed=3, steps=6, digest=True):
    kv, sp = PKGS[pkg]
    t = kv.KvVariable(dim=4, seed=seed, name="emb")
    opt = kv.GroupAdamOptimizer(t, learning_rate=1e-2)
    a = sp.SparseStateAdapter(digest=digest)
    a.register_optimizer(opt)
    _train(opt, steps=steps)
    return t, opt, a


def _assert_adapters_equal(a, b):
    assert list(a.tables) == list(b.tables)
    for name in a.tables:
        _assert_tables_equal(a.tables[name], b.tables[name])
    for oa, ob in zip(a._optimizers, b._optimizers):
        assert oa.state_scalars() == ob.state_scalars()


def _assert_blobs_equal(x, y):
    """Two nested kv exports hold the same tables, rows, tombstones and
    scalars."""
    assert set(x) == set(y)
    for name in x:
        if name in (tsp.SCALARS_KEY, tsp.KV_META_KEY):
            assert x[name] == y[name], name
            continue
        _assert_rows_equal(
            (x[name]["keys"], x[name]["values"], x[name]["freq"]),
            (y[name]["keys"], y[name]["values"], y[name]["freq"]))
        if "dead" in x[name] or "dead" in y[name]:
            np.testing.assert_array_equal(
                np.sort(np.asarray(x[name]["dead"])),
                np.sort(np.asarray(y[name]["dead"])))


def _wait_commit(ckpt_dir, step, timeout=30):
    tracker = os.path.join(str(ckpt_dir), CheckpointConstant.TRACKER_FILE)
    deadline = time.time() + timeout
    while time.time() < deadline:
        try:
            with open(tracker) as fh:
                if int(fh.read().strip() or -1) >= step:
                    return
        except (OSError, ValueError):
            pass
        time.sleep(0.05)
    raise AssertionError(f"step {step} never committed")


def _port_saver(ckpt_dir, shards=1):
    AsyncCheckpointSaver.reset()
    s = AsyncCheckpointSaver(SaverConfig(
        checkpoint_dir=str(ckpt_dir), local_shard_num=shards,
        global_shard_num=shards, node_rank=0))
    AsyncCheckpointSaver._instance = s
    return s


def _jax_saver(ckpt_dir):
    JaxSaver.reset()
    s = JaxSaver(JaxSaverConfig(
        checkpoint_dir=str(ckpt_dir), local_shard_num=1,
        global_shard_num=1, node_rank=0))
    JaxSaver._instance = s
    return s


def _engine(ckpt_dir, pkg="port", **kw):
    kw.setdefault("replicated", True)
    kw.setdefault("local_rank", 0)
    kw.setdefault("global_rank", 0)
    kw.setdefault("world_size", 1)
    cls = CheckpointEngine if pkg == "port" else jax_engine.CheckpointEngine
    return cls(str(ckpt_dir), **kw)


# -- hashes, digests and the chain merge ----------------------------------


@pytest.mark.parametrize("world", [1, 2, 3, 7])
def test_hash_owner_and_digests_match_the_jax_package(world):
    rng = np.random.default_rng(world)
    keys = rng.integers(-2**62, 2**62, 5000).astype(np.int64)
    vals = rng.normal(size=(5000, 6)).astype(np.float32)
    freq = rng.integers(0, 1000, 5000).astype(np.uint64)
    np.testing.assert_array_equal(jsp._hash64(keys), tsp._hash64(keys))
    np.testing.assert_array_equal(jsp.owner_of_keys(keys, world),
                                  tsp.owner_of_keys(keys, world))
    assert jsp.rows_digest(keys, vals, freq) == \
        tsp.rows_digest(keys, vals, freq)
    assert jsp.keys_digest(keys) == tsp.keys_digest(keys)
    # order independent and additive across disjoint shards
    perm = rng.permutation(5000)
    assert tsp.rows_digest(keys[perm], vals[perm], freq[perm]) == \
        tsp.rows_digest(keys, vals, freq)
    own = tsp.owner_of_keys(keys, world)
    parts = sum(tsp.rows_digest(keys[own == r], vals[own == r],
                                freq[own == r]) for r in range(world))
    assert parts % (1 << 64) == tsp.rows_digest(keys, vals, freq)
    # torch CPU tensors (what the port's restore paths hand out) digest
    # as their numpy views do
    assert tsp.rows_digest(torch.from_numpy(keys), torch.from_numpy(vals),
                           torch.from_numpy(freq)) == \
        tsp.rows_digest(keys, vals, freq)


def test_merge_kv_states_matches_the_jax_package():
    rng = np.random.default_rng(9)

    def blob(keys, dead=()):
        return {"emb": {
            "keys": np.asarray(keys, np.int64),
            "values": rng.normal(size=(len(keys), 3)).astype(np.float32),
            "freq": rng.integers(1, 9, len(keys)).astype(np.uint64),
            "dead": np.asarray(dead, np.int64)},
            tsp.SCALARS_KEY: {"emb": {"step": int(rng.integers(9))}}}

    base = blob(range(0, 50))
    deltas = [blob(range(40, 60), dead=[1, 2, 3]),
              blob([2, 70, 71], dead=[45, 71])]
    _assert_blobs_equal(jsp.merge_kv_states(base, deltas),
                        tsp.merge_kv_states(base, deltas))


# -- adapter blobs -------------------------------------------------------


def test_adapter_exports_and_import_match_the_jax_package():
    _, _, ja = _adapter("jax")
    _, _, ta = _adapter("port")
    _assert_adapters_equal(ja, ta)
    jb, tb = ja.export_state(step=3), ta.export_state(step=3)
    _assert_blobs_equal(jb, tb)
    # each package's blob restores the other package's tables
    _, _, ja2 = _adapter("jax", seed=50, steps=1)
    _, _, ta2 = _adapter("port", seed=50, steps=1)
    ja2.import_state(tb, tier="shm", step=3)
    ta2.import_state(jb, tier="shm", step=3)
    _assert_adapters_equal(ja2, ta)
    _assert_adapters_equal(ta2, ja)


def test_delta_chain_links_match_and_replay_to_the_live_tables():
    """Five durable exports at base cadence 3 in both packages: links
    base, delta, delta, base, delta, with the same metadata and rows;
    replaying the last chain in either package gives the live tables."""
    links = {}
    for pkg in PKGS:
        _, opt, a = _adapter(pkg, steps=2)
        a.enable_delta_checkpoints(full_every=3)
        out = []
        for i, step in enumerate((2, 4, 6, 8, 10)):
            _train(opt, steps=1, seed=100 + i)
            if i == 2:
                a.tables["emb"].delete(np.arange(5, dtype=np.int64))
            out.append(a.export_for_checkpoint(step=step, durable=True))
        links[pkg] = (out, a)
    kinds = [b[tsp.KV_META_KEY]["kind"] for b in links["port"][0]]
    assert kinds == ["base", "delta", "delta", "base", "delta"]
    for jb, tb in zip(links["jax"][0], links["port"][0]):
        _assert_blobs_equal(jb, tb)
    assert tsp.SparseStateAdapter.chain_steps(
        links["port"][0][-1][tsp.KV_META_KEY]) == [8]
    for pkg, (blobs, live) in links.items():
        _, _, fresh = _adapter("port", seed=77, steps=1)
        info = fresh.import_chain(blobs[3:], tier="storage", step=10)
        assert info["kv_chain"] == 2
        _assert_adapters_equal(fresh, live)
    # the chain with the tombstones: links 0-2
    _, _, fresh = _adapter("port", seed=77, steps=1)
    fresh.import_chain(links["jax"][0][:3])
    assert 0 not in set(fresh.tables["emb"].export()[0].tolist())


def test_shm_exports_rebase_on_poison_and_cadence():
    for pkg in PKGS:
        _, opt, a = _adapter(pkg, steps=2)
        kinds = []
        for i in range(5):
            _train(opt, steps=1, seed=i)
            if i == 3:
                a.shm_chain_poison()
            kinds.append(a.export_for_shm(step=i, full_every=3)[0])
        assert kinds == ["base", "delta", "delta", "base", "delta"], pkg


# -- the engine ----------------------------------------------------------


def test_engine_shm_round_trip_strips_kv(tmp_path):
    _port_saver(tmp_path / "ckpt")
    t, opt, adapter = _adapter()
    engine = _engine(tmp_path / "ckpt")
    engine.register_sparse(adapter)
    dense = {"w": torch.arange(6, dtype=torch.float32), "step": 5}
    assert engine.save_to_memory(5, dense)
    snapshot = t.export()
    _train(opt, steps=3, seed=77)  # diverge the table
    step, state = engine.load()
    assert step == 5 and tsp.KV_STATE_KEY not in state
    assert torch.equal(state["w"], dense["w"])
    _assert_rows_equal(t.export(), snapshot)
    assert engine.last_restore_phases["kv_rows"] > 0
    engine.close()


def test_engine_storage_round_trip_and_delta_chain_fresh_process(
        tmp_path):
    """Durable saves with delta checkpoints (base every 3): a fresh
    engine and fresh tables with the shm segment gone replay the chain
    of the last committed step from its step dirs."""
    ckpt = tmp_path / "ckpt"
    _port_saver(ckpt)
    t, opt, adapter = _adapter()
    adapter.enable_delta_checkpoints(full_every=3)
    engine = _engine(ckpt)
    engine.register_sparse(adapter)
    for step in (1, 2, 3, 4, 5):
        _train(opt, steps=1, seed=step)
        assert engine.save_to_storage(step, {"w": torch.ones(4) * step})
        assert engine.wait_async(timeout=30)
        _wait_commit(ckpt, step)
    live = {n: tb.export() for n, tb in adapter.tables.items()}
    engine.close()

    t2, opt2, adapter2 = _adapter(seed=50, steps=1)
    e2 = _engine(ckpt)
    e2._shm_handler.unlink()  # the kill dropped the shm segment
    e2.register_sparse(adapter2)
    step, state = e2.load()
    assert step == 5 and tsp.KV_STATE_KEY not in state
    assert torch.equal(state["w"], torch.ones(4) * 5)
    for name, tb in adapter2.tables.items():
        _assert_rows_equal(tb.export(), live[name])
    assert opt2.step == opt.step
    assert e2.last_restore_phases["tier"] == "storage"
    assert e2.last_restore_phases["kv_chain"] == 2  # base 4 + delta 5
    e2.close()


def test_engine_cross_world_reshards_and_refuses_shm(tmp_path):
    """Two world-2 ranks commit their hash-partitioned shards; a world-1
    restore refuses the (world-2) shm snapshot and reshards the union
    from storage, streaming, exactly once."""
    ckpt = tmp_path / "ckpt"
    _port_saver(ckpt, shards=2)
    ranks = {}
    for rank in range(2):
        t = tkv.KvVariable(dim=4, seed=rank + 1, name="emb")
        opt = tkv.GroupAdamOptimizer(t, learning_rate=1e-2)
        a = tsp.SparseStateAdapter(digest=True)
        a.register_optimizer(opt)
        keys = np.arange(300, dtype=np.int64)
        mine = keys[tsp.owner_of_keys(keys, 2) == rank]
        opt.apply_gradients(mine, np.tanh(t.gather(mine)) * 0.1)
        e = _engine(ckpt, replicated=False, local_rank=rank,
                    global_rank=rank, world_size=2)
        e.register_sparse(a)
        ranks[rank] = (t, e, mine)
    # local rank 0's persist reads ALL local shards: rank 1 first
    assert ranks[1][1].save_to_storage(1, {"w": torch.full((2,), 1.0)})
    assert ranks[1][1].wait_async(timeout=30)
    assert ranks[0][1].save_to_storage(1, {"w": torch.full((2,), 0.0)})
    assert ranks[0][1].wait_async(timeout=30)
    _wait_commit(ckpt, 1)

    tn = tkv.KvVariable(dim=4, name="emb")
    an = tsp.SparseStateAdapter(digest=True)
    an.register_optimizer(tkv.GroupAdamOptimizer(tn, learning_rate=1e-2))
    en = _engine(ckpt, replicated=False, world_size=1)
    en.register_sparse(an)
    step, state = en.load()
    assert step == 1 and torch.equal(state["w"], torch.zeros(2))
    assert en.last_restore_phases["tier"] == "storage"
    assert en.last_restore_phases.get("kv_resharded") is True
    assert len(tn) == sum(len(r[2]) for r in ranks.values())
    for t_src, _e, mine in ranks.values():
        got = tn.gather(mine, insert_missing=False, count_freq=False)
        want = t_src.gather(mine, insert_missing=False, count_freq=False)
        assert got.tobytes() == want.tobytes()
    for _t, e, _m in ranks.values():
        e.close()
    en.close()


@pytest.mark.parametrize("tier", ["shm", "storage"])
def test_load_sharded_restores_the_adapter_beside_the_target(
        tmp_path, tier):
    ckpt = tmp_path / "ckpt"
    _port_saver(ckpt)
    t, opt, adapter = _adapter()
    engine = _engine(ckpt)
    engine.register_sparse(adapter)
    w = torch.arange(8, dtype=torch.float32)
    assert engine.save_to_storage(2, {"w": w.clone()})
    assert engine.wait_async(timeout=30)
    _wait_commit(ckpt, 2)
    live = t.export()
    engine.close()
    t2, _, adapter2 = _adapter(seed=9, steps=1)
    e2 = _engine(ckpt)
    if tier == "storage":
        e2._shm_handler.unlink()
    e2.register_sparse(adapter2)
    target = {"w": torch.zeros(8)}
    step, state = e2.load_sharded(target)
    assert step == 2 and e2.last_restore_phases["tier"] == tier
    assert state["w"] is target["w"] and torch.equal(target["w"], w)
    _assert_rows_equal(t2.export(), live)
    e2.close()


# -- blobs across the packages ----------------------------------------------


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_shm_snapshot_bytes_restore_in_the_other_package(tmp_path, writer):
    """One package's engine saves its tables to shm; the raw bytes and
    meta its handler reads back (what the agent persists) restore the
    other package's adapter through that package's own parser."""
    reader = "port" if writer == "jax" else "jax"
    (_jax_saver if writer == "jax" else _port_saver)(tmp_path / "ckpt")
    _, _, wa = _adapter(writer)
    eng = _engine(tmp_path / "ckpt", pkg=writer)
    eng.register_sparse(wa)
    dense = np.arange(5, dtype=np.float32)
    assert eng.save_to_memory(
        3, {"w": dense if writer == "jax" else torch.from_numpy(dense)})
    _config, raw, meta = eng._shm_handler.read_raw()
    eng.close()
    parse = (port_shm if reader == "port" else jax_shm).flat_from_raw
    flat, _ = parse(meta, raw)
    kv_flat, rest = PKGS[reader][1].SparseStateAdapter.split_flat(flat)
    np.testing.assert_array_equal(np.asarray(rest["w"]), dense)
    _, _, ra = _adapter(reader, seed=60, steps=1)
    ra.import_state(PKGS[reader][1].SparseStateAdapter.nest_flat(kv_flat),
                    tier="shm", step=3)
    _assert_adapters_equal(ra, wa)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_step_dirs_with_a_delta_chain_restore_in_the_other_package(
        tmp_path, writer):
    """Five committed durable saves with delta checkpoints (base every
    3: steps 1 and 4 are bases) written by one package; the other
    package's engine, with fresh tables and no shm, restores step 5 by
    replaying its chain, base 4 then delta 5, from the writer's step
    dirs."""
    reader = "port" if writer == "jax" else "jax"
    ckpt = tmp_path / "ckpt"
    (_jax_saver if writer == "jax" else _port_saver)(ckpt)
    _, opt, wa = _adapter(writer)
    wa.enable_delta_checkpoints(full_every=3)
    eng = _engine(ckpt, pkg=writer, async_snapshot=False)
    eng.register_sparse(wa)
    for step in (1, 2, 3, 4, 5):
        _train(opt, steps=1, seed=step)
        assert eng.save_to_storage(step,
                                   {"w": np.full(3, step, np.float32)})
        _wait_commit(ckpt, step)
    eng.close()
    AsyncCheckpointSaver.reset()
    JaxSaver.reset()
    (_jax_saver if reader == "jax" else _port_saver)(ckpt)
    _, _, ra = _adapter(reader, seed=61, steps=1)
    e2 = _engine(ckpt, pkg=reader)
    e2._shm_handler.unlink()
    e2.register_sparse(ra)
    step, state = e2.load()
    assert step == 5
    np.testing.assert_array_equal(np.asarray(state["w"]),
                                  np.full(3, 5, np.float32))
    assert e2.last_restore_phases["kv_chain"] == 2
    _assert_adapters_equal(ra, wa)
    e2.close()


# -- chaos invariants --------------------------------------------------------


def _ev(ts, **kw):
    kw["ts"] = ts
    return kw


def test_kv_state_round_trip_invariant_verdicts():
    from dlrover_tpu_torch.chaos.harness import KvStateRoundTrip

    digests = {"emb": {"rows": 5, "sum": "00ab"}}
    good = [
        _ev(1.0, type="kv_checkpoint", stage="export", step=4,
            rows=5, bytes=1, digests=digests),
        _ev(2.0, type="chaos_inject", point="trainer.step",
            action="kill"),
        _ev(3.0, type="kv_checkpoint", stage="restore", step=4,
            rows=5, bytes=1, digests=digests),
    ]
    assert KvStateRoundTrip().check(good, None).ok
    bad = [dict(e) for e in good]
    bad[2]["digests"] = {"emb": {"rows": 5, "sum": "00ac"}}
    res = KvStateRoundTrip().check(bad, None)
    assert not res.ok and "emb" in res.detail
    assert not KvStateRoundTrip().check(good[1:], None).ok


def test_spill_breaker_tripped_invariant_verdicts():
    from dlrover_tpu_torch.chaos.harness import SpillBreakerTripped

    events = [
        _ev(1.0, type="chaos_inject", point="kv.spill",
            action="io_error"),
        _ev(2.0, type="kv_checkpoint", stage="export", step=5,
            rows=3, bytes=1, spill_disabled=True, lost_rows=7),
    ]
    assert SpillBreakerTripped().check(events, None).ok
    no_trip = [events[0], dict(events[1])]
    no_trip[1].pop("spill_disabled")
    assert not SpillBreakerTripped().check(no_trip, None).ok


def test_kv_reshard_exactly_once_invariant_verdicts():
    from dlrover_tpu_torch.chaos.harness import KvReshardExactlyOnce

    def exports(step):
        return [
            _ev(step, type="kv_checkpoint", stage="export",
                step=step, rank=r, rows=10, bytes=1,
                digests={"emb": {"rows": 10, "sum": f"{h:x}"}})
            for r, h in ((0, 0x10), (1, 0x20))
        ]

    def reshard(step, world, rows_by_rank, sums):
        return [
            _ev(step + 1, type="kv_checkpoint", stage="restore",
                step=step, resharded=True, world_size=world,
                rank=r, rows=rows, bytes=1, total_rows=20,
                digests={"emb": {"rows": rows, "sum": s}})
            for (r, rows), s in zip(rows_by_rank.items(), sums)
        ]

    ok = (exports(3) + reshard(3, 1, {0: 20}, ["30"])
          + reshard(3, 2, {0: 12, 1: 8}, ["12", "1e"]))
    assert KvReshardExactlyOnce(min_reshards=2).check(ok, None).ok
    lost = exports(3) + reshard(3, 1, {0: 19}, ["30"])
    res = KvReshardExactlyOnce(min_reshards=1).check(lost, None)
    assert not res.ok and "19" in res.detail
    forged = exports(3) + reshard(3, 1, {0: 20}, ["31"])
    res = KvReshardExactlyOnce(min_reshards=1).check(forged, None)
    assert not res.ok and "diverge" in res.detail


def test_kv_streaming_reshard_replayed_invariant_verdicts(tmp_path):
    import json

    from dlrover_tpu_torch.chaos.harness import KvStreamingReshardReplayed

    seed = tmp_path / "seed.json"
    seed.write_text(json.dumps({"rows": 30, "tables": {"emb": "ff"}}))
    events = [
        _ev(1.0, type="chaos_inject", point="kv.reshard_chunk",
            action="kill", step=3),
        _ev(2.0, type="kv_checkpoint", stage="restore", resharded=True,
            streamed=True, chunks=4, rows=30, total_rows=30,
            digests={"emb": {"rows": 30, "sum": "ff"}}),
    ]
    assert KvStreamingReshardReplayed(str(seed)).check(events, None).ok
    one_chunk = [events[0], dict(events[1], chunks=1)]
    assert not KvStreamingReshardReplayed(str(seed)).check(
        one_chunk, None).ok
    lost = [events[0], dict(events[1], rows=29)]
    assert not KvStreamingReshardReplayed(str(seed)).check(lost, None).ok


# -- pipeline wiring ---------------------------------------------------------


def test_pipeline_attach_checkpoint_and_on_step(tmp_path):
    """attach_checkpoint registers the table and its slots; on_step
    fires once each update has retired, so a strict loop checkpoints
    step-consistent state."""
    from dlrover_tpu_torch.checkpoint.checkpointer import Checkpointer
    from dlrover_tpu_torch.trainer.sparse_pipeline import (
        SparseTrainPipeline,
    )

    _port_saver(tmp_path / "ckpt")
    t = tkv.KvVariable(dim=4, seed=21, name="emb")
    opt = tkv.GroupAdamOptimizer(t, learning_rate=1e-2)

    def device_step(state, emb, ids):
        return state + 1, emb * 0.1, {"loss": emb.sum()}

    pipe = SparseTrainPipeline(t, opt, device_step, device="cpu",
                               pipeline=False)
    ckpt = Checkpointer(str(tmp_path / "ckpt"))
    adapter = pipe.attach_checkpoint(ckpt)
    assert set(adapter.tables) == {"emb", "emb.m", "emb.v"}
    rng = np.random.default_rng(0)
    seen = []
    batches = [(rng.integers(0, 50, (4, 3)).astype(np.int64),
                np.zeros(1, np.float32)) for _ in range(3)]
    state = pipe.run(0, iter(batches),
                     on_step=lambda s, n: seen.append((s, n, opt.step)))
    assert state == 3 and seen == [(1, 1, 1), (2, 2, 2), (3, 3, 3)]
    ckpt.close()


if __name__ == "__main__":
    import sys

    sys.exit(pytest.main([__file__, "-q"]))
