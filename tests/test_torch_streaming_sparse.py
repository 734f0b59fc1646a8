"""The streaming (bounded-memory) sparse paths of the PyTorch port
against the JAX package.

- A cross-world reshard streamed in windows of any size gives tables
  bit-equal to the one-shot ``import_shards`` of the port and of the
  JAX package (tolerance: none), also fed the CPU tensors the port's
  restore paths hand out; it replaces stale rows, and its additive
  digest assert fires on a row fed twice.
- Exactly-once ownership at a new world: the three ranks of world 3
  import disjoint subsets whose union is the old world's rows and whose
  digests sum to the old shards'.
- The delta chain's cadence, link metadata, poison re-base and O(rows
  touched) deltas.
- The memory guards, twins of ``tests/test_streaming_sparse.py``'s RSS
  guards with the same claim (the windowed path's peak extra memory is
  at most 2x the window, the one-shot path's is more).  They measure
  the peak of the numpy allocations with ``tracemalloc`` instead of
  process RSS: numpy reports every array it allocates to
  ``tracemalloc``, so the reading counts exactly the path's own
  transient arrays, and the rest of the machine (the suite's parallel
  workers, the allocator returning pages or not) cannot move it.  The
  tables' own rows live in the C++ store, outside both readings.
"""

import tracemalloc

import numpy as np
import pytest
import torch

from dlrover_tpu.checkpoint import sparse as jsp
from dlrover_tpu.ops import kv_variable as jkv
from dlrover_tpu_torch.checkpoint import sparse as tsp
from dlrover_tpu_torch.ops import kv_variable as tkv


def _sorted(export):
    k, v, f = export
    order = np.argsort(k)
    return k[order], v[order], f[order]


def _assert_tables_equal(a, b):
    ka, va, fa = _sorted(a.export())
    kb, vb, fb = _sorted(b.export())
    np.testing.assert_array_equal(ka, kb)
    assert va.tobytes() == vb.tobytes()
    np.testing.assert_array_equal(fa, fb)


def _two_shard_states(n_keys=600, dim=6):
    """A world-2 table, hash-partitioned: each rank's export."""
    shards = {}
    keys = np.arange(n_keys, dtype=np.int64)
    for rank in range(2):
        t = tkv.KvVariable(dim=dim, seed=rank + 1, name="emb")
        opt = tkv.GroupAdamOptimizer(t, learning_rate=1e-2)
        a = tsp.SparseStateAdapter(digest=True)
        a.register_optimizer(opt)
        mine = keys[tsp.owner_of_keys(keys, 2) == rank]
        opt.apply_gradients(mine, np.tanh(t.gather(mine)) * 0.1)
        shards[rank] = a.export_state()
    return shards


def _target(kv=tkv, sp=tsp, dim=6, spill_path=None):
    t = kv.KvVariable(dim=dim, name="emb")
    opt = kv.GroupAdamOptimizer(t, learning_rate=1e-2)
    if spill_path:
        t.enable_spill(str(spill_path), max_dram_rows=64)
    a = sp.SparseStateAdapter(digest=True)
    a.register_optimizer(opt)
    return t, opt, a


def _as_tensors(state):
    """The nested export with every array as a CPU tensor (the views
    the port's shm and storage readers hand out)."""
    if isinstance(state, dict):
        return {k: _as_tensors(v) for k, v in state.items()}
    if isinstance(state, np.ndarray):
        return torch.from_numpy(state)
    return state


@pytest.mark.parametrize("window", [1, 37, 10**6])
def test_streaming_reshard_equals_oneshot_in_both_packages(tmp_path,
                                                           window):
    shards = _two_shard_states()
    t1, o1, a1 = _target()
    a1.import_shards(dict(shards), world_size=3, rank=1)
    tj, oj, aj = _target(jkv, jsp)
    aj.import_shards(dict(shards), world_size=3, rank=1)
    t2, o2, a2 = _target(spill_path=tmp_path / "tgt.spill")
    info = a2.import_shards_streaming(
        {r: _as_tensors(s) for r, s in shards.items()}, world_size=3,
        rank=1, window_rows=window)
    tj2, oj2, aj2 = _target(jkv, jsp)
    aj2.import_shards_streaming(dict(shards), world_size=3, rank=1,
                                window_rows=window)
    for t in (tj, t2, tj2):
        _assert_tables_equal(t1, t)
    for o in (oj, o2, oj2):
        _assert_tables_equal(o1.m, o.m)
        _assert_tables_equal(o1.v, o.v)
        assert o.step == o1.step
    assert info["kv_resharded"] is True
    if window < 600:
        assert info["kv_chunks"] > 1


def test_streaming_reshard_clears_stale_rows():
    shards = _two_shard_states(n_keys=100)
    t, _opt, a = _target()
    t.insert(np.array([10**6, 10**6 + 1], dtype=np.int64),
             np.ones((2, 6), np.float32))
    a.import_shards_streaming(shards, world_size=1, rank=0,
                              window_rows=17)
    k, _v, _f = t.export()
    assert 10**6 not in set(k.tolist()) and len(k) == 100


def test_streaming_reshard_double_import_detected():
    """The additive-digest exactly-once assert fires when the same key
    arrives from two shards."""
    shards = _two_shard_states(n_keys=200)
    dup = {
        0: shards[0],
        1: {
            name: {k: np.concatenate([sub[k], shards[0][name][k]])
                   for k in ("keys", "values", "freq")}
            if isinstance(sub, dict) and "keys" in sub else sub
            for name, sub in shards[1].items()
        },
    }
    _t, _opt, a = _target()
    with pytest.raises(RuntimeError, match="not exactly-once"):
        a.import_shards_streaming(dup, world_size=1, rank=0,
                                  window_rows=29)


def test_exactly_once_ownership_at_a_new_world():
    shards = _two_shard_states(n_keys=900)
    union = np.sort(np.concatenate(
        [np.asarray(s["emb"]["keys"]) for s in shards.values()]))
    want = sum(tsp.rows_digest(s["emb"]["keys"], s["emb"]["values"],
                               s["emb"]["freq"])
               for s in shards.values()) % (1 << 64)
    got_keys, got_sum = [], 0
    for rank in range(3):
        t, _opt, a = _target()
        a.import_shards_streaming(shards, world_size=3, rank=rank,
                                  window_rows=50)
        k, v, f = t.export()
        assert (tsp.owner_of_keys(k, 3) == rank).all()
        got_keys.append(k)
        got_sum = (got_sum + tsp.rows_digest(k, v, f)) % (1 << 64)
    got = np.sort(np.concatenate(got_keys))
    np.testing.assert_array_equal(got, union)  # disjoint, complete
    assert got_sum == want


def test_reshard_window_rows_env(monkeypatch):
    monkeypatch.setenv("DLROVER_KV_RESHARD_WINDOW_ROWS", "123")
    assert tsp.reshard_window_rows(1000) == 123
    monkeypatch.delenv("DLROVER_KV_RESHARD_WINDOW_ROWS")
    monkeypatch.setenv("DLROVER_KV_RESHARD_WINDOW_MB", "1")
    assert tsp.reshard_window_rows(2**20) == 1
    assert tsp.reshard_window_rows(2**18) == 4


def _delta_trained(full_every, steps, kv=tkv, sp=tsp):
    t = kv.KvVariable(dim=6, seed=3, name="emb")
    opt = kv.GroupAdamOptimizer(t, learning_rate=1e-2)
    a = sp.SparseStateAdapter(digest=True)
    a.register_optimizer(opt)
    a.enable_delta_checkpoints(full_every=full_every)
    links = []
    for step in range(1, steps + 1):
        keys = np.random.default_rng(step).integers(
            0, 400, 60).astype(np.int64)
        opt.apply_gradients(keys, np.tanh(t.gather(keys)) * 0.1)
        links.append(a.export_for_checkpoint(step=step, durable=True))
    return t, opt, a, links


def test_delta_checkpoint_cadence_meta_and_poison():
    _t, opt, a, links = _delta_trained(full_every=3, steps=7)
    _tj, _oj, _aj, jlinks = _delta_trained(3, 7, jkv, jsp)
    kinds = [b["__meta__"]["kind"] for b in links]
    assert kinds == ["base", "delta", "delta", "base", "delta", "delta",
                     "base"]
    assert [b["__meta__"] for b in links] == \
        [b["__meta__"] for b in jlinks]
    assert tsp.SparseStateAdapter.chain_steps(links[5]["__meta__"]) == \
        [4, 5]
    a.checkpoint_chain_poison()
    opt.apply_gradients(np.arange(5, dtype=np.int64),
                        np.ones((5, 6), np.float32) * 0.1)
    assert a.export_for_checkpoint(step=8)["__meta__"]["kind"] == "base"
    # a memory save is always full and leaves the chain alone
    assert "__meta__" not in a.export_for_checkpoint(step=9,
                                                      durable=False)
    assert a.export_for_checkpoint(step=10)["__meta__"]["kind"] == "delta"


def test_delta_exports_are_o_rows_touched():
    _t, opt, a, _links = _delta_trained(full_every=100, steps=1)
    opt.apply_gradients(np.arange(7, dtype=np.int64),
                        np.ones((7, 6), np.float32) * 0.1)
    blob = a.export_for_checkpoint(step=2, durable=True)
    assert blob["__meta__"]["kind"] == "delta"
    rows = sum(len(sub["keys"]) for sub in blob.values()
               if isinstance(sub, dict) and "keys" in sub)
    assert rows == 3 * 7  # param, m and v: only the touched keys each


# -- memory guards -------------------------------------------------------


def _peak_numpy_bytes(fn):
    """``fn()`` and the peak bytes of the Python and numpy allocations
    it made above what was live when it started."""
    tracemalloc.start()
    try:
        base, _ = tracemalloc.get_traced_memory()
        tracemalloc.reset_peak()
        out = fn()
        _, peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    return out, peak - base


def test_windowed_reshard_memory_guard():
    """A ~20 MB two-shard split resharded onto world 16 (a small owned
    subset, so the reading is the path's transients): the windowed
    import's peak extra numpy memory is at most 2x its 8 MB window; the
    one-shot import (concatenate, dedupe, mask the whole table) of the
    same shards exceeds that."""
    rows, dim = 40000, 128
    rng = np.random.default_rng(1)
    keys = np.arange(rows, dtype=np.int64)
    values = rng.normal(size=(rows, dim)).astype(np.float32)
    freq = np.ones(rows, dtype=np.uint64)
    own = tsp.owner_of_keys(keys, 2)
    shards = {r: {"emb": {"keys": keys[own == r],
                          "values": values[own == r],
                          "freq": freq[own == r]}}
              for r in range(2)}
    window_mb = 8
    window_rows = int(window_mb * 2**20 / (dim * 4 + 16))

    def fresh():
        t = tkv.KvVariable(dim, name="emb")
        return t, tsp.SparseStateAdapter(digest=False).register_table(t)

    t_s, a_s = fresh()
    info, stream_peak = _peak_numpy_bytes(lambda: a_s.import_shards_streaming(
        shards, world_size=16, rank=0, window_rows=window_rows))
    assert info["kv_chunks"] > 1
    t_o, a_o = fresh()
    _, oneshot_peak = _peak_numpy_bytes(
        lambda: a_o.import_shards(shards, world_size=16, rank=0))
    _assert_tables_equal(t_s, t_o)
    bound = 2 * window_mb * 2**20
    assert stream_peak <= bound, (stream_peak / 2**20, "MB")
    assert oneshot_peak > bound, (oneshot_peak / 2**20, "MB")


def test_chunked_export_memory_guard():
    """The write side: walking a ~20 MB table with ``export_chunks``
    holds at most 2x one window of rows (the generator drops its own
    references before yielding), where ``export`` materializes the
    whole table; the chunks' rows equal the export's."""
    rows, dim = 40000, 128
    t = tkv.KvVariable(dim, seed=2, name="emb")
    t.gather(np.arange(rows, dtype=np.int64))
    window_rows = 4096
    window_bytes = window_rows * (dim * 4 + 16)

    def walk():
        n, digest = 0, 0
        for k, v, f in t.export_chunks(window_rows):
            n += len(k)
            digest = (digest + tsp.rows_digest(k, v, f)) % (1 << 64)
            k = v = f = None
        return n, digest

    (n, digest), chunk_peak = _peak_numpy_bytes(walk)
    whole, whole_peak = _peak_numpy_bytes(t.export)
    assert n == rows and digest == tsp.rows_digest(*whole)
    assert chunk_peak <= 2 * window_bytes, chunk_peak
    assert whole_peak > 2 * window_bytes, whole_peak


if __name__ == "__main__":
    import sys

    sys.exit(pytest.main([__file__, "-q"]))
