"""KvVariable and the sparse group optimizers of the PyTorch port against
the JAX package.

Both packages build the same C++ store (``native/kv_store.cc``, the
port's a byte-for-byte copy, with the same g++ flags) into separate
build directories and load them side by side through ctypes
(``RTLD_LOCAL``: neither library resolves the other's ``kv_*``
symbols).  The same sequence of operations, made from a seed with
numpy, runs on a table of each package; every comparison is of exact
bytes (tolerance: none): gather, insert, scatter, frequency, eviction,
export and import (chunked too), ``reserve``, delete and clear, the
three consumers' dirty and dead sets, every optimizer's updates with and
without the spill tier, and the spill tier's failure breaker and its
gauges.  Then the port's device gather on the CPU (its pinned copy to
the card is held in ``tests/test_torch_sparse_cuda.py``) and the
build's refusal to fall back.
"""

import ctypes

import numpy as np
import pytest
import torch

from dlrover_tpu.ops import kv_variable as jkv
from dlrover_tpu_torch import native
from dlrover_tpu_torch.ops import kv_variable as tkv

OPTIMIZERS = ["GroupAdamOptimizer", "GroupAdagradOptimizer",
              "GroupFtrlOptimizer", "SparseSGDOptimizer",
              "SparseAdamOptimizer", "RectifiedAdamOptimizer"]


def _sorted(export):
    k, v, f = export
    order = np.argsort(k)
    return k[order], v[order], f[order]


def _assert_bit_equal(a, b):
    """Two ``(keys, values, freq)`` exports hold the same rows, bit for
    bit, in any order."""
    ka, va, fa = _sorted(a)
    kb, vb, fb = _sorted(b)
    np.testing.assert_array_equal(ka, kb)
    assert va.tobytes() == vb.tobytes()
    np.testing.assert_array_equal(fa, fb)


def _pair(dim=8, seed=7, name="emb"):
    return (jkv.KvVariable(dim, seed=seed, name=name),
            tkv.KvVariable(dim, seed=seed, name=name))


def test_the_two_stores_are_separate_libraries():
    """Two builds from one source, in two build directories, loaded
    side by side: each package's table calls its own library."""
    j, t = jkv._load(), tkv._load()
    assert j._name != t._name
    assert "dlrover_tpu_torch/_build/" in t._name
    assert ctypes.DEFAULT_MODE == ctypes.RTLD_LOCAL or \
        ctypes.DEFAULT_MODE == 0
    with open(native.SRC_DIR / "kv_store.cc", "rb") as f:
        port_src = f.read()
    with open(jkv._load()._name.rsplit("/_build/", 1)[0] + "/kv_store.cc",
              "rb") as f:
        assert f.read() == port_src


def test_gather_insert_scatter_and_frequency_match():
    rng = np.random.default_rng(0)
    a, b = _pair()
    keys = rng.integers(0, 500, 300).astype(np.int64)
    # random init from the seed and the key, inside the C++
    assert a.gather(keys).tobytes() == b.gather(keys).tobytes()
    vals = rng.normal(size=(40, 8)).astype(np.float32)
    ins = np.arange(1000, 1040, dtype=np.int64)
    for t in (a, b):
        t.insert(ins, vals)
        t.scatter_add(keys[:50], vals[:50] if len(vals) >= 50 else
                      np.resize(vals, (50, 8)))
        t.scatter_sub(ins[:10], vals[:10])
        t.scatter_mul(keys[50:60], vals[10:20])
    probe = np.concatenate([keys[:80], ins, np.arange(5000, 5010)])
    assert a.gather_or_zeros(probe).tobytes() == \
        b.gather_or_zeros(probe).tobytes()
    np.testing.assert_array_equal(a.frequency(probe), b.frequency(probe))
    assert len(a) == len(b)
    _assert_bit_equal(a.export(), b.export())


@pytest.mark.parametrize("spill", [False, True], ids=["dram", "spill"])
@pytest.mark.parametrize("opt_name", OPTIMIZERS)
def test_optimizer_updates_match_bit_for_bit(tmp_path, opt_name, spill):
    """Eight steps of each optimizer over a skewed key stream; with the
    spill tier armed at a DRAM budget of 64 rows, so cold rows and
    slot rows live on disk and come back on a miss."""
    rng = np.random.default_rng(1)
    a, b = _pair(dim=8, seed=11)
    oa = getattr(jkv, opt_name)(a, learning_rate=0.05)
    ob = getattr(tkv, opt_name)(b, learning_rate=0.05)
    if spill:
        for pkg, t, o in (("j", a, oa), ("t", b, ob)):
            d = tmp_path / pkg
            d.mkdir()
            t.enable_spill(str(d / "emb.spill"), 64)
            if hasattr(o, "enable_spill"):
                o.enable_spill(str(d), 64)
    for _ in range(8):
        keys = (rng.zipf(1.3, 96) % 400).astype(np.int64)
        grads = rng.normal(size=(96, 8)).astype(np.float32)
        ea, eb = a.gather(keys), b.gather(keys)
        assert ea.tobytes() == eb.tobytes()
        oa.apply_gradients(keys, grads * np.tanh(ea))
        ob.apply_gradients(keys, grads * np.tanh(eb))
    _assert_bit_equal(a.export(), b.export())
    slots_a, slots_b = oa.slot_tables(), ob.slot_tables()
    assert list(slots_a) == list(slots_b)
    for name in slots_a:
        _assert_bit_equal(slots_a[name].export(), slots_b[name].export())
    if hasattr(oa, "state_scalars"):
        assert oa.state_scalars() == ob.state_scalars()
    if spill:
        sa, sb = a.spill_stats(), b.spill_stats()
        assert sa == sb and sa["disk_rows"] > 0


def test_eviction_matches():
    rng = np.random.default_rng(2)
    a, b = _pair(dim=4)
    for _ in range(6):
        keys = (rng.zipf(1.2, 200) % 1000).astype(np.int64)
        a.gather(keys)
        b.gather(keys)
    assert a.evict_below(2) == b.evict_below(2)
    _assert_bit_equal(a.export(), b.export())
    assert a.evict_to_capacity(60) == b.evict_to_capacity(60)
    np.testing.assert_array_equal(np.sort(a.export_freq()),
                                  np.sort(b.export_freq()))
    _assert_bit_equal(a.export(), b.export())


def test_chunked_export_import_reserve_delete_and_clear_match(tmp_path):
    rng = np.random.default_rng(3)
    a, b = _pair(dim=6)
    for t, d in ((a, "j"), (b, "t")):
        t.enable_spill(str(tmp_path / f"{d}.spill"), 50)
    keys = rng.integers(0, 10**6, 400).astype(np.int64)
    a.gather(keys)
    b.gather(keys)
    chunks_a = list(a.export_chunks(37))
    chunks_b = list(b.export_chunks(37))
    assert [len(c[0]) for c in chunks_a] == [len(c[0]) for c in chunks_b]
    cat = [tuple(np.concatenate([c[i] for c in ch]) for i in range(3))
           for ch in (chunks_a, chunks_b)]
    _assert_bit_equal(*cat)
    a2, b2 = _pair(dim=6, seed=99)
    a2.reserve(500)
    b2.reserve(500)
    assert a2.import_chunked(*cat[0], max_rows=41) == \
        b2.import_chunked(*cat[1], max_rows=41)
    _assert_bit_equal(a2.export(), b2.export())
    dead = keys[:30]
    assert a2.delete(dead) == b2.delete(dead) == 30
    _assert_bit_equal(a2.export(), b2.export())
    a2.clear()
    b2.clear()
    assert len(a2) == len(b2) == 0


def test_dirty_and_dead_tracking_per_consumer_match():
    """Each consumer slot keeps its own baseline in both packages: a
    cleared serving delta leaves the checkpoint and shm slots dirty."""
    rng = np.random.default_rng(4)
    a, b = _pair(dim=4)
    oa, ob = jkv.GroupAdamOptimizer(a), tkv.GroupAdamOptimizer(b)
    base = rng.integers(0, 300, 200).astype(np.int64)
    a.gather(base)
    b.gather(base)
    for c in (0, 1, 2):
        a.enable_dirty_tracking(c)
        b.enable_dirty_tracking(c)
    touched = base[:40]
    g = rng.normal(size=(40, 4)).astype(np.float32)
    oa.apply_gradients(touched, g)
    ob.apply_gradients(touched, g)
    a.delete(base[100:110])
    b.delete(base[100:110])
    assert tkv.DIRTY_CONSUMER_SERVING == 0
    assert tkv.DIRTY_CONSUMER_CHECKPOINT == 1
    assert tkv.DIRTY_CONSUMER_SHM == 2
    _assert_bit_equal(a.export_dirty(clear=True, consumer=0),
                      b.export_dirty(clear=True, consumer=0))
    np.testing.assert_array_equal(
        np.sort(a.export_dead(clear=True, consumer=0)),
        np.sort(b.export_dead(clear=True, consumer=0)))
    for c in (1, 2):
        assert a.dirty_count(c) == b.dirty_count(c) > 0
        assert a.dead_count(c) == b.dead_count(c) == 10
        _assert_bit_equal(a.export_dirty(consumer=c),
                          b.export_dirty(consumer=c))
    assert a.dirty_count(0) == b.dirty_count(0) == 0


def test_spill_breaker_trips_alike_and_sets_the_gauges(tmp_path):
    from dlrover_tpu_torch.telemetry.metrics import get_registry

    rng = np.random.default_rng(5)
    a, b = _pair(dim=4, name="brk")
    keys = rng.integers(0, 400, 200).astype(np.int64)
    for t, d in ((a, "j"), (b, "t")):
        t.enable_spill(str(tmp_path / f"{d}.spill"), 32)
        t.gather(keys)
        t._break_spill_tier()
        # every further spill pass fails: the breaker opens after 8
        for i in range(12):
            t.gather(np.arange(1000 + 40 * i, 1040 + 40 * i))
    sa, sb = a.spill_stats(), b.spill_stats()
    assert sa == sb
    assert sb["disabled"] and sb["write_failures"] >= 8
    text = get_registry().render_prometheus()
    assert 'dlrover_kv_spill_disabled{table="brk"} 1' in text
    # stranded cold rows read back short and drop out of both exports
    _assert_bit_equal(a.export(), b.export())


def test_device_gather_on_the_cpu():
    a, b = _pair(dim=5)
    keys = np.arange(24, dtype=np.int64).reshape(4, 6)
    got = b.device_gather(keys, "cpu")
    assert got.shape == (4, 6, 5) and got.dtype == torch.float32
    assert got.numpy().tobytes() == a.gather(keys.reshape(-1)).tobytes()
    # without insertion the gather is side-effect free
    zeros = b.device_gather(np.array([10**9]), "cpu", insert_missing=False)
    assert torch.count_nonzero(zeros) == 0 and len(b) == 24


def test_a_failed_build_raises(tmp_path):
    src = tmp_path / "broken.cc"
    src.write_text("int f( {\n")
    with pytest.raises(RuntimeError, match="native build of broken"):
        native.build_library("broken", sources=[str(src)])


if __name__ == "__main__":
    import sys

    sys.exit(pytest.main([__file__, "-q"]))
