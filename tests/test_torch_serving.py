"""Twins of ``tests/test_serving.py`` for the port's serving plane
(``dlrover_tpu_torch/serving/``): the delta surface of the table, the
publisher/replica generation protocol (torn-read refusal, exactly-once
across a mid-publish death, atomic swaps under concurrent lookups) and
the event schema of what they emit.

Every case runs its body once with each package's classes, on the same
seeded numpy inputs, keeps the reference's assertions for both, and
then holds the port's observations (content digests, generation
numbers, lookups) equal to the JAX package's, bit for bit (tolerance:
none).
"""

import os
import threading
from types import SimpleNamespace

import numpy as np
import pytest

import dlrover_tpu.checkpoint.sparse as j_sparse
import dlrover_tpu.ops.kv_variable as j_kv
import dlrover_tpu.serving as j_serving
import dlrover_tpu.serving.publisher as j_pub
import dlrover_tpu.serving.replica as j_rep
import dlrover_tpu.telemetry.events as j_ev
import dlrover_tpu.telemetry.schema as j_schema
import dlrover_tpu_torch.checkpoint.sparse as t_sparse
import dlrover_tpu_torch.ops.kv_variable as t_kv
import dlrover_tpu_torch.serving as t_serving
import dlrover_tpu_torch.serving.publisher as t_pub
import dlrover_tpu_torch.serving.replica as t_rep
import dlrover_tpu_torch.telemetry.events as t_ev
import dlrover_tpu_torch.telemetry.schema as t_schema

DIM = 8


def _ns(kv, sparse, serving, pub, rep, ev, schema):
    return SimpleNamespace(
        KvVariable=kv.KvVariable,
        GroupAdamOptimizer=kv.GroupAdamOptimizer,
        SparseStateAdapter=sparse.SparseStateAdapter,
        rows_digest=sparse.rows_digest,
        keys_digest=sparse.keys_digest,
        EmbeddingPublisher=serving.EmbeddingPublisher,
        ServingReplica=serving.ServingReplica,
        committed_generation=serving.committed_generation,
        DONE_MARKER=pub.DONE_MARKER,
        gen_dirname=pub.gen_dirname,
        TornGenerationError=rep.TornGenerationError,
        events=ev,
        validate_event=schema.validate_event,
    )


PKGS = {
    "jax": _ns(j_kv, j_sparse, j_serving, j_pub, j_rep, j_ev, j_schema),
    "torch": _ns(t_kv, t_sparse, t_serving, t_pub, t_rep, t_ev, t_schema),
}


def _both(body, tmp_path=None, **kw):
    """``body(m, dir, **kw)`` with each package's namespace ``m``; the
    port's observations must equal the JAX package's."""
    out = {}
    for name, m in PKGS.items():
        d = None
        if tmp_path is not None:
            d = tmp_path / name
            d.mkdir()
        out[name] = body(m, d, **kw)
    assert out["torch"] == out["jax"]
    return out["torch"]


def _digest(m, table) -> int:
    return m.rows_digest(*table.export())


def _train_interval(table, opt, seed, n=32, key_space=500):
    """One publish interval of mutation: gather + optimizer step."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, key_space, n).astype(np.int64)
    table.gather(keys)
    opt.apply_gradients(
        keys, rng.normal(size=(n, table.dim)).astype(np.float32)
    )
    return keys


# -- the table's delta surface -----------------------------------------------


def test_dirty_tracking_marks_only_touched_keys():
    def body(m, _d):
        t = m.KvVariable(DIM, name="t")
        t.enable_dirty_tracking()
        t.insert(np.arange(50, dtype=np.int64),
                 np.zeros((50, DIM), np.float32))
        t.clear_dirty()
        t.scatter_add(np.array([3, 7]), np.ones((2, DIM), np.float32))
        assert t.dirty_count() == 2
        keys, values, freq = t.export_dirty()
        assert sorted(keys) == [3, 7]
        # read-only gather (serving path) never dirties
        t.clear_dirty()
        t.gather_or_zeros(np.arange(50, dtype=np.int64))
        assert t.dirty_count() == 0
        # counting gather dirties (frequency is checkpoint state)
        t.gather(np.array([1], dtype=np.int64))
        assert t.dirty_count() == 1
        return sorted(keys.tolist()), values.tobytes(), _digest(m, t)

    _both(body)


def test_dirty_set_survives_spill_pass(tmp_path):
    def body(m, d):
        t = m.KvVariable(DIM, name="sp")
        t.enable_dirty_tracking()
        rng = np.random.default_rng(0)
        t.insert(np.arange(200, dtype=np.int64),
                 rng.normal(size=(200, DIM)).astype(np.float32))
        assert t.dirty_count() == 200
        t.enable_spill(str(d / "sp.spill"), 40)
        assert t.spill_stats()["disk_rows"] > 0
        assert t.dirty_count() == 200
        dk, dv, df = t.export_dirty()
        assert m.rows_digest(dk, dv, df) == _digest(m, t)
        t.clear_dirty()
        t.gather_or_zeros(np.arange(200, dtype=np.int64))
        assert t.dirty_count() == 0
        return m.rows_digest(dk, dv, df), t.spill_stats()["disk_rows"]

    _both(body, tmp_path)


def test_delete_and_tombstones(tmp_path):
    def body(m, d):
        t = m.KvVariable(DIM, name="d")
        t.enable_dirty_tracking()
        t.insert(np.arange(100, dtype=np.int64),
                 np.ones((100, DIM), np.float32))
        t.enable_spill(str(d / "d.spill"), 30)
        t.clear_dirty()
        assert t.delete(np.array([0, 99], dtype=np.int64)) == 2
        assert len(t) == 98
        assert sorted(t.export_dead()) == [0, 99]
        got = t.gather_or_zeros(np.arange(100, dtype=np.int64))
        missing = np.where(~got.any(axis=1))[0]
        assert sorted(missing) == [0, 99]
        t.gather(np.array([0], dtype=np.int64))
        assert sorted(t.export_dead()) == [99]
        assert 0 in t.export_dirty()[0]
        return got.tobytes(), _digest(m, t)

    _both(body, tmp_path)


def test_delta_over_evicted_row():
    def body(m, _d):
        src = m.KvVariable(DIM, name="e")
        src.enable_dirty_tracking()
        twin = m.KvVariable(DIM, name="e")
        twin.enable_dirty_tracking()
        src.insert(np.arange(20, dtype=np.int64),
                   np.ones((20, DIM), np.float32))
        twin.import_(*src.export())
        src.clear_dirty()
        twin.clear_dirty()
        src.gather(np.array([5], dtype=np.int64))
        assert src.evict_below(1) == 19
        keys, values, freq = src.export_dirty()
        dead = src.export_dead()
        assert list(keys) == [5]
        assert len(dead) == 19 and 5 not in dead
        twin.delete(dead)
        twin.import_(keys, values, freq)
        assert _digest(m, twin) == _digest(m, src)
        assert len(twin) == 1
        return sorted(dead.tolist()), _digest(m, twin)

    _both(body)


def test_delta_chain_replay_bit_identical_to_full_snapshot_twin(
    tmp_path, monkeypatch,
):
    monkeypatch.delenv("DLROVER_KV_DIGEST", raising=False)

    def body(m, d):
        src_t = m.KvVariable(DIM, name="c")
        src_opt = m.GroupAdamOptimizer(src_t)
        src = m.SparseStateAdapter(digest=True).register_table(src_t)
        src.enable_dirty_tracking()
        twin_t = m.KvVariable(DIM, name="c")
        twin_t.enable_spill(str(d / "twin.spill"), 50)
        twin = m.SparseStateAdapter(digest=True).register_table(twin_t)
        _train_interval(src_t, src_opt, seed=1)
        base = src.export_state()
        src_t.clear_dirty()
        twin.import_state(base)
        links = [_digest(m, twin_t)]
        assert links[0] == _digest(m, src_t)
        for i in range(2, 7):
            _train_interval(src_t, src_opt, seed=i)
            if i == 4:
                src_t.evict_below(2)
            twin.apply_delta(src.export_delta(clear=True))
            links.append(_digest(m, twin_t))
            assert links[-1] == _digest(m, src_t), (
                f"chain diverged at link {i}"
            )
        assert twin_t.spill_stats()["spills"] > 0
        return links

    _both(body, tmp_path)


def test_digest_additivity_across_base_plus_delta_chain():
    def body(m, _d):
        t = m.KvVariable(DIM, name="a")
        t.enable_dirty_tracking()
        rng = np.random.default_rng(7)
        t.insert(np.arange(300, dtype=np.int64),
                 rng.normal(size=(300, DIM)).astype(np.float32))
        t.clear_dirty()
        touched = np.unique(rng.integers(0, 300, 120)).astype(np.int64)
        t.scatter_add(
            touched,
            rng.normal(size=(len(touched), DIM)).astype(np.float32),
        )
        dk, dv, df = t.export_dirty()
        assert set(dk) == set(touched)
        fk, fv, ff = t.export()
        untouched = ~np.isin(fk, touched)
        part_sum = (
            m.rows_digest(fk[untouched], fv[untouched], ff[untouched])
            + m.rows_digest(dk, dv, df)
        ) % (1 << 64)
        assert part_sum == m.rows_digest(fk, fv, ff)
        assert m.keys_digest(np.array([1, 2], np.int64)) == (
            m.keys_digest(np.array([1], np.int64))
            + m.keys_digest(np.array([2], np.int64))
        ) % (1 << 64)
        return part_sum

    _both(body)


def test_dirty_tracking_is_opt_in():
    def body(m, _d):
        t = m.KvVariable(DIM, name="off")
        assert not t.dirty_tracking_enabled()
        t.insert(np.arange(50, dtype=np.int64),
                 np.ones((50, DIM), np.float32))
        t.gather(np.arange(50, dtype=np.int64))
        t.evict_below(1)
        assert t.dirty_count() == 0 and t.dead_count() == 0
        t.enable_dirty_tracking()
        t.scatter_add(np.array([1]), np.ones((1, DIM), np.float32))
        assert t.dirty_count() == 1
        return _digest(m, t)

    _both(body)


# -- publisher / replica protocol --------------------------------------------


def _mk_publisher(m, d, compact_every=4):
    t = m.KvVariable(DIM, name="emb")
    opt = m.GroupAdamOptimizer(t)
    adapter = m.SparseStateAdapter(digest=True).register_table(t)
    pub = m.EmbeddingPublisher(
        adapter, str(d / "serving"), compact_every=compact_every,
    )
    return t, opt, pub


def test_publish_ingest_round_trip(tmp_path):
    def body(m, d):
        t, opt, pub = _mk_publisher(m, d)
        for step in range(1, 7):
            _train_interval(t, opt, seed=step)
            pub.publish(step=step)
        rep = m.ServingReplica(str(d / "serving"))
        applied = rep.ingest_pending()
        assert applied and rep.generation == pub.generation
        assert _digest(m, rep.tables["emb"]) == _digest(m, t)
        out = rep.lookup(np.arange(5, dtype=np.int64))
        assert out.shape == (5, DIM)
        assert rep.ingest_pending() == []
        return applied, out.tobytes(), _digest(m, t)

    _both(body, tmp_path)


def test_uncommitted_generation_never_served(tmp_path):
    def body(m, d):
        t, opt, pub = _mk_publisher(m, d)
        serving = str(d / "serving")
        _train_interval(t, opt, seed=1)
        pub.publish(step=1)
        rep = m.ServingReplica(serving)
        rep.ingest_pending()
        assert rep.generation == 1
        # die mid-publish: the DONE write raises (trainer SIGKILL
        # parity)
        real_write = pub.storage.write

        def dying_write(content, path):
            if path.endswith(m.DONE_MARKER):
                raise RuntimeError("killed mid-publish")
            return real_write(content, path)

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(pub.storage, "write", dying_write)
            _train_interval(t, opt, seed=2)
            with pytest.raises(RuntimeError):
                pub.publish(step=2)
        assert m.committed_generation(serving) == 1
        assert rep.ingest_pending() == []
        assert rep.generation == 1
        # replacement publisher (fresh process): re-bases at gen 2
        t2 = m.KvVariable(DIM, name="emb")
        t2.import_(*t.export())
        adapter2 = m.SparseStateAdapter(digest=True).register_table(t2)
        pub2 = m.EmbeddingPublisher(adapter2, serving)
        assert pub2.publish(step=2) == 2
        rep.ingest_pending()
        assert rep.generation == 2
        assert _digest(m, rep.tables["emb"]) == _digest(m, t2)
        return _digest(m, t2)

    _both(body, tmp_path)


def test_torn_blobs_refused(tmp_path):
    def body(m, d):
        t, opt, pub = _mk_publisher(m, d)
        _train_interval(t, opt, seed=1)
        pub.publish(step=1)
        rep = m.ServingReplica(str(d / "serving"))
        rep.ingest_pending()
        before = _digest(m, rep.tables["emb"])
        _train_interval(t, opt, seed=2)
        pub.publish(step=2)
        blob_path = os.path.join(
            str(d / "serving"), m.gen_dirname(2), "blobs.npz"
        )
        with open(blob_path, "r+b") as f:
            f.seek(200)
            f.write(b"\xde\xad\xbe\xef" * 8)
        with pytest.raises(m.TornGenerationError):
            rep._load_generation(2)
        assert rep.ingest_pending() == []
        assert rep.generation == 1
        assert _digest(m, rep.tables["emb"]) == before
        return before

    _both(body, tmp_path)


def test_rebase_after_history_pruned(tmp_path):
    def body(m, d):
        t, opt, pub = _mk_publisher(m, d, compact_every=3)
        gens = []
        for step in range(1, 8):
            _train_interval(t, opt, seed=step)
            gens.append(pub.publish(step=step))
        rep = m.ServingReplica(str(d / "serving"))
        rep.ingest_pending()
        assert rep.generation == gens[-1]
        assert _digest(m, rep.tables["emb"]) == _digest(m, t)
        return gens, sorted(os.listdir(d / "serving"))

    _both(body, tmp_path)


def test_atomic_generation_swap_under_lookups(tmp_path):
    def body(m, d):
        serving = str(d / "serving")
        t = m.KvVariable(DIM, name="g")
        keys = np.arange(64, dtype=np.int64)
        adapter = m.SparseStateAdapter(digest=True).register_table(t)
        pub = m.EmbeddingPublisher(adapter, serving, compact_every=100)
        t.insert(keys, np.full((64, DIM), 1.0, np.float32))
        pub.publish(step=1)
        rep = m.ServingReplica(serving)
        rep.ingest_pending()
        stop = threading.Event()
        torn: list = []

        def reader():
            while not stop.is_set():
                col = rep.lookup(keys)[:, 0]
                if not np.all(col == col[0]):
                    torn.append(np.unique(col))

        readers = [threading.Thread(target=reader) for _ in range(2)]
        for r in readers:
            r.start()
        try:
            for g in range(2, 12):
                t.insert(keys, np.full((64, DIM), float(g), np.float32))
                pub.publish(step=g)
                rep.ingest_pending()
        finally:
            stop.set()
            for r in readers:
                r.join()
        assert not torn, f"torn lookup batches observed: {torn[:3]}"
        assert float(rep.lookup(keys)[0, 0]) == 11.0
        return rep.lookup(keys).tobytes()

    _both(body, tmp_path)


def test_publish_events_schema_valid(tmp_path, monkeypatch):
    def body(m, d):
        log = str(d / "events.jsonl")
        monkeypatch.setenv(m.events.EVENT_LOG_ENV, log)
        t, opt, pub = _mk_publisher(m, d)
        for step in (1, 2, 3):
            _train_interval(t, opt, seed=step)
            pub.publish(step=step)
        rep = m.ServingReplica(str(d / "serving"))
        rep.ingest_pending()
        recorded = m.events.read_events(log)
        monkeypatch.delenv(m.events.EVENT_LOG_ENV)
        serving = [
            e for e in recorded
            if str(e.get("type", "")).startswith("serving_")
            or e.get("type") == "kv_checkpoint"
        ]
        assert any(e.get("type") == "serving_publish" for e in serving)
        assert any(e.get("type") == "serving_ingest" for e in serving)
        problems = [p for e in serving for p in m.validate_event(e)]
        assert not problems, problems
        # the records' shape (type and field names), and the
        # publishes' digests
        return (
            [(e["type"], sorted(e)) for e in serving],
            [e["tables"] for e in serving
             if e["type"] == "serving_publish"],
        )

    _both(body, tmp_path)


def test_late_registered_table_forces_base(tmp_path):
    def body(m, d):
        t, opt, pub = _mk_publisher(m, d)
        _train_interval(t, opt, seed=1)
        pub.publish(step=1)
        _train_interval(t, opt, seed=2)
        pub.publish(step=2)  # delta — chain established
        late = m.KvVariable(DIM, name="late")
        late.insert(np.arange(30, dtype=np.int64),
                    np.ones((30, DIM), np.float32))
        pub.adapter.register_table(late)
        pub.publish(step=3)
        rep = m.ServingReplica(str(d / "serving"))
        rep.ingest_pending()
        assert "late" in rep.tables
        assert _digest(m, rep.tables["late"]) == _digest(m, late)
        late.scatter_add(np.array([3]), np.ones((1, DIM), np.float32))
        pub.publish(step=4)
        rep.ingest_pending()
        assert _digest(m, rep.tables["late"]) == _digest(m, late)
        return _digest(m, late), _digest(m, rep.tables["emb"])

    _both(body, tmp_path)
