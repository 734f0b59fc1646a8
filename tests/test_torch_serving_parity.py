"""Cross-package parity of the serving plane: what either package
publishes, the other serves.

The same seeded table, then a delta chain with inserts, updates,
deletes and an evicted row, goes once through each package's
``EmbeddingPublisher``.  The generations' manifests are equal apart
from the commit timestamps (digests, row counts, links, sizes); each
package's ``ServingReplica`` ingests both chains, and lookups of the
same keys, present and absent, are bit-equal on all four
publisher-replica pairs and equal to the live table's
``gather_or_zeros``.  The router's ``mix64`` and HRW owners agree on
10,000 seeded keys, and a routing table replayed from one journal is
equal in both packages whichever wrote the journal.  (The Brain's sqlite
file crosses over in ``tests/test_torch_brain.py``.)
Tolerance: none — every comparison is of exact bytes or integers.
"""

import os

import numpy as np
import pytest

import dlrover_tpu.checkpoint.sparse as j_sparse
import dlrover_tpu.ops.kv_variable as j_kv
import dlrover_tpu.serving.publisher as j_pub
import dlrover_tpu.serving.replica as j_rep
import dlrover_tpu.serving.router as j_router
import dlrover_tpu_torch.checkpoint.sparse as t_sparse
import dlrover_tpu_torch.ops.kv_variable as t_kv
import dlrover_tpu_torch.serving.publisher as t_pub
import dlrover_tpu_torch.serving.replica as t_rep
import dlrover_tpu_torch.serving.router as t_router

DIM = 16
ROWS = 3000
MODS = {
    "jax": (j_kv, j_sparse, j_pub, j_rep),
    "torch": (t_kv, t_sparse, t_pub, t_rep),
}


def _publish_chain(pkg, serving_dir):
    """Base, then three deltas: updates and inserts; deletes; an
    eviction.  Returns the live table and the generation numbers."""
    kv, sparse, pub_mod, _ = MODS[pkg]
    rng = np.random.default_rng(2024)
    t = kv.KvVariable(DIM, name="emb", seed=11)
    t.insert(np.arange(ROWS, dtype=np.int64),
             rng.normal(size=(ROWS, DIM)).astype(np.float32))
    adapter = sparse.SparseStateAdapter(digest=True).register_table(t)
    # no compaction: the chain stays base + three deltas
    pub = pub_mod.EmbeddingPublisher(adapter, serving_dir,
                                     compact_every=100, compact_ratio=2.0)
    gens = [pub.publish(step=0)]
    # delta 1: updates of seeded rows and brand-new keys
    touched = rng.choice(ROWS, 400, replace=False).astype(np.int64)
    t.scatter_add(touched,
                  rng.normal(size=(400, DIM)).astype(np.float32))
    new = np.arange(ROWS, ROWS + 50, dtype=np.int64)
    t.insert(new, rng.normal(size=(50, DIM)).astype(np.float32))
    gens.append(pub.publish(step=1))
    # delta 2: deletes, among them rows the last delta touched
    t.delete(np.concatenate([touched[:20], np.arange(5, 45)]))
    gens.append(pub.publish(step=2))
    # delta 3: counting gathers lift some rows' frequency, then the
    # eviction drops a row the chain carried earlier
    hot = np.unique(rng.integers(0, ROWS, 3000)).astype(np.int64)
    t.gather(hot)
    t.gather(hot)
    cold = int(np.setdiff1d(touched[20:], hot)[0])
    t.scatter_add(np.array([cold]), np.ones((1, DIM), np.float32))
    t.evict_below(2)
    assert t.gather_or_zeros(np.array([cold])).any() == np.False_
    gens.append(pub.publish(step=3))
    return t, gens


@pytest.fixture(scope="module")
def chains(tmp_path_factory):
    root = tmp_path_factory.mktemp("parity")
    out = {}
    for pkg in MODS:
        d = str(root / pkg)
        table, gens = _publish_chain(pkg, d)
        out[pkg] = (d, table, gens)
    return out


def _manifest(pkg, d, gen):
    m = MODS[pkg][2].read_manifest(d, gen)
    assert m is not None
    m.pop("commit_ts")
    return m


def test_the_chains_publish_the_same_generations(chains):
    jd, jt, jgens = chains["jax"]
    td, tt, tgens = chains["torch"]
    assert jgens == tgens == [1, 2, 3, 4]
    kinds = []
    for g in tgens:
        jm, tm = _manifest("jax", jd, g), _manifest("torch", td, g)
        assert tm == jm, g
        kinds.append(tm["kind"])
    assert kinds == ["base", "delta", "delta", "delta"]
    # the deltas carry deletes and the eviction as tombstones
    assert all(_manifest("torch", td, g)["tables"]["emb"]["dead"] > 0
               for g in (3, 4))
    # the same files, and each generation's blobs hold the same
    # members with the same array bytes
    for g in tgens:
        name = t_pub.gen_dirname(g)
        assert sorted(os.listdir(os.path.join(td, name))) == sorted(
            os.listdir(os.path.join(jd, name)))
        with np.load(os.path.join(td, name, "blobs.npz")) as a, \
                np.load(os.path.join(jd, name, "blobs.npz")) as b:
            assert sorted(a.files) == sorted(b.files)
            for k in a.files:
                assert a[k].dtype == b[k].dtype, (g, k)
                assert a[k].tobytes() == b[k].tobytes(), (g, k)
    assert t_pub.committed_generation(td) == \
        j_pub.committed_generation(jd) == 4
    assert t_sparse.rows_digest(*tt.export()) == \
        j_sparse.rows_digest(*jt.export())


@pytest.mark.parametrize("publisher", ["jax", "torch"])
@pytest.mark.parametrize("replica", ["jax", "torch"])
def test_each_replica_serves_each_chain_bit_for_bit(
    chains, publisher, replica,
):
    d, table, gens = chains[publisher]
    rep_mod = MODS[replica][3]
    rep = rep_mod.ServingReplica(d)
    applied = rep.ingest_pending()
    assert rep.generation == gens[-1]
    assert applied
    want_digest = MODS[publisher][1].rows_digest(*table.export())
    assert MODS[replica][1].rows_digest(
        *rep.tables["emb"].export()) == want_digest
    rng = np.random.default_rng(7)
    keys = np.concatenate([
        rng.integers(0, ROWS + 50, 4000),
        rng.integers(10**6, 2 * 10**6, 500),  # absent keys
    ]).astype(np.int64)
    got = rep.lookup(keys)
    want = table.gather_or_zeros(keys)
    assert got.dtype == np.float32 and got.shape == (len(keys), DIM)
    assert got.tobytes() == want.tobytes()
    # and equal to what the other package's replica serves of the
    # other package's chain
    other = "jax" if publisher == "torch" else "torch"
    _, otable, _ = chains[other]
    assert otable.gather_or_zeros(keys).tobytes() == got.tobytes()


def test_mix64_and_hrw_owners_agree_on_seeded_keys():
    rng = np.random.default_rng(10_000)
    keys = rng.integers(-(2**63), 2**63 - 1, 10_000, dtype=np.int64)
    keys = keys.tolist()
    assert [t_router.mix64(k) for k in keys] == [
        j_router.mix64(k) for k in keys]
    for members in ([0, 1], [0, 1, 2], [0, 2, 5, 7], list(range(9))):
        assert [t_router.hrw_owner(k, members) for k in keys] == [
            j_router.hrw_owner(k, members) for k in keys]


RECORDS = [
    ("member", {"replica_id": 0, "addr": "a:1", "generation": 1}),
    ("member", {"replica_id": 1, "addr": "b:2", "generation": 1}),
    ("member", {"replica_id": 2, "addr": "c:3", "generation": 1}),
    ("admit", {"replica_id": 0, "generation": 3}),
    ("drain", {"replica_id": 1, "target_generation": 4}),
    ("admit", {"replica_id": 1, "generation": 4}),
    ("drain", {"replica_id": 2, "target_generation": 4}),
    ("remove", {"replica_id": 2}),
    ("member", {"replica_id": 3, "addr": "d:4", "generation": 4}),
]


@pytest.mark.parametrize("writer", ["jax", "torch"])
@pytest.mark.parametrize("close", [False, True])
def test_routing_table_replays_equal_across_packages(
    tmp_path, writer, close,
):
    jdir = str(tmp_path / "journal")
    mod = t_router if writer == "torch" else j_router
    live = mod.RoutingTable(jdir)
    for kind, rec in RECORDS:
        live.record(kind, rec)
    want = live.snapshot()
    if close:
        live.close()  # compacts into a snapshot
    try:
        assert t_router.RoutingTable.replayed(jdir).snapshot() == want
        assert j_router.RoutingTable.replayed(jdir).snapshot() == want
    finally:
        if not close:
            live.close()


def test_base_ingest_needs_no_private_numpy_api(tmp_path, monkeypatch):
    """numpy 2.3 removed ``numpy.lib.format._read_array_header``, which
    the reference's windowed base ingest calls (its replica then
    refuses every base: "blob member ... unreadable"); the port's reads
    the header through the public per-version readers.  Shown here by
    hiding the private function from every caller outside numpy (this
    box's public readers still call it)."""
    import sys

    from numpy.lib import format as npformat

    serving = str(tmp_path / "serving")
    table, gens = _publish_chain("torch", serving)
    private = npformat._read_array_header
    home = npformat.read_array_header_1_0.__module__

    def numpy_internal_only(*args, **kwargs):
        if sys._getframe(1).f_globals.get("__name__") != home:
            raise AttributeError("module 'numpy.lib.format' has no "
                                 "attribute '_read_array_header'")
        return private(*args, **kwargs)

    monkeypatch.setattr(npformat, "_read_array_header",
                        numpy_internal_only)
    rep = t_rep.ServingReplica(serving)
    assert rep.ingest_pending() and rep.generation == gens[-1]
    assert t_sparse.rows_digest(*rep.tables["emb"].export()) == \
        t_sparse.rows_digest(*table.export())
    ref = j_rep.ServingReplica(serving)
    assert ref.ingest_pending() == [] and ref.generation == 0
