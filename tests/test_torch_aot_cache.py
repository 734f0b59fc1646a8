"""Twins of ``tests/test_aot_cache.py`` for the port's AOT step cache
(``dlrover_tpu_torch/common/aot_cache.py``), with the compile cache's
cases of ``tests/test_recovery.py`` (``common/compile_cache.py``) and
the kernel build's directory switch (``ops/cuda_build.py``).

The port's step is eager: an entry is the resolved step's descriptor and
the kernel libraries its first call loaded, and a hit loads them before
the first call (on the CPU an entry lists none, so a hit is the key
match alone; a library built here with ``gcc`` stands in for a kernel
library where a case needs one).  Each case runs the same sequence
through the JAX package's cache and holds the port's decisions to the
reference's: hit or miss, wrote, preloaded and, for the profiler, the
``aot_cache`` events' keys.  The steps themselves are held to the
reference's within rtol 1e-5 / atol 1e-6 (fp32 Adam on a tanh MLP), and
a resolved step to the plain eager step bit for bit.  A torch version
mismatch replaces the reference's jax version case.
"""

import json
import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jax.config.update("jax_platforms", "cpu")
optax = pytest.importorskip("optax")

import jax.numpy as jnp  # noqa: E402

from dlrover_tpu.common import aot_cache as j_aot  # noqa: E402
from dlrover_tpu.common import compile_cache as j_cc  # noqa: E402
from dlrover_tpu.trainer import elastic_trainer as j_et  # noqa: E402
from dlrover_tpu_torch.common import aot_cache  # noqa: E402
from dlrover_tpu_torch.common import compile_cache as cc  # noqa: E402
from dlrover_tpu_torch.ops import cuda_build  # noqa: E402
from dlrover_tpu_torch.trainer.elastic_trainer import (  # noqa: E402
    TrainState,
    make_train_step,
    resolve_train_step,
)

RTOL, ATOL = 1e-5, 1e-6
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# -- the step, in both packages ----------------------------------------------


def _j_params():
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    return {
        "w1": jax.random.normal(k1, (6, 8), jnp.float32),
        "w2": jax.random.normal(k2, (8, 2), jnp.float32),
    }


def _np_batch(rows=4):
    rng = np.random.default_rng(0)
    return {
        "x": rng.normal(size=(rows, 6)).astype(np.float32),
        "y": rng.normal(size=(rows, 2)).astype(np.float32),
    }


def _j_loss(p, batch):
    h = jnp.tanh(batch["x"] @ p["w1"])
    return ((h @ p["w2"] - batch["y"]) ** 2).mean()


def _j_fresh(lr=1e-3, loss=_j_loss):
    optimizer = optax.adam(lr)
    state = j_et.TrainState.create(_j_params(), optimizer)
    batch = {k: jnp.asarray(v) for k, v in _np_batch().items()}
    return j_et.make_train_step(loss, optimizer), state, batch


class _MLP(torch.nn.Module):
    def __init__(self):
        super().__init__()
        p = _j_params()
        self.w1 = torch.nn.Parameter(torch.from_numpy(np.array(p["w1"])))
        self.w2 = torch.nn.Parameter(torch.from_numpy(np.array(p["w2"])))


def _loss(module, batch):
    h = torch.tanh(batch["x"] @ module.w1)
    return ((h @ module.w2 - batch["y"]) ** 2).mean()


def _fresh(lr=1e-3, loss=_loss, rows=4):
    module = _MLP()
    optimizer = torch.optim.Adam(module.parameters(), lr=lr)
    step_fn = make_train_step(loss, optimizer, device="cpu")
    return step_fn, TrainState.create(module, optimizer), _np_batch(rows)


def _outcome(res):
    """What both packages decide: source, hit, wrote, preloaded."""
    return (res.source, res.hit, res.wrote, res.preloaded)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


# -- the round trip across processes ------------------------------------------

# one subprocess script, two modes: "write" resolves (a miss), runs the
# step and prints its outputs; "load" must HIT and prints the resolved
# step's outputs; "plain" runs the step without the cache
_CHILD = textwrap.dedent("""
    import json, sys
    import numpy as np
    import torch
    from dlrover_tpu_torch.common import aot_cache
    from dlrover_tpu_torch.trainer.elastic_trainer import (
        TrainState, make_train_step,
    )

    mode, cache_dir = sys.argv[1], sys.argv[2]
    w = np.load(sys.argv[3])
    module = torch.nn.Module()
    module.w1 = torch.nn.Parameter(torch.from_numpy(w["w1"]))
    module.w2 = torch.nn.Parameter(torch.from_numpy(w["w2"]))

    def loss(m, batch):
        h = torch.tanh(batch["x"] @ m.w1)
        return ((h @ m.w2 - batch["y"]) ** 2).mean()

    optimizer = torch.optim.Adam(module.parameters(), lr=1e-3)
    step_fn = make_train_step(loss, optimizer, device="cpu")
    state = TrainState.create(module, optimizer)
    batch = {"x": w["x"], "y": w["y"]}
    if mode == "plain":
        fn = step_fn
    else:
        res = aot_cache.resolve_step(
            step_fn, (state, batch), label="xproc", cache_dir=cache_dir)
        if mode == "load":
            assert res.source == "aot" and res.hit, (res.source, res.reason)
        fn = res.fn
    new_state, metrics = fn(state, batch)
    if mode == "write":
        assert res.source == "trace" and res.wrote, res
    print("RESULT " + json.dumps({
        "loss": metrics["loss"].numpy().tobytes().hex(),
        "grad_norm": metrics["grad_norm"].numpy().tobytes().hex(),
        "w1": module.w1.detach().numpy().tobytes().hex(),
        "w2": module.w2.detach().numpy().tobytes().hex(),
        "step": new_state.step,
    }))
""")


@pytest.fixture(scope="module")
def round_trip(tmp_path_factory):
    """The file's subprocesses, once: write, load and the plain step."""
    tmp = tmp_path_factory.mktemp("xproc")
    cache_dir = str(tmp / "aot")
    inputs = str(tmp / "inputs.npz")
    p = _j_params()
    np.savez(inputs, w1=np.array(p["w1"]), w2=np.array(p["w2"]),
             **_np_batch())
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = {}
    for mode in ("write", "load", "plain"):
        proc = subprocess.run(
            [sys.executable, "-c", _CHILD, mode, cache_dir, inputs],
            env=env, capture_output=True, text=True, timeout=240)
        assert proc.returncode == 0, proc.stderr[-2000:]
        line = [ln for ln in proc.stdout.splitlines()
                if ln.startswith("RESULT ")][-1]
        out[mode] = json.loads(line[len("RESULT "):])
    out["entries"] = aot_cache.aot_entries(cache_dir)
    return out


def test_roundtrip_bit_identity_across_processes(round_trip):
    """Process A resolves (a miss), steps and writes; process B resolves
    the entry (a hit) and its step's outputs equal A's and the plain
    eager step's bit for bit; the step is the reference's within its
    tolerance."""
    assert round_trip["entries"] == 1
    assert round_trip["write"] == round_trip["load"] == round_trip["plain"]
    step_fn, state, batch = _j_fresh()
    j_state, j_metrics = step_fn(state, batch)
    got = np.frombuffer(bytes.fromhex(round_trip["load"]["loss"]),
                        np.float32)
    _close(got, j_metrics["loss"])
    w1 = np.frombuffer(bytes.fromhex(round_trip["load"]["w1"]), np.float32)
    _close(w1.reshape(6, 8), j_state.params["w1"])


# -- in-process cases ----------------------------------------------------------


def test_miss_writes_then_same_process_hits(tmp_path):
    cache_dir = str(tmp_path / "aot")
    step_fn, state, batch = _fresh()
    r1 = aot_cache.resolve_step(
        step_fn, (state, batch), label="t", cache_dir=cache_dir)
    assert r1.source == "trace" and r1.deferred and not r1.wrote
    s1, m1 = r1.fn(state, batch)
    assert r1.wrote and r1.trace_s > 0
    step_fn2, state2, batch2 = _fresh()
    r2 = aot_cache.resolve_step(
        step_fn2, (state2, batch2), label="t", cache_dir=cache_dir)
    assert r2.source == "aot" and r2.hit
    s2, m2 = r2.fn(state2, batch2)
    assert float(m1["loss"]) == float(m2["loss"])
    assert torch.equal(s1.module.w1, s2.module.w1)

    jd = str(tmp_path / "jaot")
    js, jst, jb = _j_fresh()
    j1 = j_aot.resolve_step(js, (jst, jb), label="t", cache_dir=jd)
    _, jm = j1.fn(jst, jb)
    js2, jst2, jb2 = _j_fresh()
    j2 = j_aot.resolve_step(js2, (jst2, jb2), label="t", cache_dir=jd)
    assert [_outcome(r1), _outcome(r2)] == [_outcome(j1), _outcome(j2)]
    _close(m2["loss"].numpy(), jm["loss"])


def test_world_size_mismatch_falls_back(tmp_path, monkeypatch):
    cache_dir = str(tmp_path / "aot")
    step_fn, state, batch = _fresh()
    r1 = aot_cache.resolve_step(
        step_fn, (state, batch), label="t", cache_dir=cache_dir)
    r1.fn(state, batch)
    assert r1.wrote
    js, jst, jb = _j_fresh()
    j1 = j_aot.resolve_step(js, (jst, jb), label="t",
                            cache_dir=str(tmp_path / "j"))
    monkeypatch.setenv("DLROVER_WORLD_SIZE", "4")
    r2 = aot_cache.resolve_step(
        step_fn, (state, batch), label="t", cache_dir=cache_dir)
    # a resized world must never take the old world's entry
    assert r2.source == "trace" and not r2.hit
    _, m = r2.fn(state, batch)
    assert np.isfinite(float(m["loss"]))
    j2 = j_aot.resolve_step(js, (jst, jb), label="t",
                            cache_dir=str(tmp_path / "j"))
    assert (r2.source, r2.hit) == (j2.source, j2.hit)
    assert j1.wrote


def test_aval_shape_mismatch_falls_back(tmp_path):
    cache_dir = str(tmp_path / "aot")
    step_fn, state, batch = _fresh()
    aot_cache.resolve_step(
        step_fn, (state, batch), label="t", cache_dir=cache_dir
    ).fn(state, batch)
    bigger = {"x": np.zeros((8, 6), np.float32),
              "y": np.zeros((8, 2), np.float32)}
    r2 = aot_cache.resolve_step(
        step_fn, (state, bigger), label="t", cache_dir=cache_dir)
    assert r2.source == "trace" and not r2.hit
    _, m = r2.fn(state, bigger)
    assert np.isfinite(float(m["loss"]))

    jd = str(tmp_path / "j")
    js, jst, jb = _j_fresh()
    j_aot.resolve_step(js, (jst, jb), label="t", cache_dir=jd)
    jbig = {"x": jnp.zeros((8, 6), jnp.float32),
            "y": jnp.zeros((8, 2), jnp.float32)}
    j2 = j_aot.resolve_step(js, (jst, jbig), label="t", cache_dir=jd)
    assert (r2.source, r2.hit) == (j2.source, j2.hit)


def _foreign(path_key, cache_dir, mod, field, value):
    """Restamp an entry and its label index with a foreign ``field``."""
    path = mod.entry_path(path_key, cache_dir)
    with open(path, "rb") as f:
        entry = pickle.loads(f.read())
    entry["desc"][field] = value
    with open(path, "wb") as f:
        f.write(pickle.dumps(entry))
    with open(os.path.join(cache_dir, "t.idx"), "w") as f:
        json.dump({"key": path_key, "desc": entry["desc"]}, f)


def test_torch_version_mismatch_falls_back(tmp_path):
    """An entry stamped by another torch never resolves (the reference's
    jax version case): both the fast path and the keyed path refuse it,
    as the reference's refuse a foreign jax."""
    cache_dir = str(tmp_path / "aot")
    step_fn, state, batch = _fresh()
    r1 = aot_cache.resolve_step(
        step_fn, (state, batch), label="t", cache_dir=cache_dir)
    r1.fn(state, batch)
    _foreign(r1.key, cache_dir, aot_cache, "torch", "0.0.0-foreign")
    builder_calls = []

    def builder():
        builder_calls.append(1)
        return (state, batch)

    r2 = aot_cache.resolve_step(
        step_fn, builder, label="t", cache_dir=cache_dir)
    assert r2.source == "trace" and not r2.hit
    assert builder_calls  # fast path refused -> full path ran
    _, m = r2.fn(state, batch)
    assert np.isfinite(float(m["loss"]))

    jd = str(tmp_path / "j")
    js, jst, jb = _j_fresh()
    j1 = j_aot.resolve_step(js, (jst, jb), label="t", cache_dir=jd)
    _foreign(j1.key, jd, j_aot, "jax", "0.0.0-foreign")
    j2 = j_aot.resolve_step(
        js, lambda: j_et.abstract_like((jst, jb)), label="t", cache_dir=jd)
    assert (r2.source, r2.hit) == (j2.source, j2.hit)


def test_corrupt_entry_falls_back(tmp_path):
    cache_dir = str(tmp_path / "aot")
    step_fn, state, batch = _fresh()
    r1 = aot_cache.resolve_step(
        step_fn, (state, batch), label="t", cache_dir=cache_dir)
    _, m1 = r1.fn(state, batch)
    with open(aot_cache.entry_path(r1.key, cache_dir), "wb") as f:
        f.write(b"definitely not a pickle")
    step_fn2, state2, batch2 = _fresh()
    r2 = aot_cache.resolve_step(
        step_fn2, (state2, batch2), label="t", cache_dir=cache_dir)
    assert r2.source == "trace" and not r2.hit  # never a crash
    _, m2 = r2.fn(state2, batch2)
    assert float(m1["loss"]) == float(m2["loss"])

    jd = str(tmp_path / "j")
    js, jst, jb = _j_fresh()
    j1 = j_aot.resolve_step(js, (jst, jb), label="t", cache_dir=jd)
    with open(j_aot.entry_path(j1.key, jd), "wb") as f:
        f.write(b"definitely not a pickle")
    js2, jst2, jb2 = _j_fresh()
    j2 = j_aot.resolve_step(js2, (jst2, jb2), label="t", cache_dir=jd)
    assert (r2.source, r2.hit) == (j2.source, j2.hit)


def test_label_index_fast_path_skips_example_build(tmp_path):
    """The warm fast path resolves by label WITHOUT building the
    examples — the builder must never run on a hit; its first call then
    holds the real arguments to the entry's descriptor."""
    cache_dir = str(tmp_path / "aot")
    step_fn, state, batch = _fresh()
    r1 = aot_cache.resolve_step(
        step_fn, (state, batch), label="t", cache_dir=cache_dir)
    r1.fn(state, batch)
    assert r1.wrote

    def exploding_builder():
        raise AssertionError("builder must not run on a fast hit")

    r2 = aot_cache.resolve_step(
        step_fn, exploding_builder, label="t", cache_dir=cache_dir)
    assert r2.source == "aot" and r2.hit and r2.extra.get("fast")
    _, m = r2.fn(state, batch)
    assert np.isfinite(float(m["loss"]))

    jd = str(tmp_path / "j")
    js, jst, jb = _j_fresh()
    j_aot.resolve_step(js, (jst, jb), label="t", cache_dir=jd)
    j2 = j_aot.resolve_step(js, exploding_builder, label="t", cache_dir=jd)
    assert _outcome(r2) == _outcome(j2)
    assert r2.extra.get("fast") is j2.extra.get("fast") is True


def test_fast_hit_with_drifted_inputs_runs_the_plain_step(tmp_path):
    """The fast path keys no inputs: a first call whose batch drifted
    from the entry's is refused before the step runs and falls back to
    the plain step (the reference's loaded executable refuses the
    avals alike), so the step runs exactly once."""
    cache_dir = str(tmp_path / "aot")
    step_fn, state, batch = _fresh()
    aot_cache.resolve_step(
        step_fn, (state, batch), label="t", cache_dir=cache_dir
    ).fn(state, batch)
    step_fn2, state2, _ = _fresh(rows=8)
    bigger = _np_batch(8)
    r2 = aot_cache.resolve_step(
        step_fn2, lambda: (state2, bigger), label="t", cache_dir=cache_dir)
    assert r2.hit
    s, _ = r2.fn(state2, bigger)
    assert s.step == 1


def test_guarded_call_falls_back_on_first_failure():
    calls = []

    def bad(*a):
        raise ValueError("aval drift")

    def good(*a):
        calls.append(a)
        return "ok"

    for mod in (aot_cache, j_aot):
        calls.clear()
        guarded = mod._GuardedCall(bad, good)
        assert guarded(1, 2) == "ok"
        assert calls == [(1, 2)]
        # permanently on the fallback afterwards
        assert guarded(3) == "ok"

    # a failure inside the step itself (its checks passed) is re-raised,
    # never retried on the fallback: the step would run twice
    class Entered:
        entered = True

        def __call__(self, *a):
            raise RuntimeError("the step failed")

    guarded = aot_cache._GuardedCall(Entered(), good)
    calls.clear()
    with pytest.raises(RuntimeError, match="the step failed"):
        guarded(1)
    assert calls == []


def test_preload_serves_entries_from_memory(tmp_path):
    """preload_entries + file deletion: the entry still resolves — this
    is exactly what a forked worker inherits from the template."""
    cache_dir = str(tmp_path / "aot")
    step_fn, state, batch = _fresh()
    r1 = aot_cache.resolve_step(
        step_fn, (state, batch), label="t", cache_dir=cache_dir)
    r1.fn(state, batch)
    before = aot_cache.preloaded_entries()
    n, nbytes = aot_cache.preload_entries(cache_dir)
    jd = str(tmp_path / "j")
    js, jst, jb = _j_fresh()
    j1 = j_aot.resolve_step(js, (jst, jb), label="t", cache_dir=jd)
    try:
        assert n >= 1 and nbytes > 0
        assert aot_cache.preloaded_entries() >= before + 1
        os.unlink(aot_cache.entry_path(r1.key, cache_dir))
        os.unlink(os.path.join(cache_dir, "t.idx"))
        step_fn2, state2, batch2 = _fresh()
        r2 = aot_cache.resolve_step(
            step_fn2, (state2, batch2), label="t", cache_dir=cache_dir)
        assert r2.source == "aot" and r2.hit and r2.preloaded
        jn, _ = j_aot.preload_entries(jd)
        os.unlink(j_aot.entry_path(j1.key, jd))
        js2, jst2, jb2 = _j_fresh()
        j2 = j_aot.resolve_step(js2, (jst2, jb2), label="t", cache_dir=jd)
        assert (n, _outcome(r2)) == (jn, _outcome(j2))
    finally:
        aot_cache._PRELOADED.clear()
        j_aot._PRELOADED.clear()


def test_forkserver_pretrace_inherits_entries(tmp_path):
    """DLROVER_AOT_PRETRACE: the template preloads entry bytes and a
    forked child INHERITS them — proven by deleting the entry after the
    template started and asking the child what it sees in memory."""
    from dlrover_tpu_torch.agent.forkserver import WorkerForkServer

    cache_dir = tmp_path / "aot"
    cache_dir.mkdir()
    (cache_dir / "deadbeef.aotx").write_bytes(
        pickle.dumps({"v": 1, "desc": {}, "libraries": []}))
    out = tmp_path / "seen.txt"
    child = tmp_path / "child.py"
    child.write_text(textwrap.dedent(f"""
        from dlrover_tpu_torch.common import aot_cache
        with open({str(out)!r}, "w") as f:
            f.write(str(aot_cache.preloaded_entries()))
    """))
    probe = tmp_path / "probe.py"
    probe.write_text("pass\n")
    knobs = {
        "DLROVER_AOT_PRETRACE": "1",
        "DLROVER_AOT_CACHE_DIR": str(cache_dir),
        "DLROVER_PRELOAD": "json",
    }
    env = dict(os.environ, PYTHONPATH=ROOT, **knobs)
    old = {k: os.environ.get(k) for k in knobs}
    os.environ.update(knobs)
    fs = WorkerForkServer()
    try:
        # first spawn forces the template up (it preloads at start
        # and rescans before every fork)
        h = fs.spawn([str(probe)], env, timeout=60)
        assert h.wait(timeout=120) == 0
        # the template holds the bytes now; the file can vanish
        (cache_dir / "deadbeef.aotx").unlink()
        h = fs.spawn([str(child)], env, timeout=60)
        assert h.wait(timeout=120) == 0
        assert out.read_text().strip() == "1"
    finally:
        fs.close()
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _book_sequence(pkg, tmp_path, monkeypatch, fresh, log):
    """The reference's profiler sequence (a miss, then a hit of a new
    incarnation) through one package; returns both losses and the
    events."""
    if pkg == "port":
        from dlrover_tpu_torch.telemetry.events import read_events
        from dlrover_tpu_torch.trainer.recovery import RecoveryProfiler
    else:
        from dlrover_tpu.telemetry.events import read_events
        from dlrover_tpu.trainer.recovery import RecoveryProfiler
    monkeypatch.setenv("DLROVER_EVENT_LOG", str(log))
    monkeypatch.setenv("DLROVER_AOT_CACHE_DIR", str(tmp_path / pkg))
    step_fn, state, batch = fresh()
    p0 = RecoveryProfiler(restart_count=0, node_rank=0)
    step0 = p0.resolve_step(step_fn, (state, batch))
    _, m0 = step0(state, batch)
    step_fn1, state1, batch1 = fresh()
    p1 = RecoveryProfiler(restart_count=1, node_rank=0)
    step1 = p1.resolve_step(step_fn1, (state1, batch1))
    _, m1 = step1(state1, batch1)
    return (p0, p1), (m0, m1), list(read_events(str(log)))


def test_profiler_resolve_books_phases_and_events(tmp_path, monkeypatch):
    """RecoveryProfiler.resolve_step: MISS books the first call as the
    retrace and writes; HIT books aot (the library loads) and the
    first eager call as the retrace; aot_cache and compile_cache
    (status) events land with the reference's keys; the timeline budget
    and report read them back."""
    from dlrover_tpu_torch.telemetry import timeline as tl
    from dlrover_tpu_torch.telemetry.timeline import recovery_budgets

    (p0, p1), (m0, m1), evs = _book_sequence(
        "port", tmp_path, monkeypatch, _fresh, tmp_path / "port.jsonl")
    assert p0.aot_hit is False and p0.phases["retrace"] > 0
    assert "aot" in p0.phases
    assert p1.aot_hit is True and p1.cache_hit is True
    assert p1.phases["aot"] > 0 and p1.phases["retrace"] > 0
    assert float(m1["loss"]) == float(m0["loss"])

    aot_events = [e for e in evs if e["type"] == "aot_cache"]
    assert [e["hit"] for e in aot_events] == [False, True]
    assert aot_events[0]["wrote"] is True
    assert [e["resolution"] for e in aot_events] == [
        "eager-miss", "eager-hit"]
    cc_events = [e for e in evs if e["type"] == "compile_cache"]
    assert cc_events[-1]["status"] == "aot-hit" and cc_events[-1]["hit"]
    assert cc_events[-1]["aot_entries"] >= 1
    # on the CPU the step loads no kernel library
    assert cc_events[-1]["entries_before"] == cc_events[-1][
        "entries_after"] == 0

    budgets = recovery_budgets(evs)
    rec = budgets[(0, 1)]
    assert rec["aot_cache_hit"] is True and rec["aot"] > 0
    assert "aot=HIT" in tl.to_report(tl.assemble(evs))

    # the reference's sequence: the same decisions, the same event keys
    # (the port's adds the libraries it lists), a loss within tolerance
    _, (_, jm1), jevs = _book_sequence(
        "ref", tmp_path, monkeypatch, _j_fresh, tmp_path / "ref.jsonl")
    j_aot_events = [e for e in jevs if e["type"] == "aot_cache"]
    assert [(e["hit"], e["wrote"], e["preloaded"]) for e in aot_events] == [
        (e["hit"], e["wrote"], e["preloaded"]) for e in j_aot_events]
    for got, want in zip(aot_events, j_aot_events):
        assert set(want) <= set(got)
        assert set(got) - set(want) <= {"libraries", "libraries_preloaded",
                                        "read_s", "unpickle_s", "fast",
                                        "deserialize_s",
                                        "deserialize_cpu_s"}
    j_cc = [e for e in jevs if e["type"] == "compile_cache"]
    assert [e["status"] for e in j_cc][-1] == cc_events[-1]["status"]
    _close(m1["loss"].numpy(), jm1["loss"])


def test_resolve_train_step_helper_without_profiler(tmp_path, monkeypatch):
    cache_dir = str(tmp_path / "aot")
    monkeypatch.setenv("DLROVER_AOT_CACHE_DIR", cache_dir)
    step_fn, state, batch = _fresh()
    step = resolve_train_step(step_fn, state, batch)
    _, m = step(state, batch)
    assert np.isfinite(float(m["loss"]))
    assert aot_cache.aot_entries(cache_dir) == 1

    monkeypatch.setenv("DLROVER_AOT_CACHE_DIR", str(tmp_path / "j"))
    js, jst, jb = _j_fresh()
    j_step = j_et.resolve_train_step(
        js, j_et.abstract_like(jst), j_et.abstract_like(jb))
    _, jm = j_step(jst, jb)
    assert j_aot.aot_entries(str(tmp_path / "j")) == 1
    _close(m["loss"].numpy(), jm["loss"])


def test_resolve_step_async_join(tmp_path, monkeypatch):
    """The async resolve: the join books the wait as the aot phase and
    returns a callable equal to the sync result."""
    from dlrover_tpu_torch.trainer.recovery import RecoveryProfiler

    monkeypatch.setenv("DLROVER_AOT_CACHE_DIR", str(tmp_path / "aot"))
    monkeypatch.setenv("DLROVER_EVENT_LOG", str(tmp_path / "ev.jsonl"))
    step_fn, state, batch = _fresh()
    p0 = RecoveryProfiler(restart_count=0, node_rank=0)
    step0 = p0.resolve_step_async(step_fn, lambda: (state, batch))()
    _, m = step0(state, batch)
    step_fn1, state1, batch1 = _fresh()
    p1 = RecoveryProfiler(restart_count=1, node_rank=0)
    step1 = p1.resolve_step_async(step_fn1, lambda: (state1, batch1))()
    assert p1.aot_hit is True
    _, m1 = step1(state1, batch1)
    assert float(m1["loss"]) == float(m["loss"])
    assert "aot" in p1.phases


def test_code_change_invalidates_entry(tmp_path):
    """Same label, same inputs, DIFFERENT code: the fingerprint half of
    the key must refuse the stale entry, and so must a hyperparameter
    captured in a closure — in both packages."""
    cache_dir = str(tmp_path / "aot")
    step_a, state, batch = _fresh()
    r1 = aot_cache.resolve_step(
        step_a, (state, batch), label="t", cache_dir=cache_dir)
    r1.fn(state, batch)
    assert r1.wrote

    def other_loss(m, b):
        h = torch.tanh(b["x"] @ m.w1)
        return 2.0 * ((h @ m.w2 - b["y"]) ** 2).mean()

    step_b, state_b, batch_b = _fresh(loss=other_loss)
    r2 = aot_cache.resolve_step(
        step_b, (state_b, batch_b), label="t", cache_dir=cache_dir)
    assert r2.source == "trace" and not r2.hit
    lr_changed, state_c, batch_c = _fresh(lr=5e-3)
    r3 = aot_cache.resolve_step(
        lr_changed, (state_c, batch_c), label="t", cache_dir=cache_dir)
    assert not r3.hit  # hyperparameter captured in a closure

    jd = str(tmp_path / "j")
    ja, jst, jb = _j_fresh()
    j_aot.resolve_step(ja, (jst, jb), label="t", cache_dir=jd)

    def j_other(p, b):
        h = jnp.tanh(b["x"] @ p["w1"])
        return 2.0 * ((h @ p["w2"] - b["y"]) ** 2).mean()

    jb_, jst_b, jb_b = _j_fresh(loss=j_other)
    j2 = j_aot.resolve_step(jb_, (jst_b, jb_b), label="t", cache_dir=jd)
    jc, jst_c, jb_c = _j_fresh(lr=5e-3)
    j3 = j_aot.resolve_step(jc, (jst_c, jb_c), label="t", cache_dir=jd)
    assert (r2.hit, r3.hit) == (j2.hit, j3.hit) == (False, False)


# -- the kernel libraries an entry lists --------------------------------------


@pytest.fixture()
def loaded_guard():
    """Restore the kernel build's records of loaded libraries."""
    saved = (dict(cuda_build._loaded), dict(cuda_build._loaded_info))
    yield
    for d, s in zip((cuda_build._loaded, cuda_build._loaded_info), saved):
        d.clear()
        d.update(s)


def _gcc_library(path):
    """A real shared library at ``path`` (it stands in for a kernel
    library, which only nvcc builds)."""
    src = path.parent / "stand_in.c"
    src.write_text("int dlr_stand_in(void) { return 7; }\n")
    subprocess.run(["gcc", "-shared", "-fPIC", "-o", str(path), str(src)],
                   check=True)


def test_entry_lists_and_loads_its_kernel_libraries(tmp_path, monkeypatch,
                                                    loaded_guard):
    """An entry lists the libraries its first call loaded; a later
    resolve loads them without building, and refuses a library whose
    file no longer carries the current sources' hash."""
    monkeypatch.setenv(cc.DLROVER_CACHE_DIR_ENV, str(tmp_path / "cache"))
    lib = cuda_build.library_path("quantization")
    assert str(lib).startswith(str(tmp_path / "cache" / "kernels"))
    lib.parent.mkdir(parents=True)
    _gcc_library(lib)
    cache_dir = str(tmp_path / "aot")
    step_fn, state, batch = _fresh()

    def step_with_kernel(st, b):
        cuda_build.load("quantization")  # the library exists: no nvcc
        return step_fn(st, b)

    r1 = aot_cache.resolve_step(
        step_with_kernel, (state, batch), label="k", cache_dir=cache_dir)
    r1.fn(state, batch)
    with open(aot_cache.entry_path(r1.key, cache_dir), "rb") as f:
        entry = pickle.loads(f.read())
    assert [(x["name"], x["file"]) for x in entry["libraries"]] == [
        ("quantization", str(lib))]
    assert cc.cache_entries(str(tmp_path / "cache")) == 1

    cuda_build._loaded.clear()
    cuda_build._loaded_info.clear()
    timings = {}
    got = aot_cache.load_entry(r1.key, entry["desc"], cache_dir, timings)
    assert [x["name"] for x in got] == ["quantization"]
    assert cuda_build._loaded["quantization"].dlr_stand_in() == 7
    assert timings["libraries"] == 1 and not timings["libraries_preloaded"]

    # a stale library (the sources changed since) is a miss
    cuda_build._loaded.clear()
    cuda_build._loaded_info.clear()
    entry["libraries"][0]["file"] = str(lib.with_name(
        "quantization-0000000000000000.so"))
    with open(aot_cache.entry_path(r1.key, cache_dir), "wb") as f:
        f.write(pickle.dumps(entry))
    assert aot_cache.load_entry(r1.key, entry["desc"], cache_dir) is None


def test_preload_loads_the_listed_libraries(tmp_path, monkeypatch,
                                            loaded_guard):
    """The template's preload loads an entry's libraries (a dlopen), so
    a forked worker's resolve finds them loaded: ``libraries_preloaded``."""
    monkeypatch.setenv(cc.DLROVER_CACHE_DIR_ENV, str(tmp_path / "cache"))
    lib = cuda_build.library_path("quantization")
    lib.parent.mkdir(parents=True)
    _gcc_library(lib)
    cache_dir = str(tmp_path / "aot")
    desc = {"v": 1}
    assert aot_cache.save_entry(
        "k" * 32, desc, [{"name": "quantization", "hash": "x",
                          "file": str(lib)}], cache_dir)
    cuda_build._loaded.clear()
    cuda_build._loaded_info.clear()
    try:
        assert aot_cache.preload_entries(cache_dir)[0] == 1
        assert [x["name"] for x in cuda_build.loaded_libraries()] == [
            "quantization"]
        timings = {}
        assert aot_cache.load_entry("k" * 32, desc, cache_dir, timings)
        assert timings["libraries_preloaded"] is True
    finally:
        aot_cache._PRELOADED.clear()


# -- the compile cache ---------------------------------------------------------


def test_job_cache_dir_resolution_order(tmp_path, monkeypatch):
    """The reference's order without its step 2 (an ambient
    ``JAX_COMPILATION_CACHE_DIR``, which torch has no counterpart of):
    the explicit knob, else the job-keyed default, which both packages
    key by the same job identity."""
    for mod in (cc, j_cc):
        monkeypatch.delenv(mod.DLROVER_CACHE_DIR_ENV, raising=False)
    monkeypatch.delenv(j_cc.CACHE_DIR_ENV, raising=False)
    monkeypatch.delenv("DLROVER_JOB_NAME", raising=False)
    default = cc.job_cache_dir()
    assert "dlrover_torch_cache_" in default
    suffix = default.rsplit("dlrover_torch_cache_", 1)[1]
    assert j_cc.job_cache_dir().endswith("dlrover_jax_cache_" + suffix)
    monkeypatch.setenv("DLROVER_SHARED_DIR", str(tmp_path / "a"))
    a1, a2 = cc.job_cache_dir(), cc.job_cache_dir()
    monkeypatch.setenv("DLROVER_SHARED_DIR", str(tmp_path / "b"))
    b = cc.job_cache_dir()
    assert a1 == a2 and a1 != b
    monkeypatch.setenv("DLROVER_JOB_NAME", "jobx")
    assert cc.job_cache_dir().endswith("dlrover_torch_cache_jobx")
    # an ambient JAX_COMPILATION_CACHE_DIR moves the reference only
    monkeypatch.setenv(j_cc.CACHE_DIR_ENV, "/ambient")
    assert j_cc.job_cache_dir() == "/ambient"
    assert cc.job_cache_dir() != "/ambient"
    monkeypatch.setenv(cc.DLROVER_CACHE_DIR_ENV, "/explicit")
    assert cc.job_cache_dir() == j_cc.job_cache_dir() == "/explicit"


def test_cache_env_and_entry_count(tmp_path, monkeypatch):
    cache = tmp_path / "cache"
    monkeypatch.setenv(cc.DLROVER_CACHE_DIR_ENV, str(cache))
    assert cc.cache_env() == {cc.DLROVER_CACHE_DIR_ENV: str(cache)}
    assert cc.cache_env("/x") == {cc.DLROVER_CACHE_DIR_ENV: "/x"}
    assert j_cc.cache_env()[j_cc.CACHE_DIR_ENV] == str(cache)
    # entry counting: only built libraries are entries, not the build's
    # logs nor an nvcc output still in flight
    assert cc.cache_entries(str(cache)) == 0
    kernels = cache / "kernels"
    kernels.mkdir(parents=True)
    (kernels / "flash_attention-abc.so").write_bytes(b"x")
    (kernels / "flash_attention-abc.log").write_text("ptxas")
    (kernels / "tmpq1w2e3.so").write_bytes(b"")
    (kernels / "quantization-def.so").write_bytes(b"y")
    assert cc.cache_entries(str(cache)) == 2
    # an in-process activation outranks the environment
    monkeypatch.setitem(cc._ENABLED, "dir", "")
    assert cc.enable_persistent_cache(str(tmp_path / "other")) == str(
        tmp_path / "other")
    assert cc.active_cache_dir() == str(tmp_path / "other")
    assert (tmp_path / "other" / "kernels").is_dir()


def test_kernel_build_dir_follows_the_compile_cache(tmp_path, monkeypatch,
                                                    loaded_guard):
    """No cache armed: the package tree's ``_build/`` (so ``chip_smoke``'s
    kernel phases and the ``cuda`` tests keep their path).  Armed: the
    cache's ``kernels/``, where a library already there loads without
    ``nvcc`` (absent here), and a missing one asks for ``nvcc``."""
    monkeypatch.delenv(cc.DLROVER_CACHE_DIR_ENV, raising=False)
    monkeypatch.setenv("PATH", "/nonexistent")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    assert cuda_build.build_dir() == cuda_build.PKG_BUILD_DIR
    assert cuda_build.library_path("flash_attention").parent == (
        cuda_build.PKG_BUILD_DIR)
    monkeypatch.setenv(cc.DLROVER_CACHE_DIR_ENV, str(tmp_path / "cache"))
    kernels = tmp_path / "cache" / "kernels"
    assert cuda_build.build_dir() == kernels
    lib = cuda_build.library_path("quantization")
    assert lib.parent == kernels
    kernels.mkdir(parents=True)
    lib.write_bytes(b"a fake library: the build skips what exists")
    assert cuda_build.build(["quantization"]) == {"quantization": 0.0}
    assert cuda_build.nvcc_seconds() == 0.0
    if not os.path.exists("/usr/local/cuda/bin/nvcc"):
        with pytest.raises(RuntimeError, match="nvcc not found"):
            cuda_build.build(["flash_attention"])
    # a file that does not carry the sources' hash never loads
    assert not cuda_build.load_prebuilt(
        "flash_attention", str(kernels / "flash_attention-0.so"))
