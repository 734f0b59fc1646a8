"""The port's utilities (``dlrover_tpu_torch.utils``: timers, the
numeric checker, μP and the profiler): twins of the utility cases of
``tests/test_diagnosis_utils.py`` (``test_timers_accumulate``,
``test_numeric_checker_flags_nan``,
``test_mup_width_multipliers_and_transfer``,
``test_profiler_trace_capture_and_parse``), each also held against
the JAX package's function on the same numpy inputs where it computes
one: the numeric checker's verdicts, the width multipliers and the
μP init (exact), and three μP Adam steps (rtol 1e-5: optax and torch
order Adam's arithmetic differently).  The collector, diagnosis and
chain cases of that file have their twins in
``tests/test_torch_diagnosis.py``."""

import time

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dlrover_tpu.utils import check_numerics as jax_check_numerics
from dlrover_tpu.utils import mup as jax_mup
from dlrover_tpu_torch.utils import Timer, Timers, check_numerics
from dlrover_tpu_torch.utils.mup import (
    mup_adam,
    output_multiplier,
    scale_init,
    width_multipliers,
)
from dlrover_tpu_torch.utils.numeric_checker import compare_pytrees


def test_timers_accumulate():
    timers = Timers()
    with timers.scope("phase"):
        time.sleep(0.01)
    with timers.scope("phase"):
        time.sleep(0.01)
    assert timers("phase").count == 2
    assert timers.summary()["phase"] >= 0.01
    # block_on takes a tensor or a tree of them (the card's work is
    # waited for; a CPU tensor needs no wait)
    t = Timer("one")
    t.start()
    t.stop(block_on={"x": [torch.ones(2)], "y": None})
    assert t.count == 1 and t.mean > 0.0
    assert Timer("never").mean == 0.0


def test_numeric_checker_flags_nan():
    good = {"w": torch.ones(4)}
    bad = {"w": torch.tensor([1.0, float("nan"), 2.0, float("inf")])}
    assert check_numerics(good) == []
    problems = check_numerics(bad)
    assert problems and "non-finite" in problems[0]
    assert compare_pytrees(good, good) == []
    assert compare_pytrees(good, {"w": torch.full((4,), 2.0)})
    assert compare_pytrees(good, {"v": torch.ones(4)}) == [
        "pytree structures differ"]
    assert compare_pytrees(good, {"w": torch.ones(5)}) == [
        "w: shape (4,) vs (5,)"]


def test_numeric_checker_matches_the_jax_package():
    """The same problems on the same numpy tree, in the same order:
    non-finite counts, magnitudes past 1e8 (bf16 leaves read in fp32),
    integer leaves skipped; the port names a leaf by its keys joined
    with ``/``."""
    rng = np.random.default_rng(0)
    tree = {
        "b": {"huge": np.full((3,), 2e8, np.float32),
              "ok": rng.normal(size=(2, 3)).astype(np.float32)},
        "a": [np.array([np.nan, 1.0, np.inf], np.float32),
              np.arange(4, dtype=np.int32)],
        "c": rng.normal(size=(5,)).astype(np.float32),
    }
    torch_tree = {
        "b": {"huge": torch.from_numpy(tree["b"]["huge"]).to(torch.bfloat16),
              "ok": torch.from_numpy(tree["b"]["ok"])},
        "a": [torch.from_numpy(tree["a"][0]), torch.from_numpy(tree["a"][1])],
        "c": torch.from_numpy(tree["c"]),
    }
    got = check_numerics(torch_tree, name="state")
    want = jax_check_numerics(
        {k: v for k, v in tree.items()}, name="state")
    assert [p.split(": ", 1)[1] for p in got] == \
        [p.split(": ", 1)[1] for p in want]
    assert got == ["state/a/0: 2 non-finite values",
                   "state/b/huge: magnitude > 1e8"]


def _trees():
    base = {"w": np.zeros((8, 8), np.float32), "b": np.zeros(8, np.float32)}
    wide = {"w": np.ones((32, 8), np.float32), "b": np.zeros(8, np.float32)}
    return base, wide


def test_mup_width_multipliers_and_transfer():
    """Twin of the reference's case: matrix lr scaled down by mult,
    vector lr untouched."""
    base, wide = _trees()
    tb = {k: torch.from_numpy(v) for k, v in base.items()}
    tw = {k: torch.from_numpy(v) for k, v in wide.items()}
    mults = width_multipliers(tb, tw)
    assert mults["w"] == 4.0 and mults["b"] == 1.0
    scaled = scale_init(tw, mults)
    np.testing.assert_allclose(scaled["w"].numpy(), np.full((32, 8), 0.5))
    params = {k: torch.nn.Parameter(v.clone()) for k, v in tw.items()}
    opt = mup_adam(params, 0.1, mults)
    assert sorted(g["mup_mult"] for g in opt.param_groups) == [1.0, 4.0]
    before = {k: p.detach().clone() for k, p in params.items()}
    for p in params.values():
        p.grad = torch.ones_like(p)
    opt.step()
    w_step = float((params["w"].detach() - before["w"]).abs().mean())
    b_step = float((params["b"].detach() - before["b"]).abs().mean())
    assert w_step == pytest.approx(b_step / 4.0, rel=1e-3)
    assert output_multiplier(256, 1024) == 0.25


@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
def test_mup_matches_the_jax_package(weight_decay):
    """Multipliers, the scaled init and three μP Adam(W) steps on the
    same tree and gradients as the JAX package's ``mup_adam``."""
    base, wide = _trees()
    rng = np.random.default_rng(1)
    wide = {k: rng.normal(size=v.shape).astype(np.float32)
            for k, v in wide.items()}
    grads = [{k: rng.normal(size=v.shape).astype(np.float32)
              for k, v in wide.items()} for _ in range(3)]
    jm = jax_mup.width_multipliers(base, wide)
    mults = width_multipliers({k: torch.from_numpy(v) for k, v in base.items()},
                              {k: torch.from_numpy(v) for k, v in wide.items()})
    assert mults == {k: float(v) for k, v in jm.items()}
    jinit = jax_mup.scale_init({k: jnp.asarray(v) for k, v in wide.items()},
                               jm)
    init = scale_init({k: torch.from_numpy(v) for k, v in wide.items()},
                      mults)
    for k in wide:
        np.testing.assert_array_equal(init[k].numpy(), np.asarray(jinit[k]))
    jopt = jax_mup.mup_adam(1e-2, jm, weight_decay=weight_decay)
    jparams = {k: jnp.asarray(v) for k, v in wide.items()}
    jstate = jopt.init(jparams)
    params = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
              for k, v in wide.items()}
    opt = mup_adam(params, 1e-2, mults, weight_decay=weight_decay)
    for g in grads:
        updates, jstate = jopt.update({k: jnp.asarray(v) for k, v in
                                       g.items()}, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for k, p in params.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
    for k, p in params.items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jparams[k]),
                                   rtol=1e-5, atol=1e-7)


def test_profiler_trace_capture_and_parse(tmp_path):
    """A torch profile of a real computation, written as a gzipped
    chrome trace, parses into per-op times (reference:
    parse_trace_json.py tooling)."""
    from dlrover_tpu_torch.utils.profiler import parse_trace_dir, trace

    x = torch.ones(256, 256)
    float((x @ x).sum())
    with trace(str(tmp_path)):
        float((x @ x).sum())
    assert list(tmp_path.rglob("*.pt.trace.json.gz"))
    summary = parse_trace_dir(str(tmp_path))
    assert summary.op_self_time_us, "no trace events parsed"
    assert summary.total_duration_us > 0
    top = summary.top_ops(3)
    assert top and top[0][1] >= top[-1][1]
    assert any(name.startswith("aten::") for name in summary.op_self_time_us)
