"""Twin of ``tests/test_slo.py``, against the port (:mod:`dlrover_tpu_torch`).

Unit coverage for the declarative RPC SLO checker.

The quantile estimator in :mod:`dlrover_tpu_torch.telemetry.slo` is the
arbiter of every capacity decision the fleet harness makes (and of
the master's own breach gauges) — until now it was only exercised
end-to-end.  These tests pin its properties: monotonicity in q,
agreement with exact quantiles on synthetic bucket fills, the
min_count gate, and two rules coexisting on one verb.
"""

import math
import random

import pytest

from dlrover_tpu_torch.telemetry import metrics as tmetrics
from dlrover_tpu_torch.telemetry.slo import (
    DEFAULT_RPC_SLOS,
    SloChecker,
    SloRule,
    estimate_quantile,
    parse_slo_spec,
    rules_from_env,
)

BOUNDS = [0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0]


def _fill(values, bounds=BOUNDS):
    """Exact per-bucket counts (one extra +Inf slot) for a sample
    set — the same binning Histogram._observe applies."""
    counts = [0] * (len(bounds) + 1)
    for v in values:
        for i, b in enumerate(bounds):
            if v <= b:
                counts[i] += 1
                break
        else:
            counts[-1] += 1
    return counts


def test_quantile_monotonic_in_q():
    rng = random.Random(7)
    values = [rng.uniform(0.0, 2.0) for _ in range(500)]
    counts = _fill(values)
    prev = -1.0
    for q in (0.01, 0.1, 0.25, 0.5, 0.75, 0.9, 0.95, 0.99):
        est = estimate_quantile(BOUNDS, counts, q)
        assert est >= prev, f"estimate not monotonic at q={q}"
        prev = est


def test_quantile_agrees_with_exact_on_synthetic_fills():
    """The bucket-interpolated estimate must land inside the bucket
    the exact quantile falls in — that is the whole guarantee of the
    Prometheus-style estimator."""
    rng = random.Random(21)
    for _ in range(20):
        values = sorted(
            rng.uniform(0.0, 1.5) for _ in range(200)
        )
        counts = _fill(values)
        for q in (0.5, 0.9, 0.99):
            exact = values[
                min(len(values) - 1, int(math.ceil(q * len(values))) - 1)
            ]
            est = estimate_quantile(BOUNDS, counts, q)
            # same bucket: est and exact bracketed by one (lo, hi]
            lo = 0.0
            for b in BOUNDS:
                if exact <= b:
                    hi = b
                    break
                lo = b
            else:
                hi = math.inf
            assert lo <= est <= (hi if hi != math.inf else lo), (
                f"q={q}: est {est} outside exact's bucket "
                f"({lo}, {hi}] (exact {exact})"
            )


def test_quantile_single_bucket_interpolates_linearly():
    """All mass in one bucket: the estimate walks linearly across
    that bucket as q grows."""
    counts = [0, 0, 100, 0, 0, 0, 0, 0, 0]  # all in (0.005, 0.01]
    e25 = estimate_quantile(BOUNDS, counts, 0.25)
    e50 = estimate_quantile(BOUNDS, counts, 0.50)
    e75 = estimate_quantile(BOUNDS, counts, 0.75)
    assert 0.005 <= e25 < e50 < e75 <= 0.01
    # linear: equal q steps = equal estimate steps
    assert e50 - e25 == pytest.approx(e75 - e50, rel=1e-9)


def test_quantile_inf_bucket_clamps_to_lower_edge():
    counts = [0] * len(BOUNDS) + [10]  # everything beyond 5.0
    assert estimate_quantile(BOUNDS, counts, 0.99) == BOUNDS[-1]


def test_quantile_empty_is_zero():
    assert estimate_quantile(BOUNDS, [0] * 9, 0.99) == 0.0


def _checker_with(rules, min_count=10):
    reg = tmetrics.MetricsRegistry()
    hist = reg.histogram(
        "dlrover_rpc_seconds", "t", buckets=BOUNDS
    )
    checker = SloChecker(
        rules=rules, registry=reg, min_count=min_count
    )
    return reg, hist, checker


def test_min_count_gates_breach():
    """A breaching latency with too few samples must not fire — and
    must fire once the count clears the gate."""
    _reg, hist, checker = _checker_with(
        [SloRule("get.*", 0.99, 0.01)], min_count=10
    )
    for _ in range(5):
        hist.observe(2.0, verb="get.X")
    assert checker.check(emit=False) == []
    for _ in range(10):
        hist.observe(2.0, verb="get.X")
    breaches = checker.check(emit=False)
    assert len(breaches) == 1 and breaches[0].verb == "get.X"


def test_two_rules_one_verb_independent_series():
    """p50 and p99 rules on the same verb keep separate breach
    state and separate gauge series (a regression here silently
    merged them once)."""
    _reg, hist, checker = _checker_with([
        SloRule("get.*", 0.50, 10.0),   # generous: stays green
        SloRule("get.*", 0.99, 0.001),  # tight: breaches
    ])
    for _ in range(50):
        hist.observe(0.03, verb="get.X")
    breaches = checker.check(emit=False)
    assert [b.quantile for b in breaches] == ["p99"]
    g = checker._breach_gauge
    assert g.value(verb="get.X", quantile="p99") == 1.0
    assert g.value(verb="get.X", quantile="p50") == 0.0


def test_parse_slo_spec_and_env_fallback(monkeypatch):
    rules = parse_slo_spec("get.*:p95:0.25, report.*:p50:0.1,junk")
    assert [(r.verb_pattern, r.quantile, r.threshold_s)
            for r in rules] == [
        ("get.*", 0.95, 0.25), ("report.*", 0.5, 0.1),
    ]
    monkeypatch.delenv("DLROVER_RPC_SLO", raising=False)
    assert rules_from_env() == list(DEFAULT_RPC_SLOS)
    monkeypatch.setenv("DLROVER_RPC_SLO", "get.*:p90:2.0")
    assert rules_from_env() == [SloRule("get.*", 0.90, 2.0)]
