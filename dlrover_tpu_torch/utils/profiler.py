"""Profiler trace capture + parsing.

Copy of ``dlrover_tpu/utils/profiler.py`` (reference: ATorch's
profiler tooling, ``utils/parse_trace_json.py`` parses chrome traces,
``utils/prof.py``/timers).  :func:`trace` wraps
``torch.profiler.profile`` (CPU activity, and CUDA when a card is
present) and writes a gzipped chrome trace through
``tensorboard_trace_handler(..., use_gzip=True)`` (TensorBoard-
compatible, ``<worker>.<ts>.pt.trace.json.gz``), where the reference
wraps ``jax.profiler.trace``; :func:`parse_trace_dir` digests the
``*.trace.json.gz`` events under a directory into per-op time totals,
unchanged — enough to answer "where did the step time go" without
TensorBoard.
"""

import glob
import gzip
import json
import os
from collections import defaultdict
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, List

from dlrover_tpu_torch.common.log import default_logger as logger


@contextmanager
def trace(logdir: str):
    """Capture a torch profile of the enclosed block into ``logdir``."""
    import torch
    from torch.profiler import (
        ProfilerActivity,
        profile,
        tensorboard_trace_handler,
    )

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(logdir,
                                                          use_gzip=True)):
        yield logdir


@dataclass
class TraceSummary:
    total_duration_us: float = 0.0
    op_self_time_us: Dict[str, float] = field(default_factory=dict)

    def top_ops(self, k: int = 10) -> List:
        return sorted(
            self.op_self_time_us.items(),
            key=lambda kv: -kv[1],
        )[:k]


def parse_trace_dir(logdir: str) -> TraceSummary:
    """Digest every ``*.trace.json.gz`` under ``logdir``."""
    paths = glob.glob(
        os.path.join(logdir, "**", "*.trace.json.gz"), recursive=True
    )
    summary = TraceSummary()
    per_op = defaultdict(float)
    t_min, t_max = float("inf"), 0.0
    for path in paths:
        try:
            with gzip.open(path, "rt") as f:
                data = json.load(f)
        except (OSError, ValueError) as e:
            logger.warning("unreadable trace %s: %s", path, e)
            continue
        for event in data.get("traceEvents", []):
            if event.get("ph") != "X":
                continue
            dur = float(event.get("dur", 0.0))
            name = event.get("name", "?")
            per_op[name] += dur
            ts = float(event.get("ts", 0.0))
            t_min = min(t_min, ts)
            t_max = max(t_max, ts + dur)
    summary.op_self_time_us = dict(per_op)
    if t_max > 0 and t_min < float("inf"):
        summary.total_duration_us = t_max - t_min
    return summary
