"""Error classification + relaunch policy.

Copy of ``dlrover_tpu/master/error_monitor.py`` (the port imports
nothing of the JAX package).

Role of ``dlrover/python/master/monitor/error_monitor.py``: reported
process/node errors are classified (device error, OOM, rendezvous
failure, user code bug) and mapped to an action — relaunch the process,
replace the node, or abort the job.  The reference's TPU-only hardware
patterns (device HALTED, ICI and DCN link errors) become the card's
faults here: Xid, uncorrectable ECC, NVLink, an illegal memory access
or unspecified launch failure, NCCL errors and timeouts; ``CUDA out of
memory`` joins the OOM patterns.  Categories, actions and the generic
patterns are the reference's.
"""

import re
from dataclasses import dataclass
from typing import List, Tuple

from dlrover_tpu_torch.common.constants import (
    ErrorMonitorConstants,
    TrainingExceptionLevel,
)
from dlrover_tpu_torch.common.log import default_logger as logger


@dataclass
class ErrorRecord:
    node_id: int
    level: str
    error_data: str
    action: str


# (pattern, action) in priority order.
_HARDWARE_PATTERNS = [
    r"\bxid\b",
    r"uncorrectable.*ecc|ecc.*uncorrectable",
    r"nvlink.*(error|fail|down|inactive)",
    r"illegal memory access",
    r"unspecified launch failure",
    r"nccl.*(error|timeout|timed out)",
    r"device.*unavailable",
    r"hbm.*(uncorrectable|error)",
    r"transfer.*to device.*failed",
    r"deadline exceeded.*collective",
    r"preempt",
]
_OOM_PATTERNS = [
    r"cuda out of memory",
    r"resource.?exhausted",
    r"out of memory",
    r"oom",
    r"hbm.*exceeds",
    r"allocat.*\d+.*bytes",
]
_RDZV_PATTERNS = [
    r"rendezvous",
    r"coordination service.*(unavailable|error)",
    r"barrier.*timeout",
    r"failed to connect.*coordinator",
]
_FATAL_USER_PATTERNS = [
    r"syntaxerror",
    r"modulenotfounderror",
    r"importerror",
    r"filenotfounderror",
]


def _matches(patterns: List[str], text: str) -> bool:
    return any(re.search(p, text) for p in patterns)


class ErrorMonitor:
    """Reference ``SimpleErrorMonitor:42`` behaviour: classify and pick
    an action; the job manager executes it."""

    def __init__(self):
        self.records: List[ErrorRecord] = []

    def classify(self, error_data: str) -> Tuple[str, str]:
        """Returns (category, action)."""
        text = (error_data or "").lower()
        if _matches(_HARDWARE_PATTERNS, text):
            return "hardware", ErrorMonitorConstants.ACTION_RELAUNCH
        if _matches(_OOM_PATTERNS, text):
            return "oom", ErrorMonitorConstants.ACTION_RELAUNCH
        if _matches(_RDZV_PATTERNS, text):
            return "rdzv", ErrorMonitorConstants.ACTION_RELAUNCH
        if _matches(_FATAL_USER_PATTERNS, text):
            return "user-fatal", ErrorMonitorConstants.ACTION_ABORT
        return "unknown", ErrorMonitorConstants.ACTION_RELAUNCH

    def process_error(
        self, node_id: int, restart_count: int, error_data: str, level: str
    ) -> bool:
        """Returns True when the node should be relaunched."""
        category, action = self.classify(error_data)
        self.records.append(
            ErrorRecord(node_id, level, error_data, action)
        )
        logger.warning(
            "node %s error (restart=%d, level=%s, class=%s, action=%s): %s",
            node_id,
            restart_count,
            level,
            category,
            action,
            (error_data or "")[:500],
        )
        if level == TrainingExceptionLevel.RDZV_ERROR:
            return True
        return action == ErrorMonitorConstants.ACTION_RELAUNCH
