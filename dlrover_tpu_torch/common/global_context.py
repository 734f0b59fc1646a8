"""Singleton master configuration (role of
dlrover/python/common/global_context.py): ports, thresholds and feature
flags, overridable from env for tests.

Copy of ``dlrover_tpu/common/global_context.py`` (the port imports
nothing of the JAX package).
"""

import os

from dlrover_tpu_torch.common.constants import DefaultPorts
from dlrover_tpu_torch.common.env_utils import _get_float as _env_float
from dlrover_tpu_torch.common.singleton import Singleton


class Context(Singleton):
    def __init__(self):
        self.master_port = int(
            os.getenv("DLROVER_MASTER_PORT", DefaultPorts.MASTER)
        )
        # rendezvous
        self.rdzv_default_timeout = 600
        self.seconds_to_wait_pending_pod = 900
        # heartbeat: node considered dead after this silence window
        # (reference: dist_job_manager.py:355 300s window).  Env-
        # overridable: the elastic-resize chaos scenario shrinks it so
        # a SIGKILLed node (no failure report possible) is detected in
        # seconds and the resize decision path can play out tier-1
        self.hang_detection_seconds = _env_float(
            "DLROVER_HANG_DETECTION_S", 300
        )
        # master main-loop hang checks (env-overridable: the chaos
        # hang scenario shrinks both so a tier-1 run diagnoses a
        # frozen trainer in seconds, not half an hour)
        self.seconds_to_check_hang = _env_float(
            "DLROVER_SECONDS_TO_CHECK_HANG", 30
        )
        self.hang_timeout = _env_float("DLROVER_HANG_TIMEOUT", 1800)
        # network check
        self.network_check_timeout = 300
        self.straggler_factor = 2.0
        # relaunch policy
        self.relaunch_on_worker_failure = 3
        self.relaunch_always = False
        # speed monitor
        self.train_speed_record_num = 50
        # auto tuning / scaling
        self.auto_tuning_enabled = False
        self.auto_scaling_enabled = False
        self.seconds_interval_to_optimize = 300
        # checkpoint
        self.checkpoint_commit_timeout = 600

    @classmethod
    def instance(cls) -> "Context":
        return cls.singleton_instance()
