"""Runtime auto-tuning: master-tuned ParallelConfig file.

Reference: ``ParalConfigTuner`` (``dlrover/python/elastic_agent/config/
paral_config_tuner.py:30``) + master hyperparam generation
(``master/hyperparams/simple_strategy_generator.py``): the master
tunes runtime knobs (dataloader workers, micro-batch, grad-accum); the
agent polls them over RPC and writes a JSON file; the trainer's
dataloader reloads it between steps (``ElasticDataLoader:78``).

Copy of ``dlrover_tpu/agent/config_tuner.py`` (host code, no torch):
the file it writes is the reference's, key for key.  The default path
follows ``TMPDIR`` (the reference's is under ``/tmp``).
"""

import json
import os
import tempfile
import threading
from dataclasses import asdict
from typing import Optional

from dlrover_tpu_torch.agent.master_client import MasterClient
from dlrover_tpu_torch.common.constants import NodeEnv
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.common.messages import ParallelConfig


def default_config_path() -> str:
    return os.getenv(
        NodeEnv.PARAL_CONFIG_PATH,
        os.path.join(
            tempfile.gettempdir(), f"dlrover_paral_config_{os.getuid()}.json"
        ),
    )


class ParalConfigTuner:
    def __init__(self, interval: float = 30.0,
                 path: Optional[str] = None,
                 client: Optional[MasterClient] = None):
        self._interval = interval
        self._path = path or default_config_path()
        self._client = client or MasterClient.singleton()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._last_version = -1

    def start(self):
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._run, daemon=True, name="config-tuner"
            )
            self._thread.start()

    def stop(self):
        self._stop.set()

    def poll_once(self):
        config: ParallelConfig = self._client.get_parallel_config()
        if config.version != self._last_version:
            tmp = self._path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(asdict(config), f)
            os.replace(tmp, self._path)
            self._last_version = config.version
            logger.info("parallel config updated: %s", asdict(config))

    def _run(self):
        while not self._stop.wait(self._interval):
            try:
                self.poll_once()
            except Exception as e:  # noqa: BLE001
                logger.warning("config poll failed: %s", e)


def read_parallel_config(path: Optional[str] = None) -> Optional[dict]:
    """Trainer-side read (reference: ElasticDataLoader reading the
    paral-config file)."""
    path = path or default_config_path()
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None
