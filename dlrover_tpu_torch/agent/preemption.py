"""Proactive TPU-VM preemption handling.

Reference frame: DLRover learns about a preemption after the fact —
the pod dies and ``k8s_watcher`` classifies the exit reason
(``dlrover/python/master/watcher/k8s_watcher.py`` exit-reason
classification).  GCE spot/preemptible TPU VMs give ADVANCE notice
through the instance metadata server (the ``instance/preempted``
endpoint flips to ``TRUE`` ~30 s before ACPI shutdown); SURVEY.md §7
lists wiring this signal — instead of pod exit codes — as a
TPU-specific hard part.

:class:`PreemptionMonitor` long-polls the metadata endpoint from the
elastic agent and, on notice, fires a callback while the chips are
still alive.  The agent's callback (1) reports the preemption to the
master (which can start replacement placement immediately instead of
waiting for a heartbeat timeout), and (2) persists the shm
flash-checkpoint snapshot — so the node's training state is durable
before the VM disappears.

Enable with ``DLROVER_PREEMPTION_MONITOR=1`` (on GCE) or by pointing
``DLROVER_METADATA_SERVER`` at any URL that serves ``TRUE`` when the
host is going away (tests run a local HTTP server).

Copy of ``dlrover_tpu/agent/preemption.py`` (the port imports nothing
of the JAX package).  On a GPU cloud VM the same metadata endpoint
(or any URL given in ``DLROVER_METADATA_SERVER``) carries the notice.
"""

import os
import threading
import urllib.error
import urllib.request
from typing import Callable, Optional

from dlrover_tpu_torch import chaos as _chaos
from dlrover_tpu_torch.common.log import default_logger as logger

GCE_PREEMPTED_URL = (
    "http://metadata.google.internal/computeMetadata/v1/"
    "instance/preempted"
)
ENV_ENABLE = "DLROVER_PREEMPTION_MONITOR"
ENV_METADATA_URL = "DLROVER_METADATA_SERVER"


def monitor_enabled() -> bool:
    enable = os.getenv(ENV_ENABLE, "").strip().lower()
    if enable in ("0", "false", "no", "off"):
        return False
    return bool(enable) or bool(os.getenv(ENV_METADATA_URL))


class PreemptionMonitor:
    """Polls the (GCE) metadata server; fires ``on_preemption`` once
    when the host is scheduled to go away."""

    def __init__(
        self,
        on_preemption: Callable[[], None],
        metadata_url: Optional[str] = None,
        poll_interval: float = 1.0,
        request_timeout: float = 2.0,
    ):
        self._on_preemption = on_preemption
        self._url = metadata_url or os.getenv(
            ENV_METADATA_URL, GCE_PREEMPTED_URL
        )
        self._poll_interval = poll_interval
        self._request_timeout = request_timeout
        self._stopped = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._unreachable_logged = False

    def start(self):
        # restartable like the sibling monitors: a stopped or
        # already-fired monitor starts a fresh thread on the next
        # agent run instead of silently doing nothing
        if self._thread is not None and self._thread.is_alive():
            return
        self._stopped = threading.Event()
        self._thread = threading.Thread(
            target=self._run, daemon=True,
            name="preemption-monitor",
        )
        self._thread.start()

    def stop(self):
        self._stopped.set()

    def _probe(self) -> bool:
        req = urllib.request.Request(
            self._url, headers={"Metadata-Flavor": "Google"}
        )
        try:
            with urllib.request.urlopen(
                req, timeout=self._request_timeout
            ) as resp:
                body = resp.read(64).decode("utf-8", "replace")
            self._unreachable_logged = False
            return body.strip().upper() == "TRUE"
        except (urllib.error.URLError, OSError) as e:
            if not self._unreachable_logged:
                logger.warning(
                    "preemption monitor: metadata server %s "
                    "unreachable (%s); will keep retrying", self._url, e,
                )
                self._unreachable_logged = True
            return False

    def _run(self):
        while not self._stopped.is_set():
            # chaos hook: a preempt rule simulates the metadata server
            # flipping to TRUE without any GCE dependency — the full
            # notice -> report -> breakpoint-save path runs for real
            if _chaos.fire("preemption.probe") or self._probe():
                logger.warning(
                    "PREEMPTION NOTICE from %s — persisting "
                    "checkpoint state before shutdown", self._url,
                )
                try:
                    self._on_preemption()
                except Exception as e:  # noqa: BLE001
                    logger.error(
                        "preemption callback failed: %s", e
                    )
                return
            self._stopped.wait(self._poll_interval)
