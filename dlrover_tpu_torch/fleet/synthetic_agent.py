"""Synthetic elastic agent: the production verb mix without a trainer.

One :class:`SyntheticAgent` is one simulated node driving a REAL
:class:`~dlrover_tpu_torch.agent.master_client.MasterClient` (the full
transport: framed pickles, retries, response cache, session resync) —
not a mock and not raw sockets, so what the scoreboard measures is
what production agents would pay.  The verb mix mirrors what an
elastic agent + its trainer put on the wire:

- ``join_rendezvous`` once at start (and again after a forced
  reconnect when the fault mix says so);
- ``HeartbeatRequest`` on the heartbeat cadence (liveness + the
  master's action channel);
- ``GlobalStepRecord`` on the step cadence — or piggybacked onto
  heartbeats when ``DLROVER_STEP_PIGGYBACK`` is armed (the measured
  fan-in fix);
- shard lease/ack (``GetShardTaskRequest`` /
  ``ReportTaskResultRequest``) on the shard cadence;
- KV set/add barriers on the kv cadence;
- fault mix: with ``reconnect_prob`` per tick the agent drops its TCP
  connection and replays the session-resync handshake — the
  master-crash-recovery path under load.

Cadences are jittered (uniform ±``jitter`` fraction) so a fleet of
agents does not phase-lock into request stampedes the way identical
timers would.

Copy of ``dlrover_tpu/fleet/synthetic_agent.py`` (the port imports
nothing of the JAX package); host code, as in the reference.
"""

import random
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, Optional

from dlrover_tpu_torch.agent.master_client import MasterClient
from dlrover_tpu_torch.common.constants import RendezvousName
from dlrover_tpu_torch.common.log import default_logger as logger

# default dataset every fleet agent leases shards from (the runner
# registers it once with an effectively inexhaustible epoch count)
FLEET_DATASET = "fleet-shards"


@dataclass
class AgentProfile:
    """Cadence + fault mix of one synthetic agent (seconds)."""

    heartbeat_interval: float = 1.0
    step_interval: float = 0.5
    shard_interval: float = 2.0
    kv_interval: float = 4.0
    # uniform jitter as a fraction of each interval (0.3 = ±30%)
    jitter: float = 0.3
    # per-tick probability of a forced TCP drop + session resync
    reconnect_prob: float = 0.0
    dataset: str = FLEET_DATASET

    def jittered(self, interval: float, rng: random.Random) -> float:
        if self.jitter <= 0:
            return interval
        return interval * (
            1.0 + rng.uniform(-self.jitter, self.jitter)
        )


@dataclass
class AgentStats:
    """Per-agent op/error accounting the runner aggregates."""

    ops: Dict[str, int] = field(default_factory=dict)
    errors: Dict[str, int] = field(default_factory=dict)
    resyncs: int = 0
    actions_seen: int = 0
    last_step: int = 0

    def op(self, verb: str):
        self.ops[verb] = self.ops.get(verb, 0) + 1

    def err(self, verb: str):
        self.errors[verb] = self.errors.get(verb, 0) + 1

    @property
    def total_ops(self) -> int:
        return sum(self.ops.values())

    @property
    def total_errors(self) -> int:
        return sum(self.errors.values())


class SyntheticAgent:
    """One simulated node's control-plane life, on its own thread."""

    def __init__(
        self,
        master_addr: str,
        node_id: int,
        profile: Optional[AgentProfile] = None,
        seed: Optional[int] = None,
    ):
        self.node_id = int(node_id)
        self.profile = profile or AgentProfile()
        self.stats = AgentStats()
        self._rng = random.Random(
            seed if seed is not None else node_id
        )
        # a real client per agent: node_rank/local_world_size pinned
        # explicitly (hundreds of clients share one process env)
        self.client = MasterClient(
            master_addr,
            node_id=self.node_id,
            node_type="worker",
            node_rank=self.node_id,
            local_world_size=1,
        )
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._step = 0

    # -- lifecycle ---------------------------------------------------------

    def start(self):
        self._thread = threading.Thread(
            target=self._run,
            name=f"fleet-agent-{self.node_id}",
            daemon=True,
        )
        self._thread.start()

    def stop(self, join_timeout: float = 5.0):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=join_timeout)
            self._thread = None

    @property
    def alive(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    # -- verb helpers ------------------------------------------------------

    def _call(self, verb: str, fn, *args, **kwargs):
        """One counted op; errors are tallied, never fatal — a load
        generator that dies on the first refused request measures
        nothing."""
        if self._stop.is_set():
            return None
        try:
            out = fn(*args, **kwargs)
            self.stats.op(verb)
            return out
        except Exception as e:  # noqa: BLE001 - tally and march on
            self.stats.err(verb)
            logger.debug(
                "fleet agent %s %s failed: %s", self.node_id, verb, e
            )
            return None

    def _join(self):
        self._call(
            "join",
            self.client.join_rendezvous,
            self.node_id,
            1,
            RendezvousName.ELASTIC_TRAINING,
            node_ip="127.0.0.1",
        )

    def _heartbeat(self):
        action = self._call(
            "heartbeat", self.client.report_heartbeat
        )
        if action:
            self.stats.actions_seen += 1

    def _report_step(self):
        self._step += 1
        self.stats.last_step = self._step
        self._call(
            "step", self.client.report_global_step, self._step
        )

    def _shard_cycle(self):
        task = self._call(
            "shard_get", self.client.get_task, self.profile.dataset
        )
        task_id = getattr(task, "task_id", -1)
        if task is None or task_id < 0:
            return
        self._call(
            "shard_ack",
            self.client.report_task_result,
            self.profile.dataset,
            task_id,
            True,
        )

    def _kv_cycle(self):
        # distinct namespaces: barrier counters must never collide
        # with opaque blob sets on the same key
        if self._rng.random() < 0.5:
            self._call(
                "kv", self.client.kv_store_add,
                f"fleet/ctr/{self.node_id % 16}", 1,
            )
        else:
            self._call(
                "kv", self.client.kv_store_set,
                f"fleet/blob/{self.node_id % 16}", b"x",
            )

    def force_reconnect(self):
        """Fault mix: drop the TCP connection mid-session and replay
        the session-resync handshake — what a master respawn (or a
        broken middlebox) makes every real agent do."""
        try:
            self.client._client.close()
        except Exception:  # noqa: BLE001
            pass
        errs_before = self.stats.errors.get("resync", 0)
        self._call("resync", self.client.session_resync)
        if self.stats.errors.get("resync", 0) == errs_before:
            self.stats.resyncs += 1

    # -- main loop ---------------------------------------------------------

    def _run(self):
        p = self.profile
        self._join()
        now = time.monotonic()
        due = {
            "heartbeat": now + p.jittered(
                p.heartbeat_interval * self._rng.random() + 1e-3,
                self._rng,
            ),
            "step": now + p.jittered(
                p.step_interval * self._rng.random() + 1e-3,
                self._rng,
            ),
            "shard": now + p.jittered(
                p.shard_interval * self._rng.random() + 1e-3,
                self._rng,
            ),
            "kv": now + p.jittered(
                p.kv_interval * self._rng.random() + 1e-3, self._rng
            ),
        }
        intervals = {
            "heartbeat": p.heartbeat_interval,
            "step": p.step_interval,
            "shard": p.shard_interval,
            "kv": p.kv_interval,
        }
        actions = {
            "heartbeat": self._heartbeat,
            "step": self._report_step,
            "shard": self._shard_cycle,
            "kv": self._kv_cycle,
        }
        while not self._stop.is_set():
            now = time.monotonic()
            for name, when in due.items():
                if self._stop.is_set():
                    break
                if now >= when:
                    actions[name]()
                    due[name] = now + p.jittered(
                        intervals[name], self._rng
                    )
            if (
                p.reconnect_prob > 0
                and not self._stop.is_set()
                and self._rng.random() < p.reconnect_prob
            ):
                self.force_reconnect()
            next_due = min(due.values())
            delay = max(0.0, next_due - time.monotonic())
            self._stop.wait(min(delay, 0.25))
        # close() drains any coalesced step itself; a second explicit
        # flush here would pay the retry envelope twice when the
        # master is already gone at teardown
        self.client.close()
