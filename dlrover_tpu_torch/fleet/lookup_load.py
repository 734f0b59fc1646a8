"""Synthetic lookup load against the serving-fleet router.

Copy of ``dlrover_tpu/fleet/lookup_load.py`` (the port imports nothing of the JAX
package).

Sibling of :class:`~dlrover_tpu_torch.fleet.synthetic_agent.SyntheticAgent`
for the serving plane: one :class:`SyntheticLookupAgent` is one
simulated user-traffic stream driving REAL
:class:`~dlrover_tpu_torch.common.comm.MessageClient` lookups through the
:class:`~dlrover_tpu_torch.serving.router.LookupRouter` — the full routed
path (framed pickles, key-consistent owner choice, fallback, drain
shifts), not a mock.  The harness counts per-outcome results and
client-visible failures, which is exactly the material the
zero-failed-lookup chaos invariant and the ``serving_fleet`` bench
section assert.

Client retries are part of the model: a stream's transport retries a
dropped/unanswered request against the (re)spawned router with the
same request id — so a router kill/respawn under live load shows up
as latency, never as a failed lookup, unless the retry envelope is
exhausted.
"""

import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from dlrover_tpu_torch.common.comm import MessageClient
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.serving.messages import LookupRequest


@dataclass
class LookupStats:
    """Per-stream accounting the harness aggregates."""

    lookups: int = 0
    rows: int = 0
    failures: int = 0
    outcomes: Dict[str, int] = field(default_factory=dict)
    latencies_s: List[float] = field(default_factory=list)
    max_generation: int = -1
    generation_regressions: int = 0
    # consecutive lookups may land on different replicas mid-catch-up;
    # the router admits members within ``stale_slack`` generations of
    # the floor, so per-stream skew up to the slack is by design — a
    # REGRESSION is only a step beyond it
    generation_slack: int = 1
    _last_generation: int = -1

    def record(self, outcome: str, generation: int, dt: float,
               rows: int):
        self.lookups += 1
        self.rows += rows
        self.outcomes[outcome] = self.outcomes.get(outcome, 0) + 1
        self.latencies_s.append(dt)
        if generation >= 0:
            if generation < self._last_generation - \
                    self.generation_slack:
                self.generation_regressions += 1
            self._last_generation = max(
                self._last_generation, generation
            )
            if generation > self.max_generation:
                self.max_generation = generation


class SyntheticLookupAgent:
    """One lookup stream on its own thread."""

    def __init__(
        self,
        router_addr: str,
        stream_id: int,
        batch: int = 256,
        key_space: int = 4000,
        qps: float = 0.0,
        timeout_s: float = 30.0,
        retries: int = 8,
        seed: Optional[int] = None,
    ):
        self.stream_id = int(stream_id)
        self.stats = LookupStats()
        self._batch = batch
        self._key_space = key_space
        self._min_interval = 1.0 / qps if qps > 0 else 0.0
        self._rng = np.random.default_rng(
            seed if seed is not None else stream_id
        )
        # patient transport: a router kill/respawn mid-run must be
        # absorbed by the envelope, not surfaced as a failed lookup
        self.client = MessageClient(
            router_addr, node_id=self.stream_id,
            node_type="lookup-load", timeout=timeout_s,
            retries=retries, backoff_base=0.1, backoff_max=1.0,
            resync_timeout=0.0,
        )
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self):
        self._thread = threading.Thread(
            target=self._run, daemon=True,
            name=f"lookup-load{self.stream_id}",
        )
        self._thread.start()

    def stop(self, join_timeout: float = 10.0):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=join_timeout)
        self.client.close()

    def lookup_once(self) -> str:
        keys = self._rng.integers(
            0, self._key_space, self._batch
        ).astype(np.int64)
        t0 = time.perf_counter()
        try:
            resp = self.client.get(LookupRequest(
                keys=keys, shard_key=int(keys[0]),
            ))
            dt = time.perf_counter() - t0
            outcome = getattr(resp, "outcome", "ok")
            gen = int(getattr(resp, "generation", -1))
            self.stats.record(outcome, gen, dt, self._batch)
            return outcome
        except Exception:  # noqa: BLE001 - client-visible failure
            self.stats.failures += 1
            self.stats.record(
                "client_error", -1, time.perf_counter() - t0, 0
            )
            logger.warning(
                "lookup stream %d failed a request",
                self.stream_id, exc_info=True,
            )
            return "client_error"

    def _run(self):
        while not self._stop.is_set():
            self.lookup_once()
            if self._min_interval:
                time.sleep(self._min_interval)


class LookupLoadHarness:
    """N concurrent streams + aggregate accounting."""

    def __init__(
        self,
        router_addr: str,
        streams: int = 4,
        batch: int = 256,
        key_space: int = 4000,
        qps_per_stream: float = 0.0,
        timeout_s: float = 30.0,
        retries: int = 8,
        seed: int = 0,
    ):
        self.agents = [
            SyntheticLookupAgent(
                router_addr, i, batch=batch, key_space=key_space,
                qps=qps_per_stream, timeout_s=timeout_s,
                retries=retries, seed=seed * 1000 + i,
            )
            for i in range(streams)
        ]

    def start(self):
        self._t0 = time.perf_counter()
        for a in self.agents:
            a.start()

    def stop(self):
        for a in self.agents:
            a._stop.set()
        for a in self.agents:
            a.stop()
        self._elapsed = time.perf_counter() - self._t0

    def run_for(self, seconds: float):
        self.start()
        time.sleep(seconds)
        self.stop()
        return self.summary()

    def summary(self) -> Dict:
        lookups = sum(a.stats.lookups for a in self.agents)
        failures = sum(a.stats.failures for a in self.agents)
        regressions = sum(
            a.stats.generation_regressions for a in self.agents
        )
        outcomes: Dict[str, int] = {}
        lat: List[float] = []
        for a in self.agents:
            for k, v in a.stats.outcomes.items():
                outcomes[k] = outcomes.get(k, 0) + v
            lat.extend(a.stats.latencies_s)
        out = {
            "streams": len(self.agents),
            "lookups": lookups,
            "failed": failures,
            "generation_regressions": regressions,
            "outcomes": outcomes,
            "max_generation": max(
                (a.stats.max_generation for a in self.agents),
                default=-1,
            ),
        }
        if lat:
            arr = np.sort(np.asarray(lat))
            out["p50_ms"] = round(
                float(arr[int(0.50 * (len(arr) - 1))]) * 1e3, 3
            )
            out["p99_ms"] = round(
                float(arr[int(0.99 * (len(arr) - 1))]) * 1e3, 3
            )
        wall = getattr(self, "_elapsed", 0.0)
        out["wall_s"] = round(wall, 3)
        out["qps"] = round(lookups / wall, 1) if wall > 0 else 0.0
        return out
