"""Chaos injection engine.

Copy of ``dlrover_tpu/chaos/injector.py`` (the port imports nothing of
the JAX package).

One :class:`ChaosInjector` per process holds a loaded
:class:`~dlrover_tpu_torch.chaos.schedule.Scenario` plus per-rule runtime
state and answers every ``fire(point, **ctx)`` from the permanent hook
sites.  On a triggered rule it

1. appends ``(seq, point, rule, action, step)`` to the in-memory
   **timeline** (what the determinism tests compare),
2. emits a ``chaos_inject`` training event — BEFORE executing the
   action, so even a SIGKILL of this very process leaves its injection
   in the event log for the invariant checkers,
3. bumps ``dlrover_chaos_injections_total`` in the metrics registry,
4. executes the fault primitive (which may raise or never return).

The engine is deliberately dumb about *where* it runs: the same
scenario file is handed to the master subprocess, the agent process
and every trainer incarnation through the ``DLROVER_CHAOS`` env var;
each process arms only the rules whose points it actually fires.
"""

import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

from dlrover_tpu_torch.chaos import primitives
from dlrover_tpu_torch.chaos.schedule import RuleState, Scenario, load_scenario
from dlrover_tpu_torch.common import env_utils
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.telemetry.events import emit_event
from dlrover_tpu_torch.telemetry.metrics import get_registry

_REG = get_registry()
_INJECTIONS_TOTAL = _REG.counter(
    "dlrover_chaos_injections_total",
    "Chaos fault injections executed, by point and action",
)


@dataclass
class Injection:
    """One executed fault (the timeline entry)."""

    seq: int
    point: str
    rule: str
    action: str
    step: Optional[int] = None

    def key(self):
        """Identity tuple for cross-run determinism comparison."""
        return (self.seq, self.point, self.rule, self.action, self.step)


class ChaosInjector:
    def __init__(
        self,
        scenario,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.scenario: Scenario = load_scenario(scenario)
        self._clock = clock
        self._installed_at = clock()
        self._lock = threading.Lock()
        self._states = [
            RuleState(rule, i, self.scenario.seed)
            for i, rule in enumerate(self.scenario.rules)
        ]
        self._timeline: List[Injection] = []
        self._seq = 0

    @property
    def timeline(self) -> List[Injection]:
        with self._lock:
            return list(self._timeline)

    def timeline_keys(self) -> List[tuple]:
        return [inj.key() for inj in self.timeline]

    def fire(self, point: str, **ctx) -> Any:
        """Evaluate every matching rule; execute the first that
        triggers.  Returns the action's result (hook sites that care —
        the preemption probe — interpret it); most sites ignore it.
        Exceptions raised by fault primitives propagate to the hook
        site by design."""
        now = self._clock()
        fired: Optional[RuleState] = None
        with self._lock:
            for state in self._states:
                if state.exhausted() or not state.rule.matches(point):
                    continue
                ctx["point"] = point
                if state.should_fire(ctx, now, self._installed_at):
                    fired = state
                    state.executions += 1
                    inj = Injection(
                        seq=self._seq,
                        point=point,
                        rule=state.rule.name or state.rule.point,
                        action=state.rule.action,
                        step=ctx.get("step"),
                    )
                    self._seq += 1
                    self._timeline.append(inj)
                    break
        if fired is None:
            return None
        # telemetry first: a kill action never returns, and the event
        # log is the only witness the invariant checkers get
        emit_event(
            "chaos_inject",
            scenario=self.scenario.name,
            seed=self.scenario.seed,
            seq=inj.seq,
            point=inj.point,
            rule=inj.rule,
            action=inj.action,
            step=inj.step,
            # per-process discriminator: multi-agent scenarios (node-
            # subset partitions) need to tell WHICH node injected —
            # two processes with the same source would otherwise
            # collide on (source, seq) in the timeline
            node_rank=env_utils.get_node_rank(),
        )
        _INJECTIONS_TOTAL.inc(point=point, action=fired.rule.action)
        logger.warning(
            "chaos[%s#%s]: %s at %s (step=%s)",
            self.scenario.name, inj.seq, inj.action, point, inj.step,
        )
        handler = primitives.ACTIONS[fired.rule.action]
        return handler(dict(fired.rule.args), ctx)

    def describe(self) -> Dict[str, Any]:
        """Armed-rule summary (CLI + debugging)."""
        with self._lock:
            return {
                "scenario": self.scenario.name,
                "seed": self.scenario.seed,
                "rules": [
                    {
                        "name": s.rule.name or s.rule.point,
                        "point": s.rule.point,
                        "action": s.rule.action,
                        "calls": s.calls,
                        "executions": s.executions,
                        "chosen_step": s.chosen_step,
                        "exhausted": s.exhausted(),
                    }
                    for s in self._states
                ],
                "injections": len(self._timeline),
            }
