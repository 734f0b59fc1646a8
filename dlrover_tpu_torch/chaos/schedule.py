"""Deterministic, seeded chaos scenario schedules.

Copy of ``dlrover_tpu/chaos/schedule.py`` (the port imports nothing of
the JAX package).

A :class:`Scenario` is a named list of :class:`Rule`s.  Each rule
matches an injection point (exact name or ``fnmatch`` glob), carries
one trigger, and names a fault action executed by the injector when
the trigger fires.  Everything that involves randomness draws from a
``random.Random`` seeded with ``(scenario.seed, rule index)`` — so two
runs of the same scenario over the same sequence of ``fire()`` calls
produce byte-identical fault timelines, which is what the determinism
regression tests assert.

Trigger vocabulary (one per rule; all composable with ``max_count``,
``duration`` and ``only_first_incarnation``):

- ``at_step: N``          — fires when the hook context carries
  ``step == N`` (trainer-side points).
- ``after_step: N``       — fires once the hook context carries
  ``step >= N``.  The progress-based alternative to ``after_time``
  for SAMPLED step observations (the ``agent.monitor`` hook passes
  the step it last saw in the trainer's metrics record — equality
  can be skipped over, a threshold cannot), so "kill node 1 once it
  has trained past step N" stays deterministic however slow the
  job's startup is.
- ``step_window: [lo, hi]`` — a step is drawn deterministically from
  the inclusive window using the rule's seeded RNG ("kill one worker
  mid-step with a fixed seed").
- ``after_calls: N``      — fires from the Nth invocation of the
  matched point onward (per process).
- ``after_time: T``       — fires once wall time since injector
  install exceeds T seconds.
- ``prob: p``             — seeded Bernoulli draw per invocation.
- none of the above       — fires on every matched invocation.

``duration: S`` keeps the rule active for S seconds after its first
firing (RPC partitions, storage brownouts), ``max_count`` bounds the
number of executions (default: 1 for point rules, unbounded for
``duration`` windows — a partition drops EVERY frame in its window
unless the author bounds it explicitly; 0 always means unbounded),
and ``only_first_incarnation`` skips the rule in respawned workers
(``DLROVER_RESTART_COUNT > 0``) so a kill scheduled at step N does
not re-kill the recovered incarnation replaying step N.

Scenarios load from a dict, a JSON/YAML string, or a file path
(``.yaml``/``.yml``/``.json``); YAML needs pyyaml and degrades to a
clear error when it is missing.
"""

import fnmatch
import json
import os
import random
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from dlrover_tpu_torch.common import env_utils

# actions the injector knows how to execute (see chaos/primitives.py)
KNOWN_ACTIONS = (
    "kill",          # signal own process (default SIGKILL)
    "kill_worker",   # signal a supervised worker from ctx["procs"]
    "kill_node",     # kill worker tree then self (node-loss parity)
    "drop",          # raise ConnectionError (RPC drop / partition)
    "delay",         # sleep args["seconds"] then continue (RPC delay)
    "io_error",      # raise OSError (storage fault)
    "stall",         # sleep args["seconds"] (storage write stall)
    "slow",          # sleep args["seconds"] (straggler slow step)
    "corrupt_shm",   # flip bytes in the shm snapshot via ctx["handler"]
    "preempt",       # return True (simulated preemption notice)
)


@dataclass
class Rule:
    """One fault rule of a scenario."""

    point: str
    action: str
    name: str = ""
    at_step: Optional[int] = None
    after_step: Optional[int] = None
    step_window: Optional[List[int]] = None
    after_calls: Optional[int] = None
    after_time: Optional[float] = None
    prob: Optional[float] = None
    duration: float = 0.0
    # None = default: 1 for point rules, 0 (unbounded) inside a
    # duration window; resolved to an int in __post_init__
    max_count: Optional[int] = None
    only_first_incarnation: bool = False
    # fire only in the worker incarnation whose restart_count equals
    # this (generalizes only_first_incarnation: scheduled-churn
    # scenarios kill incarnation 0 at step A, incarnation 1 at step
    # B, ... without re-killing a respawn replaying A)
    incarnation: Optional[int] = None
    # fire only in processes whose environment matches every pair —
    # how a rule targets a SUBSET of a multi-process job: one node of
    # a multi-agent partition ({"DLROVER_NODE_RANK": "1"}), one
    # forkserver template generation
    # ({"DLROVER_FORKSERVER_GENERATION": "1"})
    env_equals: Dict[str, str] = field(default_factory=dict)
    args: Dict[str, Any] = field(default_factory=dict)

    def __post_init__(self):
        if self.max_count is None:
            self.max_count = 0 if self.duration > 0 else 1
        if self.action not in KNOWN_ACTIONS:
            raise ValueError(
                f"unknown chaos action {self.action!r}; "
                f"known: {KNOWN_ACTIONS}"
            )
        triggers = [
            t for t in (
                self.at_step, self.after_step, self.step_window,
                self.after_calls, self.after_time, self.prob,
            )
            if t is not None
        ]
        if len(triggers) > 1:
            raise ValueError(
                f"rule {self.name or self.point!r} has more than one "
                "trigger; pick one of at_step/after_step/step_window/"
                "after_calls/after_time/prob"
            )
        if self.step_window is not None:
            lo, hi = self.step_window
            if lo > hi:
                raise ValueError(
                    f"step_window lo {lo} > hi {hi}"
                )

    def matches(self, point: str) -> bool:
        if self.point == point:
            return True
        return fnmatch.fnmatchcase(point, self.point)


class RuleState:
    """Per-process runtime state of one rule: its seeded RNG, call
    and execution counters, the step drawn from a ``step_window``, and
    the ``duration`` window opening time."""

    def __init__(self, rule: Rule, index: int, seed: int):
        self.rule = rule
        # stable derivation: the rule's position and the scenario seed
        # fully determine every draw this rule will ever make
        self.rng = random.Random(f"{seed}:{index}:{rule.point}")
        self.calls = 0
        self.executions = 0
        self.window_opened_at: Optional[float] = None
        self.window_closed = False
        self.chosen_step: Optional[int] = None
        if rule.step_window is not None:
            lo, hi = rule.step_window
            self.chosen_step = self.rng.randint(lo, hi)

    def exhausted(self) -> bool:
        if self.rule.duration > 0:
            # a window rule ends when its window closes OR it hit an
            # explicit execution bound mid-window
            return self.window_closed
        return (
            self.rule.max_count > 0
            and self.executions >= self.rule.max_count
        )

    def should_fire(self, ctx: Dict[str, Any], now: float,
                    installed_at: float) -> bool:
        """Decide, deterministically, whether this invocation of the
        matched point executes the rule's action."""
        rule = self.rule
        self.calls += 1
        if rule.only_first_incarnation or rule.incarnation is not None:
            # hook sites that KNOW the incarnation pass it in ctx (the
            # agent supervises restarts but never carries the env var
            # itself — it only exports it to spawned workers); other
            # processes read their inherited env
            restart_count = ctx.get("restart_count")
            if restart_count is None:
                restart_count = env_utils.get_restart_count()
            if rule.only_first_incarnation and restart_count > 0:
                return False
            if (rule.incarnation is not None
                    and restart_count != rule.incarnation):
                return False
        if rule.env_equals:
            for key, want in rule.env_equals.items():
                if os.environ.get(key, "") != str(want):
                    return False
        # an open duration window fires until it closes — or until an
        # explicit max_count bounds the blast radius mid-window
        if self.window_opened_at is not None:
            if rule.max_count > 0 and self.executions >= rule.max_count:
                self.window_closed = True
                return False
            if now - self.window_opened_at <= rule.duration:
                return True
            self.window_closed = True
            return False
        if rule.duration <= 0 and rule.max_count > 0 \
                and self.executions >= rule.max_count:
            return False
        triggered = self._trigger(ctx, now, installed_at)
        if triggered and rule.duration > 0:
            self.window_opened_at = now
        return triggered

    def _trigger(self, ctx: Dict[str, Any], now: float,
                 installed_at: float) -> bool:
        rule = self.rule
        if rule.at_step is not None:
            return ctx.get("step") == rule.at_step
        if rule.after_step is not None:
            step = ctx.get("step")
            return step is not None and step >= rule.after_step
        if rule.step_window is not None:
            return ctx.get("step") == self.chosen_step
        if rule.after_calls is not None:
            return self.calls >= rule.after_calls
        if rule.after_time is not None:
            return now - installed_at >= rule.after_time
        if rule.prob is not None:
            return self.rng.random() < rule.prob
        return True


@dataclass
class Scenario:
    """A named, seeded fault schedule."""

    name: str = "unnamed"
    seed: int = 0
    rules: List[Rule] = field(default_factory=list)

    def to_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            "name": self.name, "seed": self.seed, "rules": [],
        }
        for r in self.rules:
            rd: Dict[str, Any] = {"point": r.point, "action": r.action}
            for key in (
                "name", "at_step", "after_step", "step_window",
                "after_calls", "after_time", "prob", "incarnation",
            ):
                val = getattr(r, key)
                if val not in (None, ""):
                    rd[key] = val
            if r.duration:
                rd["duration"] = r.duration
            if r.max_count != (0 if r.duration > 0 else 1):
                rd["max_count"] = r.max_count
            if r.only_first_incarnation:
                rd["only_first_incarnation"] = True
            if r.env_equals:
                rd["env_equals"] = dict(r.env_equals)
            if r.args:
                rd["args"] = dict(r.args)
            out["rules"].append(rd)
        return out

    @classmethod
    def from_dict(cls, spec: Dict[str, Any]) -> "Scenario":
        rules = []
        for i, rd in enumerate(spec.get("rules", [])):
            rd = dict(rd)
            rd.setdefault("name", f"rule{i}")
            rules.append(Rule(**rd))
        return cls(
            name=str(spec.get("name", "unnamed")),
            seed=int(spec.get("seed", 0)),
            rules=rules,
        )


def load_scenario(source) -> Scenario:
    """Scenario from a Scenario/dict/JSON-or-YAML string/file path."""
    if isinstance(source, Scenario):
        return source
    if isinstance(source, dict):
        return Scenario.from_dict(source)
    if not isinstance(source, str):
        raise TypeError(f"cannot load a scenario from {type(source)}")
    text = source.strip()
    if text.startswith("{"):  # inline JSON spec
        return Scenario.from_dict(json.loads(text))
    if os.path.exists(source):
        with open(source) as f:
            text = f.read().strip()
        if text.startswith("{"):
            return Scenario.from_dict(json.loads(text))
    elif "\n" not in source and (
        os.sep in source
        or source.endswith((".yaml", ".yml", ".json"))
    ):
        # it NAMES a file that is not there (typo, unmounted volume,
        # subprocess cwd mismatch): raising beats feeding the path
        # string to the YAML parser, which would 'succeed' as a
        # scalar and arm nothing — a silent no-chaos run reads as a
        # recovery-machinery failure instead of a config error
        raise FileNotFoundError(f"chaos scenario file {source!r}")
    try:
        import yaml
    except ImportError as e:  # pragma: no cover - container has pyyaml
        raise RuntimeError(
            "YAML scenario given but pyyaml is unavailable; use a "
            "JSON spec instead"
        ) from e
    return Scenario.from_dict(yaml.safe_load(text))
