"""Chaos subsystem: deterministic fault injection for elastic-recovery
testing.

Copy of ``dlrover_tpu/chaos/__init__.py`` (the port imports nothing of
the JAX package).

Permanent hook sites across the codebase call :func:`fire` — RPC
client/server (``common/comm.py``), checkpoint storage
(``common/storage.py``), the shm snapshot writer
(``checkpoint/shm_handler.py``), the trainer step loop
(``trainer/elastic_trainer.py``), the agent's worker monitor
(``agent/training.py``) and the preemption probe
(``agent/preemption.py``).  When no injector is installed — the
production default — ``fire`` is one module-global load and a ``None``
check, so the hooks live in hot paths for free.

Activation:

- set ``DLROVER_CHAOS`` to a scenario file path (YAML/JSON) or inline
  JSON before the process starts; every ``dlrover_tpu`` process that
  imports this package (the master subprocess, the agent, each trainer
  incarnation) arms itself at import, which is how one env var makes a
  whole mini-cluster misbehave on schedule, or
- call :func:`install` in-process (tests, the scenario harness).

``python -m dlrover_tpu_torch.chaos`` runs a named scenario through the
mini-cluster harness and prints the invariant report (see
``chaos/harness.py``).
"""

import os
from typing import Any, Optional

from dlrover_tpu_torch.chaos.injector import ChaosInjector, Injection
from dlrover_tpu_torch.chaos.primitives import (
    ChaosIOError,
    ChaosRpcError,
    kill_process,
)
from dlrover_tpu_torch.chaos.schedule import Rule, Scenario, load_scenario
from dlrover_tpu_torch.common.log import default_logger as logger

CHAOS_ENV = "DLROVER_CHAOS"

_injector: Optional[ChaosInjector] = None


def fire(point: str, **ctx) -> Any:
    """The permanent hook.  No-op (one global load + None check) until
    an injector is installed."""
    inj = _injector
    if inj is None:
        return None
    return inj.fire(point, **ctx)


def chaos_enabled() -> bool:
    return _injector is not None


def get_injector() -> Optional[ChaosInjector]:
    return _injector


def install(scenario, clock=None) -> ChaosInjector:
    """Arm a scenario in this process (replaces any armed one)."""
    global _injector
    kwargs = {"clock": clock} if clock is not None else {}
    _injector = ChaosInjector(scenario, **kwargs)
    logger.warning(
        "chaos armed: scenario %r seed %s (%d rules)",
        _injector.scenario.name,
        _injector.scenario.seed,
        len(_injector.scenario.rules),
    )
    return _injector


def uninstall():
    global _injector
    _injector = None


def install_from_env() -> Optional[ChaosInjector]:
    """Arm from ``DLROVER_CHAOS`` if set; never raises into the caller
    — a malformed scenario logs and leaves chaos disabled (chaos must
    not be able to take a production job down by typo)."""
    spec = os.environ.get(CHAOS_ENV, "").strip()
    if not spec:
        return None
    try:
        return install(spec)
    except Exception as e:  # noqa: BLE001 - bad spec must not kill the job
        logger.error("chaos: cannot load %s=%r: %s", CHAOS_ENV, spec, e)
        return None


# import-time activation: spawned processes (master subprocess, warm-
# or cold-started trainers) inherit DLROVER_CHAOS and arm themselves
# on first import of any hooked module
if os.environ.get(CHAOS_ENV):
    install_from_env()

__all__ = [
    "CHAOS_ENV",
    "ChaosInjector",
    "ChaosIOError",
    "ChaosRpcError",
    "Injection",
    "Rule",
    "Scenario",
    "chaos_enabled",
    "fire",
    "get_injector",
    "install",
    "install_from_env",
    "kill_process",
    "load_scenario",
    "uninstall",
]
