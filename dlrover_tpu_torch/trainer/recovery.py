"""Recovery-phase profiler: the death→first-step budget, measured.

The invisible-recovery target (``elastic_recovery_s ≤ 2.0``) is only
reachable — and only *provable* — with the serial chain broken into
named phases, each measured where it actually runs:

- **spawn**: the agent witnesses the death → this process exists
  (kernel start time from ``/proc/self/stat``, so the measurement
  covers the fork/exec itself, not just userland);
- **import**: process start → the trainer constructed this profiler
  (interpreter + torch imports — near zero under a warm fork);
- **restore**: the checkpoint restore (the engine's measured
  ``total_s``);
- **aot**: the AOT executable cache's resolve (the reference's
  ``common/aot_cache.py``);
- **retrace**: the first post-restore step, measured around the
  step's device work (for torch, the first call's autograd graph and
  the kernels' first launches);
- **first_step**: the remainder until the first step completes.

Each phase lands as a ``recovery_phase`` event + a
``dlrover_recovery_phase_seconds{phase}`` histogram sample, so the
chaos invariants and the timeline's recovery breakdown read the same
numbers.  The agent exports ``DLROVER_RECOVERY_T0``
(the wall clock at which it observed the death) into every respawned
worker's env; without it the profiler still measures import/restore/
retrace relative to process start (a first incarnation, or a cold
launch).

Copy of ``dlrover_tpu/trainer/recovery.py``.  The reference resolves
the step through JAX's AOT executable cache and watches the persistent
compile cache's entries (``common/{aot_cache,compile_cache}.py``);
their Inductor and CUDA-graph counterparts come with slice 8 of the
port.  Until then :meth:`RecoveryProfiler.resolve_step` takes the
reference's own "off" path (the first call runs under
:meth:`~RecoveryProfiler.measured_retrace`), the ``compile_cache``
witness reports ``status="off"``, and asking for a cache
(``resolve_step(cache_dir=...)``, ``resolve_step_async``) raises
``NotImplementedError`` naming slice 8.
"""

import os
import time
from typing import Callable, Dict, Optional

from dlrover_tpu_torch.common import env_utils
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.telemetry.events import emit_event
from dlrover_tpu_torch.telemetry.metrics import get_registry

RECOVERY_T0_ENV = "DLROVER_RECOVERY_T0"

_CACHE_SLICE = (
    "the step caches (the reference's AOT executable cache and "
    "persistent compile cache) come with slice 8 of the port"
)

_REG = get_registry()
_PHASE_SECONDS = _REG.histogram(
    "dlrover_recovery_phase_seconds",
    "Measured death->first-step recovery budget by phase "
    "(spawn / import / restore / aot / retrace / first_step)",
)


def _proc_start_epoch() -> Optional[float]:
    """Absolute wall-clock time this process started: kernel start
    ticks (``/proc/self/stat`` field 22) against the boot epoch from
    ``/proc/uptime`` — survives exec, unlike any userland timestamp."""
    fields = env_utils.proc_stat_fields(os.getpid())
    if fields is None:
        return None
    try:
        ticks = int(fields[19])
        hz = float(os.sysconf("SC_CLK_TCK"))
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        boot_epoch = time.time() - uptime
        return boot_epoch + ticks / hz
    except (IndexError, ValueError, OSError):
        return None


class _Phase:
    __slots__ = ("_profiler", "_name", "_t0")

    def __init__(self, profiler: "RecoveryProfiler", name: str):
        self._profiler = profiler
        self._name = name

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._profiler.record(
            self._name, time.perf_counter() - self._t0
        )
        return False


class RecoveryProfiler:
    """Construct RIGHT AFTER the heavy imports; the constructor books
    the spawn and import phases.  (The reference's constructor also
    arms the job's persistent compile cache, which comes with slice 8
    of the port.)"""

    def __init__(
        self,
        restart_count: Optional[int] = None,
        node_rank: Optional[int] = None,
    ):
        self.restart_count = (
            restart_count if restart_count is not None
            else env_utils.get_restart_count()
        )
        self.node_rank = (
            node_rank if node_rank is not None
            else env_utils.get_node_rank()
        )
        self.phases: Dict[str, float] = {}
        self.cache_hit: Optional[bool] = None
        self.aot_hit: Optional[bool] = None
        self.cache_dir = ""
        try:
            self.t0 = float(os.getenv(RECOVERY_T0_ENV, "") or 0.0)
        except ValueError:
            self.t0 = 0.0
        now = time.time()
        start = _proc_start_epoch()
        self._proc_start = start if start is not None else now
        if self.t0 > 0 and self._proc_start >= self.t0:
            self.record("spawn", self._proc_start - self.t0)
        self.record("import", max(0.0, now - self._proc_start))
        self._first_step_t0 = time.perf_counter()

    # -- recording ---------------------------------------------------------

    def record(self, phase: str, seconds: float):
        seconds = max(0.0, float(seconds))
        self.phases[phase] = round(seconds, 4)
        _PHASE_SECONDS.observe(seconds, phase=phase)
        emit_event(
            "recovery_phase",
            phase=phase,
            seconds=round(seconds, 4),
            restart_count=self.restart_count,
            node_rank=self.node_rank,
        )

    def phase(self, name: str) -> _Phase:
        """``with profiler.phase("restore"): step, state = load()``"""
        return _Phase(self, name)

    def record_restore(self, restore_phases: Dict) -> None:
        """Book the restore phase from the engine's measured
        breakdown (``Checkpointer.last_restore_phases``)."""
        total = restore_phases.get("total_s")
        if isinstance(total, (int, float)) and total > 0:
            self.record("restore", float(total))

    def resolve_step(
        self,
        fn,
        example_args=None,
        label: str = "train_step",
        cache_dir: Optional[str] = None,
        restore_busy=None,
    ) -> Callable:
        """The reference's "off" resolution of the step: a wrapper
        whose first call runs under :meth:`measured_retrace`, the
        ``aot`` phase booked as 0 and an ``aot_cache`` event with
        ``resolution="off"``::

            step = prof.resolve_step(step_fn)
            ...
            state, metrics = step(state, batch)   # first call measured

        ``restore_busy`` stamps whether the async restore was still
        reading when this resolve finished, as in the reference.
        ``cache_dir`` (the AOT executable cache) raises
        ``NotImplementedError`` naming slice 8 of the port."""
        if cache_dir:
            raise NotImplementedError(_CACHE_SLICE)
        event = {
            "hit": False, "resolution": "off", "key": "", "dir": "",
            "wrote": False, "preloaded": False, "seconds": 0.0,
            "load_s": 0.0, "trace_s": 0.0, "save_s": 0.0, "entries": 0,
            "restart_count": self.restart_count,
            "node_rank": self.node_rank,
            "reason": "no step cache in the port before slice 8",
        }
        if restore_busy is not None:
            busy = restore_busy() if callable(restore_busy) else (
                restore_busy
            )
            event["overlapped_restore"] = bool(busy)
        self.aot_hit = False
        self.record("aot", 0.0)
        emit_event("aot_cache", **event)
        done = [False]
        profiler = self

        def first_call_measured(*args, **kwargs):
            if done[0]:
                return fn(*args, **kwargs)
            done[0] = True
            with profiler.measured_retrace() as r:
                out = fn(*args, **kwargs)
                r.block(out)
            return out

        return first_call_measured

    def resolve_step_async(self, *args, **kwargs):
        """The reference resolves the step through the AOT cache on a
        thread; that cache comes with slice 8 of the port."""
        raise NotImplementedError(_CACHE_SLICE)

    def _emit_compile_cache(self, retrace_s: float):
        emit_event(
            "compile_cache",
            hit=False,
            status="off",
            entries_before=0,
            entries_after=0,
            aot_entries=0,
            retrace_s=round(retrace_s, 4),
            dir=self.cache_dir,
            restart_count=self.restart_count,
            node_rank=self.node_rank,
        )

    def measured_retrace(self) -> "_Retrace":
        """Bracket the FIRST post-restore step::

            with profiler.measured_retrace() as r:
                state, metrics = step_fn(state, batch)
                r.block(metrics)

        The block's wall time is the retrace phase.  ``block`` makes
        ``__exit__`` wait for the device work behind the step's output
        (``torch.cuda.synchronize`` of its device), so asynchronous
        launches cannot shrink the measurement.  With no step cache
        (slice 8) the ``compile_cache`` event says ``status="off"``
        and ``hit=False``."""
        return _Retrace(self)

    def record_first_step(self):
        """Close the budget: remainder since the last recorded phase
        boundary (profiler construction → now, minus restore+retrace,
        which were measured inside it)."""
        elapsed = time.perf_counter() - self._first_step_t0
        inner = sum(
            self.phases.get(p, 0.0)
            for p in ("restore", "retrace", "aot")
        )
        self.record("first_step", max(0.0, elapsed - inner))
        if self.t0 > 0:
            total = time.time() - self.t0
            logger.info(
                "recovery budget (restart %s): %.2fs total — %s",
                self.restart_count, total, self.phases,
            )


class _Retrace:
    def __init__(self, profiler: RecoveryProfiler):
        self._p = profiler
        self._blocked = None

    def block(self, x):
        """Remember the step's output so ``__exit__`` can wait on it
        (retrace_s must include the device work of the first step)."""
        self._blocked = x
        return x

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, *exc):
        if exc_type is not None:
            return False
        if self._blocked is not None:
            from dlrover_tpu_torch.trainer.elastic_trainer import (
                _synchronize,
            )

            _synchronize(self._blocked)
        retrace_s = time.perf_counter() - self._t0
        self._p.cache_hit = False
        self._p.record("retrace", retrace_s)
        self._p._emit_compile_cache(retrace_s)
        return False
