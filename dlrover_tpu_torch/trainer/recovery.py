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

Copy of ``dlrover_tpu/trainer/recovery.py``.  The step resolves through
the port's AOT step cache (:mod:`dlrover_tpu_torch.common.aot_cache`)
and the retrace witness watches the kernel libraries of the job's
compile cache (:mod:`dlrover_tpu_torch.common.compile_cache`).  The
port's step is eager, so there is no trace for a hit to skip: on every
path the ``aot`` phase books the resolve (the entry's library loads on
a hit) and ``retrace`` books the first eager call, measured with its
device work, where the reference books 0 on a hit.  A resolve without
example inputs (``resolve_step(fn)``) keys no entry and takes the
reference's "off" path.  Where the reference's constructor arms the
job's cache always, the port's is armed by the operator
(``DLROVER_COMPILE_CACHE_DIR``, or an in-process
:func:`~dlrover_tpu_torch.common.compile_cache.enable_persistent_cache`):
armed, the kernels build into the cache instead of the package tree.
"""

import os
import threading
import time
from typing import Callable, Dict, Optional

from dlrover_tpu_torch.common import compile_cache as _cc
from dlrover_tpu_torch.common import env_utils
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.telemetry.events import emit_event
from dlrover_tpu_torch.telemetry.metrics import get_registry

RECOVERY_T0_ENV = "DLROVER_RECOVERY_T0"

# the aot_cache event's resolution, where the reference names what it
# deserialized or traced
_RESOLUTION = {"aot": "eager-hit", "trace": "eager-miss"}

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
    the spawn and import phases and, when a compile cache is armed,
    creates its ``kernels/`` directory."""

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
        # the reference arms its cache here, always; the port's is armed
        # by the operator (DLROVER_COMPILE_CACHE_DIR) or in-process, and
        # the profiler only makes sure its kernels/ directory exists
        self.cache_dir = _cc.active_cache_dir()
        if self.cache_dir:
            try:
                os.makedirs(_cc.kernel_dir(self.cache_dir), exist_ok=True)
            except OSError as e:
                logger.warning("compile cache dir %s not creatable: %s",
                               self.cache_dir, e)
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
        """Resolve the step through the AOT step cache, booking the
        budget phases and emitting the witnesses::

            step = prof.resolve_step(step_fn, lambda: (state, batch))
            ...
            state, metrics = step(state, batch)   # first call measured

        HIT: the entry's kernel libraries are loaded (the ``aot``
        phase); MISS: the first call writes the entry so incarnation
        N+1 hits.  On every path the first call runs under the measured
        retrace bracket.  ``example_args`` is the argument tuple or a
        zero-arg callable building it (the warm fast path never calls
        it); without one no entry is keyed and the resolution is the
        reference's "off" path.  ``cache_dir`` is the entry directory
        (default: ``aot/`` of the job's compile cache).

        ``restore_busy`` (pass ``lambda: not load_handle.done()``; a
        plain bool works too) stamps whether the async restore was
        still reading when this resolve finished — the overlap
        witness on the ``aot_cache`` event."""
        from dlrover_tpu_torch.common import aot_cache as _aot

        if example_args is None:
            return self._book_resolution(
                _aot.Resolution(
                    fn=fn, source="off", deferred=True,
                    reason="no example inputs: no entry is keyed",
                ), 0.0, restore_busy,
            )
        t0 = time.perf_counter()
        res = _aot.resolve_step(
            fn, example_args, label=label, cache_dir=cache_dir
        )
        return self._book_resolution(
            res, time.perf_counter() - t0, restore_busy
        )

    def resolve_step_async(
        self,
        fn,
        args_builder: Callable,
        label: str = "train_step",
        cache_dir: Optional[str] = None,
        restore_busy=None,
    ) -> Callable:
        """:meth:`resolve_step` on a daemon thread, so the entry read and
        the library loads (HIT) — and the example build itself —
        overlap the async restore read AND the caller's own
        model/optimizer/state construction::

            join = prof.resolve_step_async(
                step_fn, lambda: (state, batch),
                restore_busy=lambda: not load_handle.done())
            ... build model, join the restore, build the state ...
            step = join()   # waits only for what did not overlap

        The ``aot`` budget phase books the JOIN WAIT — the seconds
        the critical path actually stalled — while the ``aot_cache``
        event keeps the thread-measured ``load_s``."""
        from dlrover_tpu_torch.common import aot_cache as _aot

        holder: Dict[str, object] = {}
        t0 = time.perf_counter()

        def run():
            try:
                # the builder is passed THROUGH (not called): on the
                # warm fast path the label index resolves without
                # ever building the examples
                holder["res"] = _aot.resolve_step(
                    fn, args_builder, label=label, cache_dir=cache_dir
                )
            except Exception as e:  # noqa: BLE001 - never crash
                holder["res"] = _aot.Resolution(
                    fn=fn, source="off", deferred=True,
                    reason=f"async resolve failed: {e}",
                )

        thread = threading.Thread(
            target=run, daemon=True, name="aot-resolve"
        )
        thread.start()

        def join(timeout: Optional[float] = None):
            w0 = time.perf_counter()
            thread.join(timeout=timeout)
            wait = time.perf_counter() - w0
            res = holder.get("res")
            if res is None:  # timeout: run plain, never wedge
                res = _aot.Resolution(
                    fn=fn, source="off", deferred=True,
                    reason="async resolve timed out",
                )
            return self._book_resolution(
                res, time.perf_counter() - t0, restore_busy,
                aot_phase_s=wait,
            )

        return join

    def _aot_event(self, res, wall: float, busy) -> Dict:
        from dlrover_tpu_torch.common import aot_cache as _aot

        event = {
            "hit": res.hit,
            # "resolution", not "source": the event envelope's
            # source field is the emitting process's identity
            "resolution": _RESOLUTION.get(res.source, res.source),
            "key": res.key,
            "dir": res.dir,
            "wrote": res.wrote,
            "preloaded": res.preloaded,
            "seconds": round(wall, 4),
            "load_s": round(res.load_s, 4),
            "trace_s": round(res.trace_s, 4),
            "save_s": round(res.save_s, 4),
            "entries": _aot.aot_entries(res.dir) if res.dir else 0,
            "restart_count": self.restart_count,
            "node_rank": self.node_rank,
        }
        for k, v in res.extra.items():
            event[k] = round(v, 4) if isinstance(v, float) else v
        if res.reason:
            event["reason"] = res.reason
        if busy is not None:
            event["overlapped_restore"] = bool(busy)
        return event

    def _book_resolution(
        self,
        res,
        wall: float,
        restore_busy=None,
        aot_phase_s: Optional[float] = None,
    ) -> Callable:
        """Book an :class:`aot_cache.Resolution` into the budget phases
        and the ``aot_cache`` witness; returns the callable the training
        loop should use, whose first call runs under the measured
        retrace (which emits the ``compile_cache`` witness).  A hit or
        an off resolve books ``aot`` now; a miss books it after the
        first call, which wrote the entry (``load_s + save_s``, as the
        reference books its miss), and emits its ``aot_cache`` event
        then, with ``wrote``, ``trace_s`` and ``save_s`` filled in.
        ``aot_phase_s`` overrides the booked ``aot`` phase of a hit or
        an off resolve (the async path passes the join wait)."""
        busy = restore_busy() if callable(restore_busy) else restore_busy
        wait = {} if aot_phase_s is None else {"wait_s": round(
            aot_phase_s, 4)}
        self.aot_hit = res.source == "aot"
        if res.source != "trace":
            self.record(
                "aot", res.load_s if aot_phase_s is None else aot_phase_s)
            emit_event("aot_cache", **self._aot_event(res, wall, busy),
                       **wait)
        inner = res.fn
        done = [False]
        profiler = self

        def first_call_measured(*args, **kwargs):
            if done[0]:
                return inner(*args, **kwargs)
            done[0] = True
            with _Retrace(profiler, res, wall, busy, wait) as r:
                out = inner(*args, **kwargs)
                r.block(out)
            return out

        return first_call_measured

    def _emit_compile_cache(
        self, hit, status, retrace_s, entries_before, entries_after,
        aot_entries, build_s=0.0,
    ):
        emit_event(
            "compile_cache",
            hit=hit,
            status=status,
            entries_before=entries_before,
            entries_after=entries_after,
            aot_entries=aot_entries,
            retrace_s=round(retrace_s, 4),
            build_s=round(build_s, 4),
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
        launches cannot shrink the measurement.  The compile cache's
        library count before/after witnesses the hit (no new library
        over a warm directory = ``kernel-cache-hit``, else ``cold``,
        with the ``nvcc`` seconds as ``build_s``), emitted as a
        ``compile_cache`` event."""
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
    """The first-call bracket.  With a resolution (``res``) it also
    closes the cache's books: a hit's witness says ``aot-hit`` when the
    call built no library, and a miss books its ``aot`` phase and emits
    its ``aot_cache`` event once the call has written the entry."""

    def __init__(self, profiler: RecoveryProfiler, res=None,
                 wall: float = 0.0, busy=None, wait=None):
        self._p = profiler
        self._res = res
        self._wall = wall
        self._busy = busy
        self._wait = wait or {}
        self._blocked = None

    def block(self, x):
        """Remember the step's output so ``__exit__`` can wait on it
        (retrace_s must include the device work of the first step)."""
        self._blocked = x
        return x

    def __enter__(self):
        from dlrover_tpu_torch.ops import cuda_build

        self._before = _cc.cache_entries(self._p.cache_dir)
        self._build0 = cuda_build.nvcc_seconds()
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
        from dlrover_tpu_torch.common import aot_cache as _aot
        from dlrover_tpu_torch.ops import cuda_build

        p, res = self._p, self._res
        retrace_s = time.perf_counter() - self._t0
        after = _cc.cache_entries(p.cache_dir)
        build_s = cuda_build.nvcc_seconds() - self._build0
        if res is not None and res.source == "aot":
            hit = after <= self._before
            status = "aot-hit" if hit else "cold"
        else:
            hit = self._before > 0 and after <= self._before
            status = "kernel-cache-hit" if hit else "cold"
        if res is not None and res.source == "trace":
            # the entry write rode the first call: it is the aot
            # phase's, as the reference books its miss
            retrace_s = max(0.0, retrace_s - res.save_s)
            p.record("aot", res.load_s + res.save_s)
            emit_event("aot_cache", **p._aot_event(
                res, self._wall, self._busy), **self._wait)
        p.cache_hit = hit
        p.record("retrace", retrace_s)
        p._emit_compile_cache(
            hit=hit, status=status, retrace_s=retrace_s,
            entries_before=self._before, entries_after=after,
            aot_entries=_aot.aot_entries(res.dir if res is not None
                                         and res.dir else None),
            build_s=build_s,
        )
        return False
