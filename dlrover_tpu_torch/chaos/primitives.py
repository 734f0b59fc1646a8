"""Fault primitives the chaos injector executes.

Copy of ``dlrover_tpu/chaos/primitives.py`` (the port imports nothing
of the JAX package).

Each primitive is a plain function ``(rule_args, ctx) -> result``;
raising is a legitimate result (RPC drop raises ``ChaosRpcError``, a
storage fault raises ``ChaosIOError`` — both subclass the exception
type the wrapped subsystem already handles, so hook sites need no
chaos-specific error handling and production retry/recovery paths are
exercised exactly as a real fault would exercise them).

Process kills use raw signals (SIGKILL parity with a node loss,
SIGTERM parity with an eviction) — the same primitive drives both the
trainer-side self-kill and the agent-side worker kill, and the
forkserver regression tests reuse :func:`kill_process` directly.
"""

import os
import signal
import time
from typing import Any, Dict

from dlrover_tpu_torch.common.log import default_logger as logger


class ChaosRpcError(ConnectionError):
    """Injected RPC drop/partition — a ConnectionError so the client's
    reconnect/backoff machinery treats it as a real broken link."""


class ChaosIOError(OSError):
    """Injected storage fault — an OSError so storage callers exercise
    their real error paths."""


_SIGNALS = {
    "KILL": signal.SIGKILL,
    "TERM": signal.SIGTERM,
    "INT": signal.SIGINT,
}


def _resolve_signal(args: Dict[str, Any]) -> int:
    name = str(args.get("signal", "KILL")).upper()
    if name.startswith("SIG"):
        name = name[3:]
    return _SIGNALS.get(name, signal.SIGKILL)


def kill_process(pid: int, sig: int = signal.SIGKILL) -> bool:
    """Signal ``pid``; False when it is already gone.  Shared by the
    chaos actions and the forkserver kill/respawn regression tests."""
    try:
        os.kill(pid, sig)
        return True
    except ProcessLookupError:
        return False
    except PermissionError:
        logger.warning("chaos: not permitted to signal pid %s", pid)
        return False


def act_kill(args: Dict[str, Any], ctx: Dict[str, Any]):
    """Signal the CURRENT process (trainer-side node-loss parity).
    With SIGKILL this call does not return."""
    sig = _resolve_signal(args)
    logger.warning(
        "chaos: signalling own pid %s with %s", os.getpid(), sig
    )
    kill_process(os.getpid(), sig)
    return None


def act_kill_worker(args: Dict[str, Any], ctx: Dict[str, Any]):
    """Signal one supervised worker process from ``ctx['procs']``
    (agent-side kill: the agent observes the death through its normal
    monitor loop, exactly like a real worker crash)."""
    procs = ctx.get("procs") or []
    idx = int(args.get("rank", 0))
    if idx >= len(procs):
        return False
    proc = procs[idx]
    pid = getattr(proc, "pid", None)
    if pid is None:
        return False
    sig = _resolve_signal(args)
    logger.warning("chaos: killing worker rank %s (pid %s)", idx, pid)
    return kill_process(pid, sig)


def act_kill_node(args: Dict[str, Any], ctx: Dict[str, Any]):
    """Node-loss parity: kill the supervised worker processes from
    ``ctx['procs']`` FIRST, then the current (agent) process — a VM
    that disappears takes its whole supervision tree with it, unlike
    ``kill`` (worker keeps its agent) or ``kill_worker`` (agent keeps
    supervising).  The elastic-resize scenarios fire this at the
    ``agent.monitor`` hook so the master sees a node go silent with
    no failure report, exactly like real capacity loss."""
    sig = _resolve_signal(args)
    for proc in ctx.get("procs") or []:
        pid = getattr(proc, "pid", None)
        if pid is not None:
            kill_process(pid, sig)
    logger.warning(
        "chaos: node loss — killed worker tree, now signalling own "
        "pid %s with %s", os.getpid(), sig,
    )
    kill_process(os.getpid(), sig)
    return None


def act_drop(args: Dict[str, Any], ctx: Dict[str, Any]):
    raise ChaosRpcError(
        f"chaos: dropped {ctx.get('point', 'rpc')} frame"
    )


def act_delay(args: Dict[str, Any], ctx: Dict[str, Any]):
    time.sleep(float(args.get("seconds", 0.1)))
    return None


def act_io_error(args: Dict[str, Any], ctx: Dict[str, Any]):
    raise ChaosIOError(
        args.get("errno", 5),
        f"chaos: injected IO error at {ctx.get('path', '?')}",
    )


def act_stall(args: Dict[str, Any], ctx: Dict[str, Any]):
    time.sleep(float(args.get("seconds", 1.0)))
    return None


def act_slow(args: Dict[str, Any], ctx: Dict[str, Any]):
    """Straggler slow-step: stretch the current step by sleeping in
    the report path, so the per-node step-time distribution the
    master's straggler rule medians over genuinely degrades."""
    time.sleep(float(args.get("seconds", 0.5)))
    return None


def act_corrupt_shm(args: Dict[str, Any], ctx: Dict[str, Any]):
    """Flip bytes in the just-written shm checkpoint snapshot via the
    handler passed in the hook context.  ``mode: "torn"`` instead
    republishes the snapshot metadata with ``writing=True`` so readers
    treat it as mid-write (a torn snapshot) and refuse the restore."""
    handler = ctx.get("handler")
    if handler is None:
        return False
    mode = str(args.get("mode", "flip"))
    meta = handler.metadata()
    if not meta:
        return False
    if mode == "torn":
        config = meta["config"]
        config.writing = True
        handler._publish_meta(
            meta["tensors"], config,
            meta["scalar_offset"], meta["scalar_nbytes"],
        )
        logger.warning("chaos: marked shm snapshot torn (writing=True)")
        return True
    shm = handler._attach()
    if shm is None:
        return False
    nbytes = min(int(args.get("nbytes", 64)), shm.size)
    offset = min(int(args.get("offset", 0)), max(0, shm.size - nbytes))
    for i in range(offset, offset + nbytes):
        shm.buf[i] = shm.buf[i] ^ 0xFF
    logger.warning(
        "chaos: flipped %s bytes of shm snapshot at offset %s",
        nbytes, offset,
    )
    return True


def act_preempt(args: Dict[str, Any], ctx: Dict[str, Any]):
    """Simulated preemption notice: the preemption monitor's probe
    hook interprets a truthy return as 'metadata server says TRUE'."""
    logger.warning("chaos: injecting preemption notice")
    return True


ACTIONS = {
    "kill": act_kill,
    "kill_worker": act_kill_worker,
    "kill_node": act_kill_node,
    "drop": act_drop,
    "delay": act_delay,
    "io_error": act_io_error,
    "stall": act_stall,
    "slow": act_slow,
    "corrupt_shm": act_corrupt_shm,
    "preempt": act_preempt,
}
