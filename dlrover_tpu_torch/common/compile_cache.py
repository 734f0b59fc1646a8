"""Job-keyed persistent cache of the port's compiled kernels.

Copy of ``dlrover_tpu/common/compile_cache.py``, with the torch meaning.
The reference caches XLA's executables: a respawned trainer re-traces
its jitted step and, without the cache, re-COMPILES it.  The port's
step runs eagerly and traces nothing; what it does compile is its hand
kernels: ``ops/cuda_build.py`` runs ``nvcc`` at the first launch of a
kernel whose library is missing, so a worker on a replacement host with
a fresh tree pays that build inside its first step.  The build is the
port's counterpart of XLA's compile, and the libraries are the
counterpart of the compiled executables.  What the elastic stack
supplies is the reference's *sharing contract*: every incarnation of a
job, a replacement worker on another host after a resize included,
resolves the SAME cache directory, so the first incarnation's build
pre-populates what every later one loads.

Resolution order for :func:`job_cache_dir`:

1. ``DLROVER_COMPILE_CACHE_DIR``, the operator's explicit choice (point
   it at job-shared storage for cross-host hits);
2. ``<tmpdir>/dlrover_torch_cache_<job>``, keyed off the job identity
   (``DLROVER_JOB_NAME`` or the IPC socket-dir hash, the namespace rule
   the shm segments use), so two jobs on one host never share entries
   but every incarnation of one job does.

The reference's step 2, an ambient ``JAX_COMPILATION_CACHE_DIR``, has no
counterpart: torch has no compile cache of its own that a user could
already have pointed somewhere.

The kernel libraries live in ``<dir>/kernels``.  :func:`cache_env` and
:func:`enable_persistent_cache` point the kernel build there; a process
with neither keeps building into the package tree's ``_build/``
(:func:`dlrover_tpu_torch.ops.cuda_build.build_dir`), so arming the
cache is the operator's choice, never a side effect of a profiler.

Hit detection (:func:`cache_entries` + the trainer's retrace monitor)
counts the libraries (``*.so``): the build writes one per kernel source
and a load only reads it, so "no new library across the first
post-restore step" IS the cache-hit witness, read from the filesystem.

The witness distinguishes the reference's THREE outcomes, surfaced as
the ``status`` field of every ``compile_cache`` event:

- ``aot-hit``: the step resolved through the AOT cache
  (:mod:`dlrover_tpu_torch.common.aot_cache`): its entry's kernel
  libraries were loaded before the first call (from the forkserver
  template's memory when it preloaded them), and that call added no
  library;
- ``kernel-cache-hit`` (the reference's ``xla-cache-hit``): no AOT hit,
  but the first post-restore step added no library over a warm
  directory: every kernel it launched loaded from this cache;
- ``cold``: the first step built a library (or the directory was
  empty); the event's ``build_s`` books the ``nvcc`` seconds.

:func:`aot_entries` counts the AOT half so both witnesses read from one
module.
"""

import os
import tempfile
from typing import Dict, Optional

from dlrover_tpu_torch.common.log import default_logger as logger

DLROVER_CACHE_DIR_ENV = "DLROVER_COMPILE_CACHE_DIR"
KERNEL_SUBDIR = "kernels"
LIBRARY_SUFFIX = ".so"

# the directory enable_persistent_cache() armed in this process ("" when
# none): it outranks the environment, as the reference's jax.config
# update outranks the env jax read at import
_ENABLED = {"dir": ""}


def job_cache_dir() -> str:
    """The cache directory every incarnation of this job shares."""
    explicit = os.getenv(DLROVER_CACHE_DIR_ENV, "").strip()
    if explicit:
        return explicit
    from dlrover_tpu_torch.checkpoint.shm_handler import default_job_suffix

    return os.path.join(
        tempfile.gettempdir(),
        f"dlrover_torch_cache_{default_job_suffix()}",
    )


def kernel_dir(cache_dir: Optional[str] = None) -> str:
    """``<cache_dir>/kernels``, where the kernel build writes its
    libraries while the cache is armed."""
    return os.path.join(
        cache_dir if cache_dir is not None else job_cache_dir(),
        KERNEL_SUBDIR,
    )


def active_cache_dir() -> str:
    """The armed cache directory of this process: the one
    :func:`enable_persistent_cache` armed, else
    ``DLROVER_COMPILE_CACHE_DIR``, else ``""`` (no cache: the kernel
    build keeps the package tree's ``_build/``)."""
    return _ENABLED["dir"] or os.getenv(DLROVER_CACHE_DIR_ENV, "").strip()


def cache_env(cache_dir: str = "") -> Dict[str, str]:
    """Env block a worker spawn exports so its kernel build writes to
    and loads from the shared cache (a forked worker reads it at its
    first build, so the template needs no config push)."""
    return {DLROVER_CACHE_DIR_ENV: cache_dir or job_cache_dir()}


def enable_persistent_cache(cache_dir: str = "") -> str:
    """In-process activation (idempotent): create ``<dir>/kernels`` and
    point this process's kernel build at it.  Returns the active
    directory, or ``""`` when it could not be created."""
    cache_dir = cache_dir or job_cache_dir()
    try:
        os.makedirs(kernel_dir(cache_dir), exist_ok=True)
    except OSError as e:
        logger.warning(
            "compile cache dir %s not creatable: %s", cache_dir, e
        )
        return ""
    _ENABLED["dir"] = cache_dir
    return cache_dir


def cache_entries(cache_dir: Optional[str] = None) -> int:
    """Number of kernel libraries in the cache (``*.so`` in
    ``<dir>/kernels``; the build's logs and in-flight temporaries are
    not entries).  A names-only ``listdir``, as the reference's: a stat
    per file would cost the recovery it witnesses."""
    if cache_dir is None:
        cache_dir = job_cache_dir()
    if not cache_dir:
        return 0
    try:
        return sum(
            1 for f in os.listdir(kernel_dir(cache_dir))
            if f.endswith(LIBRARY_SUFFIX) and not f.startswith("tmp")
        )
    except OSError:
        return 0


def aot_entries(cache_dir: Optional[str] = None) -> int:
    """Number of AOT step entries, the second half of the hit witness
    (an ``aot-hit`` builds nothing, so counting only libraries would
    read a fully warm recovery as suspiciously idle)."""
    from dlrover_tpu_torch.common.aot_cache import aot_entries as _entries

    return _entries(cache_dir)
