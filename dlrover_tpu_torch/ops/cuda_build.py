"""Build the package's CUDA sources at first use and load them with ctypes.

Port-only module (the JAX package compiles its Pallas kernels through
XLA and has no counterpart).  Each ``csrc/<name>.cu`` is compiled by
``nvcc`` for ``sm_90a`` into a shared library with a plain C interface,
``<build dir>/<name>-<hash>.so``, keyed by a hash of the sources and
flags, so an edited source rebuilds and an unchanged one loads at once.
The build directory (:func:`build_dir`) is the job's compile cache,
``<dir>/kernels``, while one is armed in the process or the environment
(:mod:`dlrover_tpu_torch.common.compile_cache`), and the package tree's
``_build/`` otherwise.  :func:`load` records which libraries a process
loaded (name, source hash, file): the AOT step cache
(:mod:`dlrover_tpu_torch.common.aot_cache`) lists them in a step's entry
and loads them again, without ``nvcc``, through :func:`load_prebuilt`.
Nothing here runs at import time: the CPU tests import the package on
machines without ``nvcc``.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, List

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
PKG_BUILD_DIR = PKG_DIR / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    # registers, shared memory and spills of every kernel, kept in the
    # build log beside the library
    "-Xptxas", "-v",
)

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
# name -> {"name", "hash", "file"} of every library this process loaded
_loaded_info: Dict[str, Dict[str, str]] = {}
# seconds this process spent in nvcc (the compile cache's cold witness)
_nvcc_seconds = [0.0]


def build_dir() -> Path:
    """``<compile cache>/kernels`` while a cache is armed in this process
    or its environment, else the package tree's ``_build/``."""
    from dlrover_tpu_torch.common import compile_cache

    cache = compile_cache.active_cache_dir()
    if cache:
        return Path(compile_cache.kernel_dir(cache))
    return PKG_BUILD_DIR


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH, else the
    toolkit's default prefix; raises when none exists."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the CUDA "
        "kernels of dlrover_tpu_torch are built at first use"
    )


def source_hash(name: str) -> str:
    """The key of ``csrc/<name>.cu``'s library: a hash of the source,
    every header in ``csrc/`` and the flags."""
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    for src in [CSRC_DIR / f"{name}.cu", *sorted(CSRC_DIR.glob("*.cuh"))]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to in :func:`build_dir`."""
    return build_dir() / f"{name}-{source_hash(name)}.so"


def build(names: Iterable[str]) -> Dict[str, float]:
    """Compile every named source whose library is missing, one
    ``nvcc`` each, all started together.  Returns ``{name: seconds}``
    (0.0 for a library that was already built); raises with the
    compiler's output when any build fails."""
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        lib = library_path(name)
        if lib.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
        os.close(fd)
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
               str(CSRC_DIR / f"{name}.cu")]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        procs[name] = (proc, tmp, lib, time.perf_counter())
    seconds = {name: 0.0 for name in names}
    failures = []
    for name, (proc, tmp, lib, t0) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        _nvcc_seconds[0] += seconds[name]
        lib.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            os.unlink(tmp)
            failures.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, lib)  # atomic: a concurrent loader sees all or none
    if failures:
        raise RuntimeError("CUDA build failed:\n" + "\n".join(failures))
    return seconds


def _open(name: str, path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    _loaded[name] = lib
    _loaded_info[name] = {"name": name, "hash": path.stem.rsplit("-", 1)[1],
                          "file": str(path)}
    return lib


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        if name not in _loaded:
            build([name])
            _open(name, library_path(name))
        return _loaded[name]


def load_prebuilt(name: str, file: str) -> bool:
    """Load the library ``file`` as ``csrc/<name>.cu``'s without
    building: only when its name carries the current sources' hash (an
    edited kernel never runs an old library) and the file exists.  True
    when the library is loaded (now or before)."""
    with _lock:
        if name in _loaded:
            return True
        path = Path(file)
        if (path.name != f"{name}-{source_hash(name)}.so"
                or not path.is_file()):
            return False
        try:
            _open(name, path)
        except OSError:
            return False
        return True


def loaded_libraries() -> List[Dict[str, str]]:
    """Name, source hash and file of every library this process loaded,
    in name order."""
    with _lock:
        return [dict(_loaded_info[n]) for n in sorted(_loaded_info)]


def nvcc_seconds() -> float:
    """Seconds this process has spent in ``nvcc`` so far."""
    return _nvcc_seconds[0]
