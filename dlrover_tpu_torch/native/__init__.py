"""Native (C++) host components and the code that compiles them.

Copy of ``dlrover_tpu/native/__init__.py`` (reference: the TFPlus C++
ops and ATorch's csrc, compiled just in time): a C++ source of this
directory is compiled on first use
with g++ into ``dlrover_tpu_torch/_build/lib<name>-<hash>.so`` (keyed
by a hash of the source, the flags and the host CPU's instruction-set
flags) and loaded with ctypes.  ``kv_store.cc`` is
the JAX package's store, copied byte for byte, and built with the same
flags, so both packages' tables compute bit-equal rows.  A failed build
raises: nothing falls back.
"""

import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import List, Optional

from dlrover_tpu_torch.common.log import default_logger as logger

SRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = SRC_DIR.parent / "_build"
# the JAX package's flags: -march=native lets g++ contract a * b + c
# into an FMA, so the two packages' stores agree bit for bit only when
# they are built alike
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-march=native")

_BUILD_LOCK = threading.Lock()


def _cpu_flags() -> bytes:
    """The instruction-set flags of this host's CPU (``/proc/cpuinfo``;
    empty where there is none)."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            for line in f:
                if line.startswith(b"flags"):
                    return line
    except OSError:
        pass
    return b""


def build_library(
    name: str, sources: Optional[List[str]] = None,
    extra_flags: Optional[List[str]] = None,
) -> str:
    """Compile ``sources`` (default ``<name>.cc`` here) into
    ``_build/lib<name>-<hash>.so`` unless it exists; returns its path.
    Raises ``RuntimeError`` with g++'s output when the build fails."""
    sources = sources or [str(SRC_DIR / f"{name}.cc")]
    flags = [*CXX_FLAGS, *(extra_flags or [])]
    digest = hashlib.sha256()
    for src in sources:
        with open(src, "rb") as f:
            digest.update(f.read())
    # -march=native ties the library to this host's instruction set: a
    # checkout copied to another machine builds its own
    digest.update(" ".join(flags).encode() + _cpu_flags())
    tag = digest.hexdigest()[:16]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib_path = BUILD_DIR / f"lib{name}-{tag}.so"
    if lib_path.exists():
        return str(lib_path)
    with _BUILD_LOCK:
        if lib_path.exists():
            return str(lib_path)
        # a name of this process's own: two processes building at once
        # each write their own file and the rename keeps one
        tmp = f"{lib_path}.{os.getpid()}.tmp"
        cmd = ["g++", *CXX_FLAGS, *sources, "-o", tmp,
               *(extra_flags or [])]
        logger.info("building native lib: %s", " ".join(cmd))
        result = subprocess.run(  # noqa: S603
            cmd, capture_output=True, text=True
        )
        if result.returncode != 0:
            raise RuntimeError(
                f"native build of {name} failed:\n{result.stderr}"
            )
        os.replace(tmp, lib_path)
    return str(lib_path)
