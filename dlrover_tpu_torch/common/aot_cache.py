"""AOT step cache: a respawn finds its step's kernels loaded.

Copy of ``dlrover_tpu/common/aot_cache.py``, with the torch meaning.
The reference serializes its compiled step executable, so a respawn
deserializes instead of re-tracing.  The port's step runs eagerly: it
has no trace for an entry to skip, and what a first call compiles is its
hand kernels (:mod:`dlrover_tpu_torch.ops.cuda_build`, cached across
incarnations by :mod:`dlrover_tpu_torch.common.compile_cache`).  So an
entry here is the resolved step's record: the descriptor it is keyed by
and the kernel libraries (name, source hash, file) that its first call
loaded.  A HIT means the key matched and the entry's libraries were
loaded before the first call, by ``ctypes`` and without ``nvcc``; when
the forkserver template preloaded them (``DLROVER_AOT_PRETRACE``) they
come from the template's memory, so neither a build nor a library load
sits in the respawn's first step.  On the CPU an entry lists no library
and a hit is the key match alone.

Keyed like the reference, from everything that could invalidate it:

- the torch and CUDA version strings;
- the device name and count, the process count and the world size (a
  resized world resolves anew);
- shape, dtype and device of every tensor leaf of the inputs (a module
  contributes its parameters and buffers, an optimizer its type, a
  dataclass its fields), plus the input treedef through
  ``torch.utils._pytree``;
- a caller-supplied label and the step function's code identity
  (:func:`fn_fingerprint`, the reference's as it is), so an edited loss
  or a changed hyperparameter captured in a closure misses.

**Strict fall-back**: any key mismatch, corrupt entry, missing or stale
library (its file name carries its sources' hash) or load error is a
"miss", and the caller runs exactly as without this module.  Entries are
written atomically (tmp + rename).

A miss has nothing to compile ahead: the entry is written after the
step's first eager call, which is what loads (or builds) its kernels,
so :class:`Resolution` ``wrote``, ``trace_s`` and ``save_s`` are filled
in by that call.  A hit's first call checks the arguments against the
entry's descriptor before the step runs (what the reference's loaded
executable does), and :class:`_GuardedCall` falls back to the plain step
on a drift.

The forkserver template (``DLROVER_AOT_PRETRACE``) calls
:func:`preload_entries` after its module preload: it reads the entries'
bytes into this module's memory and loads their libraries (a ``dlopen``;
the template makes no CUDA call, as the reference's never deserializes),
and every forked worker inherits both.
"""

import dataclasses
import hashlib
import json
import os
import pickle
import tempfile
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from dlrover_tpu_torch.common import env_utils
from dlrover_tpu_torch.common.log import default_logger as logger

AOT_CACHE_DIR_ENV = "DLROVER_AOT_CACHE_DIR"
AOT_PRETRACE_ENV = "DLROVER_AOT_PRETRACE"
ENTRY_SUFFIX = ".aotx"
# pickle framing of one entry file; bumped when the layout changes so
# an old entry reads as a miss, not an unpickling surprise
_ENTRY_VERSION = 1

# template-preloaded entry bytes (filename -> blob): populated by
# preload_entries() in the forkserver template, inherited by every
# forked worker — load_entry() serves from here before touching disk
_PRELOADED: Dict[str, bytes] = {}


def aot_cache_dir() -> str:
    """The AOT entry directory every incarnation of this job shares:
    ``DLROVER_AOT_CACHE_DIR`` when the operator chose, else ``aot/``
    under the compile cache's job-keyed directory (so the two caches
    ride the same sharing contract)."""
    explicit = os.getenv(AOT_CACHE_DIR_ENV, "").strip()
    if explicit:
        return explicit
    from dlrover_tpu_torch.common.compile_cache import job_cache_dir

    return os.path.join(job_cache_dir(), "aot")


def _expand(x: Any, depth: int = 0) -> Any:
    """The describable tree of one input: tensors stay leaves; a module
    becomes its named parameters and buffers, an optimizer its type, a
    dataclass (``TrainState``) its fields, each under a key naming the
    type, so the treedef carries it."""
    import torch

    if depth > 16 or isinstance(x, torch.Tensor):
        return x
    if isinstance(x, torch.nn.Module):
        tensors = dict(x.named_parameters())
        tensors.update(x.named_buffers())
        return {f"<{type(x).__name__}>": tensors}
    if isinstance(x, torch.optim.Optimizer):
        return {f"<{type(x).__name__}>": [
            len(g["params"]) for g in x.param_groups]}
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f"<{type(x).__name__}>": {
            f.name: _expand(getattr(x, f.name), depth + 1)
            for f in dataclasses.fields(x)}}
    if isinstance(x, dict):
        return {k: _expand(v, depth + 1) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        items = [_expand(v, depth + 1) for v in x]
        return tuple(items) if isinstance(x, tuple) else items
    return x


def _leaf_desc(leaf: Any) -> List:
    """[shape, dtype, weak_type, placement] of one input leaf, the
    reference's layout: the weak type is always False in torch, and the
    placement is the device (with a DTensor's placements).  JSON-safe
    types only: descriptors round-trip through the label index."""
    shape = [int(d) for d in getattr(leaf, "shape", ())]
    dtype = str(getattr(leaf, "dtype", type(leaf).__name__))
    device = getattr(leaf, "device", None)
    where = str(device) if device is not None else ""
    placements = getattr(leaf, "placements", None)
    if placements is not None:
        where += f" {tuple(placements)!r}"
    return [shape, dtype, False, where]


def fn_fingerprint(fn: Any) -> str:
    """Code-identity component of the key: a hash over the function's
    bytecode, literal constants, and (recursively, bounded) the same
    for every function reachable through its closure — so editing the
    loss, changing an optimizer hyperparameter captured in a closure,
    or swapping the model config invalidates the entry even though
    label, shapes and topology are unchanged.  Values whose ``repr``
    embeds a memory address contribute only their type name, so
    structurally identical closures hash identically across processes
    (the cross-process hit this cache exists for).  Unhashable oddities
    degrade to a sentinel — a stale-hit risk narrowed, never a crash.
    """
    h = hashlib.sha256()
    seen: set = set()

    def feed_callable(obj, depth):
        if depth > 8 or id(obj) in seen:
            return
        seen.add(id(obj))
        wrapped = getattr(obj, "__wrapped__", None)
        code = getattr(obj, "__code__", None)
        if code is None and wrapped is not None:
            feed_callable(wrapped, depth)
            return
        if code is None:
            feed_value(getattr(obj, "__call__", obj), depth + 1)
            return
        h.update(code.co_code)
        for const in code.co_consts:
            if isinstance(
                const, (int, float, str, bytes, bool, type(None))
            ):
                h.update(repr(const).encode("utf-8"))
            elif hasattr(const, "co_code"):
                h.update(const.co_code)
        for cell in getattr(obj, "__closure__", None) or ():
            try:
                feed_value(cell.cell_contents, depth + 1)
            except ValueError:  # empty cell
                continue

    def feed_value(v, depth):
        if depth > 8 or id(v) in seen:
            return
        if callable(v) and (
            hasattr(v, "__code__") or hasattr(v, "__wrapped__")
        ):
            feed_callable(v, depth)
            return
        if isinstance(v, (tuple, list)):
            seen.add(id(v))
            for item in v[:32]:
                feed_value(item, depth + 1)
            return
        if isinstance(v, dict):
            seen.add(id(v))
            for k in sorted(map(repr, v))[:32]:
                h.update(k.encode("utf-8"))
            for item in list(v.values())[:32]:
                feed_value(item, depth + 1)
            return
        try:
            r = repr(v)
        except Exception:  # noqa: BLE001 - repr is best-effort
            r = ""
        if " at 0x" in r:
            # address-bearing default repr: unstable across
            # processes — identity reduces to the type
            h.update(type(v).__name__.encode("utf-8"))
        else:
            h.update(r[:512].encode("utf-8"))

    try:
        feed_callable(fn, 0)
        return h.hexdigest()[:16]
    except Exception:  # noqa: BLE001 - never crash the resolve
        return "unhashable"


def _device_desc() -> Tuple[str, int]:
    import torch

    if torch.cuda.is_available():
        return torch.cuda.get_device_name(0), torch.cuda.device_count()
    return "cpu", 0


def describe(
    example_args: Tuple, label: str = "step", fn: Any = None
) -> Dict:
    """The invalidation descriptor an entry is keyed by (see module
    docstring).  ``example_args`` is the positional-argument tuple the
    step will be called with; ``fn`` contributes the code-identity
    component (see :func:`fn_fingerprint`)."""
    import torch
    from torch.utils import _pytree as pytree

    leaves, spec = pytree.tree_flatten(_expand(example_args))
    device, count = _device_desc()
    return {
        "v": _ENTRY_VERSION,
        "label": str(label),
        "fn": fn_fingerprint(fn) if fn is not None else "",
        "torch": torch.__version__,
        "cuda": torch.version.cuda or "",
        "device": device,
        "devices": count,
        "processes": int(os.getenv("DLROVER_NUM_PROCESSES", "1")),
        "world_size": env_utils.get_world_size(),
        "in_tree": str(spec),
        "avals": [_leaf_desc(x) for x in leaves],
    }


def key_of(desc: Dict) -> str:
    blob = json.dumps(desc, sort_keys=True, default=str)
    return hashlib.sha256(blob.encode("utf-8")).hexdigest()[:32]


def entry_path(key: str, cache_dir: Optional[str] = None) -> str:
    cache_dir = cache_dir or aot_cache_dir()
    return os.path.join(cache_dir, key + ENTRY_SUFFIX)


def aot_entries(cache_dir: Optional[str] = None) -> int:
    """Number of step entries in the cache — the AOT half of the
    compile-cache hit witness."""
    cache_dir = cache_dir or aot_cache_dir()
    try:
        return sum(
            1 for f in os.listdir(cache_dir)
            if f.endswith(ENTRY_SUFFIX)
        )
    except OSError:
        return 0


# descriptor fields that do NOT need the example inputs — the label
# index validates these cheaply on the warm fast path; the input half
# is checked at the first call (_KeyedCall, with _GuardedCall falling
# back to the plain step on a mismatch)
_ENV_FIELDS = (
    "v", "label", "torch", "cuda", "device", "devices",
    "processes", "world_size",
)


def _index_path(label: str, cache_dir: str) -> str:
    safe = "".join(
        c if c.isalnum() or c in "._-" else "_" for c in label
    )
    return os.path.join(cache_dir, safe + ".idx")


def _write_index(label: str, key: str, desc: Dict, cache_dir: str):
    """Label → (key, descriptor) sidecar: the warm fast path resolves
    by LABEL without building the example inputs."""
    path = _index_path(label, cache_dir)
    try:
        fd, tmp = tempfile.mkstemp(dir=cache_dir, suffix=".idx.tmp")
        with os.fdopen(fd, "w") as f:
            json.dump({"key": key, "desc": desc}, f, default=str)
        os.replace(tmp, path)
    except OSError as e:
        logger.debug("aot index write failed (%s): %s", path, e)


def _read_index(label: str, cache_dir: str) -> Optional[Dict]:
    name = os.path.basename(_index_path(label, cache_dir))
    blob = _PRELOADED.get(name)
    if blob is None:
        try:
            with open(_index_path(label, cache_dir), "rb") as f:
                blob = f.read()
        except OSError:
            return None
    try:
        idx = json.loads(blob.decode("utf-8"))
        if not isinstance(idx.get("key"), str) or not isinstance(
            idx.get("desc"), dict
        ):
            return None
        return idx
    except (ValueError, UnicodeDecodeError):
        return None


def env_desc() -> Dict:
    """The input-free half of :func:`describe`."""
    full = describe((), label="")
    return {
        k: full[k] for k in _ENV_FIELDS if k not in ("label",)
    }


def save_entry(
    key: str,
    desc: Dict,
    libraries: List[Dict[str, str]],
    cache_dir: Optional[str] = None,
) -> bool:
    """Write the entry under ``key``: the descriptor and the kernel
    libraries the step's first call loaded.  Atomic (tmp + rename) and
    non-fatal: any failure logs and returns False."""
    cache_dir = cache_dir or aot_cache_dir()
    path = entry_path(key, cache_dir)
    try:
        blob = pickle.dumps({
            "v": _ENTRY_VERSION,
            "desc": desc,
            "libraries": [dict(lib) for lib in libraries],
        })
        os.makedirs(cache_dir, exist_ok=True)
        fd, tmp = tempfile.mkstemp(
            dir=cache_dir, suffix=ENTRY_SUFFIX + ".tmp"
        )
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(blob)
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        return True
    except Exception as e:  # noqa: BLE001 - cache write is optional
        logger.warning("aot cache write failed (%s): %s", path, e)
        return False


def _load_libraries(libraries: List[Dict[str, str]]) -> bool:
    """Load every listed kernel library without building; False when
    one is missing, stale or refused."""
    if not libraries:
        return True
    from dlrover_tpu_torch.ops import cuda_build

    return all(
        cuda_build.load_prebuilt(lib["name"], lib["file"])
        for lib in libraries
    )


def load_entry(
    key: str,
    desc: Dict,
    cache_dir: Optional[str] = None,
    timings: Optional[Dict[str, Any]] = None,
) -> Optional[List[Dict[str, str]]]:
    """The libraries of the entry under ``key``, loaded, or None on ANY
    problem (absent, corrupt, descriptor mismatch, a library missing,
    stale or refused): the caller falls back.  ``timings`` (optional)
    receives ``read_s``, ``unpickle_s`` and the library loads as
    ``deserialize_s``/``deserialize_cpu_s`` (the reference's names),
    plus ``libraries`` and ``libraries_preloaded`` (every one was
    already loaded, by the template before the fork)."""
    cache_dir = cache_dir or aot_cache_dir()
    name = key + ENTRY_SUFFIX
    t0 = time.perf_counter()
    blob = _PRELOADED.get(name)
    if blob is None:
        try:
            with open(entry_path(key, cache_dir), "rb") as f:
                blob = f.read()
        except OSError:
            return None
    if timings is not None:
        timings["read_s"] = time.perf_counter() - t0
    try:
        t0 = time.perf_counter()
        entry = pickle.loads(blob)
        if timings is not None:
            timings["unpickle_s"] = time.perf_counter() - t0
        if entry.get("v") != _ENTRY_VERSION:
            return None
        if entry.get("desc") != desc:
            # a hand-copied or stale entry: its libraries must not be
            # taken for this step's
            return None
        libraries = list(entry.get("libraries", ()))
        from dlrover_tpu_torch.ops import cuda_build

        before = {lib["name"] for lib in cuda_build.loaded_libraries()}
        t0 = time.perf_counter()
        c0 = time.thread_time()
        if not _load_libraries(libraries):
            return None
        if timings is not None:
            timings["deserialize_s"] = time.perf_counter() - t0
            timings["deserialize_cpu_s"] = time.thread_time() - c0
            timings["libraries"] = len(libraries)
            timings["libraries_preloaded"] = all(
                lib["name"] in before for lib in libraries)
        return libraries
    except Exception as e:  # noqa: BLE001 - strict fall-back
        logger.warning("aot cache entry %s unusable: %s", name, e)
        return None


def preload_entries(
    cache_dir: Optional[str] = None,
    max_bytes: int = 512 * 2**20,
) -> Tuple[int, int]:
    """Read every entry's BYTES into module memory and load the kernel
    libraries each lists (forkserver template path: forked workers
    inherit the buffers and the loaded libraries).  Incremental — already-preloaded entries are skipped, so
    the template can re-scan cheaply before every fork and pick up the
    entry the PREVIOUS incarnation wrote.  Bounded by ``max_bytes``
    total; returns ``(new_entries, new_bytes)``.  Never raises and makes
    no CUDA call: a library load is a ``dlopen``."""
    cache_dir = cache_dir or aot_cache_dir()
    count = total = 0
    try:
        names = sorted(os.listdir(cache_dir))
    except OSError:
        return (0, 0)
    for name in names:
        if not name.endswith((ENTRY_SUFFIX, ".idx")):
            continue
        if name.endswith(ENTRY_SUFFIX) and name in _PRELOADED:
            # entries are content-keyed and immutable: cache by name.
            # Index files are MUTATED in place (os.replace on every
            # miss) — always re-read them
            continue
        try:
            with open(os.path.join(cache_dir, name), "rb") as f:
                blob = f.read(max_bytes - total + 1)
        except OSError:
            continue
        if total + len(blob) > max_bytes:
            logger.warning(
                "aot preload budget (%d MB) reached; %s and later "
                "entries stay on disk", max_bytes >> 20, name,
            )
            break
        _PRELOADED[name] = blob
        count += 1
        total += len(blob)
        if name.endswith(ENTRY_SUFFIX):
            try:
                _load_libraries(pickle.loads(blob).get("libraries", ()))
            except Exception as e:  # noqa: BLE001 - the child loads
                logger.warning("aot preload of %s libraries: %s", name, e)
    return (count, total)


def preloaded_entries() -> int:
    """How many entries the template preloaded (inherited over
    fork) — the pre-trace path's witness."""
    return len(_PRELOADED)


def pretrace_enabled() -> bool:
    return os.getenv(AOT_PRETRACE_ENV, "").strip().lower() in (
        "1", "true", "yes", "on",
    )


@dataclass
class Resolution:
    """What :func:`resolve_step` decided.

    ``fn`` is always callable with the original arguments.  ``source``
    is ``"aot"`` (an entry hit: its libraries are loaded), ``"trace"``
    (a miss: the step's first eager call runs, then writes the entry,
    filling ``wrote``, ``trace_s`` and ``save_s``; always ``deferred``)
    or ``"off"`` (no descriptor: plain eager semantics)."""

    fn: Any
    source: str
    key: str = ""
    dir: str = ""
    hit: bool = False
    wrote: bool = False
    deferred: bool = False
    load_s: float = 0.0
    trace_s: float = 0.0
    save_s: float = 0.0
    reason: str = ""
    preloaded: bool = False
    extra: Dict = field(default_factory=dict)


class _GuardedCall:
    """First-call safety net over a cache hit: if the very first
    invocation is refused (an input drift the key missed), fall back to
    the plain step PERMANENTLY instead of crashing the recovery.  A
    primary that reports ``entered`` (its own checks passed and the step
    itself ran) is not retried: a failure inside the step is not a
    cache problem.  After one success the guard is a single attribute
    check per step."""

    __slots__ = ("_primary", "_fallback", "_proven")

    def __init__(self, primary, fallback):
        self._primary = primary
        self._fallback = fallback
        self._proven = False

    def __call__(self, *args, **kwargs):
        if self._primary is None:
            return self._fallback(*args, **kwargs)
        try:
            out = self._primary(*args, **kwargs)
            self._proven = True
            return out
        except Exception as e:  # noqa: BLE001 - never crash recovery
            if self._proven or getattr(self._primary, "entered", False):
                raise  # a failure of the step is not a cache problem
            logger.warning(
                "aot entry rejected at first call (%s); "
                "falling back to the plain step", e,
            )
            self._primary = None
            return self._fallback(*args, **kwargs)


class _KeyedCall:
    """A hit's step: the first call holds its arguments to the entry's
    descriptor (shapes, dtypes, devices, treedef) and raises before the
    step runs when they drifted."""

    __slots__ = ("_fn", "_desc", "entered")

    def __init__(self, fn, desc: Dict):
        self._fn = fn
        self._desc = desc
        self.entered = False

    def __call__(self, *args, **kwargs):
        if not self.entered:
            got = describe(args, label=self._desc.get("label", ""))
            for k in ("in_tree", "avals"):
                if json.loads(json.dumps(got[k])) != self._desc.get(k):
                    raise ValueError(f"input drift from the entry ({k})")
            self.entered = True
        return self._fn(*args, **kwargs)


class _RecordingCall:
    """A miss's step: the first call runs the step (measured into
    ``res.trace_s``, its device work included), then writes the entry
    with the libraries loaded by then and the label index, filling
    ``res.wrote`` and ``res.save_s``; later calls go straight through."""

    __slots__ = ("_fn", "_res", "_desc", "_label", "_done")

    def __init__(self, fn, res: Resolution, desc: Dict, label: str):
        self._fn = fn
        self._res = res
        self._desc = desc
        self._label = label
        self._done = False

    def __call__(self, *args, **kwargs):
        if self._done:
            return self._fn(*args, **kwargs)
        self._done = True
        from dlrover_tpu_torch.trainer.elastic_trainer import _synchronize

        t0 = time.perf_counter()
        out = self._fn(*args, **kwargs)
        _synchronize(out)
        res = self._res
        res.trace_s = time.perf_counter() - t0
        from dlrover_tpu_torch.ops import cuda_build

        t0 = time.perf_counter()
        res.wrote = save_entry(
            res.key, self._desc, cuda_build.loaded_libraries(), res.dir)
        if res.wrote:
            _write_index(self._label, res.key, self._desc, res.dir)
        res.save_s = time.perf_counter() - t0
        return out


def resolve_step(
    fn: Any,
    example_args,
    label: str = "step",
    cache_dir: Optional[str] = None,
) -> Resolution:
    """Resolve an eager step function through the AOT cache.

    ``example_args`` is the positional tuple it will be called with (a
    ``TrainState`` and a batch, say) — or a ZERO-ARG CALLABLE returning
    that tuple, which arms the warm fast path: the label index resolves
    straight to an entry, the input-free descriptor fields are
    validated, and the example build never runs; the input half of the
    key is checked at the first call, with :class:`_GuardedCall`
    falling back to the plain step on a mismatch.

    HIT: the entry's libraries are loaded; returns the guarded step.
    MISS: returns the step wrapped so its first call writes the entry
    and index that incarnation N+1 hits.  Off/error: returns ``fn``
    untouched with ``deferred=True``."""
    cache_dir = cache_dir or aot_cache_dir()
    if callable(example_args) and not isinstance(
        example_args, (list, tuple)
    ):
        builder = example_args
        fast = _resolve_fast(fn, label, cache_dir)
        if fast is not None:
            return fast
        try:
            example_args = builder()
        except Exception as e:  # noqa: BLE001 - builder failed
            return Resolution(
                fn=fn, source="off", deferred=True, dir=cache_dir,
                reason=f"example builder failed: {e}",
            )
    try:
        desc = describe(example_args, label=label, fn=fn)
        key = key_of(desc)
    except Exception as e:  # noqa: BLE001 - odd example trees
        return Resolution(
            fn=fn, source="off", deferred=True, dir=cache_dir,
            reason=f"descriptor failed: {e}",
        )
    preloaded = (key + ENTRY_SUFFIX) in _PRELOADED
    timings: Dict[str, Any] = {}
    t0 = time.perf_counter()
    libraries = load_entry(key, desc, cache_dir, timings=timings)
    load_s = time.perf_counter() - t0
    if libraries is not None:
        return Resolution(
            fn=_GuardedCall(_KeyedCall(fn, desc), fn), source="aot",
            key=key, dir=cache_dir, hit=True, load_s=load_s,
            preloaded=preloaded, extra=timings,
        )
    res = Resolution(
        fn=fn, source="trace", key=key, dir=cache_dir, deferred=True,
        load_s=load_s,
    )
    res.fn = _RecordingCall(fn, res, desc, label)
    return res


def _resolve_fast(
    fn: Any, label: str, cache_dir: str
) -> Optional[Resolution]:
    """The warm fast path: label index → entry, no example build.
    Returns None when anything falls short (no index, env drift,
    unusable entry) — the caller runs the full keyed path."""
    idx = _read_index(label, cache_dir)
    if idx is None:
        return None
    try:
        env = env_desc()
    except Exception:  # noqa: BLE001 - odd torch build
        return None
    desc = idx["desc"]
    if desc.get("label") != label:
        return None
    if desc.get("fn") != fn_fingerprint(fn):
        # the code changed since the entry was written: its record
        # must not stand for this step, however well the inputs match
        return None
    for field_name in _ENV_FIELDS:
        if field_name == "label":
            continue
        if desc.get(field_name) != env.get(field_name):
            return None
    t0 = time.perf_counter()
    timings: Dict[str, Any] = {}
    libraries = load_entry(idx["key"], desc, cache_dir, timings=timings)
    load_s = time.perf_counter() - t0
    if libraries is None:
        return None
    return Resolution(
        fn=_GuardedCall(_KeyedCall(fn, desc), fn), source="aot",
        key=idx["key"], dir=cache_dir, hit=True, load_s=load_s,
        preloaded=(idx["key"] + ENTRY_SUFFIX) in _PRELOADED,
        extra={"fast": True, **timings},
    )
