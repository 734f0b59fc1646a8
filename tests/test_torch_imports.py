"""The PyTorch port stands alone: it imports neither JAX nor anything
of the JAX package, and each of its modules names its reference."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "dlrover_tpu_torch"
MODULES = sorted(
    str(p.relative_to(ROOT).with_suffix("")).replace(os.sep, ".")
    for p in PKG.rglob("*.py")
)
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "dlrover_tpu")


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def test_importing_every_module_loads_no_jax_and_no_reference():
    code = (
        "import importlib, json, sys\n"
        f"for m in {MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "print(json.dumps(sorted(sys.modules)))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env,
        capture_output=True, text=True, check=True,
    ).stdout
    loaded = json.loads(out.strip().splitlines()[-1])
    assert set(MODULES) <= set(loaded)
    assert [m for m in loaded if _forbidden(m)] == []


@pytest.mark.parametrize("module", MODULES)
def test_no_import_statement_names_jax_or_the_reference(module):
    """Also the imports inside functions, which a run of the import
    alone would not reach."""
    path = ROOT / (module.replace(".", os.sep) + ".py")
    bad = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.module:
            if node.level == 0 and _forbidden(node.module):
                bad.append(node.module)
    assert bad == []


@pytest.mark.parametrize("module", MODULES)
def test_module_docstring_names_its_reference(module):
    path = ROOT / (module.replace(".", os.sep) + ".py")
    doc = ast.get_docstring(ast.parse(path.read_text())) or ""
    assert "dlrover_tpu/" in doc or "Port-only" in doc or (
        path.name == "__init__.py" and doc
    ), f"{module} names no reference file"


SLICE_4_1 = [
    "dlrover_tpu_torch.accel.accelerate",
    "dlrover_tpu_torch.accel.analyser",
    "dlrover_tpu_torch.accel.dry_runner",
    "dlrover_tpu_torch.accel.model_context",
    "dlrover_tpu_torch.accel.opt_lib",
    "dlrover_tpu_torch.accel.strategy",
    "dlrover_tpu_torch.accel.strategy_search",
    "dlrover_tpu_torch.brain.bo",
    "dlrover_tpu_torch.optim.agd",
    "dlrover_tpu_torch.optim.bf16",
    "dlrover_tpu_torch.optim.offload",
    "dlrover_tpu_torch.optim.wsam",
    "dlrover_tpu_torch.parallel.mesh",
    "dlrover_tpu_torch.parallel.registry",
    "dlrover_tpu_torch.parallel.sharding",
]


@pytest.mark.parametrize("module", SLICE_4_1)
def test_the_modules_of_slice_4_1_are_checked_and_mirror_a_reference(module):
    """The accel/, parallel/ and optim/ modules of slice 4.1 are among
    the modules the tests above import and scan, each at the path of
    the reference file it names."""
    assert module in MODULES
    rel = module.split(".", 1)[1].replace(".", "/") + ".py"
    assert (ROOT / "dlrover_tpu" / rel).exists()
    doc = ast.get_docstring(ast.parse(
        (ROOT / module.replace(".", os.sep)).with_suffix(".py").read_text()))
    assert f"dlrover_tpu/{rel}" in doc


SLICE_4_2 = [
    "dlrover_tpu_torch.checkpoint.backup",
    "dlrover_tpu_torch.checkpoint.orbax_compat",
    "dlrover_tpu_torch.checkpoint.sharded",
]


@pytest.mark.parametrize("module", SLICE_4_2)
def test_the_modules_of_slice_4_2_are_checked_and_mirror_a_reference(
        module):
    """The sharded checkpoint, the orbax tier and the peer backup of
    slice 4.2 are among the modules the tests above import and scan,
    each at the path of the reference file it names."""
    assert module in MODULES
    rel = module.split(".", 1)[1].replace(".", "/") + ".py"
    assert (ROOT / "dlrover_tpu" / rel).exists()
    doc = ast.get_docstring(ast.parse(
        (ROOT / module.replace(".", os.sep)).with_suffix(".py").read_text()))
    assert f"dlrover_tpu/{rel}" in doc


SLICE_7 = [
    ("dlrover_tpu_torch.rl.ppo", "dlrover_tpu/rl/ppo.py"),
    ("dlrover_tpu_torch.rl.generation", "dlrover_tpu/rl/generation.py"),
    ("dlrover_tpu_torch.rl.model_engine", "dlrover_tpu/rl/model_engine.py"),
    ("dlrover_tpu_torch.rl.hybrid_engine", "dlrover_tpu/rl/hybrid_engine.py"),
    ("dlrover_tpu_torch.rl.rollout", "dlrover_tpu/rl/rollout.py"),
    ("dlrover_tpu_torch.rl.trainer", "dlrover_tpu/rl/trainer.py"),
    ("dlrover_tpu_torch.rl.elastic.lease", "dlrover_tpu/rl/elastic/lease.py"),
    ("dlrover_tpu_torch.rl.elastic.adapter",
     "dlrover_tpu/rl/elastic/adapter.py"),
    ("dlrover_tpu_torch.rl.__init__", "dlrover_tpu/rl/"),
    ("dlrover_tpu_torch.rl.elastic.__init__", "dlrover_tpu/rl/elastic/"),
    ("dlrover_tpu_torch.examples.rlhf_ppo", "examples/rlhf_ppo.py"),
]


@pytest.mark.parametrize("module,reference", SLICE_7)
def test_the_modules_of_slice_7_are_checked_and_name_their_reference(
        module, reference):
    """The RL engine of slice 7 (and the twin of its example) is among
    the modules the tests above import and scan, each naming the
    reference it mirrors, which exists."""
    assert module in MODULES
    assert (ROOT / reference).exists()
    doc = ast.get_docstring(ast.parse(
        (ROOT / module.replace(".", os.sep)).with_suffix(".py").read_text()))
    assert reference in doc


SLICE_6 = [
    ("dlrover_tpu_torch.native.__init__", "dlrover_tpu/native/__init__.py"),
    ("dlrover_tpu_torch.ops.kv_variable", "dlrover_tpu/ops/kv_variable.py"),
    ("dlrover_tpu_torch.checkpoint.sparse",
     "dlrover_tpu/checkpoint/sparse.py"),
    ("dlrover_tpu_torch.checkpoint.shm_handler",
     "dlrover_tpu/checkpoint/shm_handler.py"),
    ("dlrover_tpu_torch.checkpoint.engine",
     "dlrover_tpu/checkpoint/engine.py"),
    ("dlrover_tpu_torch.models.deepfm", "dlrover_tpu/models/deepfm.py"),
    ("dlrover_tpu_torch.trainer.sparse_pipeline",
     "dlrover_tpu/trainer/sparse_pipeline.py"),
    ("dlrover_tpu_torch.chaos.scenarios", "dlrover_tpu/chaos/scenarios.py"),
    ("dlrover_tpu_torch.chaos.harness", "dlrover_tpu/chaos/harness.py"),
]


@pytest.mark.parametrize("module,reference", SLICE_6)
def test_the_modules_of_the_sparse_slice_are_checked_and_name_their_reference(
        module, reference):
    """KvVariable, the sparse adapter, the paged tier, DeepFM, the
    split-step pipeline and the sparse chaos set are among the modules
    the tests above import and scan, each naming the reference it
    mirrors, which exists; the C++ store is the reference's, byte for
    byte."""
    assert module in MODULES
    assert (ROOT / reference).exists()
    doc = ast.get_docstring(ast.parse(
        (ROOT / module.replace(".", os.sep)).with_suffix(".py").read_text()))
    assert reference in doc
    assert (PKG / "native" / "kv_store.cc").read_bytes() == \
        (ROOT / "dlrover_tpu" / "native" / "kv_store.cc").read_bytes()


SLICE_5_4_AND_8_3 = [
    ("dlrover_tpu_torch.models.bert", "dlrover_tpu/models/bert.py"),
    ("dlrover_tpu_torch.models.gpt", "dlrover_tpu/models/gpt.py"),
    ("dlrover_tpu_torch.utils.torch_compat",
     "dlrover_tpu/utils/torch_compat.py"),
    ("dlrover_tpu_torch.utils.timer", "dlrover_tpu/utils/timer.py"),
    ("dlrover_tpu_torch.utils.numeric_checker",
     "dlrover_tpu/utils/numeric_checker.py"),
    ("dlrover_tpu_torch.utils.mup", "dlrover_tpu/utils/mup.py"),
    ("dlrover_tpu_torch.utils.profiler", "dlrover_tpu/utils/profiler.py"),
    ("dlrover_tpu_torch.utils.__init__", "dlrover_tpu/utils/"),
    ("dlrover_tpu_torch.trainer.starter", "dlrover_tpu/trainer/starter.py"),
    ("dlrover_tpu_torch.common.storage", "dlrover_tpu/common/storage.py"),
]


@pytest.mark.parametrize("module,reference", SLICE_5_4_AND_8_3)
def test_the_modules_of_slices_5_4_and_8_3_are_checked_and_name_their_reference(
        module, reference):
    """BERT and GPT's save_attn (slice 5.4), the utilities, the HF
    bridge, the starter and the object-store storage (slice 8.3) are
    among the modules the tests above import and scan, each naming the
    reference it mirrors, which exists."""
    assert module in MODULES
    assert (ROOT / reference).exists()
    doc = ast.get_docstring(ast.parse(
        (ROOT / module.replace(".", os.sep)).with_suffix(".py").read_text()))
    assert reference in doc


def test_the_starter_loads_no_torch():
    """The platform starter runs the launcher in its own process, which
    never touches the card: it loads no torch (fsspec, which the card
    machines lack, is held to the same by
    ``tests/test_torch_fsspec_storage.py``)."""
    code = (
        "import json, sys\n"
        "import dlrover_tpu_torch.trainer.starter\n"
        "print(json.dumps(sorted(sys.modules)))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env,
        capture_output=True, text=True, check=True,
    ).stdout
    loaded = json.loads(out.strip().splitlines()[-1])
    assert "dlrover_tpu_torch.trainer.starter" in loaded
    assert [m for m in loaded if m == "torch" or m.startswith("torch.")] == []


def test_the_elastic_example_is_checked_and_names_its_reference():
    """The twin of ``examples/train_gpt_elastic.py`` is among the
    scanned modules and names the reference example."""
    module = "dlrover_tpu_torch.examples.train_gpt_elastic"
    assert module in MODULES
    assert (ROOT / "examples" / "train_gpt_elastic.py").exists()
    doc = ast.get_docstring(ast.parse(
        (ROOT / module.replace(".", os.sep)).with_suffix(".py").read_text()))
    assert "examples/train_gpt_elastic.py" in doc


def test_the_master_loads_no_torch():
    """The master has no device work: its import closure, and its
    client's, loads no torch, so it cannot make a CUDA context that
    would take memory on the training card."""
    code = (
        "import json, sys\n"
        "import dlrover_tpu_torch.master.main\n"
        "import dlrover_tpu_torch.agent.master_client\n"
        "print(json.dumps(sorted(sys.modules)))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env,
        capture_output=True, text=True, check=True,
    ).stdout
    loaded = json.loads(out.strip().splitlines()[-1])
    assert "dlrover_tpu_torch.master.master" in loaded
    assert [m for m in loaded if m == "torch" or m.startswith("torch.")] == []


def test_the_launcher_and_the_agent_load_no_torch():
    """The launcher, the agent, its saver and the chaos harness run in
    a process that never touches the card; a CUDA build of torch maps
    the CUDA driver's library at import, so that process loads no
    torch at all (the worker does)."""
    code = (
        "import json, sys\n"
        "import dlrover_tpu_torch.run\n"
        "import dlrover_tpu_torch.agent.training\n"
        "import dlrover_tpu_torch.agent.forkserver\n"
        "import dlrover_tpu_torch.checkpoint.saver\n"
        "import dlrover_tpu_torch.chaos.harness\n"
        "import dlrover_tpu_torch.chaos.__main__\n"
        "from dlrover_tpu_torch.checkpoint import AsyncCheckpointSaver\n"
        "print(json.dumps(sorted(sys.modules)))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env,
        capture_output=True, text=True, check=True,
    ).stdout
    loaded = json.loads(out.strip().splitlines()[-1])
    assert "dlrover_tpu_torch.agent.training" in loaded
    assert [m for m in loaded if m == "torch" or m.startswith("torch.")] == []


SLICE_9_1 = [
    ("dlrover_tpu_torch.serving.__init__", "dlrover_tpu/serving/__init__.py"),
    ("dlrover_tpu_torch.serving.__main__", "dlrover_tpu/serving/__main__.py"),
    ("dlrover_tpu_torch.serving.messages", "dlrover_tpu/serving/messages.py"),
    ("dlrover_tpu_torch.serving.publisher",
     "dlrover_tpu/serving/publisher.py"),
    ("dlrover_tpu_torch.serving.replica", "dlrover_tpu/serving/replica.py"),
    ("dlrover_tpu_torch.serving.pool", "dlrover_tpu/serving/pool.py"),
    ("dlrover_tpu_torch.serving.router", "dlrover_tpu/serving/router.py"),
    ("dlrover_tpu_torch.fleet.__init__", "dlrover_tpu/fleet/"),
    ("dlrover_tpu_torch.fleet.lookup_load",
     "dlrover_tpu/fleet/lookup_load.py"),
    ("dlrover_tpu_torch.brain.__init__", "dlrover_tpu/brain/__init__.py"),
    ("dlrover_tpu_torch.brain.service", "dlrover_tpu/brain/service.py"),
    ("dlrover_tpu_torch.brain.datastore", "dlrover_tpu/brain/datastore.py"),
    ("dlrover_tpu_torch.brain.optimizer_chain",
     "dlrover_tpu/brain/optimizer_chain.py"),
    ("dlrover_tpu_torch.brain.cluster_monitor",
     "dlrover_tpu/brain/cluster_monitor.py"),
    ("dlrover_tpu_torch.telemetry.schema", "dlrover_tpu/telemetry/schema.py"),
    ("dlrover_tpu_torch.telemetry.check_events",
     "dlrover_tpu/telemetry/check_events.py"),
    ("dlrover_tpu_torch.telemetry.lint_events",
     "dlrover_tpu/telemetry/lint_events.py"),
]


@pytest.mark.parametrize("module,reference", SLICE_9_1)
def test_the_modules_of_slice_9_1_are_checked_and_name_their_reference(
        module, reference):
    """The serving plane, the lookup load, the Brain's service,
    datastore, optimizer chain and cluster monitor and the event schema
    with its checkers (slice 9.1), the ``__main__`` entry points
    included, are among the modules the subprocess import check and the
    AST scan above cover, each naming the reference it mirrors, which
    exists."""
    assert module in MODULES
    assert (ROOT / reference).exists()
    doc = ast.get_docstring(ast.parse(
        (ROOT / module.replace(".", os.sep)).with_suffix(".py").read_text()))
    assert reference in doc


STEP_CACHES_AND_PLANES = [
    ("dlrover_tpu_torch.common.compile_cache",
     "dlrover_tpu/common/compile_cache.py"),
    ("dlrover_tpu_torch.common.aot_cache", "dlrover_tpu/common/aot_cache.py"),
    ("dlrover_tpu_torch.fleet.synthetic_agent",
     "dlrover_tpu/fleet/synthetic_agent.py"),
    ("dlrover_tpu_torch.fleet.scoreboard", "dlrover_tpu/fleet/scoreboard.py"),
    ("dlrover_tpu_torch.fleet.runner", "dlrover_tpu/fleet/runner.py"),
    ("dlrover_tpu_torch.fleet.agent_pack", "dlrover_tpu/fleet/agent_pack.py"),
    ("dlrover_tpu_torch.fleet.__init__", "dlrover_tpu/fleet/__init__.py"),
    ("dlrover_tpu_torch.operator.__init__",
     "dlrover_tpu/operator/__init__.py"),
    ("dlrover_tpu_torch.operator.reconciler",
     "dlrover_tpu/operator/reconciler.py"),
    ("dlrover_tpu_torch.scheduler.ray_backend",
     "dlrover_tpu/scheduler/ray_backend.py"),
]


@pytest.mark.parametrize("module,reference", STEP_CACHES_AND_PLANES)
def test_the_modules_of_slices_8_2_and_9_2_are_checked_and_name_their_reference(
        module, reference):
    """The step caches (slice 8.2) and the rest of the planes (slice
    9.2: the fleet harness, the operator, the Ray backend) are among the
    modules the subprocess import check and the AST scan above cover,
    each naming the reference it mirrors, which exists."""
    assert module in MODULES
    assert (ROOT / reference).exists()
    doc = ast.get_docstring(ast.parse(
        (ROOT / module.replace(".", os.sep)).with_suffix(".py").read_text()))
    assert reference in doc


def test_the_host_planes_load_no_torch():
    """The fleet harness, the operator and the Ray backend are host
    code, as in the reference: their import closure loads no torch, so
    a fleet's master and agents map no CUDA library on a card
    machine."""
    code = (
        "import json, sys\n"
        "import dlrover_tpu_torch.fleet.runner\n"
        "import dlrover_tpu_torch.fleet.agent_pack\n"
        "import dlrover_tpu_torch.operator\n"
        "import dlrover_tpu_torch.scheduler.ray_backend\n"
        "print(json.dumps(sorted(sys.modules)))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env,
        capture_output=True, text=True, check=True,
    ).stdout
    loaded = json.loads(out.strip().splitlines()[-1])
    assert [m for m in loaded if m == "torch" or m.startswith("torch.")] == []
    assert "ray" not in loaded


def test_the_serving_processes_load_no_torch():
    """The replica, the router, the pool and the lookup load run on the
    host, as the reference's do: their import closure loads no torch,
    so they cannot map a CUDA library on a card machine."""
    code = (
        "import json, sys\n"
        "import dlrover_tpu_torch.serving.__main__\n"
        "import dlrover_tpu_torch.serving.router\n"
        "import dlrover_tpu_torch.serving.pool\n"
        "import dlrover_tpu_torch.fleet.lookup_load\n"
        "import dlrover_tpu_torch.brain.cluster_monitor\n"
        "print(json.dumps(sorted(sys.modules)))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env,
        capture_output=True, text=True, check=True,
    ).stdout
    loaded = json.loads(out.strip().splitlines()[-1])
    assert "dlrover_tpu_torch.serving.replica" in loaded
    assert [m for m in loaded if m == "torch" or m.startswith("torch.")] == []


# written into a directory on the spawned processes' PYTHONPATH: at a
# normal exit each process records its command line and its modules
_PROBE = r'''
import atexit, json, os, sys

def _dump():
    out = os.environ.get("DLROVER_TEST_MODULES_DIR")
    if not out:
        return
    with open("/proc/self/cmdline", "rb") as f:
        cmd = [a.decode() for a in f.read().split(b"\0") if a]
    with open(os.path.join(out, f"{os.getpid()}.json"), "w") as f:
        spec = getattr(sys.modules.get("__main__"), "__spec__", None)
        json.dump({"cmd": cmd, "main": getattr(spec, "name", ""),
                   "modules": sorted(sys.modules)}, f)

atexit.register(_dump)
'''


def test_spawned_replicas_and_router_run_the_port(tmp_path, monkeypatch):
    """A ``ReplicaPool`` replica and the router, started by the port's
    serving-fleet runner, run the port's modules: their command lines
    name ``dlrover_tpu_torch`` and neither holds ``jax``, torch or any
    ``dlrover_tpu.`` module in ``sys.modules`` (where both packages are
    importable, a pool that spawned ``-m dlrover_tpu.serving`` would
    quietly serve from the JAX package)."""
    from dlrover_tpu_torch.chaos import harness
    from dlrover_tpu_torch.chaos.schedule import Scenario

    probe = tmp_path / "probe"
    probe.mkdir()
    (probe / "sitecustomize.py").write_text(_PROBE)
    out = tmp_path / "modules"
    out.mkdir()
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        p for p in (str(probe), os.environ.get("PYTHONPATH", "")) if p))
    monkeypatch.setenv("DLROVER_TEST_MODULES_DIR", str(out))
    report = harness.run_serving_fleet_scenario(
        Scenario.from_dict({"name": "spawn-probe", "seed": 3,
                            "rules": []}),
        workdir=str(tmp_path / "run"), pool_size=1, generations=2,
        publish_every_s=0.1, load_streams=1, invariants=[],
    )
    assert report.rc == 0
    dumps = [json.loads(p.read_text()) for p in out.glob("*.json")]
    roles = {}
    for d in dumps:
        assert "-m" in d["cmd"], d["cmd"]
        target = d["cmd"][d["cmd"].index("-m") + 1]
        assert d["main"] in (target, target + ".__main__"), d["main"]
        roles[target] = d["modules"]
    assert set(roles) == {"dlrover_tpu_torch.serving",
                          "dlrover_tpu_torch.serving.router"}
    assert "dlrover_tpu_torch.serving.replica" in \
        roles["dlrover_tpu_torch.serving"]
    assert "dlrover_tpu_torch.serving.messages" in \
        roles["dlrover_tpu_torch.serving.router"]
    for mods in roles.values():
        assert [m for m in mods if _forbidden(m)] == []
        assert [m for m in mods
                if m == "torch" or m.startswith("torch.")] == []
