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
