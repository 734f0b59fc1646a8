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
