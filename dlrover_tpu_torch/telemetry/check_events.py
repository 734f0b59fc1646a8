"""Static + log checker for the training-event schema registry.

Copy of ``dlrover_tpu/telemetry/check_events.py`` (the port imports nothing of the JAX
package).

Two passes, both against :mod:`dlrover_tpu_torch.telemetry.schema`:

1. **Call sites** — walk the package's Python sources (AST, no
   imports) for ``emit_event("type", field=...)`` calls and verify
   every literal event type is registered and its literal keyword
   fields match the registry (unregistered type, field drift, missing
   required fields).  Calls whose type is not a string literal are
   reported too: a dynamic type can never be schema-checked.
2. **Recorded logs** — every event in the given JSONL files must be a
   registered type carrying its required fields.

Wired as a tier-1 test so new instrumentation cannot silently fork
the schema::

    python -m dlrover_tpu_torch.telemetry.check_events            # call sites
    python -m dlrover_tpu_torch.telemetry.check_events events.jsonl  # + logs
"""

import ast
import os
import sys
from typing import Iterable, List, Optional

from dlrover_tpu_torch.telemetry import schema as _schema
from dlrover_tpu_torch.telemetry.events import read_events

# the definition site and re-export wrappers, not emission sites
_SKIP_FILES = ("telemetry/events.py",)


def _is_emit_event(node: ast.Call) -> bool:
    fn = node.func
    if isinstance(fn, ast.Name):
        return fn.id == "emit_event"
    if isinstance(fn, ast.Attribute):
        return fn.attr == "emit_event"
    return False


def check_source(path: str, rel: str = "") -> List[str]:
    """Schema problems in one Python source file."""
    rel = rel or path
    try:
        with open(path, "rb") as f:
            tree = ast.parse(f.read(), filename=path)
    except (OSError, SyntaxError) as e:
        return [f"cannot scan {rel}: {e}"]
    problems: List[str] = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call) or not _is_emit_event(node):
            continue
        where = f"{rel}:{node.lineno}"
        if not node.args:
            problems.append(f"emit_event with no type{f' at {where}'}")
            continue
        first = node.args[0]
        if not (
            isinstance(first, ast.Constant)
            and isinstance(first.value, str)
        ):
            problems.append(
                f"emit_event with non-literal type at {where} "
                "(cannot be schema-checked)"
            )
            continue
        literal_kwargs = [
            kw.arg for kw in node.keywords if kw.arg is not None
        ]
        has_dynamic = any(kw.arg is None for kw in node.keywords)
        problems.extend(
            _schema.validate_call(
                first.value, literal_kwargs,
                has_dynamic=has_dynamic, where=where,
            )
        )
    return problems


def check_call_sites(package_dir: Optional[str] = None) -> List[str]:
    """Scan every ``.py`` under the dlrover_tpu_torch package (default) for
    emit_event schema violations."""
    if package_dir is None:
        import dlrover_tpu_torch

        package_dir = os.path.dirname(dlrover_tpu_torch.__file__)
    root = os.path.dirname(package_dir.rstrip(os.sep))
    problems: List[str] = []
    for dirpath, dirnames, filenames in os.walk(package_dir):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for name in sorted(filenames):
            if not name.endswith(".py"):
                continue
            path = os.path.join(dirpath, name)
            rel = os.path.relpath(path, root)
            if rel.replace(os.sep, "/").endswith(_SKIP_FILES):
                continue
            problems.extend(check_source(path, rel=rel))
    return problems


def check_logs(paths: Iterable[str]) -> List[str]:
    """Schema problems in recorded event logs (deduplicated: one
    report per distinct problem, not per line)."""
    problems: List[str] = []
    seen = set()
    for path in paths:
        try:
            for i, event in enumerate(read_events(path)):
                for p in _schema.validate_event(event):
                    key = (path, p)
                    if key not in seen:
                        seen.add(key)
                        problems.append(f"{path} (line ~{i + 1}): {p}")
        except OSError as e:
            problems.append(f"cannot read {path}: {e}")
    return problems


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(
        description="Check emit_event call sites and recorded event "
        "logs against the event-schema registry",
    )
    parser.add_argument(
        "logs", nargs="*",
        help="JSONL event logs to validate (call sites are always "
        "scanned)",
    )
    parser.add_argument(
        "--package", default=None,
        help="package directory to scan (default: dlrover_tpu_torch)",
    )
    args = parser.parse_args(argv)
    problems = check_call_sites(args.package)
    problems += check_logs(args.logs)
    for p in problems:
        print(f"SCHEMA: {p}")
    if problems:
        print(f"{len(problems)} schema problem(s)")
        return 1
    print(
        f"event schema OK ({len(_schema.EVENT_SCHEMAS)} registered "
        "types)"
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
