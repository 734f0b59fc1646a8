"""Static event-schema lint.

Copy of ``dlrover_tpu/telemetry/lint_events.py`` (the port imports nothing of the JAX
package).

``check_events.check_call_sites`` validates the *fields* of literal
``emit_event(...)`` calls; this pass closes the remaining two holes
as pure static analysis over the package AST:

1. an event TYPE emitted anywhere (``emit_event("x", ...)`` or an
   exporter's ``.emit("x", ...)``) that is absent from
   ``schema.EVENT_SCHEMAS`` — it would be dropped by every consumer
   that validates;
2. a schema entry NO call site emits — dead registry weight that
   rots into documentation-of-nothing.

Some emitters live inside embedded train-script string constants
(the chaos scenarios ship whole trainer programs as strings), so any
sizeable string literal that both mentions ``emit_event(`` and parses
as Python is linted as source too.

CLI::

    python -m dlrover_tpu_torch.telemetry.lint_events
"""

import ast
import os
import sys
from typing import Dict, List, Optional, Tuple

from dlrover_tpu_torch.telemetry.schema import EVENT_SCHEMAS

# a string constant is considered an embedded script when it is at
# least this long and mentions an emit call — short docstrings that
# merely *talk about* emit_event don't parse as programs anyway, but
# the floor keeps the AST re-parse off every one-line literal
_EMBEDDED_MIN_LEN = 200

# schema entries intentionally without an in-package literal call
# site (emitted by external tooling / reserved for operators).  None in
# the port, as in the reference: every registered type has an emitter
ALLOWED_UNEMITTED: Tuple[str, ...] = ()


def _emit_name(node: ast.Call) -> Optional[str]:
    """The emitted event-type literal, for calls shaped like
    ``emit_event("x", ...)`` / ``something.emit("x", ...)``."""
    func = node.func
    name = ""
    if isinstance(func, ast.Name):
        name = func.id
    elif isinstance(func, ast.Attribute):
        name = func.attr
    if name not in ("emit_event", "emit"):
        return None
    if not node.args:
        return None
    first = node.args[0]
    if isinstance(first, ast.Constant) and isinstance(
        first.value, str
    ):
        return first.value
    return None


def _collect_from_tree(
    tree: ast.AST, rel: str, out: Dict[str, List[str]]
):
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            etype = _emit_name(node)
            if etype:
                out.setdefault(etype, []).append(
                    f"{rel}:{getattr(node, 'lineno', 0)}"
                )
        elif isinstance(node, ast.Constant) and isinstance(
            node.value, str
        ):
            text = node.value
            if (
                len(text) >= _EMBEDDED_MIN_LEN
                and "emit_event(" in text
            ):
                try:
                    subtree = ast.parse(text)
                except SyntaxError:
                    continue
                _collect_from_tree(
                    subtree,
                    f"{rel}:{getattr(node, 'lineno', 0)}<embedded>",
                    out,
                )


def collect_emitted_types(
    package_dir: Optional[str] = None,
) -> Dict[str, List[str]]:
    """Map every statically-visible emitted event type to the call
    sites (``relpath:line``) that emit it."""
    if package_dir is None:
        package_dir = os.path.dirname(os.path.dirname(__file__))
    emitted: Dict[str, List[str]] = {}
    for root, dirs, files in os.walk(package_dir):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        for fname in sorted(files):
            if not fname.endswith(".py"):
                continue
            path = os.path.join(root, fname)
            rel = os.path.relpath(path, package_dir)
            try:
                with open(path, "r", encoding="utf-8") as f:
                    tree = ast.parse(f.read(), filename=rel)
            except (OSError, SyntaxError) as exc:
                emitted.setdefault("<unparseable>", []).append(
                    f"{rel}: {exc}"
                )
                continue
            _collect_from_tree(tree, rel, emitted)
    return emitted


def lint(package_dir: Optional[str] = None) -> List[str]:
    """Problems (empty = the emit surface and the registry agree):
    unregistered emitted types, and registered types nothing emits."""
    emitted = collect_emitted_types(package_dir)
    problems: List[str] = []
    for rel in emitted.pop("<unparseable>", []):
        problems.append(f"unparseable source: {rel}")
    for etype in sorted(emitted):
        if etype not in EVENT_SCHEMAS:
            sites = ", ".join(emitted[etype][:3])
            problems.append(
                f"emitted type {etype!r} is not registered in "
                f"schema.EVENT_SCHEMAS ({sites})"
            )
    for etype in sorted(EVENT_SCHEMAS):
        if etype in emitted or etype in ALLOWED_UNEMITTED:
            continue
        problems.append(
            f"schema entry {etype!r} has no emitting call site "
            f"(dead registry entry?)"
        )
    return problems


def main(argv=None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    package_dir = args[0] if args else None
    problems = lint(package_dir)
    for p in problems:
        print(p)
    if problems:
        print(f"{len(problems)} problem(s)")
        return 1
    print("event emit surface and schema registry agree")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
