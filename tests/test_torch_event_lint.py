"""Twins of ``tests/test_event_lint.py`` for the port's event-schema
lint and checker (``dlrover_tpu_torch/telemetry/{schema,lint_events,
check_events}.py``): every statically visible ``emit_event(...)`` /
``.emit(...)`` type in the port's package, the train scripts embedded as
strings included, is registered, and every registered type has an
emitting call site.  Running it over the real package is the gate.

The port's registry is the reference's plus what the port alone emits
(``process_group``, and the probe fields of ``node_check``); the cases
that lint a synthetic package run both packages' linters and hold the
port's findings equal to the JAX package's.
"""

import textwrap

import pytest

from dlrover_tpu.telemetry import lint_events as j_lint
from dlrover_tpu.telemetry import schema as j_schema
from dlrover_tpu_torch.telemetry import check_events, lint_events
from dlrover_tpu_torch.telemetry.schema import EVENT_SCHEMAS


def test_package_emit_surface_matches_schema():
    problems = lint_events.lint()
    assert problems == [], "\n".join(problems)


def test_package_call_sites_match_schema_fields():
    """The field half: every literal ``emit_event`` call of the port
    names only registered fields and all required ones."""
    problems = check_events.check_call_sites()
    assert problems == [], "\n".join(problems)
    assert check_events.main([]) == 0


def test_the_port_registry_extends_the_reference():
    """Every reference type is registered alike; the port adds
    ``process_group`` and widens ``node_check`` (its probes),
    ``compile_cache`` (``build_s``, the nvcc seconds) and ``aot_cache``
    (the entry's kernel libraries) by optional fields only."""
    extra = set(EVENT_SCHEMAS) - set(j_schema.EVENT_SCHEMAS)
    assert extra == {"process_group"}
    for name, ref in j_schema.EVENT_SCHEMAS.items():
        port = EVENT_SCHEMAS[name]
        assert port.required == ref.required, name
        assert port.allow_extra == ref.allow_extra, name
        assert port.optional >= ref.optional, name
        if name == "compile_cache":
            assert port.optional - ref.optional == {"build_s"}
        elif name == "aot_cache":
            assert port.optional - ref.optional == {
                "libraries", "libraries_preloaded"}
        elif name != "node_check":
            assert port.optional == ref.optional, name


def _both_lint(tmp_path, fn):
    return fn(lint_events), fn(j_lint)


def test_unregistered_emit_is_reported(tmp_path):
    (tmp_path / "mod.py").write_text(textwrap.dedent("""
        from dlrover_tpu_torch.telemetry.events import emit_event

        def f():
            emit_event("totally_unregistered_event", foo=1)
    """))
    port, ref = _both_lint(tmp_path, lambda m: m.lint(str(tmp_path)))
    assert any(
        "totally_unregistered_event" in p and "not registered" in p
        for p in port
    ), port
    assert [p for p in port if "totally" in p] == [
        p for p in ref if "totally" in p]


def test_dead_schema_entries_are_reported(tmp_path):
    (tmp_path / "mod.py").write_text("x = 1\n")
    problems = lint_events.lint(str(tmp_path))
    dead = [p for p in problems if "no emitting call site" in p]
    assert any("'train_step'" in p for p in dead), problems
    assert len(dead) >= len(EVENT_SCHEMAS) - len(
        lint_events.ALLOWED_UNEMITTED
    )


@pytest.mark.parametrize("which", ["port", "reference"])
def test_embedded_script_strings_are_linted(tmp_path, which):
    mod = lint_events if which == "port" else j_lint
    script = "\n".join(
        ["from dlrover_tpu_torch.telemetry.events import emit_event"]
        + ["# padding line to cross the embedded-script floor"] * 8
        + ["emit_event(\"my_embedded_event\", step=1)"]
    )
    (tmp_path / "mod.py").write_text(f"TRAIN_SCRIPT = {script!r}\n")
    emitted = mod.collect_emitted_types(str(tmp_path))
    assert "my_embedded_event" in emitted
    assert "<embedded>" in emitted["my_embedded_event"][0]


def test_exporter_style_emit_is_collected(tmp_path):
    (tmp_path / "mod.py").write_text(textwrap.dedent("""
        def f(exporter):
            exporter.emit("exporter_style_event", path="p")
    """))
    port, ref = _both_lint(
        tmp_path, lambda m: m.collect_emitted_types(str(tmp_path)))
    assert "exporter_style_event" in port
    assert port == ref


def test_unparseable_source_is_a_problem(tmp_path):
    (tmp_path / "broken.py").write_text("def f(:\n")
    port, ref = _both_lint(tmp_path, lambda m: m.lint(str(tmp_path)))
    assert any("unparseable" in p for p in port), port
    assert [p for p in port if "unparseable" in p] == [
        p for p in ref if "unparseable" in p]
