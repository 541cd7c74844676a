"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the program."""

import ast
from pathlib import Path

import run

BENCH = Path(run.__file__).resolve().parent
FORBIDDEN = {"jax", "jaxlib", "flax", "ephemeris_explorer_tpu"}
PORT = "ephemeris_explorer_tpu_torch"


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module.split(".")[0])
    return out


def test_whole_names_are_compared():
    assert run.forbidden_loaded(["ephemeris_explorer_tpu_torch.spacecraft", "torch"]) == []
    assert run.forbidden_loaded(["ephemeris_explorer_tpu.ops", "jaxlib.xla"]) == [
        "ephemeris_explorer_tpu", "jaxlib"]
    assert run.forbidden_loaded(["jaxtyping", "flax_like"]) == []


def test_no_source_imports_jax():
    for path in BENCH.rglob("*.py"):
        assert not (_imports(path) & FORBIDDEN), path


def test_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").glob("*.py"):
        assert PORT not in _imports(path), path
        assert "harness" not in _imports(path), path
