"""Nothing under hebench/ imports JAX or the JAX package, and the plain
reference imports nothing of the program: top-level module names compared
whole (the program's name begins with the JAX package's)."""

import ast
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "hehub_tpu"}


def top_names(path: Path):
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_no_jax_anywhere():
    files = sorted(BENCH.rglob("*.py"))
    assert len(files) > 20
    for f in files:
        assert not top_names(f) & FORBIDDEN, f


def test_reference_imports_nothing_of_the_program():
    for f in (BENCH / "reference").rglob("*.py"):
        names = top_names(f)
        assert "hehub_tpu_torch" not in names and not names & FORBIDDEN, f
        assert names <= {"__future__", "math", "typing", "numpy", "torch"}, (f, names)


def test_the_checker_compares_whole_names():
    from hebench import harness

    assert "hehub_tpu_torch".split(".")[0] not in harness.FORBIDDEN
    assert "hehub_tpu" in harness.FORBIDDEN
