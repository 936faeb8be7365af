"""The import guard: nothing under bench/ imports JAX or the JAX package
(top-level names compared whole, so ``repro_torch`` passes), and the
reference's files import nothing of the program."""
import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "benchmarks"}
# the reference and what it draws its data with
REFERENCE = ["reference.py", "loadgen.py", "stats.py", "operators/stencil.py"]


def _top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(HERE.rglob("*.py")), ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_or_jax_package(path):
    assert not _top_level_imports(path) & FORBIDDEN


def test_the_guard_compares_whole_names(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import repro_torch.plan\nfrom repro_torch import serve\nimport jax.numpy\n")
    assert _top_level_imports(f) & FORBIDDEN == {"jax"}


@pytest.mark.parametrize("name", REFERENCE)
def test_reference_takes_nothing_of_the_program(name):
    assert "repro_torch" not in _top_level_imports(HERE / name)
