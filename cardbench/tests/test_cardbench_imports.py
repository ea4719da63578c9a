"""No module of the benchmark imports JAX or the JAX package (compared by
whole top-level names: the port's name begins with the JAX package's),
and the reference imports nothing of the program."""
import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "benchmarks"}
# the reference and what it imports: the yardstick of `correct`
YARDSTICK = ("reference.py", "datasets.py")


def _top_level_imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


MODULES = sorted(HERE.rglob("*.py"))


@pytest.mark.parametrize("path", MODULES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_and_no_jax_package(path):
    assert not _top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("name", YARDSTICK)
def test_the_reference_imports_nothing_of_the_program(name):
    assert "repro_torch" not in _top_level_imports(HERE / name)


def test_the_scan_sees_the_port_as_its_own_name():
    src = "import repro_torch.api\nfrom repro.core import x\nimport jaxlib\n"
    tree_names = set()
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Import):
            tree_names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            tree_names.add(node.module.split(".")[0])
    assert tree_names & FORBIDDEN == {"repro", "jaxlib"}
