"""No module the benchmark runs imports JAX or the JAX package, and the
plain reference imports nothing of the program: compared by whole top-level
module name, since ``glimpse_tpu_torch`` begins with ``glimpse_tpu``."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "glimpse_tpu"}
RUN = sorted(p for p in ROOT.rglob("*.py") if "tests" not in p.relative_to(ROOT).parts)


def imported(path: Path) -> set:
    """Top-level names of every module a file imports, at any depth of its code."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(alias.name.split(".", 1)[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".", 1)[0])
    return names


def test_the_walk_finds_the_benchmark():
    found = {p.relative_to(ROOT).as_posix() for p in RUN}
    assert {"run.py", "harness.py", "reference/filter.py", "scenes/nadir.py", "metrics/_reader.py"} <= found


@pytest.mark.parametrize("path", RUN, ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_module_imports_jax(path):
    assert not imported(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((ROOT / "reference").glob("*.py")), ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    names = imported(path)
    assert "glimpse_tpu_torch" not in names and "portbench" not in names, names


def test_a_run_loads_neither_jax_nor_the_jax_package():
    """A whole run on the CPU at a small size, in a process of its own: no
    forbidden module is loaded at its end, and loading the reference alone
    loads nothing of the program."""
    script = f"""
import sys
sys.path.insert(0, {str(ROOT.parent)!r})
import portbench.reference.filter, portbench.reference.compare
assert not [m for m in sys.modules if m.split(".", 1)[0] == "glimpse_tpu_torch"]
from portbench import harness
from portbench.tests.conftest import small
result = harness.run("columbia-2obs.north-star", 3, 0.0, False, "cpu", overrides=small("columbia-2obs.north-star"))
assert result["correct"], result
found = [m for m in sys.modules if m.split(".", 1)[0] in {sorted(FORBIDDEN)!r}]
assert not found, found
assert "glimpse_tpu_torch" in sys.modules
print("ok")
"""
    done = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True, timeout=300)
    assert done.returncode == 0 and done.stdout.strip().endswith("ok"), done.stderr[-3000:]
