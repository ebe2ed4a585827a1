"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the program under test. Top-level module
names (the part before the first dot) are compared whole: the port's name
``jwave_tpu_torch`` begins with the JAX package's ``jwave_tpu``."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark import harness

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
MODULES = sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts)


def _top_level_imports(path: Path) -> set[str]:
    """Top-level names of the absolute imports of a module; a relative
    import stays inside ``benchmark``."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            names.add("benchmark" if node.level else node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", MODULES, ids=[str(p.relative_to(BENCH)) for p in MODULES])
def test_no_module_imports_jax_or_the_jax_package(path):
    assert harness.forbidden(_top_level_imports(path)) == []


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    names = _top_level_imports(path)
    assert "jwave_tpu_torch" not in names
    assert names <= {"__future__", "math", "typing", "torch", "benchmark"}


def test_names_are_compared_whole():
    assert harness.forbidden(["jwave_tpu_torch", "jwave_tpu_torch.ops", "jaxtyping"]) == []
    assert harness.forbidden(["jwave_tpu.ops", "jax.numpy", "flax", "jaxlib"]) == [
        "flax", "jax", "jaxlib", "jwave_tpu"]


def test_a_run_loads_no_jax_module():
    """Import every module a run loads, the program with it, in a fresh
    process, and look at what it holds."""
    code = (
        "import sys, importlib, pathlib\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "import jwave_tpu_torch\n"
        "from benchmark import harness, control, run\n"
        f"for p in sorted(pathlib.Path({str(BENCH)!r}).glob('*/*.py')):\n"
        "    if p.parent.name in ('entries', 'reference'):\n"
        "        importlib.import_module(f'benchmark.{p.parent.name}.{p.stem}')\n"
        "for kind, folder in (('end_to_end', 'end_to_end'), ('per_layer', 'metrics')):\n"
        f"    for p in sorted(pathlib.Path({str(BENCH)!r}, folder).glob('*.py')):\n"
        "        if p.stem != '__init__':\n"
        "            harness.load_reader(kind, p.stem)\n"
        "print(harness.forbidden(sys.modules))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
