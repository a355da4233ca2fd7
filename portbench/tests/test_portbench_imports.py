"""Nothing the card runs imports JAX or the JAX package (``repro``),
compared by whole top-level name (``repro_torch`` begins with ``repro``);
the reference imports nothing of the program either."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest

from conftest import ROOT

BENCH = ROOT / "portbench"
FILES = sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.parts)
BANNED = {"jax", "jaxlib", "flax", "repro"}


def _imports(path: Path) -> set[str]:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".")[0])
    return tops


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_jax_package_import(path):
    assert not _imports(path) & BANNED


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert _imports(path) <= {"__future__", "math", "torch", "portbench"}


def test_a_run_loads_no_jax(bench_dir):
    pytest.importorskip("torch")
    code = (f"import sys; sys.path[:0] = [{str(ROOT / 'src')!r}, {str(ROOT)!r}]\n"
            "from portbench import run\n"
            f"run.execute('granite-smoke.serve', 1, 0.01, False, device='cpu', "
            f"root=__import__('pathlib').Path({str(bench_dir)!r}), "
            f"base=__import__('pathlib').Path({str(bench_dir)!r}))\n"
            "print(run.banned_modules())\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip().splitlines()[-1] == "[]"
