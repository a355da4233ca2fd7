"""Shared fixtures of the benchmark's own tests.  They run on the CPU at the
smoke sizes of ``data/`` (the program's smoke widths, two layers); the tests
marked ``gpu`` need a CUDA card and skip without one.

    PYTHONPATH=src python -m pytest portbench/tests
"""
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

DATA = Path(__file__).resolve().parent / "data"


@pytest.fixture
def bench_dir(tmp_path):
    """A copy of the smoke cells (``data/``) beside the real metric
    readers: a root with its ``BENCHMARK.json`` and the folders the
    harness looks in."""
    shutil.copytree(DATA, tmp_path, dirs_exist_ok=True)
    shutil.copytree(ROOT / "portbench" / "metrics", tmp_path / "metrics")
    return tmp_path


@pytest.fixture
def cuda():
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
