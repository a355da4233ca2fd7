"""The port's store, recovery and drift benchmarks against the reference's
(``benchmarks/torch_store_cache.py``, ``torch_recovery_bench.py``,
``torch_adaptive_drift.py``), each ``--smoke`` with the crawl assets'
tensor work on the CPU (``--device cpu``), each beside the reference's
smoke in a child process, all six at once.

* Every field equals the reference's but the walls (the host's clock)
  and what the threads' timing decides: cache hits, executed tasks and
  their names, plan counts, spend, kill points, attempts, makespans and
  every ``checks`` boolean.  What a crash finds in flight (the recovery
  benchmark's frontier, relaunched and rework tasks) depends on the
  threads' timing in either package (at the 50 % kill, 2 rework tasks in
  one run of the twin and 1 in the next on a CPU); so do the drift
  benchmark's drifted levels, whose closed loop replans on the host's
  clock (``mild``: its static arm ran 20 attempts alone and 21 beside four
  other benchmarks; ``severe``: a makespan reduction of 0.8119 in one run
  of the reference beside the whole test suite, 0.816 in every other), so
  there only their drift parameters and the ``checks`` booleans are held;
  the ``none`` level is held whole.
* The unchanged ``check_{store,recovery,adaptive}_regression.py`` gates
  pass on each twin's output against its
  ``benchmarks/baselines/torch_*_baseline.json``.  Their floors are
  ratios within one run (warm over cold, journaled over plain, closed over
  static), far from a CPU's values.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
BENCHES = {  # twin: (reference, gate, baseline)
    "torch_store_cache": ("store_cache", "store", "torch_store_cache"),
    "torch_recovery_bench": ("recovery_bench", "recovery", "torch_recovery"),
    "torch_adaptive_drift": ("adaptive_drift", "adaptive",
                             "torch_adaptive_drift"),
}
#: keys whose values are the host's clock or the threads' timing
TIMED = ("wall_s", "warm_speedup", "resume_s", "plain_s", "journaled_s",
         "overhead_frac", "frontier_tasks", "relaunched_tasks",
         "rework_tasks", "rework_fraction")


def _untimed(tree, skip=()):
    if isinstance(tree, dict):
        return {k: _untimed(v, skip) for k, v in tree.items()
                if k not in TIMED and k not in skip}
    return tree


@pytest.fixture(scope="module")
def smokes(tmp_path_factory):
    """{twin: (its output, the reference's, its output's path)}."""
    d = tmp_path_factory.mktemp("bench_store")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT)]))
    procs = {}
    for twin, (ref, _, _) in BENCHES.items():
        for name, extra in ((twin, ["--device", "cpu"]), (ref, [])):
            procs[name] = subprocess.Popen(
                [sys.executable, str(ROOT / "benchmarks" / f"{name}.py"),
                 "--smoke", "--out", str(d / f"{name}.json"), *extra],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                env=env, cwd=ROOT)
    for name, p in procs.items():
        _, err = p.communicate(timeout=600)
        assert p.returncode == 0, f"{name}: {err[-2000:]}"
    return {twin: (json.loads((d / f"{twin}.json").read_text()),
                   json.loads((d / f"{ref}.json").read_text()),
                   d / f"{twin}.json")
            for twin, (ref, _, _) in BENCHES.items()}


def test_store_cache_smoke_equals_the_reference(smokes):
    got, want, _ = smokes["torch_store_cache"]
    assert _untimed(got) == _untimed(want)
    assert got["warm"]["tasks_executed"] == 0
    assert got["cutoff"]["executed"] == [
        f"nodes[{got['config']['target_partition']}]"]
    assert all(got["checks"].values()), got["checks"]


def test_recovery_smoke_equals_the_reference(smokes):
    got, want, _ = smokes["torch_recovery_bench"]
    assert _untimed(got) == _untimed(want)
    assert sorted(got["kills"]) == ["kill_25", "kill_50", "kill_75"]
    assert all(got["checks"].values()), got["checks"]


def test_adaptive_drift_smoke_equals_the_reference(smokes):
    got, want, _ = smokes["torch_adaptive_drift"]
    drifted = ("mild", "severe")
    assert _untimed(got, skip=drifted) == _untimed(want, skip=drifted)
    assert sorted(got["levels"]) == ["mild", "none", "severe"]
    for level in drifted:
        assert got["levels"][level]["drift"] == want["levels"][level]["drift"]
    assert all(got["checks"].values()), got["checks"]


@pytest.mark.parametrize("twin", list(BENCHES))
def test_gate_passes_on_the_twin(smokes, twin):
    _, gate, baseline = BENCHES[twin]
    r = subprocess.run(
        [sys.executable,
         str(ROOT / "benchmarks" / f"check_{gate}_regression.py"),
         "--current", str(smokes[twin][2]), "--baseline",
         str(ROOT / "benchmarks" / "baselines" / f"{baseline}_baseline.json")],
        capture_output=True, text=True, timeout=60, cwd=ROOT)
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.strip().splitlines()[-1].startswith("OK")


@pytest.mark.parametrize("twin", list(BENCHES))
def test_twin_takes_the_card_unless_asked(twin):
    """``--device`` defaults to ``cuda``, as ``torch_cc_pipeline`` does: no
    quiet switch to the CPU."""
    r = subprocess.run([sys.executable,
                        str(ROOT / "benchmarks" / f"{twin}.py"), "--help"],
                       capture_output=True, text=True, timeout=120,
                       env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
                       cwd=ROOT)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "--device" in r.stdout
    src = (ROOT / "benchmarks" / f"{twin}.py").read_text()
    assert 'ap.add_argument("--device", default="cuda"' in src
