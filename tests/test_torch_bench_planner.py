"""The port's planner benchmarks and roofline table against the reference's
(``benchmarks/torch_planner_vs_greedy.py``, ``torch_planner_scale.py``,
``torch_roofline.py``).

* ``torch_planner_vs_greedy.run(smoke=True)`` equals
  ``planner_vs_greedy.run(smoke=True)`` exactly (no tensor work, no clock).
* ``torch_planner_scale.py --smoke`` (sizes 100 and 1,000, the legacy
  planner included) equals the reference's smoke on every field but the
  plan times and the speedups derived from them, which are the host's; the
  two run side by side in child processes.  The unchanged
  ``check_planner_regression.py`` passes on the twin's output against
  ``benchmarks/baselines/torch_planner_scale_baseline.json``: its time
  check compares plan times normalized by the legacy planner's in the same
  run, so it holds across machines, and its quality booleans must hold.
* ``torch_roofline.run()`` over a directory of hand-made cells equals
  ``roofline.run()`` over the same cells with the meshes named as the
  reference names them (16x16, 2x16x16 for 32x8, 2x32x8).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from benchmarks import planner_scale as ref_scale
from benchmarks import planner_vs_greedy as ref_pvg
from benchmarks import roofline as ref_roofline
from benchmarks import torch_planner_scale as port_scale
from benchmarks import torch_planner_vs_greedy as port_pvg
from benchmarks import torch_roofline as port_roofline

ROOT = Path(__file__).resolve().parents[1]
#: keys whose values are the host's clock, not the planner's result
TIMED = ("plan_time_s", "speedup", "min_speedup", "speedup_at_largest",
         "geomean_speedup_at_largest")


def _untimed(tree):
    if isinstance(tree, dict):
        return {k: _untimed(v) for k, v in tree.items() if k not in TIMED}
    return tree


def _env() -> dict:
    return dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT)]))


def test_planner_vs_greedy_smoke_equals_the_reference():
    got, want = port_pvg.run(smoke=True), ref_pvg.run(smoke=True)
    assert got == want
    assert got["summary"]["n_dominates"] == got["summary"]["n_configs"] == 2


def test_planner_vs_greedy_cli_writes_its_own_file(tmp_path):
    r = subprocess.run([sys.executable,
                        str(ROOT / "benchmarks/torch_planner_vs_greedy.py"),
                        "--smoke"], capture_output=True, text=True,
                       timeout=300, env=_env(), cwd=tmp_path)
    assert r.returncode == 0, r.stderr[-2000:]
    assert [p.name for p in tmp_path.iterdir()] == \
        ["BENCH_torch_planner_vs_greedy_smoke.json"]
    got = json.loads((tmp_path / "BENCH_torch_planner_vs_greedy_smoke.json")
                     .read_text())
    assert got == json.loads(json.dumps(ref_pvg.run(smoke=True)))


@pytest.fixture(scope="module")
def scale_smokes(tmp_path_factory):
    """(twin's, reference's) ``--smoke`` outputs, run side by side."""
    d = tmp_path_factory.mktemp("planner_scale")
    procs = {name: subprocess.Popen(
        [sys.executable, str(ROOT / "benchmarks" / f"{name}.py"), "--smoke",
         "--out", str(d / f"{name}.json")], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=_env(), cwd=ROOT)
        for name in ("torch_planner_scale", "planner_scale")}
    for name, p in procs.items():
        _, err = p.communicate(timeout=600)
        assert p.returncode == 0, err[-2000:]
    return tuple(json.loads((d / f"{name}.json").read_text())
                 for name in procs) + (d / "torch_planner_scale.json",)


def test_planner_scale_smoke_equals_the_reference(scale_smokes):
    got, want, _ = scale_smokes
    assert got["smoke"] is True
    assert sorted(got["shapes"]) == sorted(port_scale.SHAPES)
    for shape in got["shapes"]:
        assert sorted(got["shapes"][shape]) == ["100", "1000"]
    assert _untimed(got) == _untimed(want)
    assert got["summary"]["all_cost_ok"] and got["summary"]["all_makespan_ok"]


def test_planner_scale_gate_passes_on_the_twin(scale_smokes):
    r = subprocess.run(
        [sys.executable, str(ROOT / "benchmarks/check_planner_regression.py"),
         "--current", str(scale_smokes[2]), "--baseline",
         str(ROOT / "benchmarks/baselines/torch_planner_scale_baseline.json")],
        capture_output=True, text=True, timeout=60, cwd=ROOT)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "4 shapes within" in r.stdout


@pytest.mark.parametrize("shape", list(ref_scale.SHAPES))
def test_legacy_planner_is_the_reference_yardstick(shape):
    """The twin keeps the PR-2 planner: on each 100-task shape its
    assignment and iteration count are the reference's."""
    graph, targets = port_scale.SHAPES[shape](100)
    factory = port_scale._factory()
    got, got_iters = port_scale._LegacyPlanner(graph, factory).plan(
        targets, factory.objective)
    ref_graph, ref_targets = ref_scale.SHAPES[shape](100)
    ref_factory = ref_scale._factory()
    want, want_iters = ref_scale._LegacyPlanner(ref_graph, ref_factory).plan(
        ref_targets, ref_factory.objective)
    assert got == want and got_iters == want_iters


def _cell(arch, shape, mesh, status="ok", **roof):
    c = {"arch": arch, "shape": shape, "mesh": mesh, "kind": "train",
         "status": status}
    if status == "ok":
        c.update({"roofline": {"t_compute_s": roof["c"], "t_memory_s": roof["m"],
                               "t_collective_s": roof["x"],
                               "bottleneck": roof["b"],
                               "step_time_s": max(roof["c"], roof["m"],
                                                  roof["x"]),
                               "model_flops_util": roof["mfu"],
                               "useful_flops_ratio": 0.91},
                  "model_flops": 1.5e18, "compile_s": 12.5})
    elif status == "skipped":
        c["reason"] = "full-attention arch: long_500k skipped per assignment"
    else:
        c["error"] = "RuntimeError: boom"
    return c


def test_roofline_twin_equals_the_reference(tmp_path, monkeypatch):
    names = {"32x8": "16x16", "2x32x8": "2x16x16"}
    cells = [
        _cell("gemma-2b", "train_4k", "32x8", c=0.088, m=0.004, x=0.064,
              b="compute", mfu=0.41),
        _cell("gemma-2b", "prefill_32k", "32x8", c=0.009, m=0.001, x=0.02,
              b="collective", mfu=0.2),
        _cell("gemma-2b", "long_500k", "32x8", status="skipped"),
        _cell("rwkv6-1.6b", "decode_32k", "32x8", c=1e-5, m=3e-3, x=1e-3,
              b="memory", mfu=0.001),
        _cell("rwkv6-1.6b", "train_4k", "32x8", status="error"),
        _cell("gemma-2b", "train_4k", "2x32x8", c=0.044, m=0.002, x=0.09,
              b="collective", mfu=0.2),
    ]
    port_dir, ref_dir = tmp_path / "port", tmp_path / "ref"
    port_dir.mkdir()
    ref_dir.mkdir()
    for i, c in enumerate(cells):
        (port_dir / f"{i}.json").write_text(json.dumps(c))
        (ref_dir / f"{i}.json").write_text(
            json.dumps({**c, "mesh": names[c["mesh"]]}))
    monkeypatch.setattr(port_roofline, "ART_DIR", str(port_dir))
    monkeypatch.setattr(ref_roofline, "ART_DIR", str(ref_dir))
    got, want = port_roofline.run(), ref_roofline.run()
    for row in want["rows"]:
        row["mesh"] = {v: k for k, v in names.items()}[row["mesh"]]
    assert got == want
    assert (got["n_ok"], got["n_skipped"], got["n_error"],
            got["n_multipod_ok"]) == (3, 1, 1, 1)
    assert port_roofline.render(got["rows"]) == \
        ref_roofline.render(want["rows"])
