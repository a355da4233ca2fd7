"""The port's kernel, serving and micro benchmarks, its benchmark runner and
its serving example, on the CPU (``--device cpu``).

Each twin runs end to end at a small size and writes what the reference
writes: the kernel sweep's and the serving sweep's JSON carry every key of
the reference's committed outputs (``benchmarks/baselines/
kernel_bench_baseline.json``, ``serving_baseline.json``), so the unchanged
gates read them; no speed is asserted (the CPU runs the plain versions).
The microbenchmarks and ``torch_run.py --smoke`` print their rows, and
``examples/torch_serve_lm.py`` serves.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
BASELINES = ROOT / "benchmarks" / "baselines"


def _run(args, tmp_path, **env):
    full_env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(ROOT / "src"), str(ROOT)]), **env}
    r = subprocess.run([sys.executable, *args], cwd=tmp_path, env=full_env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    return r.stdout


def test_kernel_bench_on_cpu_has_the_referenceset(tmp_path):
    out = tmp_path / "k.json"
    _run([str(ROOT / "benchmarks" / "torch_kernel_bench.py"), "--smoke",
          "--device", "cpu", "--iters", "1", "--out", str(out)], tmp_path,
         REPRO_TORCH_AUTOTUNE_CACHE=str(tmp_path / "cache.json"))
    cur = json.loads(out.read_text())
    ref = json.loads((BASELINES / "kernel_bench_baseline.json").read_text())
    assert set(ref) <= set(cur)
    assert cur["mode"] == cur["backend"] == "cpu"
    assert set(ref["summary"]) <= set(cur["summary"])
    assert set(cur["configs"]) == {"whisper-medium-enc-self", "gemma-2b-mqa",
                                   "deepseek-7b-mha", "rwkv6-1b6-wkv"}
    ref_row = next(iter(ref["configs"].values()))
    for name, row in cur["configs"].items():
        assert set(ref_row) <= set(row), name
        assert row["speedup_vs_default"] >= 1.0
        assert row["cache_key"].split("|")[1] == "cpu"
        assert row["bound_ms"] > 0 and row["bound_by"] in ("bytes", "operations")
    # two tiles where the wgmma body has them, one at Dv 256
    assert cur["configs"]["deepseek-7b-mha"]["n_candidates"] == 2
    assert cur["configs"]["gemma-2b-mqa"]["n_candidates"] == 1
    assert cur["configs"]["rwkv6-1b6-wkv"]["n_candidates"] == 2
    cached = json.loads((tmp_path / "cache.json").read_text())["entries"]
    for r in cur["configs"].values():  # each winner persisted
        assert cached[r["cache_key"]]["config"] == r["tuned"]
    # the unchanged gate reads it (here against itself: same mode)
    _run([str(ROOT / "benchmarks" / "check_kernel_regression.py"), "--current",
          str(out), "--baseline", str(out)], tmp_path)


def test_serving_bench_on_cpu_has_the_referenceset(tmp_path):
    out = tmp_path / "s.json"
    _run([str(ROOT / "benchmarks" / "torch_serving_bench.py"), "--smoke",
          "--device", "cpu", "--width", "smoke", "--requests", "8",
          "--out", str(out)], tmp_path)
    cur = json.loads(out.read_text())
    ref = json.loads((BASELINES / "serving_baseline.json").read_text())
    assert set(ref) <= set(cur)
    assert cur["mode"] == "cpu" and cur["model"] == "gemma-2b-smoke-f32"
    assert set(ref["summary"]) <= set(cur["summary"])
    assert set(ref["scenarios"]) == set(cur["scenarios"])
    # the paged engine no longer reports latency in ticks or the page
    # share left after its run has freed every page
    dropped = {"p50_latency_ticks", "p99_latency_ticks", "page_utilization"}
    for name, sc in ref["scenarios"].items():
        assert set(sc) - dropped <= set(cur["scenarios"][name]), name
        assert not dropped & set(cur["scenarios"][name]), name
        assert cur["scenarios"][name]["tokens"] == 8 * 24
        assert cur["scenarios"][name]["rejected"] == 0


def test_microbench_rows_on_cpu():
    sys.path.insert(0, str(ROOT))
    from benchmarks import torch_microbench

    rows = torch_microbench.run("cpu")
    assert list(rows) == ["attention_core_2k", "flash_attention_kernel_512",
                          "wkv_chunked_1k", "wkv_scan_kernel_512",
                          "moe_dense_small", "train_step_smoke_7b_cfg"]
    for name, row in rows.items():
        assert row["us"] > 0 and row["std_us"] >= 0 and row["iters"] >= 3, name


def test_runner_smoke_prints_its_rows(tmp_path):
    text = _run([str(ROOT / "benchmarks" / "torch_run.py"), "--smoke",
                 "--device", "cpu"], tmp_path)
    lines = text.strip().splitlines()
    assert lines[0] == "name,us_per_call,derived"
    assert lines[1].startswith("table1_cost,")
    assert lines[2].startswith("planner_vs_greedy,") and "dominates=2/2" in lines[2]
    saved = json.loads((tmp_path / "BENCH_torch_smoke.json").read_text())
    assert set(saved) == {"table1", "planner_vs_greedy"}


def test_serve_example_on_cpu(tmp_path):
    text = _run([str(ROOT / "examples" / "torch_serve_lm.py"), "--device",
                 "cpu", "--requests", "4", "--max-new", "5"], tmp_path)
    assert text.startswith("[serve gemma-2b] 4 requests, 20 tokens in")
    assert text.count("  req ") == 3
