"""Everything of a cell is found by name: a configuration, a traffic mix
and a metric added as new files run with no edit of any file there."""
import json

import pytest

pytest.importorskip("torch")

from portbench import run, spec  # noqa: E402


def test_new_config_traffic_and_metric_are_found_by_name(bench_dir):
    cfg = json.loads((bench_dir / "configs" / "granite-smoke.json").read_text())
    cfg["name"] = "dummy-model"
    (bench_dir / "configs" / "dummy-model.json").write_text(json.dumps(cfg))
    (bench_dir / "traffic" / "dummy_mix.json").write_text(json.dumps(
        {"kind": "waves", "requests": 3,
         "prompt": {"dist": "uniform", "lo": 5, "hi": 9},
         "output": {"dist": "uniform", "lo": 4, "hi": 6}}))
    (bench_dir / "limits" / "dummy.cell.json").write_text(json.dumps(
        {"check_requests": 2, "numbers": {"logit_gap_max": {"limit": 1.0}}}))
    (bench_dir / "metrics" / "dummy_count.py").write_text(
        "def read(record, ctx):\n    return float(len(record['served']))\n")
    before = {p: p.read_bytes() for p in bench_dir.rglob("*") if p.is_file()
              and "dummy" not in p.name and p.name != "BENCHMARK.json"}
    bench = json.loads((bench_dir / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "dummy.cell", "config": "dummy-model",
                               "traffic": "dummy_mix", "chips": 1,
                               "why": "a test"})
    bench["end_to_end"].append({"name": "dummy_count", "unit": "requests",
                                "workloads": ["dummy.cell"]})
    (bench_dir / "BENCHMARK.json").write_text(json.dumps(bench))

    out = run.execute("dummy.cell", 9, 0.01, False, device="cpu",
                      root=bench_dir, base=bench_dir)
    assert out["metrics"]["dummy_count"]["value"] == 3.0
    assert out["attempted"] == 3 and out["correct"]
    assert {p: p.read_bytes() for p in before} == before


def test_metrics_for_a_cell_follow_their_workloads_lists(bench_dir):
    bench = spec.benchmark(bench_dir)
    names = [m["name"] for m in spec.metrics_for(bench, "granite-smoke.train",
                                                 "end_to_end")]
    assert names == ["setup_s", "train_tok_per_s"]


def test_every_benchmark_metric_and_cell_has_its_files():
    bench = spec.benchmark()
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(spec.reader(m["name"]))
    for w in bench["workloads"]:
        assert spec.config(w["config"])["name"] == w["config"]
        assert spec.traffic(w["traffic"])["kind"] in ("waves", "train_batches")
        assert spec.limits(w["name"])["numbers"]


def test_a_reader_that_finds_nothing_leaves_its_metric_out(bench_dir):
    record = {"kind": "serve", "trace": None}
    assert spec.reader("wkv_roofline", bench_dir)(record, None) is None
    assert spec.reader("mfu.train", bench_dir)(record, None) is None


def test_wkv_roofline_reads_only_a_whole_wave(bench_dir):
    from types import SimpleNamespace

    from portbench.trace import Trace

    ctx = SimpleNamespace(config=spec.config("rwkv6-smoke", bench_dir),
                          traffic=spec.traffic("serve_tiny", bench_dir))
    kernels = [("wkv_chunk", 0, 10**9)]
    read = spec.reader("wkv_roofline", bench_dir)
    whole = {"kind": "serve", "trace": Trace(kernels, [], 0, 2 * 10**9)}
    assert 0 < read(whole, ctx) < 100
    cut = {"kind": "serve",
           "trace": Trace(kernels, [], 0, 2 * 10**9, cut=True)}
    assert read(cut, ctx) is None
