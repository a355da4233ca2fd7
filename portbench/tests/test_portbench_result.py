"""The result line: exactly the contract's keys, the compared numbers last;
no result and a non-zero exit where there is no card or no program."""
import json
import os
import shutil
import subprocess
import sys
import time

import pytest

pytest.importorskip("torch")

from portbench import run, trace  # noqa: E402
from conftest import ROOT  # noqa: E402

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def _fake_start(self):
    """The profiler's place on a machine with no card."""
    self.prof = True
    self.t0 = time.time_ns()


def _fake_stop(self, cut=False):
    """One kernel over the first half of the traced time."""
    if self.prof is None:
        return
    self.prof = None
    t1 = time.time_ns()
    self.trace = trace.Trace([("fake_kernel", self.t0,
                               self.t0 + (t1 - self.t0) // 2)],
                             self.spans.upto(t1), self.t0, t1, cut=cut)


@pytest.fixture
def fake_profiler(monkeypatch):
    monkeypatch.setattr(trace.Tracer, "start", _fake_start)
    monkeypatch.setattr(trace.Tracer, "stop", _fake_stop)


@pytest.mark.parametrize("cell", ["granite-smoke.serve", "granite-smoke.train"])
def test_untraced_line_has_the_contract_keys(bench_dir, cell):
    out = run.execute(cell, 2**31 + 3, 0.01, False, device="cpu",
                      root=bench_dir, base=bench_dir)
    out.pop("_record")
    assert list(out) == KEYS + ["checks"]
    assert set(out["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    bench = json.loads((bench_dir / "BENCHMARK.json").read_text())
    want = {m["name"] for m in bench["end_to_end"]
            if "workloads" not in m or cell in m["workloads"]}
    assert set(out["metrics"]) == want
    for name, m in out["metrics"].items():
        assert set(m) == {"value", "unit"} and m["value"] > 0, name
    assert all(set(c) == {"value", "limit"} for c in out["checks"].values())
    json.dumps(out)


@pytest.mark.parametrize("cell", ["granite-smoke.serve", "granite-smoke.train"])
def test_traced_line_adds_busy_window_and_breakdown(bench_dir, cell,
                                                    fake_profiler):
    out = run.execute(cell, 5, 0.01, True, device="cpu", root=bench_dir,
                      base=bench_dir)
    out.pop("_record")
    assert list(out) == KEYS + ["breakdown", "checks"]
    assert 0 < out["device"]["busy_s"] <= out["device"]["window_s"]
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert len(out["breakdown"]["device_ops"]) <= 10
    assert "fake_kernel" in out["breakdown"]["device_ops"][0][0]
    bench = json.loads((bench_dir / "BENCHMARK.json").read_text())
    names = {m["name"] for m in bench["per_layer"]
             if cell in m.get("workloads", [cell])}
    assert set(out["metrics"]) <= names and out["metrics"]


def _env():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    env["CUDA_VISIBLE_DEVICES"] = ""
    return env


def test_no_card_no_result():
    r = subprocess.run([sys.executable, str(ROOT / "portbench" / "run.py"),
                        "--workload", "granite-moe.serve.long", "--seed", "1",
                        "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, env=_env(), cwd=ROOT,
                       timeout=300)
    assert r.returncode != 0
    assert r.stdout == ""


def test_paths_alone_are_not_enough(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys; sys.argv=['x']; from portbench import run; "
            "out = run.execute('granite-moe.serve.long', 1, 1, False, "
            "device='cpu'); print(out)")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=_env(), cwd=tmp_path, timeout=300)
    assert r.returncode != 0
    assert r.stdout == ""
    assert "repro_torch" in r.stderr


def test_a_limited_trace_stops_at_its_first_poll_past_the_limit(fake_profiler):
    spans = trace.Spans()
    tracer = trace.Tracer(spans, lambda: None, limit_s=0.05)
    with spans.span("wave 0"):
        tracer.start()
        tracer.poll()
        assert tracer.prof is not None
        time.sleep(0.06)
        tracer.poll()
        assert tracer.prof is None and tracer.trace.cut
        tracer.stop()
    assert tracer.trace.spans[0][0] == "wave 0"
    assert tracer.trace.spans[0][2] == tracer.trace.t1
