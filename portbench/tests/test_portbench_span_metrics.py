"""The readers of the paged engine's span record, on synthetic records:
device time by round and block, the KV view's rate, the idle shares inside
the program's spans; nothing from a program without the record."""
import time

import pytest

pytest.importorskip("torch")

from portbench import run, spec  # noqa: E402
from portbench.trace import Trace  # noqa: E402
from repro_torch.launch.serve import Span  # noqa: E402

SIX = ["kv_view_ms", "kv_view_gbps", "prefill_model_ms", "decode_block_ms",
       "idle_in_prefill_pct", "idle_between_blocks_pct"]


def _spans(t=0):
    """One wave: two timed rounds and one without device times, two blocks,
    a drain; host times from ``t``."""
    out = []

    def add(name, parent, s, e, ms=None):
        out.append(Span(name, len(out), parent, t + s, t + e, ms))
        return len(out) - 1

    run_ = add("run", None, 0, 100)
    add("admit", run_, 0, 10)
    add("decode.block", run_, 10, 12, 8.0)
    for i, (g, m, sc) in enumerate([(1.0, 20.0, 2.0), (3.0, 40.0, 4.0),
                                    (None, None, None)]):
        base = 12 + 10 * i
        r = add("prefill.round", run_, base, base + 10)
        add("prefill.prepare", r, base, base + 1)
        add("kv.gather", r, base + 1, base + 2, g)
        add("model.prefill_chunk", r, base + 2, base + 7, m)
        add("kv.scatter", r, base + 7, base + 8, sc)
        add("prefill.finalize", r, base + 8, base + 10)
    d = add("drain", run_, 42, 60)
    add("drain.wait", d, 42, 50)
    add("drain.unpack", d, 50, 60)
    add("admit", run_, 60, 70)
    add("decode.block", run_, 70, 75, 16.0)
    return out


def _record(trace=None, spans=True):
    stats = {"decode_ticks": 16, "prefill_rounds": 3,
             "kv_view_bytes": 3 * 10**9, "tick_ms_p50": 1.0}
    waves = [{"t0": 0.0, "t1": 1.0, "stats": dict(stats)},
             {"t0": 1.0, "t1": 2.0, "stats": dict(stats)}]
    if spans:
        waves[0]["stats"]["spans"] = _spans()
        waves[1]["stats"]["spans"] = _spans(1000)
    return {"kind": "serve", "waves": waves, "trace": trace}


def _read(name, record):
    return spec.reader(name)(record, None)


def test_device_times_by_round_and_block():
    rec = _record()
    assert _read("kv_view_ms", rec) == 5.0  # rounds 1 + 2 and 3 + 4
    assert _read("prefill_model_ms", rec) == 30.0
    assert _read("decode_block_ms", rec) == 1.5  # 8 and 16 ms over 8 ticks
    # 2 timed rounds a wave of 1e9 bytes each, over 3 + 7 ms
    assert _read("kv_view_gbps", rec) == pytest.approx(200.0)


def test_idle_shares_inside_the_spans_of_the_traced_wave():
    kernels = [("k", 20, 30), ("k", 45, 52), ("k", 55, 62), ("k", 72, 90)]
    rec = _record(Trace(kernels, [], 0, 100))
    # rounds [12, 42) hold kernels [20, 30): 20 idle
    assert _read("idle_in_prefill_pct", rec) == pytest.approx(20.0)
    # admit [0, 10) 10, block [10, 12) 2, unpack [50, 60) 3 (52-55),
    # admit [60, 70) 8, block [70, 75) 2
    assert _read("idle_between_blocks_pct", rec) == pytest.approx(25.0)
    idle = spec.reader("idle_pct.serve")(rec, None)
    assert (_read("idle_in_prefill_pct", rec)
            + _read("idle_between_blocks_pct", rec)) <= idle


def test_the_trace_is_held_against_its_own_wave_and_window():
    kernels = [("k", 1020, 1030)]
    rec = _record(Trace(kernels, [], 1010, 1040))  # inside the second wave
    # rounds [1012, 1040) of the window hold kernels [1020, 1030)
    assert _read("idle_in_prefill_pct", rec) == pytest.approx(
        100 * 18 / 30)
    assert _read("idle_between_blocks_pct", rec) == pytest.approx(
        100 * 2 / 30)  # its first block, [1010, 1012)
    outside = _record(Trace(kernels, [], 5000, 6000))
    assert _read("idle_in_prefill_pct", outside) is None


def test_a_program_without_spans_leaves_the_six_out():
    traced = Trace([("k", 0, 50)], [], 0, 100)
    for rec in (_record(traced, spans=False), {"kind": "train", "trace": traced}):
        assert [_read(n, rec) for n in SIX] == [None] * 6


def test_a_traced_smoke_run_feeds_the_readers(bench_dir, monkeypatch):
    """The smoke serving cell on the CPU, traced by a stand-in profiler (one
    kernel over the first half of the window): the engine's spans reach
    the readers through the record; with no card there is no device
    time, so only the idle shares read."""
    from portbench import trace

    def start(self):
        self.prof, self.t0 = True, time.time_ns()

    def stop(self, cut=False):
        if self.prof is None:
            return
        self.prof, t1 = None, time.time_ns()
        self.trace = trace.Trace([("k", self.t0, (self.t0 + t1) // 2)],
                                 self.spans.upto(t1), self.t0, t1, cut=cut)

    monkeypatch.setattr(trace.Tracer, "start", start)
    monkeypatch.setattr(trace.Tracer, "stop", stop)
    out = run.execute("granite-smoke.serve", 2**31 + 7, 0.01, True,
                      device="cpu", root=bench_dir, base=bench_dir,
                      keep_ctx=True)
    rec, ctx = out["_record"], out["_ctx"]
    assert all(w["stats"]["spans"] for w in rec["waves"])
    vals = {n: spec.reader(n)(rec, ctx) for n in SIX}
    assert vals["kv_view_ms"] is vals["prefill_model_ms"] is None
    assert vals["kv_view_gbps"] is vals["decode_block_ms"] is None
    idle = spec.reader("idle_pct.serve")(rec, ctx)
    assert 0 <= vals["idle_in_prefill_pct"] <= idle
    assert 0 <= vals["idle_between_blocks_pct"] <= idle
    assert vals["idle_in_prefill_pct"] + vals["idle_between_blocks_pct"] \
        <= idle + 1e-9
