"""The paged engine's span record (``PagedServingEngine.run``'s
``stats["spans"]``) and its KV-view byte counter, on the CPU at smoke sizes:
each prefill round's five phases in order, one round span a round, one
block span a block, ``kv_view_bytes`` from the cache specs, ``tick_ms``
from the block spans, and the CUDA-event bookkeeping with stand-in events.

The ``gpu`` test runs a small engine on the card under a CUDA-only
``torch.profiler``: the program's spans and the profiler's device events
share one clock, every timed span has a positive device time, and the
events add no kernel and no synchronisation.  Run it (no JAX needed) with

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_serving_trace.py
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch.train import smoke_config  # noqa: E402
from repro_torch.models import LanguageModel  # noqa: E402
from repro_torch.utils import tree_leaves  # noqa: E402

PAGED = dict(n_slots=3, max_len=64, page_size=8, chunk_max=8, drain_every=4)
LENS = [3, 9, 5, 13, 4, 11, 6]
ROUND = ["prefill.prepare", "kv.gather", "model.prefill_chunk", "kv.scatter",
         "prefill.finalize"]
TIMED = {"kv.gather", "model.prefill_chunk", "kv.scatter", "decode.block"}


def _requests(vocab):
    rng = np.random.RandomState(3)
    return [serve.Request(rid=i, prompt=rng.randint(0, vocab, n).tolist(),
                          max_new=3 + (i % 4) * 2, arrival=2 * i)
            for i, n in enumerate(LENS)]


def _engine(arch="granite-moe-1b-a400m", device="cpu", **kw):
    model = LanguageModel(smoke_config(arch), device=device)
    dtype = torch.float32 if device == "cpu" else torch.bfloat16
    return serve.PagedServingEngine(model, model.init(0), dtype=dtype,
                                    **{**PAGED, **kw})


@pytest.fixture(scope="module")
def served():
    eng = _engine()
    stats = eng.run(_requests(eng.model.cfg.vocab_size))
    return eng, stats


def _children(spans, parent):
    return [s for s in spans if s.parent == parent.id]


def test_spans_nest_inside_one_run_span(served):
    _, stats = served
    spans = stats["spans"]
    (run,) = [s for s in spans if s.parent is None]
    assert run.name == "run" and run.id == 0
    by_id = {s.id: s for s in spans}
    for s in spans[1:]:
        p = by_id[s.parent]
        assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns, (s, p)
    assert {s.name for s in _children(spans, run)} == {
        "admit", "decode.block", "prefill.round", "drain"}
    for d in (s for s in spans if s.name == "drain"):
        assert [c.name for c in _children(spans, d)] == ["drain.wait",
                                                         "drain.unpack"]
    assert all(s.device_ms is None for s in spans)  # no card, no events


def test_every_round_has_its_five_phases_in_time_order(served):
    _, stats = served
    spans = stats["spans"]
    rounds = [s for s in spans if s.name == "prefill.round"]
    assert len(rounds) == stats["prefill_rounds"] > 3
    for r in rounds:
        kids = _children(spans, r)
        assert [k.name for k in kids] == ROUND
        for a, b in zip(kids, kids[1:]):
            assert a.end_ns <= b.start_ns


def test_one_block_span_a_decode_block(served):
    eng, stats = served
    blocks = [s for s in stats["spans"] if s.name == "decode.block"]
    assert len(blocks) == stats["decode_ticks"] // eng.drain_every > 3
    assert stats["decode_ticks"] % eng.drain_every == 0


def test_tick_ms_is_read_from_the_block_spans(served):
    eng, stats = served
    spans = stats["spans"]
    walls = []
    for b in (s for s in spans if s.name == "decode.block"):
        wait = next(s for s in spans
                    if s.name == "drain.wait" and s.start_ns >= b.end_ns)
        walls.append((wait.end_ns - b.start_ns) / eng.drain_every / 1e6)
    walls.sort()
    for q, key in ((0.5, "tick_ms_p50"), (0.99, "tick_ms_p99")):
        i = min(len(walls) - 1, int(q * (len(walls) - 1) + 0.5))
        assert stats[key] == pytest.approx(walls[i], rel=1e-12), key


def _view_bytes_from_specs(kv, G):
    total = 0
    for spec in tree_leaves(kv.specs):
        n = math.prod(spec.shape) * spec.dtype.itemsize
        if "pages" in spec.axes:
            d = spec.axes.index("pages")
            n = n // (spec.shape[d] * spec.shape[d + 1]) * G * kv.view_len
        else:
            n = n // spec.shape[spec.axes.index("batch")] * G
        total += n
    return total


def test_kv_view_bytes_is_four_views_a_round(served):
    eng, stats = served
    view = _view_bytes_from_specs(eng.kv, eng.prefill_group)
    assert stats["kv_view_bytes"] == 4 * view * stats["prefill_rounds"]


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "rwkv6-1.6b"])
def test_view_bytes_are_the_gathered_views(arch):
    """Page pools (granite) and slot-dense states (rwkv6): the counted bytes
    are the bytes ``_gather_impl`` hands the model."""
    kv = _engine(arch).kv
    slots = [0, 2, kv.n_slots]
    rows = kv.table[[0, 2, 0]]
    view = kv._gather_impl(kv.cache, rows, slots)
    got = sum(t.numel() * t.element_size() for t in tree_leaves(view))
    assert kv.view_bytes(len(slots)) == got == _view_bytes_from_specs(kv, 3)


class _FakeEvent:
    """A CUDA event's stand-in, stamped from a counter when recorded; it
    refuses to be recorded again before an elapsed time has read it."""
    clock = 0
    made = 0

    def __init__(self, enable_timing=False):
        assert enable_timing
        type(self).made += 1
        self.t, self.unread = None, False

    def record(self, stream=None):
        assert not self.unread, "an event recorded again before it was read"
        type(self).clock += 1
        self.t, self.unread = type(self).clock, True

    def elapsed_time(self, end):
        self.unread = end.unread = False
        return float(end.t - self.t)


def test_device_intervals_are_read_at_the_drains(monkeypatch):
    """With stand-in events: every timed span gets its interval, a round's
    three intervals are contiguous (one event between two), events are
    reused only after a drain read them, and nothing synchronises but the
    drains."""
    syncs = []
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: None)
    monkeypatch.setattr(serve, "sync", syncs.append)
    record = serve.SpanRecord
    monkeypatch.setattr(serve, "SpanRecord",
                        lambda device=None: record(torch.device("cpu")))
    eng = _engine()
    _FakeEvent.clock = _FakeEvent.made = 0
    stats = eng.run(_requests(eng.model.cfg.vocab_size))
    spans = stats["spans"]
    timed = [s for s in spans if s.name in TIMED]
    assert timed and all(s.device_ms is not None and s.device_ms > 0
                         for s in timed)
    assert all(s.device_ms is None for s in spans if s.name not in TIMED)
    for r in (s for s in spans if s.name == "prefill.round"):
        g, m, sc = _children(spans, r)[1:4]
        assert (g.device_ms, m.device_ms, sc.device_ms) == (1.0, 1.0, 1.0)
    blocks = [s for s in spans if s.name == "decode.block"]
    assert all(b.device_ms == 1.0 for b in blocks)
    assert len(syncs) == stats["drains"] == stats["host_syncs"]
    records = 4 * stats["prefill_rounds"] + 2 * len(blocks)
    assert _FakeEvent.clock == records > _FakeEvent.made


def test_main_prints_stats_without_spans(monkeypatch, capsys):
    monkeypatch.setattr("sys.argv", ["serve", "--device", "cpu", "--arch",
                                     "granite-moe-1b-a400m", "--requests",
                                     "2", "--max-new", "3"])
    serve.main()
    out = capsys.readouterr().out
    assert "'kv_view_bytes'" in out and "spans" not in out


@pytest.mark.gpu
def test_spans_share_the_profilers_clock_on_gpu(monkeypatch):
    """On the card: kernels launched inside each round's ``kv.gather`` span
    start after the span's start on the profiler's clock; every timed span
    has a positive device time; the same run with and without the CUDA
    events launches the same device work and synchronises as often."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the events and the trace are its")
    from torch.profiler import ProfilerActivity, profile

    eng = _engine(device="cuda", n_slots=4, max_len=128, page_size=16,
                  chunk_max=32, drain_every=8, prefill_chunks_per_tick=4)
    vocab = eng.model.cfg.vocab_size
    eng.run(_requests(vocab))  # warm: allocator, cuBLAS, the graph's capture
    torch.cuda.synchronize()

    def traced():
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            stats = eng.run(_requests(vocab))
            torch.cuda.synchronize()
        return stats, list(prof.profiler.kineto_results.events())

    monkeypatch.setattr(serve.SpanRecord, "mark", lambda self: None)
    plain, plain_ev = traced()  # no events
    monkeypatch.undo()
    stats, events = traced()

    def device(evs):
        return [e for e in evs if e.device_type().name == "CUDA"]

    def syncs(evs):
        return sum("Synchronize" in e.name() for e in evs
                   if e.device_type().name != "CUDA")

    assert len(device(events)) == len(device(plain_ev)) > 0
    assert syncs(events) == syncs(plain_ev)
    assert stats["host_syncs"] == plain["host_syncs"] == stats["drains"]

    spans = stats["spans"]
    timed = [s for s in spans if s.name in TIMED]
    assert len(timed) == 3 * stats["prefill_rounds"] + len(
        [s for s in spans if s.name == "decode.block"])
    assert all(s.device_ms is not None and s.device_ms > 0 for s in timed)

    launches = [e for e in events if e.device_type().name != "CUDA"
                and e.correlation_id() > 0]
    by_corr = {}
    for e in device(events):
        by_corr.setdefault(e.correlation_id(), []).append(e.start_ns())
    gathers = [s for s in spans if s.name == "kv.gather"]
    assert gathers
    for g in gathers:
        starts = [t for e in launches if g.start_ns <= e.start_ns() < g.end_ns
                  for t in by_corr.get(e.correlation_id(), [])]
        assert starts, f"no device work launched inside {g}"
        assert min(starts) >= g.start_ns, (min(starts) - g.start_ns, g)
