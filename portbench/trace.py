"""The traced part of a run: the card's kernels from ``torch.profiler`` and
the harness's own spans, on one clock.

The profiler records the card's activity only (no host operators, which
would slow the traced window and swell the trace).  Kineto stamps device
events on the host's wall clock in nanoseconds (``time.time_ns``), so the
harness's spans, stamped with the same clock around its calls into the
program, place every kernel and every idle gap in the span it fell in.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time


@dataclasses.dataclass
class Trace:
    kernels: list  # (name, start_ns, end_ns) on the card, start order
    spans: list  # (name, start_ns, end_ns) of the harness, host clock
    t0: int  # the traced window, host clock
    t1: int
    overhead_s: float = 0.0  # stopping the profiler and reading its events
    cut: bool = False  # stopped by its time limit before the traced call ended

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e9

    def merged(self) -> list[tuple[int, int]]:
        """The union of the kernels' intervals inside the window."""
        out: list[list[int]] = []
        for _, s, e in self.kernels:
            s, e = max(s, self.t0), min(e, self.t1)
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.merged()) / 1e9

    def device_time_s(self, start_ns: int, end_ns: int,
                      name_has: tuple[str, ...] = ()) -> float:
        """Summed device time of the kernels that start in [start, end),
        only those whose name holds one of ``name_has`` if given."""
        return sum(e - s for n, s, e in self.kernels
                   if start_ns <= s < end_ns
                   and (not name_has or any(h in n for h in name_has))) / 1e9

    def span_at(self, t: int) -> str:
        inner = [(e - s, n) for n, s, e in self.spans if s <= t < e]
        return min(inner)[1] if inner else "outside the harness's spans"

    def top_ops(self, n: int = 10) -> list:
        by: dict[str, float] = {}
        for name, s, e in self.kernels:
            key = name[:96]
            by[key] = by.get(key, 0.0) + (e - s) / 1e9
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> list:
        """The longest stretches with no kernel on the card, each named by
        the harness span it fell in and the kernel that ended it."""
        busy = self.merged()
        starts = {}
        for name, s, _ in self.kernels:
            starts.setdefault(s, name)
        edges = [self.t0] + [t for iv in busy for t in iv] + [self.t1]
        gaps = []
        for a, b in zip(edges[0::2], edges[1::2]):
            if b > a:
                nxt = starts.get(b, "the window's end")
                gaps.append([f"{self.span_at((a + b) // 2)}, before "
                             f"{nxt[:48]}", (b - a) / 1e9])
        return sorted(gaps, key=lambda g: -g[1])[:n]

    def breakdown(self) -> dict:
        return {"device_ops": self.top_ops(), "idle_gaps": self.idle_gaps()}


class Spans:
    """The harness's spans on the host's wall clock."""

    def __init__(self):
        self.spans: list = []
        self._open: list = []

    @contextlib.contextmanager
    def span(self, name: str):
        self._open.append((name, time.time_ns()))
        try:
            yield
        finally:
            name, t0 = self._open.pop()
            self.spans.append((name, t0, time.time_ns()))

    def upto(self, t: int) -> list:
        """The spans closed so far, and those still open cut at ``t``."""
        return self.spans + [(n, t0, t) for n, t0 in self._open]


class Tracer:
    """``torch.profiler`` over the card's activity only, started and stopped
    by hand.  With ``limit_s``, ``poll()`` stops it at its first call after
    that many seconds of tracing, from the thread that started it: reading
    a trace costs time in proportion to its kernels, and a whole wave of
    decode blocks (about a million kernels) would not be read inside a
    run's time.  ``overhead_s`` is what stopping the profiler and reading
    its events took, which the run leaves out of its window."""

    def __init__(self, spans: Spans, sync, limit_s: float | None = None):
        self.spans, self.sync, self.limit_s = spans, sync, limit_s
        self.prof = None
        self.trace: Trace | None = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.start()
        self.sync()
        self.t0 = time.time_ns()

    def poll(self) -> None:
        if (self.prof is not None and self.limit_s is not None
                and time.time_ns() - self.t0 > self.limit_s * 1e9):
            self.stop(cut=True)

    def stop(self, cut: bool = False) -> None:
        if self.prof is None:
            return
        self.sync()
        t1 = time.time_ns()
        prof, self.prof = self.prof, None
        prof.stop()
        kernels = []
        for e in prof.profiler.kineto_results.events():
            if e.device_type().name == "CUDA":
                s = e.start_ns()
                kernels.append((e.name(), s, s + e.duration_ns()))
        kernels.sort(key=lambda k: k[1])
        self.trace = Trace(kernels, self.spans.upto(t1), self.t0, t1,
                           (time.time_ns() - t1) / 1e9, cut)


def traced(fn, spans: Spans, sync) -> tuple[object, Trace]:
    """Run ``fn()`` under a ``Tracer`` with no limit: the window is from just
    before the call to the synchronisation after it."""
    tracer = Tracer(spans, sync)
    tracer.start()
    try:
        out = fn()
    finally:
        tracer.stop()
    return out, tracer.trace
