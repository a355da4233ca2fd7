"""What the readers of the paged engine's span record share.

The program's ``PagedServingEngine.run`` returns its spans in its stats
(``stats["spans"]``; each with ``name``, ``id``, ``parent``, ``start_ns``,
``end_ns`` on ``time.time_ns`` and ``device_ms`` from CUDA events or None),
and ``serve.py`` keeps each wave's stats in ``record["waves"]``.  A program
without the record gives these readers nothing to read: they return None.
"""
from __future__ import annotations

import statistics


def waves(record) -> list:
    """(stats, spans) of each wave of the window whose engine kept spans."""
    if record["kind"] != "serve":
        return []
    return [(w["stats"], w["stats"]["spans"]) for w in record["waves"]
            if w["stats"].get("spans")]


def round_device_ms(spans, names: tuple[str, ...]) -> list[float]:
    """Each prefill round's summed ``device_ms`` of its phases named in
    ``names``, for the rounds that have a device time for each of them."""
    by_round: dict[int, list] = {}
    for s in spans:
        if s.name in names:
            by_round.setdefault(s.parent, []).append(s.device_ms)
    return [sum(v) for v in by_round.values()
            if len(v) == len(names) and None not in v]


def median_round_ms(record, names: tuple[str, ...]) -> float | None:
    vals = [ms for _, spans in waves(record)
            for ms in round_device_ms(spans, names)]
    return statistics.median(vals) if vals else None


def _union(ivs: list) -> list:
    out: list[list[int]] = []
    for s, e in sorted(ivs):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _overlap_ns(a: list, b: list) -> int:
    """Length of the intersection of two sorted lists of disjoint
    intervals."""
    i = j = total = 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_pct_inside(record, names: set[str]) -> float | None:
    """Share (%) of the traced window in which no kernel ran on the card
    while the host was inside a span named in ``names``: the trace's
    kernels against the spans of the wave the trace fell in, on the one
    clock both are stamped on."""
    tr = record.get("trace")
    if tr is None:
        return None
    traced = [spans for _, spans in waves(record)
              if spans[0].start_ns < tr.t1 and spans[0].end_ns > tr.t0]
    if not traced:
        return None
    host = _union([(max(s.start_ns, tr.t0), min(s.end_ns, tr.t1))
                   for s in traced[0] if s.name in names
                   and s.end_ns > tr.t0 and s.start_ns < tr.t1])
    inside = sum(e - s for s, e in host)
    busy = [list(iv) for iv in tr.merged()]
    return 100.0 * (inside - _overlap_ns(host, busy)) / (tr.t1 - tr.t0)
