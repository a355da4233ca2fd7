"""Message Reader: structured telemetry capture (paper component #2).

Every run emits events (submit / start / heartbeat / materialize / finish /
fail / cancel / cost-report / scaling).  The reader aggregates them for the
monitoring benchmarks (Fig 3 run-state counts, Fig 6 duration distributions)
and powers straggler detection plus the closed-loop adaptive controller in
the coordinator.

Long-lived fleet/serving runs can bound memory with ``max_events``: when the
live list reaches the cap, the oldest half is folded into compacted
aggregates (outcome counts, cost totals, duration summaries, cache stats)
before eviction, so the Fig-3/Table-1 rollups keep reporting lifetime
numbers while ``events()`` only returns the live window.
"""
from __future__ import annotations

import dataclasses
import statistics
import threading
import time
from typing import Any, Iterable

#: Terminal-outcome buckets reported by ``outcome_counts`` — preemptions are
#: their own bucket (the clients tag ``FAILURE`` events with
#: ``failure_kind``), not lumped into ``failure``.
OUTCOME_KEYS = ("success", "failure", "preemption", "cancelled")


@dataclasses.dataclass(frozen=True)
class Event:
    ts: float
    run_id: str
    asset: str
    partition: str
    platform: str
    kind: str  # SUBMIT|START|HEARTBEAT|MATERIALIZE|SUCCESS|FAILURE|CANCEL|COST|SCALING|RETRY|FAILOVER|SPECULATE|CACHE_HIT|STALE|REPLAN|BREAKER
    payload: dict[str, Any] = dataclasses.field(default_factory=dict)
    seq: int = 0  # monotonically increasing per reader; survives compaction

    def outcome_key(self) -> str | None:
        """The ``outcome_counts`` bucket this event lands in, if any."""
        if self.kind == "SUCCESS":
            return "success"
        if self.kind == "CANCEL":
            return "cancelled"
        if self.kind == "FAILURE":
            if self.payload.get("failure_kind") == "preemption":
                return "preemption"
            return "failure"
        return None


class MessageReader:
    def __init__(self, max_events: int | None = None) -> None:
        if max_events is not None and max_events < 2:
            raise ValueError("max_events must be >= 2 (or None for unbounded)")
        self._events: list[Event] = []
        self._lock = threading.Lock()
        self._next_seq = 0
        self._max_events = max_events
        self._evicted = 0
        # Compacted aggregates — folded in before eviction so the rollups
        # below keep lifetime totals.
        self._c_outcomes: dict[str, dict[str, int]] = {}
        self._c_cost_by_platform: dict[str, float] = {}
        self._c_cost_by_asset: dict[str, float] = {}
        self._c_dur: dict[str, list[float]] = {}  # asset -> [n, sum]
        self._c_cache: dict[str, dict[str, Any]] = {}  # run_id -> stats

    def emit(self, run_id: str, asset: str, partition: str, platform: str,
             kind: str, **payload: Any) -> Event:
        with self._lock:
            ev = Event(time.time(), run_id, asset, partition, platform, kind,
                       dict(payload), seq=self._next_seq)
            self._next_seq += 1
            self._events.append(ev)
            if (self._max_events is not None
                    and len(self._events) > self._max_events):
                self._compact_locked()
        return ev

    # ------------------------------------------------------------ compaction
    def _compact_locked(self) -> None:
        """Fold the oldest half of the live window into the aggregate
        summaries and drop it.  Called with the lock held."""
        keep_from = max(1, len(self._events) // 2)
        evicted, self._events = (self._events[:keep_from],
                                 self._events[keep_from:])
        self._evicted += len(evicted)
        for e in evicted:
            self._fold(e)

    def _fold(self, e: Event) -> None:
        key = e.outcome_key()
        if key is not None:
            d = self._c_outcomes.setdefault(
                e.platform, {k: 0 for k in OUTCOME_KEYS})
            d[key] += 1
        if e.kind == "SUCCESS" and "duration_s" in e.payload:
            agg = self._c_dur.setdefault(e.asset, [0, 0.0])
            agg[0] += 1
            agg[1] += e.payload["duration_s"]
        if e.kind == "COST":
            usd = e.payload.get("total_usd", 0.0)
            self._c_cost_by_platform[e.platform] = (
                self._c_cost_by_platform.get(e.platform, 0.0) + usd)
            self._c_cost_by_asset[e.asset] = (
                self._c_cost_by_asset.get(e.asset, 0.0) + usd)
        if e.kind in ("CACHE_HIT", "STALE") or (
                e.kind == "SUCCESS" and not e.payload.get("cached")):
            cs = self._c_cache.setdefault(
                e.run_id, {"cache_hits": 0, "executed": 0,
                           "stale_reasons": {}})
            if e.kind == "CACHE_HIT":
                cs["cache_hits"] += 1
            elif e.kind == "STALE":
                reason = e.payload.get("reason", "unknown").split(":")[0]
                cs["stale_reasons"][reason] = (
                    cs["stale_reasons"].get(reason, 0) + 1)
            else:
                cs["executed"] += 1

    @property
    def evicted_events(self) -> int:
        """How many events compaction has folded away (0 when unbounded)."""
        with self._lock:
            return self._evicted

    @property
    def min_live_seq(self) -> int:
        """Smallest seq still in the live window (= next seq when empty).
        A consumer whose cursor is older than this has lost events to
        compaction — ``events_since`` cannot return them."""
        with self._lock:
            return self._events[0].seq if self._events else self._next_seq

    # ------------------------------------------------------------ access
    def events(self, kind: str | None = None, asset: str | None = None,
               platform: str | None = None) -> list[Event]:
        """The live (non-compacted) event window, optionally filtered."""
        with self._lock:
            evs = list(self._events)
        if kind is not None:
            evs = [e for e in evs if e.kind == kind]
        if asset is not None:
            evs = [e for e in evs if e.asset == asset]
        if platform is not None:
            evs = [e for e in evs if e.platform == platform]
        return evs

    def events_since(self, seq: int) -> list[Event]:
        """Live events with ``e.seq >= seq`` — the adaptive controller's
        incremental cursor (keep ``last.seq + 1`` between calls).  Events
        evicted by compaction are gone; callers that must not miss events
        should size ``max_events`` above their polling interval's volume."""
        with self._lock:
            return [e for e in self._events if e.seq >= seq]

    # ------------------------------------------------------------ aggregates
    def outcome_counts(self) -> dict[str, dict[str, int]]:
        """platform -> {success, failure, preemption, cancelled} — Fig 3.

        ``FAILURE`` events tagged ``failure_kind == "preemption"`` land in
        the ``preemption`` bucket; ``failure`` counts hard failures only.
        All four keys are always present per platform.
        """
        with self._lock:
            out: dict[str, dict[str, int]] = {
                p: dict(d) for p, d in self._c_outcomes.items()}
        for e in self.events():
            key = e.outcome_key()
            if key is not None:
                d = out.setdefault(e.platform, {k: 0 for k in OUTCOME_KEYS})
                d[key] += 1
        return out

    def durations(self, asset: str | None = None,
                  platform: str | None = None) -> list[float]:
        """Realized durations from the live window (compacted events only
        survive as the per-asset mean — see ``median_duration``)."""
        return [e.payload["duration_s"]
                for e in self.events(kind="SUCCESS", asset=asset,
                                     platform=platform)
                if "duration_s" in e.payload]

    def median_duration(self, asset: str) -> float | None:
        d = self.durations(asset=asset)
        if d:
            return statistics.median(d)
        with self._lock:
            agg = list(self._c_dur.get(asset, ()))
        if agg and agg[0] > 0:
            return agg[1] / agg[0]  # compacted fallback: lifetime mean
        return None

    def total_cost(self, platform: str | None = None) -> float:
        with self._lock:
            if platform is None:
                compacted = sum(self._c_cost_by_platform.values())
            else:
                compacted = self._c_cost_by_platform.get(platform, 0.0)
        return compacted + sum(e.payload.get("total_usd", 0.0)
                               for e in self.events(kind="COST",
                                                    platform=platform))

    def cost_by_asset(self) -> dict[str, float]:
        with self._lock:
            out: dict[str, float] = dict(self._c_cost_by_asset)
        for e in self.events(kind="COST"):
            out[e.asset] = out.get(e.asset, 0.0) + e.payload.get("total_usd", 0.0)
        return out

    def cache_stats(self, run_id: str | None = None) -> dict[str, Any]:
        """Incremental-materialization aggregate: cache hits, executions and
        the per-reason staleness breakdown (``STALE`` events are emitted by
        the coordinator's upfront resolution, ``CACHE_HIT`` at launch time —
        a task can be pessimistically stale yet still hit via early cutoff).
        """
        hits = executed = 0
        reasons: dict[str, int] = {}
        with self._lock:
            compacted_cache = {rid: {"cache_hits": cs["cache_hits"],
                                     "executed": cs["executed"],
                                     "stale_reasons": dict(cs["stale_reasons"])}
                               for rid, cs in self._c_cache.items()}
        for rid, cs in compacted_cache.items():
            if run_id is not None and rid != run_id:
                continue
            hits += cs["cache_hits"]
            executed += cs["executed"]
            for reason, cnt in cs["stale_reasons"].items():
                reasons[reason] = reasons.get(reason, 0) + cnt
        for e in self.events():
            if run_id is not None and e.run_id != run_id:
                continue
            if e.kind == "CACHE_HIT":
                hits += 1
            elif e.kind == "SUCCESS" and not e.payload.get("cached"):
                executed += 1
            elif e.kind == "STALE":
                reason = e.payload.get("reason", "unknown").split(":")[0]
                reasons[reason] = reasons.get(reason, 0) + 1
        return {"cache_hits": hits, "executed": executed,
                "stale_reasons": reasons,
                "hit_rate": hits / max(1, hits + executed)}

    def tail(self, n: int = 20) -> Iterable[Event]:
        with self._lock:
            return list(self._events[-n:])
