"""Incremental, slot-aware scheduling engine — the planner's inner loop.

``RunPlanner`` once re-ran a full critical-path pass over all *n* tasks for
every upgrade/downgrade candidate trial, and its schedule assumed infinite
width per platform while the ``RunCoordinator`` executes with finite elastic
slots.  This module fixes both:

* ``ScheduleEngine`` keeps one mutable schedule state and offers **O(cone)
  incremental retiming** (``set_duration`` / ``try_duration``): a duration
  change only re-times the affected descendant cone, and slack is re-derived
  lazily (one backward pass per batch, not per trial).
* ``slot_schedule`` is a **finite-capacity list scheduler**: per-platform
  slot budgets plus the global concurrency cap, exactly the knobs the
  coordinator runs with (shared via ``SlotConfig``), so predicted makespans
  stay honest under contention.
* ``task_dag`` expands the (asset, partition) task DAG once, caching
  ``partition_keys()`` / ``dep_partition_keys()`` per asset instead of
  re-expanding them per task — hot at 10k tasks.

Both the planner (predictions) and the coordinator (``RunReport.
slot_makespan_s`` replay) consume this engine, so plan and execution agree
on what a slot is.
"""
from __future__ import annotations

import dataclasses
import heapq

import numpy as np

from repro_torch.core.assets import AssetGraph

TaskKey = tuple[str, str]  # (asset, partition)

#: slack below this fraction of the makespan counts as "on the critical path"
CRITICAL_EPS = 1e-9


@dataclasses.dataclass(frozen=True)
class SlotConfig:
    """Concurrency limits shared by the planner and the coordinator.

    ``platform_slots`` is the initial per-platform budget; the coordinator's
    elastic scaler grows a backlogged platform one slot per blocked launch
    attempt up to ``elastic_max_slots``.  The ramp takes milliseconds against
    hour-scale tasks, so the *steady-state* width — ``elastic_max_slots``,
    still capped by ``max_concurrent`` globally — is what a schedule sees.
    """

    max_concurrent: int = 8
    platform_slots: int = 2
    elastic_max_slots: int = 8

    def capacity(self, platform: str) -> int:
        """Steady-state concurrent-task width for one platform.  The
        coordinator's budget starts at ``platform_slots`` and only ever
        grows (toward ``elastic_max_slots``), so the steady-state width is
        the larger of the two.  ``platform`` is unused today; it keeps the
        call sites ready for per-platform budget overrides."""
        return max(1, self.platform_slots, self.elastic_max_slots)


@dataclasses.dataclass
class SlotSchedule:
    """Result of one finite-capacity list-scheduling pass."""

    makespan_s: float
    start: np.ndarray  # per task index
    finish: np.ndarray
    peak_in_use: dict[str, int]  # platform -> max concurrent tasks observed
    wait_s_total: float  # total ready-but-queued time (contention signal)


def task_dag(graph: AssetGraph, targets: list[str] | None) -> tuple[
        list[TaskKey], dict[TaskKey, list[TaskKey]]]:
    """Topologically ordered (asset, partition) keys + predecessor edges.

    Partition expansion is cached per asset: ``partition_keys`` once per
    asset and ``dep_partition_keys`` once per (dep, partition) pair, instead
    of per task — the difference between O(n) and O(n * |partitions|) graph
    builds on partitioned DAGs.
    """
    order = graph.topo_order(targets)
    from repro_torch.core.partitions import dep_partition_keys, partition_keys

    pkeys: dict[str, list[str]] = {}
    for name in order:
        pkeys[name] = partition_keys(graph[name].partitions)

    keys: list[TaskKey] = []
    preds: dict[TaskKey, list[TaskKey]] = {}
    dep_cache: dict[tuple[str, str], list[str]] = {}
    for name in order:
        spec = graph[name]
        for key in pkeys[name]:
            tk = (name, key)
            keys.append(tk)
            plist: list[TaskKey] = []
            for d in spec.deps:
                dks = dep_cache.get((d, key))
                if dks is None:
                    # canonical mapping semantics, cached expansion
                    dks = dep_partition_keys(graph[d].partitions, key,
                                             dkeys=pkeys[d])
                    dep_cache[(d, key)] = dks
                plist.extend((d, dk) for dk in dks)
            preds[tk] = plist
    return keys, preds


class ScheduleEngine:
    """One mutable schedule over a fixed task DAG.

    Keys must be topologically ordered (as ``task_dag`` returns them), so
    integer index order is a valid topological order — the incremental
    retimer and both schedulers rely on that.
    """

    def __init__(self, keys: list[TaskKey],
                 preds: dict[TaskKey, list[TaskKey]],
                 slots: SlotConfig | None = None):
        self.keys = list(keys)
        self.n = len(self.keys)
        self.index = {k: i for i, k in enumerate(self.keys)}
        self.preds: list[list[int]] = [
            [self.index[p] for p in preds[k]] for k in self.keys]
        self.succs: list[list[int]] = [[] for _ in range(self.n)]
        for i, ps in enumerate(self.preds):
            for p in ps:
                if p >= i:
                    raise ValueError(
                        f"keys not topologically ordered: {self.keys[p]} "
                        f"precedes {self.keys[i]}")
                self.succs[p].append(i)
        self.sinks = [i for i in range(self.n) if not self.succs[i]]
        self.slots = slots
        self._dur: list[float] = [0.0] * self.n
        self._platform: list[str] = [""] * self.n
        self._finish: list[float] = [0.0] * self.n
        self._start: list[float] = [0.0] * self.n
        self._slack: np.ndarray | None = None
        self._makespan = 0.0

    # ------------------------------------------------------------- loading
    def load(self, durations, platforms=None) -> float:
        """Set all durations (+ optional platforms) and run one full
        forward pass.  Returns the infinite-width (PERT) makespan."""
        self._dur = [float(d) for d in durations]
        if len(self._dur) != self.n:
            raise ValueError(f"expected {self.n} durations")
        if platforms is not None:
            self._platform = [str(p) for p in platforms]
        self._forward_full()
        return self._makespan

    def _forward_full(self) -> None:
        finish = self._finish
        starts = self._start
        dur = self._dur
        for i in range(self.n):
            start = 0.0
            for p in self.preds[i]:
                if finish[p] > start:
                    start = finish[p]
            starts[i] = start
            finish[i] = start + dur[i]
        self._makespan = max((finish[s] for s in self.sinks), default=0.0)
        self._slack = None

    # -------------------------------------------------- incremental retime
    @property
    def makespan_s(self) -> float:
        return self._makespan

    def durations(self) -> np.ndarray:
        return np.asarray(self._dur, dtype=np.float64)

    def platforms(self) -> list[str]:
        return list(self._platform)

    def set_duration(self, i: int, dur: float,
                     platform: str | None = None) -> float:
        """Change one task's duration and incrementally re-time its
        descendant cone (O(cone), not O(n)).  Returns the new makespan."""
        _, undo = self.try_duration(i, dur, platform)
        del undo  # committed
        self._slack = None
        return self._makespan

    def try_duration(self, i: int, dur: float,
                     platform: str | None = None):
        """Trial variant of ``set_duration``: returns ``(makespan, undo)``
        where calling ``undo()`` restores the previous state (including the
        cached slack, so an undone trial costs no backward pass).

        Propagation is edge-incremental: each affected node keeps its start
        (= max of predecessor finishes) cached, and a predecessor's finish
        change updates it in O(1) — a full rescan of a node's predecessor
        list happens only when the unique max *decreased*.  That makes the
        common downgrade trial (durations grow) O(cone edges touched), not
        O(in-degree) per touched node — on a fan-out DAG the sink has n
        predecessors and the old rescan made every trial O(n)."""
        old_dur = self._dur[i]
        old_plat = self._platform[i]
        old_ms = self._makespan
        old_slack = self._slack
        self._dur[i] = float(dur)
        if platform is not None:
            self._platform[i] = platform
        finish, starts, d = self._finish, self._start, self._dur
        preds, succs = self.preds, self.succs
        changed: list[tuple[int, float]] = []  # (node, old finish)
        old_starts: dict[int, float] = {}
        # indices pop in increasing order, which is topological — every
        # changed predecessor of a node applies its edge update before the
        # node itself pops, so each node pops (and re-times) at most once
        heap = [i]
        inheap = {i}
        while heap:
            j = heapq.heappop(heap)
            inheap.discard(j)
            nf = starts[j] + d[j]
            fo = finish[j]
            if nf == fo:
                continue
            changed.append((j, fo))
            finish[j] = nf
            for s in succs[j]:
                st = starts[s]
                if nf > st:  # new max
                    new_st = nf
                elif nf < st and fo >= st:  # the max itself decreased
                    new_st = 0.0
                    for p in preds[s]:
                        if finish[p] > new_st:
                            new_st = finish[p]
                else:  # below the max before and after: no effect
                    continue
                if new_st != st:
                    if s not in old_starts:
                        old_starts[s] = st
                    starts[s] = new_st
                    if s not in inheap:
                        inheap.add(s)
                        heapq.heappush(heap, s)
        if changed:
            self._makespan = max(
                (finish[s] for s in self.sinks), default=0.0)
            self._slack = None

        def undo():
            self._dur[i] = old_dur
            self._platform[i] = old_plat
            for j, f in reversed(changed):
                finish[j] = f
            for j, st in old_starts.items():
                starts[j] = st
            self._makespan = old_ms
            self._slack = old_slack

        return self._makespan, undo

    # ------------------------------------------------------ slack (lazy)
    def slack(self) -> np.ndarray:
        """Total float per task against the current PERT makespan; computed
        lazily — one backward pass per batch of committed moves."""
        if self._slack is None:
            latest = [0.0] * self.n
            finish, dur, succs = self._finish, self._dur, self.succs
            ms = self._makespan
            for i in range(self.n - 1, -1, -1):
                lt = ms
                for s in succs[i]:
                    cand = latest[s] - dur[s]
                    if cand < lt:
                        lt = cand
                latest[i] = lt
            self._slack = np.asarray(
                [latest[i] - finish[i] for i in range(self.n)],
                dtype=np.float64)
        return self._slack

    def critical_mask(self) -> np.ndarray:
        return self.slack() <= CRITICAL_EPS * max(self._makespan, 1.0)

    # ----------------------------------------------- finite-capacity pass
    def slot_schedule(self, slots: SlotConfig | None = None) -> SlotSchedule:
        """Event-driven list schedule under per-platform slot budgets and the
        global concurrency cap.  Ready tasks launch in topological-index
        order (the coordinator's FIFO launch order) whenever their platform
        has a free slot.  O(n log n)."""
        cfg = slots if slots is not None else self.slots
        n = self.n
        if n == 0:
            return SlotSchedule(0.0, np.zeros(0), np.zeros(0), {}, 0.0)
        if cfg is None:  # infinite width: the PERT forward pass
            finish = np.asarray(self._finish, dtype=np.float64)
            start = np.asarray(self._start, dtype=np.float64)
            return SlotSchedule(self._makespan, start, finish, {}, 0.0)

        fast = self._pert_feasible_schedule(cfg)
        if fast is not None:
            return fast
        if all(cfg.capacity(p) >= cfg.max_concurrent
               for p in set(self._platform)):
            return self._slot_schedule_pool(cfg)

        indeg = [len(p) for p in self.preds]
        plats = sorted(set(self._platform))
        queues: dict[str, list[int]] = {p: [] for p in plats}
        in_use = {p: 0 for p in plats}
        peak = {p: 0 for p in plats}
        cap = {p: cfg.capacity(p) for p in plats}
        ready_at = [0.0] * n
        start = np.zeros(n)
        finish = np.zeros(n)
        running: list[tuple[float, int]] = []
        global_in_use = 0
        t = 0.0
        wait = 0.0
        for i in range(n):
            if indeg[i] == 0:
                heapq.heappush(queues[self._platform[i]], i)
        n_done = 0
        while n_done < n:
            while global_in_use < cfg.max_concurrent:
                best: str | None = None
                for p in plats:
                    if queues[p] and in_use[p] < cap[p] and (
                            best is None or queues[p][0] < queues[best][0]):
                        best = p
                if best is None:
                    break
                i = heapq.heappop(queues[best])
                start[i] = t
                finish[i] = t + self._dur[i]
                wait += t - ready_at[i]
                in_use[best] += 1
                peak[best] = max(peak[best], in_use[best])
                global_in_use += 1
                heapq.heappush(running, (finish[i], i))
            if not running:
                raise RuntimeError("slot schedule stalled (cycle?)")
            t, i = heapq.heappop(running)
            while True:
                p = self._platform[i]
                in_use[p] -= 1
                global_in_use -= 1
                n_done += 1
                for s in self.succs[i]:
                    indeg[s] -= 1
                    if indeg[s] == 0:
                        ready_at[s] = t
                        heapq.heappush(queues[self._platform[s]], s)
                if running and running[0][0] <= t:
                    _, i = heapq.heappop(running)
                else:
                    break
        return SlotSchedule(float(finish.max()), start, finish, peak, wait)

    @staticmethod
    def _peak_concurrency(start: np.ndarray, finish: np.ndarray) -> int:
        """Max simultaneous tasks of an interval set, counting a task that
        finishes at t as freeing its slot before one starting at t takes it
        (the list scheduler's event order)."""
        m = len(start)
        if m == 0:
            return 0
        times = np.concatenate([start, finish])
        deltas = np.concatenate([np.ones(m, dtype=np.int64),
                                 -np.ones(m, dtype=np.int64)])
        order = np.lexsort((deltas, times))  # -1 sorts before +1 at ties
        return int(np.cumsum(deltas[order]).max())

    def _pert_feasible_schedule(self, cfg: SlotConfig) -> SlotSchedule | None:
        """Contention-free fast path: if the infinite-width (PERT) schedule
        already respects the global cap and every platform cap, the FIFO
        list schedule equals it exactly — each task launches the instant it
        becomes ready, so no event loop is needed.  A wide fan-in/out stage
        that *does* exceed a cap returns ``None`` and takes the event-driven
        pass.  Vectorised event sweep, O(n log n) in numpy.

        Requires strictly positive durations: a zero-duration task is a
        point, not an interval, and the event loop serialises the launch of
        such chains through slot turnover at a single timestamp — the
        interval profile can look feasible while FIFO order still delays a
        successor past its PERT start.  Real cost-model durations are always
        positive; the degenerate case just takes the exact event loop."""
        dur = self._dur
        if any(d <= 0.0 for d in dur):
            return None
        start = np.asarray(self._start, dtype=np.float64)
        finish = np.asarray(self._finish, dtype=np.float64)
        if self._peak_concurrency(start, finish) > cfg.max_concurrent:
            return None
        parr = np.asarray(self._platform)
        peaks: dict[str, int] = {}
        for p in sorted(set(self._platform)):
            mask = parr == p
            pk = self._peak_concurrency(start[mask], finish[mask])
            if pk > cfg.capacity(p):
                return None
            peaks[p] = pk
        return SlotSchedule(self._makespan, start, finish, peaks, 0.0)

    def _slot_schedule_pool(self, cfg: SlotConfig) -> SlotSchedule:
        """Single-pool FIFO list schedule for the (default-config) case where
        every per-platform cap is >= the global cap, so only the global cap
        can ever bind: ready tasks form one index-ordered heap and each
        launch is O(log n) — no per-launch scan across platform queues."""
        n = self.n
        indeg = [len(p) for p in self.preds]
        ready = [i for i in range(n) if indeg[i] == 0]
        heapq.heapify(ready)
        in_use = {p: 0 for p in set(self._platform)}
        peak = dict(in_use)
        ready_at = [0.0] * n
        start = np.zeros(n)
        finish = np.zeros(n)
        running: list[tuple[float, int]] = []
        global_in_use = 0
        t = 0.0
        wait = 0.0
        n_done = 0
        dur, plat, succs = self._dur, self._platform, self.succs
        while n_done < n:
            while ready and global_in_use < cfg.max_concurrent:
                i = heapq.heappop(ready)
                p = plat[i]
                start[i] = t
                finish[i] = t + dur[i]
                wait += t - ready_at[i]
                u = in_use[p] + 1
                in_use[p] = u
                if u > peak[p]:
                    peak[p] = u
                global_in_use += 1
                heapq.heappush(running, (finish[i], i))
            if not running:
                raise RuntimeError("slot schedule stalled (cycle?)")
            t, i = heapq.heappop(running)
            while True:
                in_use[plat[i]] -= 1
                global_in_use -= 1
                n_done += 1
                for s in succs[i]:
                    indeg[s] -= 1
                    if indeg[s] == 0:
                        ready_at[s] = t
                        heapq.heappush(ready, s)
                if running and running[0][0] <= t:
                    _, i = heapq.heappop(running)
                else:
                    break
        return SlotSchedule(float(finish.max()), start, finish, peak, wait)
