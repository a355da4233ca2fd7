"""DAG-level cost/deadline-aware run planner.

``DynamicClientFactory.choose`` is a per-task greedy argmin: it scores each
(asset, partition) in isolation, so under time pressure it happily pays the
premium surcharge for *every* task even though only the critical path decides
the makespan.  The planner fixes that with a global pass over the task DAG:

1. price every task on every feasible platform in one vectorized
   ``CostModel.estimate_batch`` call (expected cost with retries, roofline
   duration),
2. build the greedy baseline the factory would have produced; its
   **slot-aware** makespan becomes the default deadline, so a plan is never
   slower than greedy *as executed* (finite per-platform slots, shared with
   the coordinator via ``SlotConfig``),
3. start from the cheapest feasible assignment and *upgrade* critical-path
   tasks — batched best seconds-saved-per-dollar rounds with one schedule
   pass per round — until the target is met, then a slot-aware refinement
   loop buys down residual contention,
4. run a batched *downgrade* pass: off-path tasks move to cheaper platforms
   whenever the increase provably fits their slack; each trial is an O(cone)
   incremental retime (``ScheduleEngine.try_duration``), not a full
   reschedule,
5. check ``Objective.budget_usd`` / ``Objective.deadline_s`` and mark the
   plan infeasible (with a proof-style reason when even the cheapest/fastest
   assignment cannot satisfy the constraint).

Candidate selection tie-breaks are deterministic — stable sort on
(score, platform, key) — so the same DAG yields byte-identical plans across
runs and hash seeds.

**Cache-aware planning**: constructed with a ``MaterializationStore``, the
planner resolves per-(asset, partition) staleness first and plans only the
*stale cone* — fresh tasks are priced at $0 / ~0s on the pseudo-platform
``"cached"`` and never enter the schedule, so they can never occupy a
platform slot and a warm-cache re-run's plan collapses to the work that is
actually stale.  Staleness resolution is pessimistic (a stale upstream
poisons its consumers), which means the stale cone is upward-closed and the
reduced DAG needs no edge contraction.

The result is a ``RunPlan`` mapping every (asset, partition) to a
``PlannedChoice``; ``RunCoordinator.materialize(plan=...)`` consumes it and
falls back to the greedy factory on failover/deny.  ``targets`` everywhere
accepts an ``AssetSelection`` (or the legacy ``list[str]`` / a CLI
selection string — see ``core/selection.py``).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.assets import AssetGraph
from repro_torch.core.costmodel import CostEstimate
from repro_torch.core.factory import DynamicClientFactory, Objective
from repro_torch.core.schedule import (CRITICAL_EPS, ScheduleEngine, SlotConfig,
                                 SlotSchedule, task_dag)
from repro_torch.core.selection import AssetSelection
from repro_torch.core.store import MaterializationStore, resolve_staleness

TaskKey = tuple[str, str]  # (asset, partition)


@dataclasses.dataclass(frozen=True)
class PlannedChoice:
    """Final platform assignment for one (asset, partition) task."""

    asset: str
    partition: str
    platform: str
    estimate: CostEstimate
    expected_cost_usd: float  # retry-aware (cost / P(success))
    critical: bool = False
    slack_s: float = 0.0


@dataclasses.dataclass
class _Candidates:
    """Vectorized per-asset pricing shared by every partition of an asset."""

    assets: list[str]  # unique asset names (row order)
    platforms: list[str]  # column order: sorted platform names
    cost: np.ndarray  # [n_assets, n_platforms] expected USD, inf = excluded
    dur: np.ndarray  # [n_assets, n_platforms] seconds, inf = excluded
    #: what the *schedule* sees: == ``dur`` normally, or the rework-aware
    #: ``sched_duration_s`` under preemption-aware planning (failures and
    #: preemptions stretch the timeline, not just the expected cost)
    sched: np.ndarray = None
    rows: np.ndarray = None  # [n_tasks] task -> asset row
    #: CostEstimate component columns (same [n_assets, n_platforms] layout)
    #: so final choices are assembled without per-task scalar ``estimate``
    compute_s: np.ndarray = None
    base_usd: np.ndarray = None
    surcharge_usd: np.ndarray = None
    storage_usd: np.ndarray = None

    def estimate(self, row: int, col: int) -> CostEstimate:
        """Re-assemble the scalar ``CostEstimate`` for one priced cell."""
        return CostEstimate(
            platform=self.platforms[col],
            duration_s=float(self.dur[row, col]),
            compute_s=float(self.compute_s[row, col]),
            base_usd=float(self.base_usd[row, col]),
            surcharge_usd=float(self.surcharge_usd[row, col]),
            storage_usd=float(self.storage_usd[row, col]))


@dataclasses.dataclass
class RunPlan:
    objective: Objective
    choices: dict[TaskKey, PlannedChoice]
    predicted_cost_usd: float
    predicted_makespan_s: float  # slot-aware when planned with a SlotConfig
    greedy_cost_usd: float
    greedy_makespan_s: float
    feasible: bool = True
    reason: str = ""
    iterations: int = 0
    slot_config: SlotConfig | None = None
    platform_peaks: dict[str, int] = dataclasses.field(default_factory=dict)
    pert_makespan_s: float = 0.0  # infinite-width lower bound
    slot_wait_s: float = 0.0  # total time tasks sat ready-but-queued
    cached_tasks: int = 0  # fresh-in-store tasks priced at ~0 ("cached")

    @property
    def stale_tasks(self) -> int:
        return len(self.choices) - self.cached_tasks

    def choice(self, asset: str, partition: str) -> PlannedChoice | None:
        return self.choices.get((asset, partition))

    @property
    def cost_delta_vs_greedy(self) -> float:
        return self.predicted_cost_usd - self.greedy_cost_usd

    @property
    def makespan_delta_vs_greedy(self) -> float:
        return self.predicted_makespan_s - self.greedy_makespan_s

    def table(self, max_rows: int = 50) -> str:
        """Per-task assignment table plus predicted totals vs greedy.

        Beyond ``max_rows`` tasks the per-task listing is truncated and a
        per-(asset, platform) summary footer is printed instead — partitioned
        DAGs stay readable."""
        hdr = (f"{'task':<34} {'platform':<14} {'exp_usd':>9} "
               f"{'dur_h':>7} {'slack_h':>8} crit")
        lines = [hdr, "-" * len(hdr)]
        ordered = sorted(self.choices.items())
        truncated = max_rows is not None and len(ordered) > max_rows
        shown = ordered[:max_rows] if truncated else ordered
        for (a, p), c in shown:
            lines.append(
                f"{a + '[' + p + ']':<34} {c.platform:<14} "
                f"{c.expected_cost_usd:>9.2f} "
                f"{c.estimate.duration_s / 3600.0:>7.2f} "
                f"{c.slack_s / 3600.0:>8.2f} {'*' if c.critical else ''}")
        if truncated:
            lines.append(f"... ({len(ordered) - max_rows} more tasks; "
                         f"per-asset/platform summary below)")
            agg: dict[tuple[str, str], tuple[int, float, float]] = {}
            for (a, _p), c in ordered:
                n, usd, crit = agg.get((a, c.platform), (0, 0.0, 0))
                agg[(a, c.platform)] = (n + 1, usd + c.expected_cost_usd,
                                        crit + (1 if c.critical else 0))
            lines.append("-" * len(hdr))
            lines.append(f"{'asset @ platform':<49} {'tasks':>6} "
                         f"{'exp_usd':>9} {'crit':>5}")
            for (a, plat), (n, usd, crit) in sorted(agg.items()):
                lines.append(f"{a + ' @ ' + plat:<49} {n:>6} {usd:>9.2f} "
                             f"{crit:>5}")
        lines.append("-" * len(hdr))
        if self.cached_tasks:
            lines.append(
                f"cached:   {self.cached_tasks} of {len(self.choices)} tasks "
                f"fresh in store ($0, no slots); {self.stale_tasks} planned")
        lines.append(
            f"planned: ${self.predicted_cost_usd:.2f} / "
            f"{self.predicted_makespan_s / 3600.0:.2f} h   "
            f"greedy: ${self.greedy_cost_usd:.2f} / "
            f"{self.greedy_makespan_s / 3600.0:.2f} h   "
            f"delta: ${self.cost_delta_vs_greedy:+.2f} / "
            f"{self.makespan_delta_vs_greedy / 3600.0:+.2f} h")
        if self.slot_config is not None and self.platform_peaks:
            parts = []
            for name in sorted(self.platform_peaks):
                peak = self.platform_peaks[name]
                cap = self.slot_config.capacity(name)
                parts.append(f"{name} {peak}/{cap}"
                             + ("!" if peak >= cap else ""))
            lines.append(
                f"slots:    {'  '.join(parts)}   "
                f"(queued {self.slot_wait_s / 3600.0:.2f} task-h; "
                f"critical-path bound {self.pert_makespan_s / 3600.0:.2f} h)")
        if self.objective.budget_usd is not None:
            lines.append(f"budget:   ${self.objective.budget_usd:.2f} "
                         f"({'OK' if self.feasible else 'VIOLATED'})")
        if self.objective.deadline_s is not None:
            lines.append(f"deadline: {self.objective.deadline_s / 3600.0:.2f} h"
                         f" ({'OK' if self.feasible else 'VIOLATED'})")
        if not self.feasible:
            lines.append(f"INFEASIBLE: {self.reason}")
        return "\n".join(lines)


class RunPlanner:
    """Global (asset, partition) -> platform assignment under an Objective.

    ``slots`` defaults to the coordinator's ``SlotConfig`` so predictions
    account for finite per-platform concurrency; pass ``slots=None`` for the
    infinite-width (pure critical-path) relaxation.

    ``store`` (optional) enables cache-aware planning: tasks fresh in the
    ``MaterializationStore`` are excluded from the schedule and priced at
    ``CostEstimate.cached()`` — see the module docstring.
    """

    def __init__(self, graph: AssetGraph, factory: DynamicClientFactory,
                 max_iterations: int | None = None,
                 slots: SlotConfig | None = SlotConfig(),
                 store: MaterializationStore | None = None,
                 preemption_aware: bool = False):
        self.graph = graph
        self.factory = factory
        #: hard cap on optimization moves per plan; None (default) scales
        #: with DAG size — moves are O(cone) now, so a 10k-task DAG can
        #: afford 10k of them (the legacy planner paid a full O(n)
        #: reschedule per move and capped at 1000 regardless)
        self.max_iterations = max_iterations
        self.slots = slots
        self.store = store
        #: schedule on rework-aware durations (``sched_duration_s``): each
        #: task's timeline slot is stretched by expected retry rework on its
        #: platform, so flaky-platform assignments pay in *makespan*, not
        #: just expected cost.  Off by default — nominal durations keep the
        #: planner's makespan prediction aligned with a coordinator replay
        #: of the no-failure case; the adaptive coordinator turns it on.
        self.preemption_aware = preemption_aware

    # ------------------------------------------------------------ pricing
    def _candidates(self, keys: list[TaskKey]) -> _Candidates:
        """Vectorized feasible per-platform pricing; honors ``platform_hint``
        pins.  Estimates depend on (asset, platform) only, so partitions of
        one asset share a single priced row."""
        assets: list[str] = []
        row_of: dict[str, int] = {}
        for name, _part in keys:
            if name not in row_of:
                row_of[name] = len(assets)
                assets.append(name)
        platforms = sorted(self.factory.catalog)
        specs = [self.graph[a] for a in assets]
        batch = self.factory.cost_model.estimate_batch(
            specs, [self.factory.catalog[p] for p in platforms])
        cost = batch["expected_usd"].copy()
        dur = batch["duration_s"].copy()
        sched = (batch["sched_duration_s"].copy() if self.preemption_aware
                 else dur)
        for i, spec in enumerate(specs):
            # a hint naming a platform outside the catalog (e.g. evicted by
            # an open circuit breaker) is ignored rather than made
            # unsatisfiable
            if spec.platform_hint and spec.platform_hint in platforms:
                for j, pname in enumerate(platforms):
                    if pname != spec.platform_hint:
                        cost[i, j] = dur[i, j] = np.inf
                        sched[i, j] = np.inf
            if not np.isfinite(cost[i]).any():
                raise RuntimeError(
                    f"no feasible platform for asset {spec.name!r}")
        rows = np.asarray([row_of[name] for name, _ in keys], dtype=np.int64)
        return _Candidates(assets, platforms, cost, dur, sched=sched,
                           rows=rows,
                           compute_s=batch["compute_s"],
                           base_usd=batch["base_usd"],
                           surcharge_usd=batch["surcharge_usd"],
                           storage_usd=batch["storage_usd"])

    # ----------------------------------------------------- assignments
    @staticmethod
    def _argmin_rows(primary: np.ndarray, secondary: np.ndarray) -> np.ndarray:
        """Per-row argmin of (primary, secondary, column) — deterministic
        lexicographic tie-breaking (columns are sorted platform names).
        Vectorized: mask the primary ties, break them on the secondary, and
        let ``argmax`` on the surviving mask pick the lowest column."""
        p_min = primary.min(axis=1, keepdims=True)
        tie = primary == p_min
        sec = np.where(tie, secondary, np.inf)
        tie &= sec == sec.min(axis=1, keepdims=True)
        return tie.argmax(axis=1).astype(np.int64)

    def _greedy_cols(self, cand: _Candidates, obj: Objective) -> np.ndarray:
        """What per-task ``factory.choose`` would do — the baseline."""
        tv = obj.time_value_usd_per_hour
        with np.errstate(invalid="ignore"):
            # 0 * inf = nan on excluded cells; force them back to +inf
            score = np.where(np.isfinite(cand.cost),
                             cand.cost + tv * (cand.dur / 3600.0), np.inf)
        return self._argmin_rows(score, cand.cost)

    # ----------------------------------------------------------------- api
    def plan(self, targets: "AssetSelection | str | list[str] | None" = None,
             objective: Objective | None = None,
             force: bool = False,
             exclude: "set[TaskKey] | None" = None) -> RunPlan:
        """``exclude`` drops (asset, partition) tasks from the plan — the
        mid-run replan path passes everything already done or in flight.
        The set must be predecessor-closed (every predecessor of an excluded
        task is itself excluded), which done+running sets are by
        construction: a task only launches once its deps finished."""
        obj = objective or self.factory.objective
        names = AssetSelection.coerce(targets).resolve(self.graph)
        keys, preds = task_dag(self.graph, names)
        if exclude:
            keys = [k for k in keys if k not in exclude]
            preds = {k: [p for p in preds[k] if p not in exclude]
                     for k in keys}
        cached_keys: list[TaskKey] = []
        if self.store is not None and not force:
            staleness = resolve_staleness(self.graph, self.store, names)
            fresh = {k for k in keys if staleness[k].fresh}
            if fresh:
                # pessimistic resolution makes the stale cone upward-closed
                # (every predecessor of a stale task is itself stale or
                # absent), so dropping fresh tasks and filtering their edges
                # out of ``preds`` is an exact DAG restriction
                cached_keys = [k for k in keys if k in fresh]
                keys = [k for k in keys if k not in fresh]
                preds = {k: [p for p in preds[k] if p not in fresh]
                         for k in keys}
        cand = self._candidates(keys)
        engine = ScheduleEngine(keys, preds, self.slots)
        rows = cand.rows
        plat_arr = np.asarray(cand.platforms)

        def load(cols: np.ndarray) -> float:
            """Full schedule pass for an assignment; returns PERT makespan.
            Schedules on ``cand.sched`` (== ``dur`` unless preemption-aware
            planning inflated it with expected rework)."""
            return engine.load(cand.sched[rows, cols], plat_arr[cols])

        def slot_ms() -> SlotSchedule:
            return engine.slot_schedule()

        def total_cost(cols: np.ndarray) -> float:
            return float(cand.cost[rows, cols].sum()) if len(rows) else 0.0

        # greedy baseline (slot-aware: what greedy costs *as executed*)
        greedy_cols = self._greedy_cols(cand, obj)[rows] \
            if len(rows) else np.zeros(0, dtype=np.int64)
        load(greedy_cols)
        greedy_sched = slot_ms()
        greedy_ms = greedy_sched.makespan_s
        greedy_cost = total_cost(greedy_cols)

        # a plan must never be slower than greedy; a deadline tightens that
        target = greedy_ms
        if obj.deadline_s is not None:
            target = min(target, obj.deadline_s)

        iters = 0
        budget = (self.max_iterations if self.max_iterations is not None
                  else max(1000, 2 * len(keys)))
        feasible, reason = True, ""

        # provable lower bounds first: the infinite-width makespan of the
        # fastest assignment lower-bounds any schedule under any slots, and
        # the cheapest assignment lower-bounds any plan's cost.
        fastest_cols = self._argmin_rows(cand.sched, cand.cost)[rows] \
            if len(rows) else np.zeros(0, dtype=np.int64)
        fastest_pert = load(fastest_cols)
        cheapest_cols = self._argmin_rows(cand.cost, cand.dur)[rows] \
            if len(rows) else np.zeros(0, dtype=np.int64)
        min_cost = total_cost(cheapest_cols)
        if obj.deadline_s is not None and fastest_pert > obj.deadline_s:
            feasible = False
            reason = (f"deadline {obj.deadline_s:.0f}s infeasible: even the "
                      f"fastest assignment needs {fastest_pert:.0f}s on the "
                      f"critical path alone")
        if obj.budget_usd is not None and min_cost > obj.budget_usd:
            feasible = False
            reason = (reason + "; " if reason else "") + (
                f"budget ${obj.budget_usd:.2f} infeasible: even the cheapest "
                f"assignment costs ${min_cost:.2f}")

        # 1) start cheap, 2) buy back time on the critical path — batched
        # best-rate rounds, one full schedule pass per round instead of one
        # per candidate trial
        cols = cheapest_cols.copy()
        pert = load(cols)
        while pert > target * (1 + 1e-9) and iters < budget:
            applied = self._upgrade_round(engine, cand, cols,
                                          pert - target)
            if not applied:
                break
            iters += applied
            pert = load(cols)

        # 2b) slot-aware refinement: the PERT bound is met (or unmeetable)
        # but finite slots may still queue work past the target
        sched = slot_ms()
        greedy_meets = greedy_ms <= target * (1 + 1e-9)
        if sched.makespan_s > target * (1 + 1e-9) and greedy_meets \
                and sched.makespan_s > 1.5 * max(pert, 1e-9):
            # throughput-bound regime: the binding limit is slot width, not
            # the critical path — migrating ~n tasks batch by batch costs
            # more planning time than it saves, so start from greedy (which
            # meets the target by definition) and let the downgrade pass
            # claw cost back inside the slot envelope
            cols = greedy_cols.copy()
            pert = load(cols)
            sched = greedy_sched  # identical assignment: reuse its schedule
        else:
            # latency-bound residual: keep buying speed / shifting load off
            # the saturated platform, one schedule pass per round, until the
            # target is met or progress stalls
            rounds = 0
            while sched.makespan_s > target * (1 + 1e-9) \
                    and iters < budget and rounds < 48:
                applied = self._contention_round(engine, cand, cols, sched,
                                                 budget - iters,
                                                 greedy_meets=greedy_meets)
                if not applied:
                    break
                iters += applied
                load(cols)
                prev_ms = sched.makespan_s
                sched = slot_ms()
                rounds += 1
                if sched.makespan_s > prev_ms * (1 - 1e-3):
                    break  # stalled: the fallback below takes over

        if sched.makespan_s > target * (1 + 1e-9):
            if obj.deadline_s is not None and feasible:
                feasible = False
                reason = (f"deadline {obj.deadline_s:.0f}s unmet: best "
                          f"achievable makespan {sched.makespan_s:.0f}s")
            # never return a plan slower than greedy
            if sched.makespan_s > greedy_ms:
                cols = greedy_cols.copy()
                load(cols)
                sched = greedy_sched

        # 3) spend slack: batched downgrade pass — off-path tasks take the
        # cheapest platform whose extra duration provably fits their slack;
        # each trial is an O(cone) incremental retime, slack re-derived
        # lazily once per round, slot-validated in chunks
        slot_cap = max(target, sched.makespan_s)
        moved = self._downgrade(engine, cand, cols, budget - iters,
                                slot_cap, load)
        iters += moved
        if moved:
            sched = slot_ms()

        cost = total_cost(cols)
        # dominance guard: when greedy itself meets the target, never ship a
        # plan that costs more than greedy
        if cost > greedy_cost + 1e-9 and greedy_ms <= target * (1 + 1e-9):
            cols = greedy_cols.copy()
            load(cols)
            sched = greedy_sched
            cost = greedy_cost

        if obj.budget_usd is not None and cost > obj.budget_usd and feasible:
            feasible = False
            reason = (f"budget ${obj.budget_usd:.2f} unmet at deadline: best "
                      f"plan costs ${cost:.2f}")

        slack = engine.slack()
        crit = engine.critical_mask()
        # estimates depend on (asset row, platform col) only: reassemble one
        # CostEstimate per priced cell from the batch columns — no scalar
        # ``estimate`` calls even when every task is its own asset
        est_cache: dict[tuple[int, int], CostEstimate] = {}
        choices: dict[TaskKey, PlannedChoice] = {}
        for t, tk in enumerate(keys):
            col = int(cols[t])
            ck = (int(rows[t]), col)
            est = est_cache.get(ck)
            if est is None:
                est = est_cache[ck] = cand.estimate(*ck)
            choices[tk] = PlannedChoice(
                asset=tk[0], partition=tk[1],
                platform=cand.platforms[col],
                estimate=est,
                expected_cost_usd=float(cand.cost[rows[t], col]),
                critical=bool(crit[t]), slack_s=float(slack[t]))
        for tk in cached_keys:
            choices[tk] = PlannedChoice(
                asset=tk[0], partition=tk[1], platform="cached",
                estimate=CostEstimate.cached(), expected_cost_usd=0.0,
                critical=False, slack_s=0.0)
        return RunPlan(
            objective=obj, choices=choices, predicted_cost_usd=cost,
            predicted_makespan_s=sched.makespan_s,
            greedy_cost_usd=greedy_cost,
            greedy_makespan_s=greedy_ms,
            feasible=feasible, reason=reason, iterations=iters,
            slot_config=self.slots,
            platform_peaks=dict(sched.peak_in_use),
            pert_makespan_s=engine.makespan_s,
            slot_wait_s=sched.wait_s_total,
            cached_tasks=len(cached_keys))

    # ------------------------------------------------------ upgrade rounds
    def _upgrade_round(self, engine: ScheduleEngine, cand: _Candidates,
                       cols: np.ndarray, gap_s: float) -> int:
        """Apply the best seconds-saved-per-dollar moves on critical tasks
        until their combined saving covers ``gap_s``.  Savings on parallel
        critical branches are not additive, so the next round's schedule
        pass re-measures; rounds converge geometrically in practice."""
        crit = engine.critical_mask()
        moves = self._rank_moves(cand, cols, crit, engine.durations())
        if not moves:
            return 0
        applied = 0
        saved = 0.0
        for _rate, _plat, t, col, save in moves:
            cols[t] = col
            applied += 1
            saved += save
            if saved >= gap_s:
                break
        return applied

    def _contention_round(self, engine: ScheduleEngine, cand: _Candidates,
                          cols: np.ndarray, sched: SlotSchedule,
                          remaining: int, greedy_meets: bool) -> int:
        """One slot-refinement round: upgrade the best-rate moves among
        tasks that are PERT-critical or sitting on the most-loaded platform
        when it is saturated.  Batch size scales with the number of eligible
        moves so rebalancing a 10k-task backlog doesn't take 10k rounds.
        When the rebalance provably cannot fit the remaining move budget and
        greedy already meets the target, bail out — the greedy fallback is
        cheaper than grinding through a doomed refinement."""
        dur = engine.durations()
        plats = engine.platforms()
        load_by: dict[str, float] = {}
        for i, p in enumerate(plats):
            load_by[p] = load_by.get(p, 0.0) + dur[i]
        hot = max(sorted(load_by), key=lambda p: load_by[p]) if load_by else ""
        mask = engine.critical_mask().copy()
        if hot and self.slots is not None and \
                sched.peak_in_use.get(hot, 0) >= self.slots.capacity(hot):
            plat_arr = np.asarray(plats)
            mask |= plat_arr == hot
        moves = self._rank_moves(cand, cols, mask, dur)
        if not moves or (greedy_meets and len(moves) > remaining):
            return 0
        batch = min(max(1, len(moves) // 8), remaining)
        for _rate, _plat, t, col, _save in moves[:batch]:
            cols[t] = col
        return batch

    @staticmethod
    def _rank_moves(cand: _Candidates, cols: np.ndarray,
                    mask: np.ndarray, dur: np.ndarray) -> list[
                        tuple[float, str, int, int, float]]:
        """Deterministically ranked speed-up moves for masked tasks, one
        best move per task: sorted by (rate desc, platform, task index) —
        task index is topological, so ordering is stable across runs and
        hash seeds.  Each move is (neg_rate, platform, task, col, saved_s).
        Fully vectorized: one numpy pass over tasks x platforms."""
        idx = np.flatnonzero(mask)
        if len(idx) == 0:
            return []
        r = cand.rows[idx]
        cur_c = cand.cost[r, cols[idx]]
        save = dur[idx][:, None] - cand.sched[r]  # [k, m]
        dcost = cand.cost[r] - cur_c[:, None]
        with np.errstate(invalid="ignore"):
            rate = save / np.maximum(dcost, 1e-9)
            valid = (save > 0) & np.isfinite(cand.cost[r])
        rate = np.where(valid, rate, -np.inf)
        # first argmax = lowest column index = alphabetically-first platform,
        # matching the (rate desc, platform) tie-break
        best = np.argmax(rate, axis=1)
        k = np.arange(len(idx))
        brate = rate[k, best]
        keep = np.isfinite(brate)
        if not keep.any():
            return []
        idx, best, brate = idx[keep], best[keep], brate[keep]
        bsave = save[k[keep], best]
        order = np.lexsort((idx, best, -brate))
        return [(float(-brate[i]), cand.platforms[best[i]], int(idx[i]),
                 int(best[i]), float(bsave[i])) for i in order]

    # --------------------------------------------------------- downgrades
    def _downgrade(self, engine: ScheduleEngine, cand: _Candidates,
                   cols: np.ndarray, budget: int, slot_cap: float,
                   reload) -> int:
        """Batched slack-spending: for every task (largest slack first, then
        key — deterministic), take the cheapest platform whose extra
        duration fits the task's current slack.  Each acceptance is an
        incremental O(cone) retime; slack is recomputed lazily once per
        round — the legacy planner paid a full O(n) reschedule per trial.

        The PERT cap proves accepted moves never stretch the critical path;
        finite slots can still (rarely) cascade a longer task into a later
        queue, so batches are slot-validated in chunks: a chunk that pushes
        the slot makespan past ``slot_cap`` is rolled back and the pass
        stops at the last good checkpoint."""
        if budget <= 0 or engine.n == 0:
            return 0
        rows = cand.rows
        cap = engine.makespan_s * (1 + 1e-12)
        assets_arr = np.asarray([k[0] for k in engine.keys])
        parts_arr = np.asarray([k[1] for k in engine.keys])
        chunk = max(32, engine.n // 16)
        snapshot = cols.copy()
        accepted = 0  # since last slot validation
        iters = 0

        def validate() -> bool:
            """Slot-check the pending chunk; roll back to the checkpoint on
            regression (uncounting the discarded moves).  Returns False to
            stop the pass."""
            nonlocal accepted, snapshot, iters
            if accepted == 0:
                return True
            sched = engine.slot_schedule()
            if sched.makespan_s > slot_cap * (1 + 1e-9):
                cols[:] = snapshot
                reload(cols)
                iters -= accepted  # rolled back: not part of the plan
                accepted = 0
                return False
            snapshot = cols.copy()
            accepted = 0
            return True

        # cheaper-platform options depend only on (asset row, current col):
        # memoize so 10k partitions of one asset don't re-sort 10k times
        opt_cache: dict[tuple[int, int], list[int]] = {}

        def options(r: int, cur_col: int) -> list[int]:
            ck = (int(r), cur_col)
            out = opt_cache.get(ck)
            if out is None:
                cur_c = cand.cost[r, cur_col]
                out = sorted(
                    (j for j in range(len(cand.platforms))
                     if np.isfinite(cand.cost[r, j]) and
                     cand.cost[r, j] < cur_c),
                    key=lambda j: (cand.cost[r, j], cand.sched[r, j], j))
                opt_cache[ck] = out
            return out

        improved = True
        alive = True
        while improved and alive and iters < budget:
            improved = False
            slack = engine.slack()
            order = np.lexsort((parts_arr, assets_arr, -slack))
            for t in order:
                if iters >= budget:
                    break
                t = int(t)
                r = rows[t]
                cur_col = int(cols[t])
                cur_d = cand.sched[r, cur_col]
                for j in options(r, cur_col):
                    extra = cand.sched[r, j] - cur_d
                    if extra > slack[t] * (1 + 1e-12) + 1e-9:
                        continue  # cannot fit even in this task's slack
                    ms, undo = engine.try_duration(
                        t, cand.sched[r, j], cand.platforms[j])
                    if ms <= cap:
                        cols[t] = j
                        improved = True
                        iters += 1
                        accepted += 1
                        if accepted >= chunk and not validate():
                            alive = False
                        break
                    undo()
                if not alive:
                    break
        if alive:
            validate()
        return iters


def plan_run(graph: AssetGraph, factory: DynamicClientFactory,
             targets: "AssetSelection | str | list[str] | None" = None,
             objective: Objective | None = None,
             slots: SlotConfig | None = SlotConfig(),
             store: MaterializationStore | None = None,
             force: bool = False) -> RunPlan:
    """One-shot convenience wrapper around ``RunPlanner``."""
    return RunPlanner(graph, factory, slots=slots, store=store).plan(
        targets, objective, force=force)


# re-exported for code that imports the old private name
_CRITICAL_EPS = CRITICAL_EPS
