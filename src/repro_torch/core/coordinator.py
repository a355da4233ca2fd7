"""Run Coordinator: DAG scheduling with retries, platform failover,
speculative straggler re-execution and elastic per-platform concurrency.

Failure semantics mirror the paper's operational reality (Fig 3): failed
attempts still bill (EMR burning money on flaky runs is why the mixed policy
wins), preemptions are distinguished from hard failures, and after
``retry.failover_after`` attempts on one platform the Dynamic Factory is
re-consulted with that platform deny-listed — the orchestration-level answer
to "EMR needs continual oversight".

Incremental materialization: before scheduling, staleness is resolved per
(asset, partition) against the content-addressed ``MaterializationStore``
(see store.py) and emitted as ``STALE`` telemetry; at launch time each task
re-checks its fingerprint against the now-materialized upstream data hashes,
so a warm cache executes zero tasks and an upstream that reproduces
byte-identical data cuts its downstream cone off early.  ``force=True``
rebuilds the selection unconditionally.
"""
from __future__ import annotations

import dataclasses
import time
import uuid
from typing import Any

from repro_torch.core.adaptive import AdaptiveConfig, AdaptiveController
from repro_torch.core.assets import AssetGraph, AssetSpec
from repro_torch.core.clients import JobSpec, PlatformError, RunHandle
from repro_torch.core.context import ContextInjector
from repro_torch.core.costmodel import CostEstimate
from repro_torch.core.factory import DynamicClientFactory, Objective
from repro_torch.core.faults import FaultPlan
from repro_torch.core.journal import JournalState, RunJournal
from repro_torch.core.partitions import dep_partition_keys, partition_keys
from repro_torch.core.planner import RunPlan, RunPlanner
from repro_torch.core.schedule import ScheduleEngine, SlotConfig, task_dag
from repro_torch.core.selection import AssetSelection
from repro_torch.core.store import (MaterializationStore, code_version,
                              resolve_staleness)
from repro_torch.core.telemetry import MessageReader


@dataclasses.dataclass
class AttemptRecord:
    platform: str
    status: str  # success | failure | preemption | cancelled
    sim_duration_s: float
    cost_usd: float
    speculative: bool = False
    error: str = ""


@dataclasses.dataclass
class TaskRecord:
    asset: str
    partition: str
    attempts: list[AttemptRecord] = dataclasses.field(default_factory=list)
    status: str = "pending"
    cached: bool = False

    @property
    def platform(self) -> str:
        return self.attempts[-1].platform if self.attempts else ""

    @property
    def total_sim_s(self) -> float:
        return sum(a.sim_duration_s for a in self.attempts)

    @property
    def serial_sim_s(self) -> float:
        """Wall-clock the task occupied its slot chain: retries serialize,
        but a speculative twin that *lost* ran concurrently with the primary
        and must not be double-counted (a twin that won is the attempt the
        task finished on, so it stays)."""
        return sum(a.sim_duration_s for a in self.attempts
                   if not (a.speculative and a.status != "success"))

    @property
    def total_cost(self) -> float:
        return sum(a.cost_usd for a in self.attempts)


@dataclasses.dataclass
class RunReport:
    run_id: str
    records: list[TaskRecord]
    graph: AssetGraph

    @property
    def ok(self) -> bool:
        return all(r.status == "success" for r in self.records)

    @property
    def total_cost(self) -> float:
        return sum(r.total_cost for r in self.records)

    def slot_makespan_s(self, slots: SlotConfig | None = None) -> float:
        """Slot-aware simulated makespan: replay the recorded attempt
        durations (retries serialize within a task) through the same
        finite-capacity list scheduler the planner predicts with, on the
        platform each task actually ran on.  This is the number a planner
        prediction should match under contention."""
        if not self.records:
            return 0.0
        recs = {(r.asset, r.partition): r for r in self.records}
        keys, preds = task_dag(self.graph,
                               sorted({r.asset for r in self.records}))
        keys = [k for k in keys if k in recs]
        engine = ScheduleEngine(
            keys, {k: [p for p in preds[k] if p in recs] for k in keys},
            slots)
        engine.load([recs[k].serial_sim_s for k in keys],
                    [recs[k].platform or "local" for k in keys])
        return engine.slot_schedule().makespan_s if slots is not None \
            else engine.makespan_s

    def makespan_s(self) -> float:
        """Critical-path simulated duration through the (asset, partition) DAG."""
        finish: dict[tuple[str, str], float] = {}
        by_asset: dict[str, list[TaskRecord]] = {}
        for r in self.records:
            by_asset.setdefault(r.asset, []).append(r)
        for name in self.graph.topo_order([r.asset for r in self.records]):
            spec = self.graph[name]
            for r in by_asset.get(name, []):
                dep_done = 0.0
                for d in spec.deps:
                    for dr in by_asset.get(d, []):
                        if dr.partition in (r.partition, "__all__") or \
                                r.partition == "__all__":
                            dep_done = max(dep_done,
                                           finish.get((d, dr.partition), 0.0))
                finish[(name, r.partition)] = dep_done + r.total_sim_s
        return max(finish.values()) if finish else 0.0

    def by_asset_cost(self) -> dict[str, float]:
        out: dict[str, float] = {}
        for r in self.records:
            out[r.asset] = out.get(r.asset, 0.0) + r.total_cost
        return out

    def summary(self) -> str:
        lines = [f"run {self.run_id}: {len(self.records)} tasks, "
                 f"cost ${self.total_cost:.2f}, "
                 f"makespan {self.makespan_s() / 3600.0:.2f} h, ok={self.ok}"]
        for r in self.records:
            lines.append(
                f"  {r.asset}[{r.partition}] -> {r.platform} "
                f"({len(r.attempts)} attempts, {r.status}"
                f"{', cached' if r.cached else ''}) "
                f"${r.total_cost:.2f} / {r.total_sim_s / 3600.0:.3f} h")
        return "\n".join(lines)


@dataclasses.dataclass
class _Task:
    spec: AssetSpec
    partition: str
    record: TaskRecord
    attempt: int = 0
    deny: set[str] = dataclasses.field(default_factory=set)
    handle: RunHandle | None = None
    spec_handle: RunHandle | None = None  # speculative duplicate
    speculated: bool = False  # at most one speculative twin per attempt
    estimate: CostEstimate | None = None
    spec_estimate: CostEstimate | None = None
    launched_at: float = 0.0
    next_eligible: float = 0.0
    fingerprint: str = ""
    code_version: str = ""
    upstream: dict[str, str] = dataclasses.field(default_factory=dict)
    #: resume: attempt -> platform the crashed run had launched it on, so
    #: re-execution replays the same (run_id, asset, partition, attempt,
    #: platform) key — deterministic clients then reproduce the attempt
    replay: dict[int, str] = dataclasses.field(default_factory=dict)


class RunCoordinator:
    def __init__(self, graph: AssetGraph, factory: DynamicClientFactory,
                 store: MaterializationStore | None = None,
                 reader: MessageReader | None = None,
                 injector: ContextInjector | None = None,
                 max_concurrent: int = 8,
                 platform_slots: int = 2,
                 elastic_max_slots: int = 8,
                 straggler_factor: float = 2.5,
                 straggler_min_s: float = 0.05,
                 enable_speculation: bool = True,
                 use_cache: bool = True,
                 slots: SlotConfig | None = None,
                 adaptive: "AdaptiveController | AdaptiveConfig | bool | None"
                 = None,
                 journal_dir: str | None = None,
                 faults: FaultPlan | None = None):
        graph.validate()
        self.graph = graph
        self.factory = factory
        self.store = store if store is not None else MaterializationStore()
        self.reader = reader or MessageReader()
        self.injector = injector or ContextInjector(reader=self.reader)
        self.injector.reader = self.reader
        # one slot configuration drives both execution (this class) and the
        # planner's finite-capacity schedule, so plan and run agree on what
        # a slot is; ``slots`` wins over the legacy per-field kwargs
        self.slots = slots or SlotConfig(max_concurrent=max_concurrent,
                                         platform_slots=platform_slots,
                                         elastic_max_slots=elastic_max_slots)
        self.straggler_factor = straggler_factor
        self.straggler_min_s = straggler_min_s
        self.enable_speculation = enable_speculation
        self.use_cache = use_cache
        # closed-loop adaptation (see core/adaptive.py): online cost model +
        # drift-triggered replanning + per-platform circuit breakers.  Pass
        # True (defaults), an AdaptiveConfig, or a prebuilt controller.
        if adaptive is True:
            adaptive = AdaptiveConfig()
        if isinstance(adaptive, AdaptiveConfig):
            adaptive = AdaptiveController(factory.catalog, factory.cost_model,
                                          adaptive)
        self.adaptive: AdaptiveController | None = adaptive or None
        self._dep_key_cache: dict[tuple[str, str], list[str]] = {}
        # crash consistency (see core/journal.py): with ``journal_dir`` set,
        # every task lifecycle transition is fsync'd to an append-only
        # write-ahead log and ``resume(run_id)`` can reopen a killed run.
        # ``faults`` threads a seeded FaultPlan through the journal's
        # record-boundary kill points (chaos testing).
        self.journal_dir = journal_dir
        self.faults = faults
        self._jrnl: RunJournal | None = None
        # (asset, partition, attempt) -> (sim_s, cost_usd) for attempts the
        # crashed run already billed but whose output never landed: the
        # resumed re-execution carries the journaled bill instead of
        # emitting a second one (exactly-once billing)
        self._prepaid: dict[tuple[str, str, int], tuple[float, float]] = {}

    # legacy attribute style stays writable, but reads/writes go through
    # self.slots so the launch loop and plan() can never disagree
    @property
    def max_concurrent(self) -> int:
        return self.slots.max_concurrent

    @max_concurrent.setter
    def max_concurrent(self, v: int) -> None:
        self.slots = dataclasses.replace(self.slots, max_concurrent=v)

    @property
    def platform_slots(self) -> int:
        return self.slots.platform_slots

    @platform_slots.setter
    def platform_slots(self, v: int) -> None:
        self.slots = dataclasses.replace(self.slots, platform_slots=v)

    @property
    def elastic_max_slots(self) -> int:
        return self.slots.elastic_max_slots

    @elastic_max_slots.setter
    def elastic_max_slots(self, v: int) -> None:
        self.slots = dataclasses.replace(self.slots, elastic_max_slots=v)

    # ------------------------------------------------------------------ api
    def plan(self, targets: "AssetSelection | str | list[str] | None" = None,
             objective=None, force: bool = False) -> RunPlan:
        """Global cost/deadline-aware platform assignment (see planner.py),
        predicted under this coordinator's own slot configuration and —
        when caching is enabled — against this coordinator's store, so
        fresh tasks are priced at ~0 and kept out of the slot schedule.

        With an adaptive controller attached, pricing goes through the
        online cost model (learned duration ratios and success rates),
        open-breaker platforms are dropped from the candidate catalog, and
        scheduling is preemption-aware (rework-inflated durations)."""
        store = self.store if self.use_cache else None
        factory, preemption_aware = self.factory, False
        if self.adaptive is not None:
            factory = self.adaptive.planning_factory(self.factory,
                                                     time.time())
            preemption_aware = True
        return RunPlanner(self.graph, factory, slots=self.slots,
                          store=store,
                          preemption_aware=preemption_aware).plan(
                              targets, objective, force=force)

    def materialize(self,
                    targets: "AssetSelection | str | list[str] | None" = None,
                    run_id: str | None = None,
                    plan: RunPlan | None = None,
                    force: bool = False,
                    _prior: JournalState | None = None) -> RunReport:
        """Execute the target selection.  ``targets`` accepts an
        ``AssetSelection``, a CLI selection string, the legacy ``list[str]``
        or ``None`` (everything); upstream deps are always materialized (or
        served from cache) as needed.  ``force`` bypasses the cache and
        rebuilds every selected task.  ``_prior`` is internal: the replayed
        journal state ``resume`` reconciles a crashed run from."""
        if plan is not None and not plan.feasible:
            raise ValueError(f"refusing to execute infeasible plan: "
                             f"{plan.reason}")
        run_id = run_id or uuid.uuid4().hex[:10]
        # the run-level objective replans are budgeted against (replanned
        # objectives hold *remaining* budget/deadline, so always derive from
        # this one, never from the current plan's)
        base_obj = plan.objective if plan is not None else self.factory.objective
        names = AssetSelection.coerce(targets).resolve(self.graph)
        order = self.graph.topo_order(names)
        tasks: dict[tuple[str, str], _Task] = {}
        records: list[TaskRecord] = []
        for name in order:
            spec = self.graph[name]
            for key in partition_keys(spec.partitions):
                rec = TaskRecord(asset=name, partition=key)
                records.append(rec)
                tasks[(name, key)] = _Task(spec=spec, partition=key, record=rec)

        # write-ahead journal: BEGIN (fresh run) / RESUME (reopened run)
        # is durable before any task is touched
        self._prepaid = {}
        jrnl = self._jrnl = (
            RunJournal(self.journal_dir, run_id, faults=self.faults)
            if self.journal_dir is not None else None)
        if jrnl is not None:
            if _prior is None:
                jrnl.append(
                    "BEGIN", targets=names, force=force,
                    planned=plan is not None, use_cache=self.use_cache,
                    adaptive=self.adaptive is not None,
                    objective={
                        "name": base_obj.name,
                        "time_value_usd_per_hour":
                            base_obj.time_value_usd_per_hour,
                        "budget_usd": base_obj.budget_usd,
                        "deadline_s": base_obj.deadline_s,
                    })
            else:
                jrnl.append(
                    "RESUME", resumes=_prior.resumes + 1,
                    spent_usd=round(_prior.spent_usd(), 6),
                    dropped_records=_prior.dropped_records,
                    frontier=sorted(f"{a}[{p}]"
                                    for a, p in _prior.frontier()))
        try:
            return self._run(run_id, base_obj, names, tasks, records, plan,
                             force, _prior)
        finally:
            if jrnl is not None:
                jrnl.close()
            self._jrnl = None

    def _run(self, run_id: str, base_obj, names: list[str],
             tasks: dict[tuple[str, str], _Task], records: list[TaskRecord],
             plan: RunPlan | None, force: bool,
             _prior: JournalState | None) -> RunReport:

        # upfront per-(asset, partition) staleness resolution: pessimistic
        # verdicts (stale upstream poisons downstream) drive telemetry and
        # match what plan() priced; the launch-time fingerprint check below
        # still grants early cutoff when a re-run upstream reproduces
        # byte-identical data
        if self.use_cache:
            for tk, st in resolve_staleness(
                    self.graph, self.store, names, force=force).items():
                if tk in tasks and not st.fresh:
                    self.reader.emit(run_id, tk[0], tk[1], "", "STALE",
                                     reason=st.reason)

        slots: dict[str, int] = {}  # platform -> current slot budget
        running: list[_Task] = []
        done: set[tuple[str, str]] = set()
        failed_hard: set[tuple[str, str]] = set()

        def deps_ready(t: _Task) -> bool:
            for d in t.spec.deps:
                dspec = self.graph[d]
                for k in self._dep_keys(dspec, t.partition):
                    if (d, k) not in done:
                        return False
            return True

        def dep_values(t: _Task) -> dict[str, Any]:
            vals: dict[str, Any] = {}
            for d in t.spec.deps:
                dspec = self.graph[d]
                keys = self._dep_keys(dspec, t.partition)
                if len(keys) == 1:
                    vals[d] = self.store.get(d, keys[0])
                else:
                    vals[d] = {k: self.store.get(d, k) for k in keys}
            return vals

        def upstream_hashes(t: _Task) -> dict[str, str] | None:
            """Content hashes of this task's upstream materializations, or
            ``None`` when any record is missing — a missing upstream forces
            staleness outright (no "?" placeholder that could collide with a
            real hash and fake freshness)."""
            out: dict[str, str] = {}
            for d in t.spec.deps:
                dspec = self.graph[d]
                for k in self._dep_keys(dspec, t.partition):
                    h = self.store.data_hash(d, k)
                    if h is None:
                        return None
                    out[f"{d}[{k}]"] = h
            return out

        cver: dict[str, str] = {}  # asset -> code version (memoized)

        pending = list(tasks.values())
        if _prior is not None:
            self._apply_prior(run_id, _prior, tasks, done, pending)
        while pending or running:
            # ---------------- launch ready tasks ------------------------
            now = time.time()
            # fleet-wide platform eviction: platforms with an open circuit
            # breaker are denied for every task (a half-open breaker admits
            # exactly one probe launch per cooldown)
            open_plats = (self.adaptive.open_platforms(now)
                          if self.adaptive is not None else set())
            launchable = [t for t in pending
                          if deps_ready(t) and now >= t.next_eligible]
            for t in launchable:
                if len(running) >= self.max_concurrent:
                    break
                # cache hit?  checked at launch time (deps are done) so an
                # upstream that re-ran but reproduced identical data still
                # short-circuits this task — early cutoff
                up = upstream_hashes(t)
                t.code_version = cver.get(t.spec.name) or cver.setdefault(
                    t.spec.name, code_version(t.spec))
                t.upstream = up or {}
                fp = self.store.fingerprint(t.code_version, t.partition,
                                            t.upstream) if up is not None \
                    else ""
                t.fingerprint = fp
                if self.use_cache and not force and fp and \
                        self.store.is_fresh(t.spec.name, t.partition, fp):
                    t.record.status = "success"
                    t.record.cached = True
                    done.add((t.spec.name, t.partition))
                    pending.remove(t)
                    self.reader.emit(run_id, t.spec.name, t.partition,
                                     "cache", "CACHE_HIT", fingerprint=fp)
                    self.reader.emit(run_id, t.spec.name, t.partition,
                                     "cache", "SUCCESS", duration_s=0.0,
                                     cached=True)
                    if self._jrnl is not None:
                        self._jrnl.append(
                            "SUCCESS", asset=t.spec.name,
                            partition=t.partition, platform="cache",
                            cached=True, fingerprint=fp,
                            data_hash=self.store.data_hash(
                                t.spec.name, t.partition))
                    # a resumed prepaid attempt resolved by early cutoff
                    # (upstream re-ran byte-identical): the crashed run's
                    # bill still belongs in this report
                    for pk in [k for k in self._prepaid
                               if k[:2] == (t.spec.name, t.partition)]:
                        sim_p, cost_p = self._prepaid.pop(pk)
                        t.record.attempts.append(AttemptRecord(
                            t.replay.get(pk[2], ""), "success", sim_p,
                            cost_p))
                    continue
                platform = est = None
                # resume replay: the crashed run journaled a LAUNCH for the
                # attempt we are about to make — re-launch it on the same
                # platform so the deterministic client key (run, asset,
                # partition, attempt, platform) reproduces the attempt
                rp = t.replay.get(t.attempt + 1)
                if rp is not None and rp in self.factory.catalog:
                    platform = self.factory.catalog[rp]
                    est = self.factory.cost_model.estimate(t.spec, platform)
                if plan is not None and platform is None:
                    pc = plan.choice(t.spec.name, t.partition)
                    if (pc is not None and pc.platform not in t.deny
                            and pc.platform not in open_plats
                            and pc.platform in self.factory.catalog):
                        platform = self.factory.catalog[pc.platform]
                        est = pc.estimate
                if platform is None:
                    # no plan, or the planned platform was deny-listed after
                    # failures / tripped its breaker: fall back to the
                    # greedy per-task factory
                    try:
                        platform, est = self.factory.choose(
                            t.spec, deny=t.deny | open_plats)
                    except RuntimeError:
                        try:
                            # breakers made it unsolvable: a sick platform
                            # beats no platform — ignore breakers, keep the
                            # per-task deny list
                            platform, est = self.factory.choose(t.spec,
                                                                deny=t.deny)
                        except RuntimeError:
                            # every platform deny-listed: reset and take the
                            # best remaining option (failures were transient)
                            t.deny.clear()
                            self.reader.emit(run_id, t.spec.name, t.partition,
                                             "", "DENY_RESET")
                            platform, est = self.factory.choose(t.spec)
                # elastic scaling: grow this platform's slot budget while a
                # backlog exists (paper: "automatic scaling")
                cur = slots.get(platform.name, self.platform_slots)
                in_use = sum(1 for r in running
                             if r.handle and r.handle.platform == platform.name)
                if in_use >= cur:
                    if cur < self.elastic_max_slots:
                        slots[platform.name] = cur + 1
                        self.reader.emit(run_id, t.spec.name, t.partition,
                                         platform.name, "SCALING",
                                         slots=cur + 1)
                    else:
                        continue  # saturated; try next loop
                t.attempt += 1
                t.estimate = est
                ctx = self.injector.build(run_id, t.spec, t.partition,
                                          platform, t.attempt)
                job = JobSpec(fn=t.spec.fn, args=(), kwargs=dep_values(t),
                              ctx=ctx, estimate=est)
                self.reader.emit(run_id, t.spec.name, t.partition,
                                 platform.name, "SUBMIT",
                                 attempt=t.attempt,
                                 est_usd=est.total_usd,
                                 est_duration_s=est.duration_s,
                                 planned=plan is not None)
                if self._jrnl is not None:
                    # WAL ordering: the LAUNCH record is durable before the
                    # job exists — a crash between the two re-launches an
                    # attempt that never ran (harmless), never the reverse
                    # (an attempt running with no record of it)
                    self._jrnl.append(
                        "LAUNCH", asset=t.spec.name, partition=t.partition,
                        platform=platform.name, attempt=t.attempt,
                        est_usd=est.total_usd, est_duration_s=est.duration_s)
                t.handle = self.factory.client(platform).submit(job)
                t.launched_at = now
                if self.adaptive is not None:
                    self.adaptive.note_launch(platform.name, now)
                pending.remove(t)
                running.append(t)
                self.reader.emit(run_id, t.spec.name, t.partition,
                                 platform.name, "START", attempt=t.attempt)

            # ---------------- check completions -------------------------
            time.sleep(0.0005)
            for t in list(running):
                prim, spec = t.handle, t.spec_handle
                prim_done = prim is not None and prim.done()
                spec_done = spec is not None and spec.done()
                if not (prim_done or spec_done):
                    self._maybe_speculate(run_id, t)
                    continue
                prim_ok = (prim_done and prim.error is None
                           and not prim.cancelled)
                spec_ok = (spec_done and spec is not None
                           and spec.error is None and not spec.cancelled)

                if prim_ok or spec_ok:
                    if prim_ok:
                        h, est, speculative, other, o_est = (
                            prim, t.estimate, False, spec, t.spec_estimate)
                    else:
                        h, est, speculative, other, o_est = (
                            spec, t.spec_estimate, True, prim, t.estimate)
                    running.remove(t)
                    if other is not None and not other.done():
                        other.cancelled = True
                        self.reader.emit(run_id, t.spec.name, t.partition,
                                         other.platform, "CANCEL",
                                         reason="speculative twin won")
                        t.record.attempts.append(AttemptRecord(
                            other.platform, "cancelled", 0.0, 0.0))
                    elif other is not None and other.error is not None:
                        self._record_failed_attempt(run_id, t, other, o_est)
                    self._on_success(run_id, t, h, est, speculative, done)
                    t.handle = t.spec_handle = None
                    continue

                # a speculative twin failed while the primary still runs:
                # bill + record it, drop the twin, keep waiting
                if spec_done and spec is not None and not spec_ok \
                        and not prim_done:
                    self._record_failed_attempt(run_id, t, spec,
                                                t.spec_estimate)
                    t.spec_handle = t.spec_estimate = None
                    continue

                # primary failed (twin absent, failed, or also finished)
                running.remove(t)
                if spec_done and spec is not None and not spec_ok:
                    self._record_failed_attempt(run_id, t, spec,
                                                t.spec_estimate)
                self._on_failure(run_id, t, prim, t.estimate, pending,
                                 failed_hard)
                t.handle = t.spec_handle = None

            # ---------------- closed loop: learn / trip / replan ---------
            if self.adaptive is not None:
                plan = self._adaptive_step(run_id, names, base_obj, plan,
                                           tasks, pending, records, force)

        report = RunReport(run_id=run_id, records=records, graph=self.graph)
        if self._jrnl is not None:
            self._jrnl.append("END", ok=report.ok,
                              total_cost_usd=round(report.total_cost, 6),
                              tasks=len(records))
        return report

    def _adaptive_step(self, run_id: str, names: list[str], base_obj,
                       plan: RunPlan | None, tasks: dict,
                       pending: list, records: list,
                       force: bool) -> RunPlan | None:
        """One closed-loop tick: ingest fresh telemetry into the online
        model / drift detector / breakers, emit breaker transitions, and —
        when drift fires — replan the not-yet-launched tasks under the
        remaining budget/deadline.  Returns the (possibly new) plan."""
        ctl = self.adaptive
        outcomes, transitions = ctl.ingest(self.reader)
        for plat, state in transitions:
            self.reader.emit(run_id, "", "", plat, "BREAKER", state=state,
                             consecutive_failures=ctl.breakers[plat].consecutive)
        if not outcomes:
            return plan  # nothing new happened; drift verdict is unchanged
        now = time.time()
        reasons = ctl.should_replan(now)
        if not reasons or not pending:
            return plan
        # in-flight and finished tasks keep their assignments: replan only
        # what is still pending (the set of non-pending keys is
        # predecessor-closed — a task launches only after its deps finish)
        pending_keys = {(t.spec.name, t.partition) for t in pending}
        exclude = set(tasks) - pending_keys
        obj = base_obj
        spent = sum(r.total_cost for r in records)
        elapsed = RunReport(run_id, records, self.graph).makespan_s()
        remaining_budget = (None if obj.budget_usd is None
                            else obj.budget_usd - spent)
        remaining_deadline = (None if obj.deadline_s is None
                              else max(obj.deadline_s - elapsed, 0.0))
        planner = RunPlanner(
            self.graph, ctl.planning_factory(self.factory, now),
            slots=self.slots,
            store=self.store if self.use_cache else None,
            preemption_aware=True)
        try:
            new_plan = planner.plan(
                names, obj.constrained(budget_usd=remaining_budget,
                                       deadline_s=remaining_deadline),
                force=force, exclude=exclude)
        except RuntimeError:
            # e.g. every platform for some asset breaker-evicted AND
            # infeasible — keep flying on the old plan
            ctl.note_replanned(now, reasons, adopted=False)
            return plan
        adopted = new_plan.feasible
        ctl.note_replanned(now, reasons, adopted=adopted)
        self.reader.emit(
            run_id, "", "", "", "REPLAN", reasons=reasons,
            adopted=adopted, replans=ctl.replans,
            pending_tasks=len(pending_keys),
            predicted_cost_usd=new_plan.predicted_cost_usd,
            predicted_makespan_s=new_plan.predicted_makespan_s)
        if self._jrnl is not None:
            self._jrnl.append("REPLAN", adopted=adopted, reasons=reasons,
                              replans=ctl.replans,
                              pending=len(pending_keys))
        # an infeasible remainder-plan (budget already blown, deadline
        # already passed) is advice we cannot execute: keep the old plan
        return new_plan if adopted else plan

    # ------------------------------------------------------------ internals
    def _dep_keys(self, dspec: AssetSpec, partition: str) -> list[str]:
        # memoized: called from every deps_ready poll in the launch loop
        ck = (dspec.name, partition)
        out = self._dep_key_cache.get(ck)
        if out is None:
            out = dep_partition_keys(dspec.partitions, partition)
            self._dep_key_cache[ck] = out
        return out

    def _maybe_speculate(self, run_id: str, t: _Task) -> None:
        if (not self.enable_speculation or t.spec_handle is not None
                or t.speculated or t.handle is None):
            return
        med = self.reader.median_duration(t.spec.name)
        if med is None:
            return
        elapsed = time.time() - t.launched_at
        sim_scale = getattr(self.factory.client(
            self.factory.catalog[t.handle.platform]), "sim_time_scale", 0.0)
        if sim_scale <= 0.0:
            # pure-accounting mode: runs complete instantly, so wall-clock
            # carries no straggler signal — speculating here would just add
            # load-dependent nondeterminism (real clients always have one)
            return
        threshold = max(self.straggler_min_s,
                        self.straggler_factor * med * sim_scale)
        if elapsed < threshold:
            return
        try:
            platform, est = self.factory.choose(t.spec,
                                                deny={t.handle.platform})
        except RuntimeError:
            return
        ctx = self.injector.build(run_id, t.spec, t.partition, platform,
                                  t.attempt, overrides={"SPECULATIVE": "1"})
        # speculative duplicate re-reads inputs from the store
        vals = {}
        for d in t.spec.deps:
            dspec = self.graph[d]
            keys = self._dep_keys(dspec, t.partition)
            vals[d] = (self.store.get(d, keys[0]) if len(keys) == 1
                       else {k: self.store.get(d, k) for k in keys})
        job = JobSpec(fn=t.spec.fn, args=(), kwargs=vals, ctx=ctx,
                      estimate=est)
        if self._jrnl is not None:
            self._jrnl.append(
                "LAUNCH", asset=t.spec.name, partition=t.partition,
                platform=platform.name, attempt=t.attempt, speculative=True)
        t.spec_handle = self.factory.client(platform).submit(job)
        t.spec_estimate = est
        self.reader.emit(run_id, t.spec.name, t.partition, platform.name,
                         "SPECULATE", original=t.handle.platform)
        t.speculated = True

    def _bill(self, run_id: str, t: _Task, h: RunHandle,
              est: CostEstimate | None, outcome: str = "success",
              speculative: bool = False) -> tuple[float, float]:
        # exactly-once billing across crashes: an attempt the crashed run
        # already billed (success journaled, output never landed) carries
        # its journaled money forward instead of paying twice
        prepaid = (self._prepaid.pop((t.spec.name, t.partition, t.attempt),
                                     None) if not speculative else None)
        if prepaid is not None:
            sim, cost = prepaid
        else:
            est_total = est.total_usd if est else 0.0
            est_dur = est.duration_s if est else 1e-9
            sim = h.sim_duration_s or max(h.finished - h.started, 1e-9)
            cost = est_total * (sim / max(est_dur, 1e-9))
        if self._jrnl is not None and prepaid is None:
            # money truth: the BILL record is durable before the store put /
            # telemetry — resume trusts the journal, never re-derives spend
            self._jrnl.append(
                "BILL", asset=t.spec.name, partition=t.partition,
                platform=h.platform, attempt=t.attempt, cost_usd=cost,
                sim_duration_s=sim, outcome=outcome, speculative=speculative,
                est_duration_s=(est.duration_s if est else 0.0))
        # outcome + predicted duration ride along so the adaptive
        # controller can learn realized/predicted ratios and success rates
        # from the COST stream alone
        self.reader.emit(run_id, t.spec.name, t.partition, h.platform,
                         "COST", total_usd=cost, duration_s=sim,
                         attempt=t.attempt, outcome=outcome,
                         prepaid=prepaid is not None,
                         est_duration_s=(est.duration_s if est else 0.0))
        return sim, cost

    def _record_failed_attempt(self, run_id: str, t: _Task, h: RunHandle,
                               est: CostEstimate | None) -> None:
        """A failed handle that does NOT end the task (e.g. a speculative
        twin): billed and recorded, no retry bookkeeping."""
        kind = (h.error.kind if isinstance(h.error, PlatformError)
                else "failure")
        sim, cost = self._bill(run_id, t, h, est, outcome=kind,
                               speculative=True)
        t.record.attempts.append(AttemptRecord(
            h.platform, kind, sim, cost, speculative=True,
            error=str(h.error)))
        self.reader.emit(run_id, t.spec.name, t.partition, h.platform,
                         "FAILURE", attempt=t.attempt, failure_kind=kind,
                         speculative=True, error=str(h.error))

    def _on_success(self, run_id: str, t: _Task, h: RunHandle,
                    est: CostEstimate | None, speculative: bool,
                    done: set) -> None:
        # write ordering contract: BILL (journal) -> put (store) -> SUCCESS
        # (journal).  A crash after BILL but before put leaves a success-
        # billed attempt with no data: resume re-runs it prepaid.  A crash
        # after put but before SUCCESS leaves landed data: resume trusts
        # the store (data truth) and marks the task done.
        sim, cost = self._bill(run_id, t, h, est, outcome="success",
                               speculative=speculative)
        self.store.put(t.spec.name, t.partition, h.result, t.fingerprint,
                       meta={"platform": h.platform, "run_id": run_id},
                       code_version=t.code_version, upstream=t.upstream)
        if self._jrnl is not None:
            self._jrnl.append(
                "SUCCESS", asset=t.spec.name, partition=t.partition,
                platform=h.platform, attempt=t.attempt,
                fingerprint=t.fingerprint, speculative=speculative,
                data_hash=self.store.data_hash(t.spec.name, t.partition))
        t.record.attempts.append(AttemptRecord(
            h.platform, "success", sim, cost, speculative))
        t.record.status = "success"
        done.add((t.spec.name, t.partition))
        self.reader.emit(run_id, t.spec.name, t.partition, h.platform,
                         "MATERIALIZE", fingerprint=t.fingerprint)
        self.reader.emit(run_id, t.spec.name, t.partition, h.platform,
                         "SUCCESS", duration_s=sim, cost_usd=cost,
                         speculative=speculative)

    def _on_failure(self, run_id: str, t: _Task, h: RunHandle,
                    est: CostEstimate | None, pending: list,
                    failed_hard: set) -> None:
        kind = (h.error.kind if isinstance(h.error, PlatformError)
                else "failure")
        sim, cost = self._bill(run_id, t, h, est, outcome=kind)
        t.record.attempts.append(AttemptRecord(
            h.platform, kind, sim, cost, error=str(h.error)))
        self.reader.emit(run_id, t.spec.name, t.partition, h.platform,
                         "FAILURE", attempt=t.attempt, failure_kind=kind,
                         error=str(h.error))
        if t.attempt >= t.spec.retry.max_attempts:
            t.record.status = "failed"
            failed_hard.add((t.spec.name, t.partition))
            if self._jrnl is not None:
                # durable tombstone: resume refuses to retry past an
                # exhausted budget instead of silently re-running the task
                self._jrnl.append(
                    "FAIL", asset=t.spec.name, partition=t.partition,
                    platform=h.platform, attempt=t.attempt,
                    error=str(h.error))
                self._jrnl.append("END", ok=False)
            raise RuntimeError(
                f"asset {t.spec.name}[{t.partition}] failed after "
                f"{t.attempt} attempts: {h.error}")
        if t.attempt >= t.spec.retry.failover_after:
            t.deny.add(h.platform)
            self.reader.emit(run_id, t.spec.name, t.partition, h.platform,
                             "FAILOVER", deny=sorted(t.deny))
        self.reader.emit(run_id, t.spec.name, t.partition, h.platform,
                         "RETRY", attempt=t.attempt + 1)
        # capped exponential backoff with deterministic per-task jitter
        # (see RetryPolicy.delay_s) — retries decorrelate without RNG state
        t.next_eligible = time.time() + t.spec.retry.delay_s(
            t.attempt, (t.spec.name, t.partition))
        t.speculated = False  # the retry may speculate once again
        pending.append(t)

    # ------------------------------------------------------------ resume
    @staticmethod
    def _attempt_from_bill(b: dict) -> AttemptRecord:
        p = b["payload"]
        return AttemptRecord(
            b["platform"], p.get("outcome", "success"),
            p.get("sim_duration_s", 0.0), p.get("cost_usd", 0.0),
            speculative=bool(p.get("speculative")))

    def _apply_prior(self, run_id: str, prior: JournalState,
                     tasks: dict[tuple[str, str], _Task], done: set,
                     pending: list) -> None:
        """Reconcile the replayed journal against the store and prefill the
        fresh task table so only the crash frontier re-executes.

        Per task: *done* iff its output landed (store record written by this
        run, or a journaled SUCCESS whose record still exists — the store is
        data truth, the journal is money truth); journaled FAIL re-raises
        (the retry budget was exhausted durably); everything else replays —
        terminal bills prefill attempts/deny/backoff state, a success bill
        whose put never landed becomes *prepaid* (re-executed, not re-billed)
        and in-flight launches pin their attempt to the journaled platform
        so deterministic clients reproduce the interrupted attempt."""
        for tk, t in tasks.items():
            asset, part = tk
            bills = prior.bills_by_task.get(tk, [])
            if tk in prior.failed:
                if self._jrnl is not None:
                    self._jrnl.append("END", ok=False)
                raise RuntimeError(
                    f"asset {asset}[{part}] hard-failed in run "
                    f"{prior.run_id} (journaled FAIL after "
                    f"{max((b['attempt'] for b in bills), default=0)} "
                    f"attempts); resume will not retry past an exhausted "
                    f"attempt budget")
            rec = self.store.record(asset, part)
            landed = rec is not None and (
                tk in prior.succeeded
                or rec.get("meta", {}).get("run_id") == run_id)
            if landed:
                # a landed output only counts if every upstream it was built
                # from is itself carried-done with an unchanged data hash
                # (tasks iterate in topo order, so deps resolved first) — a
                # quarantined/re-running upstream demotes this task to the
                # frontier rather than letting it serve stale data
                for d in t.spec.deps:
                    for k in self._dep_keys(self.graph[d], part):
                        h = self.store.data_hash(d, k)
                        if (d, k) not in done or h is None or \
                                rec.get("upstream", {}).get(
                                    f"{d}[{k}]") != h:
                            landed = False
                            break
                    if not landed:
                        break
            if landed:
                # durably done: carry the journaled money into the report
                for b in bills:
                    t.record.attempts.append(self._attempt_from_bill(b))
                t.record.status = "success"
                t.record.cached = bool(
                    prior.succeeded.get(tk, {}).get("payload", {})
                    .get("cached"))
                t.attempt = max((b["attempt"] for b in bills), default=0)
                done.add(tk)
                pending.remove(t)
                self.reader.emit(run_id, asset, part, rec.get(
                    "meta", {}).get("platform", ""), "CARRIED",
                    attempts=len(bills))
                continue
            # replays: prefill terminal attempts the crashed run paid for
            success_bill = None
            for b in bills:
                if b["payload"].get("outcome") == "success" \
                        and success_bill is None:
                    success_bill = b  # goes prepaid, not into the report
                    continue
                t.record.attempts.append(self._attempt_from_bill(b))
                if not b["payload"].get("speculative") \
                        and b["attempt"] >= t.spec.retry.failover_after:
                    t.deny.add(b["platform"])
            failed_attempts = prior.terminal_attempts(tk)
            t.attempt = max(failed_attempts, default=0)
            if len(failed_attempts) >= t.spec.retry.max_attempts \
                    and success_bill is None:
                raise RuntimeError(
                    f"asset {asset}[{part}] exhausted its "
                    f"{t.spec.retry.max_attempts}-attempt budget in run "
                    f"{prior.run_id}; refusing to resume past it")
            if success_bill is not None:
                # crash fell between BILL and store.put: re-execute the
                # attempt, but carry the journaled money (exactly-once)
                p = success_bill["payload"]
                self._prepaid[(asset, part, success_bill["attempt"])] = (
                    p.get("sim_duration_s", 0.0), p.get("cost_usd", 0.0))
                t.replay[success_bill["attempt"]] = success_bill["platform"]
                t.attempt = success_bill["attempt"] - 1
            else:
                orphans = prior.in_flight().get(tk, [])
                if orphans:
                    # the launch the crash cut down: same attempt number +
                    # platform -> the deterministic client replays it
                    a = max(r["attempt"] for r in orphans)
                    for r in orphans:
                        t.replay[r["attempt"]] = r["platform"]
                    t.attempt = a - 1

    def _prior_makespan(self, prior: JournalState) -> float:
        """Simulated elapsed time the crashed run already consumed,
        reconstructed from its BILL records (feeds remaining-deadline)."""
        recs = []
        for tk, bills in prior.bills_by_task.items():
            r = TaskRecord(asset=tk[0], partition=tk[1])
            r.attempts = [self._attempt_from_bill(b) for b in bills]
            r.status = "success" if tk in prior.succeeded else "pending"
            recs.append(r)
        return RunReport(prior.run_id, recs, self.graph).makespan_s()

    def resume(self, run_id: str, replan: bool = True) -> RunReport:
        """Reopen a crashed run from its write-ahead journal.

        Replays the journal (torn-tail tolerant), sweeps the target cone's
        store records for integrity (corrupt blobs quarantine and re-run),
        warm-starts the adaptive controller from journaled bills, replans
        the remainder under the *remaining* budget/deadline, then executes
        only the crash frontier — done work is carried, billed attempts are
        never billed twice."""
        if self.journal_dir is None:
            raise ValueError("resume() requires a coordinator constructed "
                             "with journal_dir")
        recs, dropped = RunJournal.load(self.journal_dir, run_id)
        prior = JournalState.from_records(recs, dropped)
        if prior.ended and prior.ok:
            raise ValueError(f"run {run_id} already ended ok; "
                             f"nothing to resume")
        names = AssetSelection.coerce(prior.targets).resolve(self.graph)
        for name in self.graph.topo_order(names):
            for key in partition_keys(self.graph[name].partitions):
                self.store.verify(name, key)
        if self.adaptive is not None and prior.bills:
            self.adaptive.warm_start(prior.bills)
        plan = None
        if replan and prior.planned:
            obj = Objective(
                name=prior.objective.get("name",
                                         self.factory.objective.name),
                time_value_usd_per_hour=prior.objective.get(
                    "time_value_usd_per_hour",
                    self.factory.objective.time_value_usd_per_hour),
                budget_usd=prior.objective.get("budget_usd"),
                deadline_s=prior.objective.get("deadline_s"))
            remaining_budget = (
                None if obj.budget_usd is None
                else max(obj.budget_usd - prior.spent_usd(), 0.0))
            remaining_deadline = (
                None if obj.deadline_s is None
                else max(obj.deadline_s - self._prior_makespan(prior), 0.0))
            try:
                plan = self.plan(names, obj.constrained(
                    budget_usd=remaining_budget,
                    deadline_s=remaining_deadline))
            except RuntimeError:
                plan = None
            if plan is not None and not plan.feasible:
                # an unplannable remainder (budget already blown) must not
                # strand the run: fall back to greedy best-effort recovery
                plan = None
        return self.materialize(names, run_id=run_id, plan=plan,
                                force=prior.force, _prior=prior)
