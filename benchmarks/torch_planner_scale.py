"""Planner scale sweep: the incremental, slot-aware scheduling engine vs the
legacy full-recompute planner on 100 -> 10,000-task DAGs.

The port's copy of ``benchmarks/planner_scale.py`` on ``repro_torch.core``,
``_LegacyPlanner`` (the PR-2 planner, the yardstick) included; no tensor
work, so its times are the host's.  Writes
``BENCH_torch_planner_scale.json`` (``_smoke`` with ``--smoke``), gated by
the unchanged ``check_planner_regression.py`` against
``benchmarks/baselines/torch_planner_scale_baseline.json``.

``_LegacyPlanner`` below is a faithful port of the PR-2 ``RunPlanner``: an
infinite-width critical-path schedule re-run over all *n* tasks for every
upgrade/downgrade candidate trial.  The current ``RunPlanner`` replaces that
with ``core.schedule.ScheduleEngine`` — O(cone) incremental retiming, lazy
slack, vectorized pricing and a finite-capacity list schedule.

For every (shape x size) cell we time both planners and evaluate both plans
under the *same* slot-aware evaluator (``SlotConfig()`` — the coordinator's
execution limits), so the quality comparison reflects realized makespans,
not the legacy planner's infinite-width beliefs:

* ``makespan_ok`` — the new plan's realized (slot-aware) makespan is never
  worse than legacy's;
* ``cost_ok`` — the new plan costs no more than legacy (0.5% tolerance for
  upgrade-ordering noise: batched rounds occasionally buy a different but
  equally-critical sibling than legacy's one-at-a-time loop), *or* legacy's
  plan broke the planner contract — realized makespan slower than greedy as
  executed — in which case its lower sticker price bought a plan the
  planner is not allowed to return.

On fan-out shapes the legacy planner looks fast: its infinite-width model
sees no contention, so it skips nearly all optimization work — and ships a
plan whose realized makespan exceeds the greedy envelope.  The speedup
headline therefore reports the geometric mean across shapes alongside the
per-shape numbers.

Writes ``BENCH_planner_scale.json``; CI's bench-smoke job re-runs the
100/1,000 sizes (``--smoke``) and ``check_planner_regression.py`` fails on a
>1.5x plan-time regression at 1,000 tasks vs the committed baseline.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

# make `python benchmarks/torch_planner_scale.py` work from the root
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)

from repro_torch.core import (AssetGraph, ComputeProfile, CostModel,  # noqa: E402
                        DynamicClientFactory, Objective, RunPlanner,
                        ScheduleEngine, SlotConfig, asset, default_catalog,
                        task_dag)
from repro_torch.core.partitions import StaticPartitions  # noqa: E402

SIZES = (100, 1000, 10000)
SMOKE_SIZES = (100, 1000)
TIME_VALUE = 600.0


# --------------------------------------------------------------- DAG shapes
def _work(i: int) -> float:
    """Deterministic per-task work variation so upgrade/downgrade moves
    exist at every scale."""
    return 20.0 + (i % 7) * 33.0


def _cls(i: int) -> str:
    return ("scan", "shuffle", "light")[i % 3]


def _leaf(name: str, work: float, cls: str = "scan", deps=(), parts=None):
    return asset(name=name, deps=deps, partitions=parts,
                 compute=ComputeProfile(work_chip_hours=work,
                                        speedup_class=cls, min_chips=8))(
        lambda ctx, **kw: name)


def chain_graph(n: int):
    """Pure chain: every task is critical."""
    specs = [_leaf("s0", _work(0))]
    for i in range(1, n):
        specs.append(_leaf(f"s{i:05d}", _work(i), _cls(i),
                           deps=(specs[-1].name,)))
    return AssetGraph(specs), [specs[-1].name]


def fanout_graph(n: int):
    """One source, n-2 parallel branches, one sink — maximal slot pressure."""
    specs = [_leaf("src", 5.0)]
    for i in range(n - 2):
        specs.append(_leaf(f"b{i:05d}", _work(i), _cls(i), deps=("src",)))
    specs.append(_leaf("sink", 5.0, "light",
                       deps=tuple(s.name for s in specs[1:])))
    return AssetGraph(specs), ["sink"]


def diamond_graph(n: int):
    """Back-to-back unbalanced diamonds (width 4)."""
    specs = [_leaf("d00000", _work(0))]
    i = 1
    while len(specs) < n - 4:
        top = specs[-1].name
        mids = []
        for w in range(4):
            s = _leaf(f"d{i:05d}", _work(i + w) * (3.0 if w == 0 else 1.0),
                      _cls(i + w), deps=(top,))
            specs.append(s)
            mids.append(s.name)
            i += 1
        specs.append(_leaf(f"d{i:05d}", 10.0, "light", deps=tuple(mids)))
        i += 1
    return AssetGraph(specs), [specs[-1].name]


def partitioned_graph(n: int):
    """Partitioned fan-in: the Common-Crawl shape at scale."""
    parts = StaticPartitions(tuple(f"p{i:05d}" for i in range(max(2, n - 1))))
    shards = _leaf("shards", 120.0, parts=parts)
    merged = _leaf("merged", 40.0, "shuffle", deps=("shards",))
    return AssetGraph([shards, merged]), ["merged"]


SHAPES = {
    "chain": chain_graph,
    "fanout": fanout_graph,
    "diamond": diamond_graph,
    "partitioned_fanin": partitioned_graph,
}


# ------------------------------------------------------ legacy (PR-2) port
class _LegacyPlanner:
    """The pre-engine planner: full critical-path reschedule per candidate
    trial, infinite platform width, per-task Python pricing loops.  Kept
    here (not in src/) purely as the benchmark baseline."""

    def __init__(self, graph, factory, max_iterations: int = 1000):
        self.graph = graph
        self.factory = factory
        self.max_iterations = max_iterations

    def _tasks(self, targets):
        from repro_torch.core.partitions import (dep_partition_keys,
                                                 partition_keys)
        order = self.graph.topo_order(targets)
        keys, preds = [], {}
        for name in order:
            spec = self.graph[name]
            for key in partition_keys(spec.partitions):
                tk = (name, key)
                keys.append(tk)
                preds[tk] = [
                    (d, dk) for d in spec.deps
                    for dk in dep_partition_keys(
                        self.graph[d].partitions, key)]
        return keys, preds

    def _candidates(self, keys):
        cm = self.factory.cost_model
        by_asset, out = {}, {}
        for name, _part in keys:
            if name not in by_asset:
                spec = self.graph[name]
                cands = []
                for pname, platform in self.factory.catalog.items():
                    if spec.platform_hint and pname != spec.platform_hint:
                        continue
                    est = cm.estimate(spec, platform)
                    if not est.feasible:
                        continue
                    cands.append((pname,
                                  cm.expected_cost_with_retries(est, platform),
                                  est.duration_s))
                by_asset[name] = cands
            out[(name, _part)] = by_asset[name]
        return out

    @staticmethod
    def _schedule(keys, preds, durations):
        finish = {}
        for tk in keys:
            start = max((finish[p] for p in preds[tk]), default=0.0)
            finish[tk] = start + durations[tk]
        makespan = max(finish.values(), default=0.0)
        succs = {tk: [] for tk in keys}
        for tk in keys:
            for p in preds[tk]:
                succs[p].append(tk)
        latest = {}
        for tk in reversed(keys):
            latest[tk] = min(
                (latest[s] - durations[s] for s in succs[tk]),
                default=makespan)
        slack = {tk: latest[tk] - finish[tk] for tk in keys}
        return makespan, slack

    def plan(self, targets, objective):
        obj = objective
        keys, preds = self._tasks(targets)
        cands = self._candidates(keys)
        durations = lambda assign: {tk: c[2] for tk, c in assign.items()}
        tv = obj.time_value_usd_per_hour
        greedy = {tk: min(cs, key=lambda c: c[1] + tv * c[2] / 3600.0)
                  for tk, cs in cands.items()}
        greedy_ms, _ = self._schedule(keys, preds, durations(greedy))
        target_ms = greedy_ms
        assign = {tk: min(cs, key=lambda c: (c[1], c[2]))
                  for tk, cs in cands.items()}
        iters = 0
        ms, slack = self._schedule(keys, preds, durations(assign))
        eps = 1e-9
        while ms > target_ms and iters < self.max_iterations:
            iters += 1
            best = None
            for tk in keys:
                if slack[tk] > eps * max(ms, 1.0):
                    continue
                cur = assign[tk]
                for c in cands[tk]:
                    saved = cur[2] - c[2]
                    if saved <= 0:
                        continue
                    rate = saved / max(c[1] - cur[1], 1e-9)
                    if best is None or rate > best[0]:
                        best = (rate, tk, c)
            if best is None:
                break
            assign[best[1]] = best[2]
            ms, slack = self._schedule(keys, preds, durations(assign))
        if ms > greedy_ms * (1 + 1e-9):
            assign = dict(greedy)
            ms, slack = self._schedule(keys, preds, durations(assign))
        improved = True
        while improved and iters < self.max_iterations:
            improved = False
            for tk in sorted(keys, key=lambda k: -slack[k]):
                cur = assign[tk]
                for c in sorted(cands[tk], key=lambda c: c[1]):
                    if c[1] >= cur[1]:
                        break
                    if c[2] > cur[2] + slack[tk]:
                        continue
                    trial = dict(assign)
                    trial[tk] = c
                    tms, tslack = self._schedule(keys, preds,
                                                 durations(trial))
                    if tms <= max(ms, target_ms) * (1 + 1e-12):
                        assign, ms, slack = trial, tms, tslack
                        improved = True
                        iters += 1
                        break
        return {tk: {"platform": c[0], "cost": c[1], "dur": c[2]}
                for tk, c in assign.items()}, iters


# ------------------------------------------------------------- evaluation
def _evaluate(graph, targets, assignment: dict, slots: SlotConfig):
    """Slot-aware realized cost/makespan of any (task -> platform/cost/dur)
    assignment — the common yardstick for both planners."""
    keys, preds = task_dag(graph, targets)
    engine = ScheduleEngine(keys, preds, slots)
    engine.load([assignment[k]["dur"] for k in keys],
                [assignment[k]["platform"] for k in keys])
    sched = engine.slot_schedule()
    return (sum(a["cost"] for a in assignment.values()), sched.makespan_s)


def _factory():
    return DynamicClientFactory(default_catalog(), CostModel(),
                                Objective.balanced(TIME_VALUE))


def run_cell(shape: str, size: int, repeats: int = 3,
             with_legacy: bool = True) -> dict:
    graph, targets = SHAPES[shape](size)
    slots = SlotConfig()
    factory = _factory()

    best_new = float("inf")
    plan = None
    for _ in range(repeats):
        t0 = time.perf_counter()
        plan = RunPlanner(graph, factory, slots=slots).plan(targets)
        best_new = min(best_new, time.perf_counter() - t0)
    new_assign = {tk: {"platform": c.platform, "cost": c.expected_cost_usd,
                       "dur": c.estimate.duration_s}
                  for tk, c in plan.choices.items()}
    new_cost, new_ms = _evaluate(graph, targets, new_assign, slots)
    greedy_env_ms = plan.greedy_makespan_s  # greedy as executed under slots

    out = {
        "n_tasks": len(plan.choices),
        "new": {"plan_time_s": round(best_new, 4),
                "cost_usd": round(new_cost, 2),
                "slot_makespan_h": round(new_ms / 3600.0, 3),
                "predicted_makespan_h": round(
                    plan.predicted_makespan_s / 3600.0, 3),
                "iterations": plan.iterations},
        "greedy_envelope_h": round(greedy_env_ms / 3600.0, 3),
    }
    if with_legacy:
        # best-of-2 at CI sizes so the normalized regression gate isn't at
        # the mercy of one noisy sub-100ms sample; single run at 10k where
        # legacy takes minutes
        legacy_t = float("inf")
        for _ in range(2 if size <= 1000 else 1):
            t0 = time.perf_counter()
            legacy_assign, legacy_iters = _LegacyPlanner(graph, factory).plan(
                targets, factory.objective)
            legacy_t = min(legacy_t, time.perf_counter() - t0)
        legacy_cost, legacy_ms = _evaluate(graph, targets, legacy_assign,
                                           slots)
        legacy_breaks_envelope = legacy_ms > greedy_env_ms * (1 + 1e-6)
        out["legacy"] = {"plan_time_s": round(legacy_t, 4),
                         "cost_usd": round(legacy_cost, 2),
                         "slot_makespan_h": round(legacy_ms / 3600.0, 3),
                         "iterations": legacy_iters,
                         "breaks_greedy_envelope": bool(
                             legacy_breaks_envelope)}
        out["speedup"] = round(legacy_t / max(best_new, 1e-9), 2)
        out["makespan_ok"] = bool(new_ms <= legacy_ms * (1 + 1e-6))
        out["cost_ok"] = bool(
            new_cost <= legacy_cost * 1.005 or legacy_breaks_envelope)
    return out


def run(sizes=SIZES, with_legacy: bool = True) -> dict:
    out: dict = {"time_value_usd_per_hour": TIME_VALUE,
                 "slots": dataclass_dict(SlotConfig()), "shapes": {}}
    worst = None
    for shape in SHAPES:
        out["shapes"][shape] = {}
        for size in sizes:
            cell = run_cell(shape, size, with_legacy=with_legacy)
            out["shapes"][shape][str(size)] = cell
            print(f"{shape:>18} n={size:>6}: new {cell['new']['plan_time_s']:.3f}s"
                  + (f"  legacy {cell['legacy']['plan_time_s']:.3f}s"
                     f"  speedup {cell['speedup']:.1f}x"
                     f"  cost_ok={cell['cost_ok']}"
                     f"  makespan_ok={cell['makespan_ok']}"
                     if with_legacy else ""),
                  flush=True)
            if with_legacy:
                if worst is None or cell["speedup"] < worst:
                    worst = cell["speedup"]
    if with_legacy:
        largest = str(max(sizes))
        at_largest = {s: out["shapes"][s][largest]["speedup"]
                      for s in SHAPES}
        geo = 1.0
        for v in at_largest.values():
            geo *= max(v, 1e-9)
        geo **= 1.0 / len(at_largest)
        out["summary"] = {
            "largest_size": int(largest),
            "min_speedup": worst,
            "speedup_at_largest": at_largest,
            "geomean_speedup_at_largest": round(geo, 2),
            "all_cost_ok": all(
                c["cost_ok"] for s in out["shapes"].values()
                for c in s.values()),
            "all_makespan_ok": all(
                c["makespan_ok"] for s in out["shapes"].values()
                for c in s.values()),
        }
    return out


def dataclass_dict(s: SlotConfig) -> dict:
    return {"max_concurrent": s.max_concurrent,
            "platform_slots": s.platform_slots,
            "elastic_max_slots": s.elastic_max_slots}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--smoke", action="store_true",
                    help="CI subset: sizes 100/1000 only")
    ap.add_argument("--out", default=None,
                    help="output path (default: "
                         "BENCH_torch_planner_scale.json, or "
                         "BENCH_torch_planner_scale_smoke.json with --smoke)")
    args = ap.parse_args()
    out = args.out or ("BENCH_torch_planner_scale_smoke.json" if args.smoke
                       else "BENCH_torch_planner_scale.json")
    sizes = SMOKE_SIZES if args.smoke else SIZES
    res = run(sizes=sizes)
    res["smoke"] = args.smoke
    with open(out, "w") as f:
        json.dump(res, f, indent=1, default=float)
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
