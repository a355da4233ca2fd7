"""Planner vs greedy: sweep DAG shapes, compare predicted AND simulated
cost/makespan of the global ``RunPlanner`` against the per-task greedy
``DynamicClientFactory.choose``.

The port's copy of ``benchmarks/planner_vs_greedy.py`` on
``repro_torch.core``: the same sweep and the same numbers (no tensor work).
Writes ``BENCH_torch_planner_vs_greedy.json`` (``_smoke`` with
``--smoke``, the two fastest graphs).

    python benchmarks/torch_planner_vs_greedy.py [--smoke] [--out FILE]

Each sweep configuration builds a graph, plans it, then *executes* both
policies through the ``RunCoordinator`` with deterministic simulated clients
(fault injection off, fixed run_ids) so the deltas are reproducible.  The
planner's contract — cost <= greedy at equal-or-better makespan — is checked
per configuration and summarized as ``n_dominates``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

# make `python benchmarks/torch_planner_vs_greedy.py` work from the root
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)

from repro_torch.core import (AssetGraph, ComputeProfile, CostModel,
                        DynamicClientFactory, Objective, RunCoordinator,
                        RunPlanner, SimulatedClusterClient, StaticPartitions,
                        asset, default_catalog)  # noqa: E402

SCAN = "scan"


def _leaf(name: str, work: float, cls: str = SCAN, deps=(), parts=None):
    return asset(name=name, deps=deps, partitions=parts,
                 compute=ComputeProfile(work_chip_hours=work,
                                        speedup_class=cls, min_chips=8))(
        lambda ctx, **kw: name)


def chain_graph(n: int = 5) -> tuple[AssetGraph, list[str]]:
    """Pure chain: every task is critical — planner == greedy makespan."""
    specs = [_leaf("s0", 60.0)]
    for i in range(1, n):
        specs.append(_leaf(f"s{i}", 60.0, deps=(f"s{i-1}",)))
    return AssetGraph(specs), [f"s{n-1}"]


def fanout_graph(width: int = 6) -> tuple[AssetGraph, list[str]]:
    """One heavy critical branch, many light ones with slack."""
    specs = [_leaf("src", 10.0)]
    for i in range(width):
        work = 500.0 if i == 0 else 50.0
        specs.append(_leaf(f"b{i}", work, deps=("src",)))
    specs.append(_leaf("sink", 10.0, cls="light",
                       deps=tuple(f"b{i}" for i in range(width))))
    return AssetGraph(specs), ["sink"]


def diamond_graph() -> tuple[AssetGraph, list[str]]:
    """Two unbalanced diamonds back to back."""
    specs = [
        _leaf("a", 20.0),
        _leaf("b1", 300.0, deps=("a",)),
        _leaf("b2", 30.0, cls="shuffle", deps=("a",)),
        _leaf("c", 20.0, cls="light", deps=("b1", "b2")),
        _leaf("d1", 200.0, deps=("c",)),
        _leaf("d2", 25.0, cls="shuffle", deps=("c",)),
        _leaf("e", 10.0, cls="light", deps=("d1", "d2")),
    ]
    return AssetGraph(specs), ["e"]


def partitioned_graph() -> tuple[AssetGraph, list[str]]:
    """Partitioned fan-in, the Common-Crawl shape at benchmark scale."""
    parts = StaticPartitions(("p0", "p1", "p2"))
    shards = asset(name="shards", partitions=parts,
                   compute=ComputeProfile(work_chip_hours=120.0,
                                          speedup_class=SCAN, min_chips=8))(
        lambda ctx, **kw: 0)
    merged = _leaf("merged", 40.0, cls="shuffle", deps=("shards",))
    return AssetGraph([shards, merged]), ["merged"]


SWEEP = {
    "chain": chain_graph,
    "fanout": fanout_graph,
    "diamond": diamond_graph,
    "partitioned_fanin": partitioned_graph,
}


def _nofail_factory(objective: Objective) -> DynamicClientFactory:
    return DynamicClientFactory(
        default_catalog(), CostModel(), objective,
        client_builder=lambda p: SimulatedClusterClient(
            p, seed=0, failure_rate=0.0, preemption_rate=0.0))


def run_config(name: str, objective: Objective) -> dict:
    graph, targets = SWEEP[name]()
    factory = _nofail_factory(objective)
    plan = RunPlanner(graph, factory).plan(targets)

    # both policies share one run_id: the clients' jitter RNG is keyed on
    # (run_id, asset, partition, attempt, platform), so a task that lands on
    # the same platform draws the same duration under either policy — the
    # comparison is paired, not noisy
    greedy_rep = RunCoordinator(
        graph, _nofail_factory(objective), use_cache=False).materialize(
        targets, run_id=f"pvg-{name}")
    planned_rep = RunCoordinator(
        graph, _nofail_factory(objective), use_cache=False).materialize(
        targets, run_id=f"pvg-{name}", plan=plan)

    out = {
        "n_tasks": len(plan.choices),
        "predicted": {
            "greedy_cost": round(plan.greedy_cost_usd, 2),
            "planned_cost": round(plan.predicted_cost_usd, 2),
            "greedy_makespan_h": round(plan.greedy_makespan_s / 3600.0, 3),
            "planned_makespan_h": round(
                plan.predicted_makespan_s / 3600.0, 3),
        },
        "simulated": {
            "greedy_cost": round(greedy_rep.total_cost, 2),
            "planned_cost": round(planned_rep.total_cost, 2),
            "greedy_makespan_h": round(greedy_rep.makespan_s() / 3600.0, 3),
            "planned_makespan_h": round(
                planned_rep.makespan_s() / 3600.0, 3),
        },
        "iterations": plan.iterations,
    }
    out["dominates_predicted"] = (
        plan.predicted_cost_usd <= plan.greedy_cost_usd + 1e-9
        and plan.predicted_makespan_s <= plan.greedy_makespan_s + 1e-9)
    out["cost_saving_pct"] = round(
        100.0 * (1.0 - plan.predicted_cost_usd
                 / max(plan.greedy_cost_usd, 1e-9)), 2)
    return out


def run(smoke: bool = False,
        time_value: float = 600.0) -> dict:
    """Sweep all shapes.  ``smoke`` restricts to the two fastest graphs."""
    objective = Objective.balanced(time_value)
    names = ["chain", "fanout"] if smoke else list(SWEEP)
    out: dict = {n: run_config(n, objective) for n in names}
    out["summary"] = {
        "n_configs": len(names),
        "n_dominates": sum(1 for n in names
                           if out[n]["dominates_predicted"]),
        "max_cost_saving_pct": max(out[n]["cost_saving_pct"]
                                   for n in names),
    }
    assert out["summary"]["n_dominates"] == len(names), \
        "planner failed to match greedy on every sweep configuration"
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--smoke", action="store_true",
                    help="the two fastest graphs only")
    ap.add_argument("--out", default=None,
                    help="default BENCH_torch_planner_vs_greedy.json, or "
                         "BENCH_torch_planner_vs_greedy_smoke.json with "
                         "--smoke")
    args = ap.parse_args()
    out = args.out or ("BENCH_torch_planner_vs_greedy_smoke.json"
                       if args.smoke else "BENCH_torch_planner_vs_greedy.json")
    res = run(smoke=args.smoke)
    with open(out, "w") as f:
        json.dump(res, f, indent=1, default=float)
    print(json.dumps(res, indent=1, default=float))
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
