"""Closed-loop adaptation benchmark: static plan vs adaptive coordinator
under injected platform drift on the Common-Crawl pipeline.

The port's copy of ``benchmarks/adaptive_drift.py`` on ``repro_torch.core``
and ``benchmarks/torch_cc_pipeline.py``: the crawl assets do their tensor
work on ``--device`` (default ``cuda``).  Writes
``BENCH_torch_adaptive.json`` (``_smoke`` with ``--smoke``), gated by the
unchanged ``check_adaptive_regression.py`` against
``benchmarks/baselines/torch_adaptive_drift_baseline.json``.

Reality diverges from the catalog on the *spot* platforms only: their
attempts run ``bias``x slower than the roofline estimate and suffer
failure/preemption rates the catalog never promised, while the premium
platform stays truthful.  Three drift levels:

* **none**   — reality matches the catalog exactly (no faults, bias 1.0);
* **mild**   — spot attempts 1.8x slow, preemptions up;
* **severe** — spot attempts 3.0x slow, 30% preemption, 10% hard failure.

Both arms start from the *same* static ``RunPlanner`` plan (min-cost: the
big ``edges`` tasks land on spot) and the same run id, so the deterministic
fault injection gives byte-identical behaviour until the closed loop
actually diverges:

* **static** — plain coordinator: per-task retries + failover only;
* **closed** — ``adaptive=AdaptiveConfig(...)``: the online cost model
  learns realized/predicted duration ratios from the early small ``nodes``
  tasks, the drift detector fires, and the coordinator replans the
  not-yet-launched ``edges``/``graph`` cone onto the truthful platform
  before the expensive work ever launches on the drifted one.

Checks: at zero drift the closed loop must match the static arm (it never
pays for adaptivity it does not need); at severe drift it must cut realized
slot-makespan by >= 15% and realized cost by > 0, via at least one adopted
replan.  ``check_adaptive_regression.py`` gates CI on these booleans plus
the makespan-reduction floor in
``benchmarks/baselines/adaptive_drift_baseline.json``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

# make `python benchmarks/torch_adaptive_drift.py` work from the root
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)

from repro_torch.core import (AdaptiveConfig, CostModel,  # noqa: E402
                        DynamicClientFactory, MessageReader, Objective,
                        RunCoordinator, SimulatedClusterClient, SlotConfig,
                        default_catalog)
from benchmarks.torch_cc_pipeline import build_graph  # noqa: E402
from benchmarks.torch_store_cache import _partitions  # noqa: E402

#: sleep = sim_duration * scale; edges ~8.6 h sim => ~0.9 s wall nominal,
#: so severe-drift static runs take seconds, not minutes
SIM_TIME_SCALE = 3e-5

#: injected *reality* on ``pod-spot`` — the platform every min-cost plan
#: relies on — while catalog beliefs stay untouched: a platform-local
#: incident (the paper's EMR-needs-oversight regime).  The other platforms
#: run clean, so rerouting is *possible*; the static plan just never does it
DRIFT_LEVELS = {
    "none": {"bias": 1.0, "failure": 0.0, "preemption": 0.0},
    "mild": {"bias": 1.8, "failure": 0.05, "preemption": 0.15},
    "severe": {"bias": 3.0, "failure": 0.10, "preemption": 0.30},
}

#: 2 slots per platform, no elastic growth: the pipeline drains in waves,
#: so the small nodes tasks finish (and teach the online model) before the
#: big edges tasks launch — the window a replan can act in
SLOTS = SlotConfig(max_concurrent=4, platform_slots=2, elastic_max_slots=2)

ADAPTIVE = AdaptiveConfig(replan_cooldown_s=0.05, breaker_cooldown_s=2.0)


def _client_builder(level: dict):
    def build(p):
        drifted = p.name == "pod-spot"
        return SimulatedClusterClient(
            p, sim_time_scale=SIM_TIME_SCALE,
            failure_rate=level["failure"] if drifted else 0.0,
            preemption_rate=level["preemption"] if drifted else 0.0,
            duration_bias=level["bias"] if drifted else 1.0)
    return build


def _coordinator(level: dict, parts, adaptive: bool,
                 device: str = "cuda") -> tuple[RunCoordinator,
                                                MessageReader]:
    reader = MessageReader()
    # fleet catalog: clusters only (the free local platform is a debug
    # device and would win any min-cost argmin outright)
    catalog = {k: p for k, p in default_catalog().items() if k != "local"}
    factory = DynamicClientFactory(
        catalog, CostModel(), Objective.min_cost(),
        client_builder=_client_builder(level))
    coord = RunCoordinator(
        build_graph(partitions=parts, device=device), factory, reader=reader,
        slots=SLOTS, enable_speculation=False, use_cache=False,
        adaptive=ADAPTIVE if adaptive else None)
    return coord, reader


def _arm(name: str, level: dict, parts, run_id: str, plan,
         adaptive: bool, device: str = "cuda") -> dict:
    coord, reader = _coordinator(level, parts, adaptive, device)
    t0 = time.perf_counter()
    report = coord.materialize("graph_aggr", run_id=run_id, plan=plan)
    wall_s = time.perf_counter() - t0
    replans = [e for e in reader.events() if e.kind == "REPLAN"]
    trips = [e for e in reader.events()
             if e.kind == "BREAKER" and e.payload.get("state") == "open"]
    edges_platforms = sorted({r.platform for r in report.records
                              if r.asset == "edges"})
    counts = reader.outcome_counts()
    return {
        "wall_s": round(wall_s, 3),
        "sim_makespan_s": round(report.slot_makespan_s(coord.slots), 1),
        "cost_usd": round(report.total_cost, 2),
        "attempts": sum(len(r.attempts) for r in report.records),
        "preemptions": sum(c.get("preemption", 0) for c in counts.values()),
        "failures": sum(c.get("failure", 0) for c in counts.values()),
        "replans_adopted": sum(1 for e in replans if e.payload.get("adopted")),
        "replan_reasons": (replans[0].payload.get("reasons", [])[:2]
                           if replans else []),
        "breaker_trips": len(trips),
        "edges_platforms": edges_platforms,
        "ok": report.ok,
    }


def _level(name: str, level: dict, parts, device: str = "cuda") -> dict:
    # one static plan, priced by the *catalog* (it cannot see the drift),
    # shared by both arms — and one run id, so the deterministic fault
    # injection replays identically until the arms actually diverge
    plan_coord, _ = _coordinator(level, parts, adaptive=False, device=device)
    plan = plan_coord.plan("graph_aggr")
    run_id = f"adaptive-{name}"
    static = _arm("static", level, parts, run_id, plan, adaptive=False,
                  device=device)
    closed = _arm("closed", level, parts, run_id, plan, adaptive=True,
                  device=device)
    mk_red = 1.0 - closed["sim_makespan_s"] / max(static["sim_makespan_s"],
                                                  1e-9)
    cost_red = 1.0 - closed["cost_usd"] / max(static["cost_usd"], 1e-9)
    return {
        "drift": level,
        "static": static,
        "closed": closed,
        "makespan_reduction": round(mk_red, 4),
        "cost_reduction": round(cost_red, 4),
    }


def run(n_crawls: int, n_shards: int, device: str = "cuda") -> dict:
    parts = _partitions(n_crawls, n_shards)
    levels = {name: _level(name, lv, parts, device)
              for name, lv in DRIFT_LEVELS.items()}
    none, severe = levels["none"], levels["severe"]
    checks = {
        # no drift -> no replan -> the two arms replay identically
        "zero_drift_parity_makespan": abs(none["makespan_reduction"]) <= 0.02,
        "zero_drift_parity_cost": abs(none["cost_reduction"]) <= 0.02,
        "zero_drift_no_replan": none["closed"]["replans_adopted"] == 0,
        "mild_no_regression": levels["mild"]["makespan_reduction"] >= -0.05,
        "severe_makespan_reduction_15pct":
            severe["makespan_reduction"] >= 0.15,
        "severe_cost_reduction": severe["cost_reduction"] > 0.0,
        "closed_loop_replanned": severe["closed"]["replans_adopted"] >= 1,
        "closed_loop_migrated_edges":
            severe["closed"]["edges_platforms"] != ["pod-spot"],
        "all_runs_ok": all(lv[arm]["ok"] for lv in levels.values()
                           for arm in ("static", "closed")),
    }
    return {
        "config": {"n_crawls": n_crawls, "n_shards": n_shards,
                   "n_tasks": 4 * n_crawls * n_shards,
                   "sim_time_scale": SIM_TIME_SCALE,
                   "slots": {"max_concurrent": SLOTS.max_concurrent,
                             "platform_slots": SLOTS.platform_slots}},
        "levels": levels,
        "checks": checks,
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--smoke", action="store_true",
                    help="small partition grid for CI (16 tasks)")
    ap.add_argument("--out", default=None,
                    help="default BENCH_torch_adaptive.json, or "
                         "BENCH_torch_adaptive_smoke.json with --smoke")
    ap.add_argument("--device", default="cuda",
                    help="where the crawl assets' tensor work runs")
    args = ap.parse_args()

    n_crawls, n_shards = (2, 2) if args.smoke else (3, 2)
    out = args.out or ("BENCH_torch_adaptive_smoke.json" if args.smoke
                       else "BENCH_torch_adaptive.json")
    result = run(n_crawls, n_shards, device=args.device)

    with open(out, "w") as f:
        json.dump(result, f, indent=1, sort_keys=True)
    for name, lv in result["levels"].items():
        print(f"{name:7s} static {lv['static']['sim_makespan_s'] / 3600:7.1f} h "
              f"${lv['static']['cost_usd']:8.0f} | "
              f"closed {lv['closed']['sim_makespan_s'] / 3600:7.1f} h "
              f"${lv['closed']['cost_usd']:8.0f} | "
              f"makespan -{lv['makespan_reduction'] * 100:5.1f}% "
              f"cost -{lv['cost_reduction'] * 100:5.1f}% "
              f"(replans {lv['closed']['replans_adopted']}, "
              f"edges -> {','.join(lv['closed']['edges_platforms'])})")
    for name, ok in sorted(result["checks"].items()):
        print(f"  {'PASS' if ok else 'FAIL'} {name}")
    print(f"wrote {out}")
    if not all(result["checks"].values()):
        raise SystemExit("adaptive drift benchmark checks failed")


if __name__ == "__main__":
    main()
