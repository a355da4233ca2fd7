"""Cross-run cache benchmark: cold vs warm vs single-partition backfill on
the Common-Crawl pipeline, against the content-addressed
``MaterializationStore``.

The port's copy of ``benchmarks/store_cache.py`` on ``repro_torch.core`` and
``benchmarks/torch_cc_pipeline.py``: the crawl assets do their tensor work
on ``--device`` (default ``cuda``, as ``torch_cc_pipeline.run_policy``).
Writes ``BENCH_torch_store.json`` (``_smoke`` with ``--smoke``), gated by
the unchanged ``check_store_regression.py`` against
``benchmarks/baselines/torch_store_cache_baseline.json``.  Its walls are
the host's.

Four phases, each with a *fresh* store instance and coordinator on the same
store directory (so every phase exercises the persistent index, not
in-process state):

* **cold**  — empty store: every (asset, partition) task executes;
* **warm**  — nothing changed: the planner prices every task ``cached`` and
  the run executes **zero** tasks, so wall-clock collapses to bookkeeping
  (the gate requires >= 10x faster than cold);
* **backfill** — one ``nodes`` partition's source data changes (store record
  invalidated + a salt folded into the recomputed output): exactly that
  partition's downstream cone re-executes (4 of the 4 x P tasks), every
  other partition stays cached;
* **cutoff** — one ``nodes`` record invalidated with *unchanged* source
  data: ``nodes`` re-runs, reproduces byte-identical output, and the
  downstream cone is cut off — exactly **one** task executes even though
  the pessimistic upfront resolution marked the whole cone stale.

Execution sleeps ``estimate.duration_s * SIM_TIME_SCALE`` per task
(``SimulatedClusterClient``), so cold wall-clock reflects the DAG's real
shape (edges dominates) and the warm speedup is measured against genuine
concurrency, not a no-op loop.

Writes ``BENCH_store.json`` (or ``BENCH_store_smoke.json`` with ``--smoke``);
CI's bench-smoke job runs ``--smoke`` and ``check_store_regression.py``
gates on the booleans + the warm speedup floor in
``benchmarks/baselines/store_cache_baseline.json``.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

# make `python benchmarks/torch_store_cache.py` work from the root
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)

from repro_torch.core import (CostModel, DynamicClientFactory,  # noqa: E402
                        MaterializationStore, MessageReader, MultiPartitions,
                        Objective, RunCoordinator, SimulatedClusterClient,
                        StaticPartitions, default_catalog)
from benchmarks.torch_cc_pipeline import build_graph  # noqa: E402

#: sleep = estimate.duration_s * scale; edges ~ 8.6 h => ~3 s per task, so a
#: cold run takes seconds while a warm run takes milliseconds — a >= 10x
#: speedup floor is robust even on a noisy CI runner
SIM_TIME_SCALE = 1e-4


def _partitions(n_crawls: int, n_shards: int) -> MultiPartitions:
    crawls = tuple(f"2023-{10 + i:02d}" for i in range(n_crawls))
    shards = tuple(f"shard-{i}" for i in range(n_shards))
    return MultiPartitions(dims=(("time", StaticPartitions(crawls)),
                                 ("domain", StaticPartitions(shards))))


def _coordinator(store_dir: str, parts: MultiPartitions,
                 salt: dict | None = None,
                 device: str = "cuda") -> tuple[RunCoordinator,
                                                MessageReader]:
    graph = build_graph(partitions=parts, salt=salt, device=device)
    store = MaterializationStore(store_dir)  # fresh instance: disk is truth
    reader = MessageReader()
    factory = DynamicClientFactory(
        default_catalog(), CostModel(), Objective.balanced(),
        client_builder=lambda p: SimulatedClusterClient(
            p, failure_rate=0.0, preemption_rate=0.0,
            sim_time_scale=SIM_TIME_SCALE))
    coord = RunCoordinator(graph, factory, store=store, reader=reader,
                           enable_speculation=False)
    return coord, reader


def _phase(name: str, store_dir: str, parts: MultiPartitions,
           salt: dict | None = None, device: str = "cuda") -> dict:
    coord, reader = _coordinator(store_dir, parts, salt=salt, device=device)
    t0 = time.perf_counter()
    plan = coord.plan("graph_aggr")
    report = coord.materialize("graph_aggr", run_id=f"store-bench-{name}",
                               plan=plan)
    wall_s = time.perf_counter() - t0
    executed = sorted((r.asset, r.partition) for r in report.records
                      if not r.cached)
    cached_platforms_scheduled = sorted(
        {c.platform for c in plan.choices.values()} - {"cached"})
    return {
        "wall_s": round(wall_s, 4),
        "tasks_total": len(report.records),
        "tasks_executed": len(executed),
        "executed": [f"{a}[{p}]" for a, p in executed],
        "plan_cached_tasks": plan.cached_tasks,
        "plan_stale_tasks": plan.stale_tasks,
        "plan_platforms_scheduled": cached_platforms_scheduled,
        "cache_stats": reader.cache_stats(f"store-bench-{name}"),
        "ok": report.ok,
    }


def run(n_crawls: int, n_shards: int, store_dir: str,
        device: str = "cuda") -> dict:
    parts = _partitions(n_crawls, n_shards)
    pkeys = parts.keys()
    target_part = pkeys[0]
    n_parts = len(pkeys)

    cold = _phase("cold", store_dir, parts, device=device)
    warm = _phase("warm", store_dir, parts, device=device)

    # backfill: partition 0's crawl snapshot is refreshed — the store record
    # is dropped and the recomputed nodes output carries a salt token (new
    # upstream *data*, unchanged code), so exactly its downstream cone runs
    MaterializationStore(store_dir).invalidate("nodes", target_part)
    backfill = _phase("backfill", store_dir, parts,
                      salt={target_part: "refresh-1"}, device=device)
    expected_cone = sorted(f"{a}[{target_part}]"
                           for a in ("nodes", "edges", "graph", "graph_aggr"))

    # early cutoff: drop the same record with *unchanged* inputs — nodes
    # re-runs, reproduces identical bytes, downstream cone stays cached
    MaterializationStore(store_dir).invalidate("nodes", target_part)
    cutoff = _phase("cutoff", store_dir, parts,
                    salt={target_part: "refresh-1"}, device=device)

    speedup = cold["wall_s"] / max(warm["wall_s"], 1e-9)
    checks = {
        "cold_all_executed": cold["tasks_executed"] == cold["tasks_total"],
        "warm_zero_tasks": warm["tasks_executed"] == 0,
        "warm_10x_faster": speedup >= 10.0,
        "warm_plan_all_cached":
            warm["plan_cached_tasks"] == warm["tasks_total"],
        "warm_plan_no_slots": warm["plan_platforms_scheduled"] == [],
        "backfill_exact_cone": backfill["executed"] == expected_cone,
        "cutoff_single_task":
            cutoff["executed"] == [f"nodes[{target_part}]"],
        "all_runs_ok": all(p["ok"] for p in (cold, warm, backfill, cutoff)),
    }
    return {
        "config": {"n_crawls": n_crawls, "n_shards": n_shards,
                   "n_partitions": n_parts,
                   "n_tasks": cold["tasks_total"],
                   "sim_time_scale": SIM_TIME_SCALE,
                   "target_partition": target_part},
        "cold": cold, "warm": warm, "backfill": backfill, "cutoff": cutoff,
        "warm_speedup": round(speedup, 2),
        "checks": checks,
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--smoke", action="store_true",
                    help="small partition grid for CI (8 tasks)")
    ap.add_argument("--out", default=None,
                    help="default BENCH_torch_store.json, or "
                         "BENCH_torch_store_smoke.json with --smoke")
    ap.add_argument("--device", default="cuda",
                    help="where the crawl assets' tensor work runs")
    ap.add_argument("--store-dir", default=None,
                    help="store directory (default: fresh temp dir)")
    args = ap.parse_args()

    n_crawls, n_shards = (1, 2) if args.smoke else (2, 2)
    out = args.out or ("BENCH_torch_store_smoke.json" if args.smoke
                       else "BENCH_torch_store.json")
    store_dir = args.store_dir or tempfile.mkdtemp(prefix="store_bench_")
    cleanup = args.store_dir is None
    try:
        result = run(n_crawls, n_shards, store_dir, device=args.device)
    finally:
        if cleanup:
            shutil.rmtree(store_dir, ignore_errors=True)

    with open(out, "w") as f:
        json.dump(result, f, indent=1, sort_keys=True)
    print(f"cold {result['cold']['wall_s']:.2f}s "
          f"({result['cold']['tasks_executed']} tasks) | "
          f"warm {result['warm']['wall_s']:.3f}s "
          f"({result['warm']['tasks_executed']} tasks, "
          f"{result['warm_speedup']:.0f}x) | "
          f"backfill {result['backfill']['tasks_executed']} tasks | "
          f"cutoff {result['cutoff']['tasks_executed']} task")
    for name, ok in sorted(result["checks"].items()):
        print(f"  {'PASS' if ok else 'FAIL'} {name}")
    print(f"wrote {out}")
    if not all(result["checks"].values()):
        raise SystemExit("store cache benchmark checks failed")


if __name__ == "__main__":
    main()
