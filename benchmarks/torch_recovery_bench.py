"""Crash-recovery benchmark: kill/resume economics + journaling overhead on
the Common-Crawl pipeline.

The port's copy of ``benchmarks/recovery_bench.py`` on ``repro_torch.core``
and ``benchmarks/torch_cc_pipeline.py``: the crawl assets do their tensor
work on ``--device`` (default ``cuda``).  Writes
``BENCH_torch_recovery.json`` (``_smoke`` with ``--smoke``), gated by the
unchanged ``check_recovery_regression.py`` against
``benchmarks/baselines/torch_recovery_baseline.json``.  Its walls are the
host's.

Two phases:

* **overhead** — the happy path run twice per repeat (journal off vs on,
  fresh store/journal dirs each time, ``SIM_TIME_SCALE`` so wall-clock
  reflects the DAG's real shape), min-of-repeats per arm.  The write-ahead
  journal fsyncs every record, so this measures the real durability tax;
  the CI gate requires it under the baseline's ``max_overhead_frac`` (5%).
* **kill/resume** — the coordinator is killed at ~25/50/75% of the
  journal's record stream (seeded ``FaultPlan`` record-boundary kill: the
  record is durable, the action may not be), then resumed with a fresh
  coordinator.  Executed in pure-accounting mode (``sim_time_scale=0``) so
  the deterministic clients make an uninterrupted run of the same run_id an
  exact reference.  Per kill point we check: resume completes, zero
  duplicate billing (journal idempotency keys), spend equal to the
  uninterrupted run, byte-identical store contents, and rework (re-launched
  previously-launched tasks) bounded by the crash frontier — plus report
  the rework fraction (re-executed / total tasks), the headline number for
  "how much work does a crash at X% cost us?".

Writes ``BENCH_recovery.json`` (or ``BENCH_recovery_smoke.json`` with
``--smoke``); CI's bench-smoke job gates via
``check_recovery_regression.py`` against
``benchmarks/baselines/recovery_baseline.json``.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

# make `python benchmarks/torch_recovery_bench.py` work from the root
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)

from repro_torch.core import (CoordinatorKilled, CostModel,  # noqa: E402
                        DynamicClientFactory, FaultPlan, JournalState,
                        MaterializationStore, MessageReader, MultiPartitions,
                        Objective, RunCoordinator, RunJournal,
                        StaticPartitions, default_catalog)
from benchmarks.torch_cc_pipeline import build_graph  # noqa: E402

#: overhead arm: sleep = estimate.duration_s * scale; edges ~8.6h => ~3s, so
#: the base run is seconds-long and ~tens of fsync'd journal records cost a
#: small, measurable fraction of it
SIM_TIME_SCALE = 1e-4
KILL_FRACS = (0.25, 0.5, 0.75)


def _partitions(n_crawls: int, n_shards: int) -> MultiPartitions:
    crawls = tuple(f"2023-{10 + i:02d}" for i in range(n_crawls))
    shards = tuple(f"shard-{i}" for i in range(n_shards))
    return MultiPartitions(dims=(("time", StaticPartitions(crawls)),
                                 ("domain", StaticPartitions(shards))))


def _coordinator(graph, root: str, tag: str, journal: bool,
                 sim_time_scale: float, faults: FaultPlan | None = None,
                 seed: int = 0) -> RunCoordinator:
    factory = DynamicClientFactory(
        default_catalog(), CostModel(), Objective.balanced(),
        sim_seed=seed, sim_time_scale=sim_time_scale, faults=faults)
    return RunCoordinator(
        graph, factory, reader=MessageReader(),
        store=MaterializationStore(os.path.join(root, f"store-{tag}")),
        journal_dir=os.path.join(root, f"journal-{tag}") if journal else None,
        faults=faults)


# ------------------------------------------------------------------ overhead
def bench_overhead(graph, root: str, repeats: int) -> dict:
    times = {"plain": [], "journaled": []}
    records = 0
    for i in range(repeats):
        for arm, journal in (("plain", False), ("journaled", True)):
            tag = f"ovh-{arm}-{i}"
            coord = _coordinator(graph, root, tag, journal, SIM_TIME_SCALE)
            # same run_id for both arms: the simulated clients key durations
            # and outcomes on it, so the arms execute identical schedules
            t0 = time.perf_counter()
            report = coord.materialize(["graph_aggr"], run_id=f"ovh{i}")
            times[arm].append(time.perf_counter() - t0)
            assert report.ok
            if journal:
                recs, _ = RunJournal.load(
                    os.path.join(root, f"journal-{tag}"), f"ovh{i}")
                records = max(records, recs[-1]["seq"] + 1)
    plain, journaled = min(times["plain"]), min(times["journaled"])
    return {
        "repeats": repeats,
        "plain_s": round(plain, 4),
        "journaled_s": round(journaled, 4),
        "overhead_frac": round(max(journaled - plain, 0.0) / plain, 4),
        "journal_records": records,
    }


# --------------------------------------------------------------- kill/resume
def bench_kills(graph, root: str) -> tuple[dict, dict]:
    # probe: how many records does an uninterrupted journaled run write?
    probe = _coordinator(graph, root, "probe", True, 0.0)
    assert probe.materialize(["graph_aggr"], run_id="probe").ok
    n_records = RunJournal.load(
        os.path.join(root, "journal-probe"), "probe")[0][-1]["seq"] + 1

    kills: dict[str, dict] = {}
    checks: dict[str, bool] = {}
    for frac in KILL_FRACS:
        kill_at = max(2, int(n_records * frac))
        rid = f"kill{int(frac * 100)}"
        label = f"kill_{int(frac * 100)}"

        # uninterrupted reference with the SAME run_id (deterministic
        # clients key durations/outcomes on it)
        ref = _coordinator(graph, root, f"{label}-ref", True, 0.0)
        ref_report = ref.materialize(["graph_aggr"], run_id=rid)
        ref_keys = [(r.asset, r.partition) for r in ref_report.records]
        ref_hashes = {tk: ref.store.data_hash(*tk) for tk in ref_keys}
        ref_spend = JournalState.from_records(RunJournal.load(
            os.path.join(root, f"journal-{label}-ref"), rid)[0]).spent_usd()

        fp = FaultPlan(seed=1, kill_at_record=kill_at)
        chaos = _coordinator(graph, root, label, True, 0.0, faults=fp)
        killed = False
        try:
            chaos.materialize(["graph_aggr"], run_id=rid)
        except CoordinatorKilled:
            killed = True
        jdir = os.path.join(root, f"journal-{label}")
        pre = JournalState.from_records(RunJournal.load(jdir, rid)[0])
        frontier = pre.frontier()
        launched_before = set(pre.launches)

        resumer = _coordinator(graph, root, label, True, 0.0)
        t0 = time.perf_counter()
        resume_ok = True
        try:
            resume_ok = resumer.resume(rid).ok
        except ValueError:  # killed after END: already complete
            resume_ok = pre.ended and bool(pre.ok)
        resume_s = time.perf_counter() - t0

        post_recs, _ = RunJournal.load(jdir, rid)
        post = JournalState.from_records(post_recs)
        keys = post.billed_keys()
        got_hashes = {tk: resumer.store.data_hash(*tk) for tk in ref_keys}
        resume_seq = next((r["seq"] for r in post_recs
                           if r["kind"] == "RESUME"), None)
        relaunched = {(r["asset"], r["partition"]) for r in post_recs
                      if r["kind"] == "LAUNCH"
                      and resume_seq is not None and r["seq"] > resume_seq}
        rework = relaunched & launched_before

        kills[label] = {
            "kill_at_record": kill_at,
            "total_records": n_records,
            "killed": killed,
            "resume_s": round(resume_s, 4),
            "frontier_tasks": len(frontier),
            "relaunched_tasks": len(relaunched),
            "rework_tasks": len(rework),
            "total_tasks": len(ref_keys),
            "rework_fraction": round(len(rework) / len(ref_keys), 4),
            "spend_usd": round(post.spent_usd(), 6),
            "reference_spend_usd": round(ref_spend, 6),
        }
        checks[f"{label}_fired"] = killed or kill_at >= n_records
        checks[f"{label}_resume_ok"] = resume_ok
        checks[f"{label}_no_double_billing"] = len(keys) == len(set(keys))
        checks[f"{label}_spend_matches_reference"] = (
            abs(post.spent_usd() - ref_spend) < 1e-6)
        checks[f"{label}_store_identical"] = got_hashes == ref_hashes
        checks[f"{label}_rework_bounded_by_frontier"] = rework <= frontier
    return kills, checks


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--smoke", action="store_true",
                    help="small partition grid + fewer overhead repeats")
    ap.add_argument("--out", default=None,
                    help="default BENCH_torch_recovery.json, or "
                         "BENCH_torch_recovery_smoke.json with --smoke")
    ap.add_argument("--device", default="cuda",
                    help="where the crawl assets' tensor work runs")
    ap.add_argument("--repeats", type=int, default=None)
    args = ap.parse_args()

    n_crawls, n_shards = (1, 2) if args.smoke else (2, 2)
    repeats = args.repeats or (2 if args.smoke else 3)
    out = args.out or ("BENCH_torch_recovery_smoke.json" if args.smoke
                       else "BENCH_torch_recovery.json")
    graph = build_graph(partitions=_partitions(n_crawls, n_shards),
                        device=args.device)

    root = tempfile.mkdtemp(prefix="recovery-bench-")
    try:
        overhead = bench_overhead(graph, root, repeats)
        kills, checks = bench_kills(graph, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)

    result = {
        "smoke": args.smoke,
        "partitions": {"crawls": n_crawls, "shards": n_shards},
        "overhead": overhead,
        "kills": kills,
        "checks": checks,
    }
    with open(out, "w") as f:
        json.dump(result, f, indent=1, sort_keys=True)
    print(json.dumps(result, indent=1, sort_keys=True))
    print(f"\nwrote {out}: journaling overhead "
          f"{overhead['overhead_frac'] * 100:.1f}% "
          f"({overhead['journal_records']} records), "
          f"{sum(checks.values())}/{len(checks)} checks passed")


if __name__ == "__main__":
    main()
