"""Benchmark runner of the port -- one entry per paper table/figure plus the
roofline and the substrate microbenchmarks.  Prints ``name,us_per_call,
derived`` CSV.

The port's copy of ``benchmarks/run.py``, with the same rows and CSV
through the port's twins: ``torch_table1_cost``, ``torch_fig{3,4,5,6}_*``,
``torch_roofline`` (over the dry run's records in
``artifacts/dryrun_torch``; 0 cells where the sweep has not run),
``torch_lm_platform_choice``, ``torch_planner_vs_greedy`` and
``torch_microbench``.  ``--device`` (default ``cuda``) is where the Common
Crawl assets' tensor work and the microbenchmarks run.

``--smoke`` runs the fast orchestration subset (Table 1 and the planner
sweep) and writes ``BENCH_torch_smoke.json``; the full run writes
``artifacts/torch_bench_results.json``.  ``us_per_call`` is the host's
clock around each row's call, crawl and kernels included.

    python benchmarks/torch_run.py [--smoke] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

# make `python benchmarks/torch_run.py` work from the root
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for _p in (_ROOT, os.path.join(_ROOT, "src")):
    if _p not in sys.path:
        sys.path.insert(0, _p)


def _timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return (time.perf_counter() - t0) * 1e6, out


def _table1_row(rows, device: str, full: bool):
    from benchmarks import torch_table1_cost
    us, t1 = _timed(lambda: torch_table1_cost.run(device=device))
    claims = t1["claims"]
    derived = (f"cost_reduction_vs_premium="
               f"{claims['cost_reduction_vs_premium_table_basis']:.3f}")
    if full:
        derived += (f";cost_reduction_simulated="
                    f"{claims['cost_reduction_vs_premium_simulated']:.3f};"
                    f"tuning_improvement="
                    f"{claims['tuning_improvement_vs_untuned_spot']:.3f};"
                    f"savings_usd={claims['savings_usd_per_run']:.0f}")
    rows.append(("table1_cost", us, derived))
    return t1


def _planner_row(rows, smoke: bool):
    from benchmarks import torch_planner_vs_greedy
    us, pv = _timed(lambda: torch_planner_vs_greedy.run(smoke=smoke))
    s = pv["summary"]
    rows.append(("planner_vs_greedy", us,
                 f"dominates={s['n_dominates']}/{s['n_configs']};"
                 f"max_saving_pct={s['max_cost_saving_pct']:.1f}"))
    return pv


def _print_rows(rows) -> None:
    print("name,us_per_call,derived")
    for name, us, derived in rows:
        print(f"{name},{us:.1f},{derived}")


def smoke(device: str = "cuda") -> None:
    """Fast subset: Table-1 economics + planner sweep (seconds)."""
    rows: list[tuple[str, float, str]] = []
    t1 = _table1_row(rows, device, full=False)
    pv = _planner_row(rows, smoke=True)
    _print_rows(rows)
    with open("BENCH_torch_smoke.json", "w") as f:
        json.dump({"table1": t1, "planner_vs_greedy": pv}, f, indent=1,
                  default=float)


def main(device: str = "cuda") -> None:
    rows: list[tuple[str, float, str]] = []
    t1 = _table1_row(rows, device, full=True)

    from benchmarks import torch_fig3_reliability
    us, f3 = _timed(lambda: torch_fig3_reliability.run(n_seeds=6, device=device))
    rows.append(("fig3_reliability", us,
                 f"trial_ratio={f3['trial_ratio_spot_over_premium']:.2f};"
                 f"spot_fail={f3['failure_rate']['pod-spot']:.2f};"
                 f"premium_fail={f3['failure_rate']['pod-premium']:.2f}"))

    from benchmarks import torch_fig4_effort
    us, f4 = _timed(lambda: torch_fig4_effort.run(device=device))
    rows.append(("fig4_effort", us,
                 f"trial_ratio={f4['trial_ratio_spot_over_premium']:.2f};"
                 f"spot_changes={f4['pod-spot']['mean_changes']:.1f};"
                 f"premium_changes={f4['pod-premium']['mean_changes']:.1f}"))

    from benchmarks import torch_fig5_cost_by_asset
    us, f5 = _timed(lambda: torch_fig5_cost_by_asset.run(device=device))
    rows.append(("fig5_cost_by_asset", us,
                 f"orchestrated_total={f5['orchestrated']['total_cost']:.0f};"
                 f"premium_total={f5['all-premium']['total_cost']:.0f}"))

    from benchmarks import torch_fig6_durations
    us, f6 = _timed(lambda: torch_fig6_durations.run(n_seeds=6, device=device))
    edges_ratio = (f6["edges@pod-spot"]["median_h"]
                   / f6["edges@pod-premium"]["median_h"])
    rows.append(("fig6_durations", us,
                 f"edges_spot_over_premium={edges_ratio:.2f}"))

    from benchmarks import torch_roofline
    us, rf = _timed(torch_roofline.run)
    rows.append(("roofline", us,
                 f"ok={rf['n_ok']};skipped={rf['n_skipped']};"
                 f"errors={rf['n_error']};multipod_ok={rf['n_multipod_ok']};"
                 f"mean_mfu_train={rf['mean_mfu_train']:.3f};"
                 f"best_mfu_train={rf['best_mfu_train']:.3f};"
                 f"mean_mfu_prefill={rf['mean_mfu_prefill']:.3f}"))

    from benchmarks import torch_lm_platform_choice
    us, lm = _timed(torch_lm_platform_choice.run)
    train_cells = {k: v for k, v in lm.items() if "train" in k}
    prem = sum(1 for v in train_cells.values()
               if v["platform"] == "pod-premium")
    rows.append(("lm_platform_choice", us,
                 f"cells={len(lm)};train_on_premium={prem}/"
                 f"{len(train_cells)}"))

    pv = _planner_row(rows, smoke=False)

    from benchmarks import torch_microbench
    for name, val in torch_microbench.run(device).items():
        rows.append((f"micro_{name}", val["us"],
                     f"std_us={val['std_us']:.1f};iters={val['iters']}"))

    _print_rows(rows)

    os.makedirs("artifacts", exist_ok=True)
    with open(os.path.join("artifacts", "torch_bench_results.json"), "w") as f:
        json.dump({"table1": t1, "fig3": f3, "fig4": f4, "fig5": f5,
                   "fig6": f6, "lm_platform_choice": lm,
                   "planner_vs_greedy": pv,
                   "roofline": {k: v for k, v in rf.items() if k != "rows"}},
                  f, indent=1, default=float)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--smoke", action="store_true",
                    help="fast orchestration subset; writes "
                         "BENCH_torch_smoke.json")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    a = ap.parse_args()
    if a.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            raise SystemExit("torch_run: no CUDA device (--device cpu runs "
                             "the crawl on the host)")
    if a.smoke:
        smoke(a.device)
    else:
        main(a.device)
