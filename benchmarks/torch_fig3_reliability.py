"""Fig 3: stacked run outcomes (success / failure / preemption / cancelled)
by platform under fault injection, and the ~2x trial-run gap between the
cheap and the managed platform before production stability.

The port's copy of ``benchmarks/fig3_reliability.py`` on ``repro_torch.core`` and
``torch_cc_pipeline``: ``device`` says where the pipeline's edges and
graph_aggr assets do their tensor work (the card unless the caller passes
``"cpu"``); the numbers do not depend on it.
"""
from __future__ import annotations

import torch

from benchmarks.torch_cc_pipeline import SMALL, run_policy
from repro_torch.core.telemetry import OUTCOME_KEYS


def run(n_seeds: int = 10, device: torch.device | str = "cuda") -> dict:
    counts = {"pod-spot": {k: 0 for k in OUTCOME_KEYS},
              "pod-premium": {k: 0 for k in OUTCOME_KEYS}}
    attempts = {"pod-spot": [], "pod-premium": []}
    for seed in range(n_seeds):
        for policy, plat in (("all-spot", "pod-spot"),
                             ("all-premium", "pod-premium")):
            report, reader = run_policy(policy, seed=100 + seed,
                                        partitions=SMALL, device=device)
            oc = reader.outcome_counts().get(
                plat, {k: 0 for k in OUTCOME_KEYS})
            for k in counts[plat]:
                counts[plat][k] += oc.get(k, 0)
            attempts[plat].append(
                sum(len(r.attempts) for r in report.records))
    spot_attempts = sum(attempts["pod-spot"]) / max(1, n_seeds)
    prem_attempts = sum(attempts["pod-premium"]) / max(1, n_seeds)
    spot_runs = counts["pod-spot"]
    prem_runs = counts["pod-premium"]
    spot_fail_rate = spot_runs["failure"] / max(
        1, sum(spot_runs.values()))
    prem_fail_rate = prem_runs["failure"] / max(
        1, sum(prem_runs.values()))
    return {
        "outcomes": counts,
        "mean_attempts_per_pipeline": {"pod-spot": spot_attempts,
                                       "pod-premium": prem_attempts},
        "trial_ratio_spot_over_premium": spot_attempts / max(prem_attempts, 1e-9),
        "failure_rate": {"pod-spot": spot_fail_rate,
                         "pod-premium": prem_fail_rate},
    }


if __name__ == "__main__":
    import argparse
    import json
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda")
    print(json.dumps(run(device=ap.parse_args().device), indent=1,
                     default=float))
