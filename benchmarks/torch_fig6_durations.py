"""Fig 6: run-duration distributions per step and platform (premium's
optimized runtime consistently shortens the heavy steps).

The port's copy of ``benchmarks/fig6_durations.py`` on ``repro_torch.core`` and
``torch_cc_pipeline``: ``device`` says where the pipeline's edges and
graph_aggr assets do their tensor work (the card unless the caller passes
``"cpu"``); the numbers do not depend on it.
"""
from __future__ import annotations

import statistics

import torch

from benchmarks.torch_cc_pipeline import SMALL, run_policy


def run(n_seeds: int = 10, device: torch.device | str = "cuda") -> dict:
    durs: dict[tuple[str, str], list[float]] = {}
    for seed in range(n_seeds):
        for policy, plat in (("all-spot", "pod-spot"),
                             ("all-premium", "pod-premium")):
            _, reader = run_policy(policy, seed=200 + seed, partitions=SMALL,
                                   device=device)
            for ev in reader.events(kind="SUCCESS"):
                durs.setdefault((ev.asset, plat), []).append(
                    ev.payload["duration_s"] / 3600.0)
    table = {}
    for (a, p), vals in sorted(durs.items()):
        table[f"{a}@{p}"] = {
            "median_h": round(statistics.median(vals), 3),
            "p90_h": round(sorted(vals)[int(0.9 * (len(vals) - 1))], 3),
            "n": len(vals),
        }
    # premium must be consistently faster on the heavy chip-capped step
    # (Fig 6): edges 8.7 h vs 5.9 h expected, robust against the 18% jitter.
    # Right-sized small assets absorb the Photon speedup into cluster size,
    # leaving only startup latency (0.98 vs 0.90 h expected) — inside jitter
    # noise at benchmark sample counts, so reported but not asserted.
    spot = table["edges@pod-spot"]["median_h"]
    prem = table["edges@pod-premium"]["median_h"]
    assert spot > 1.25 * prem, ("edges", spot, prem)
    return table


if __name__ == "__main__":
    import argparse
    import json
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda")
    print(json.dumps(run(device=ap.parse_args().device), indent=1,
                     default=float))
