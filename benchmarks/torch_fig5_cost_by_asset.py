"""Fig 5: total cost of production runs by asset, across multiple Common
Crawl batches (time x domain partitions), per platform policy.

The port's copy of ``benchmarks/fig5_cost_by_asset.py`` on ``repro_torch.core`` and
``torch_cc_pipeline``: ``device`` says where the pipeline's edges and
graph_aggr assets do their tensor work (the card unless the caller passes
``"cpu"``); the numbers do not depend on it.
"""
from __future__ import annotations

import torch

from benchmarks.torch_cc_pipeline import run_policy
from repro_torch.core import MultiPartitions, StaticPartitions

BATCHES = MultiPartitions(dims=(
    ("time", StaticPartitions(("2023-10", "2023-11", "2023-12"))),
    ("domain", StaticPartitions(("shard-0", "shard-1"))),
))


def run(device: torch.device | str = "cuda") -> dict:
    out = {}
    for policy in ("orchestrated", "all-spot", "all-premium"):
        report, reader = run_policy(policy, seed=7, partitions=BATCHES,
                                    device=device)
        out[policy] = {
            "cost_by_asset": {k: round(v, 2)
                              for k, v in report.by_asset_cost().items()},
            "total_cost": round(report.total_cost, 2),
            "makespan_h": round(report.makespan_s() / 3600.0, 2),
            "n_partitions": len(report.records) // 4,
        }
    # the paper's Fig-5 shape: edges dominates cost on every platform
    for policy in out:
        c = out[policy]["cost_by_asset"]
        assert c["edges"] > 10 * max(c["nodes"], c["graph_aggr"]), c
    return out


if __name__ == "__main__":
    import argparse
    import json
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda")
    print(json.dumps(run(device=ap.parse_args().device), indent=1,
                     default=float))
