"""Quickstart on the PyTorch port (the twin of ``examples/quickstart.py``):
define two assets, let the Dynamic Factory pick platforms, materialize, and
inspect cost/telemetry.  The report asset sums the monthly counts on
``--device`` and stores a Python int: stored values hold no tensors.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse

import torch

from repro_torch.core import (AssetGraph, ComputeProfile, CostModel,
                              DynamicClientFactory, Objective, RunCoordinator,
                              StaticPartitions, asset, default_catalog)

parts = StaticPartitions(("2024-01", "2024-02"))


@asset(name="raw_counts", partitions=parts,
       compute=ComputeProfile(work_chip_hours=50.0, speedup_class="scan"))
def raw_counts(ctx):
    ctx.log("HEARTBEAT", stage="counting")
    return {"month": ctx.partition_key, "count": 1000 + len(ctx.partition_key)}


def make_report(device: str):
    @asset(name="report", deps=("raw_counts",),
           compute=ComputeProfile(work_chip_hours=1.0, speedup_class="light"))
    def report(ctx, raw_counts):
        counts = torch.tensor([v["count"] for v in raw_counts.values()],
                              device=device)
        return {"total": int(counts.sum()), "months": sorted(raw_counts)}

    return report


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    graph = AssetGraph([raw_counts, make_report(args.device)])
    factory = DynamicClientFactory(default_catalog(), CostModel(),
                                   Objective.balanced(), sim_seed=42)
    coord = RunCoordinator(graph, factory)
    rep = coord.materialize(["report"])
    print(rep.summary())
    print("result:", coord.store.get("report", "__all__"))
    print("total simulated cost: $%.2f" % rep.total_cost)
    for name in ("raw_counts", "report"):
        platform, est = factory.choose(graph[name])
        print(f"factory would run {name!r} on {platform.name} "
              f"(${est.total_usd:.2f}, {est.duration_s / 3600:.2f} h)")


if __name__ == "__main__":
    main()
