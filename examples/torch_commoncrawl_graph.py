"""The paper's §5 use case end-to-end on the PyTorch port (the twin of
``examples/commoncrawl_graph.py``): mine a web-based inter-firm network
from (synthetic) Common-Crawl data with the 4-asset pipeline, partitioned
by crawl-month x domain-shard, dispatched across platforms by cost.  The
edges and graph_aggr assets do their tensor work on ``--device``.

    PYTHONPATH=src python examples/torch_commoncrawl_graph.py [--device cpu]
"""
import argparse
import os
import sys

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)

from benchmarks.torch_cc_pipeline import build_graph  # noqa: E402
from repro_torch.core import (CostModel, DynamicClientFactory,  # noqa: E402
                              MessageReader, MultiPartitions, Objective,
                              RunCoordinator, StaticPartitions,
                              default_catalog)

PARTS = MultiPartitions(dims=(
    ("time", StaticPartitions(("2023-10", "2023-11"))),
    ("domain", StaticPartitions(("shard-0", "shard-1"))),
))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    graph = build_graph(partitions=PARTS, device=args.device)
    reader = MessageReader()
    factory = DynamicClientFactory(default_catalog(), CostModel(),
                                   Objective.balanced(), sim_seed=3)
    coord = RunCoordinator(graph, factory, reader=reader)

    # global DAG-level plan first: critical path on fast platforms, slack
    # tasks on cheap ones — then execute it (greedy fallback on failover)
    plan = coord.plan(["graph_aggr"])
    print("run plan preview:")
    print(plan.table())
    print()

    report = coord.materialize(["graph_aggr"], plan=plan)
    print(report.summary())

    agg = coord.store.get("graph_aggr", "2023-10/shard-0")
    print(f"\ndomain-level graph (2023-10/shard-0): "
          f"{len(agg['weight'])} inter-domain edges, "
          f"{agg['n_domains']} domains")
    top = sorted(zip(agg["weight"], agg["src_domain"], agg["dst_domain"]),
                 reverse=True)[:5]
    for w, s, d in top:
        print(f"  domain {s:>3} -> domain {d:>3}  weight {w:.2f}")

    print("\nper-platform outcomes (Fig 3 view):", reader.outcome_counts())
    print("cost by asset (Fig 5 view):",
          {k: round(v, 2) for k, v in report.by_asset_cost().items()})


if __name__ == "__main__":
    main()
