"""Shared harness: the paper's 4-asset Common-Crawl pipeline wired into the
port's orchestrator (``repro_torch.core``), with Table-1-calibrated compute
profiles; the port's copy of ``benchmarks/cc_pipeline.py``.  ``device``
says where the edges and graph_aggr assets do their tensor work (the card
unless the caller passes ``"cpu"``).

Calibration (DESIGN.md §7): spot == EMR, premium == DBR.
Rates: spot $0.145/chip-h + 26% surcharge; premium 2.4x base + 48% surcharge;
work back-solved from Table 1 base costs (edges 2200 chip-h, graph 26,
nodes 2.3, graph_aggr 8) with right-sized clusters (CostModel.chips_for)
=> edges ~ $400/8.6h spot vs ~$730/5.7h premium, matching Table 1.
"""
from __future__ import annotations

import torch

from repro_torch.core import (AssetGraph, ComputeProfile, CostModel,
                              DynamicClientFactory, MessageReader,
                              MultiPartitions, Objective, RetryPolicy,
                              RunCoordinator, StaticPartitions,
                              TimeWindowPartitions, asset, default_catalog)
from repro_torch.data import commoncrawl as cc

CRAWLS = TimeWindowPartitions("2023-10", "2024-03")  # paper's access window
DOMAIN_SHARDS = StaticPartitions(("shard-0", "shard-1"))
PARTS = MultiPartitions(dims=(("time", CRAWLS), ("domain", DOMAIN_SHARDS)))
SMALL = MultiPartitions(dims=(
    ("time", StaticPartitions(("2023-10",))),
    ("domain", StaticPartitions(("shard-0",))),
))

# work_chip_hours back-solved from Table 1 base costs at the spot rate
# ($0.139/chip-h effective): work = base_usd / rate (see DESIGN.md §7)
PROFILES = {
    "nodes": ComputeProfile(work_chip_hours=2.3, speedup_class="light"),
    "edges": ComputeProfile(work_chip_hours=2200.0, speedup_class="scan"),
    "graph": ComputeProfile(work_chip_hours=26.0, speedup_class="shuffle"),
    "graph_aggr": ComputeProfile(work_chip_hours=8.0, speedup_class="light"),
}


def build_graph(cfg: cc.CrawlConfig | None = None,
                partitions=None, hints: dict | None = None,
                salt: dict | None = None,
                device: torch.device | str = "cuda") -> AssetGraph:
    """``salt`` (partition key -> token) is an external-input stand-in for
    the cache benchmarks: it is folded into the ``nodes`` *output* (new
    upstream data) without touching any compute function's source, so
    changing a partition's salt re-materializes exactly that partition's
    downstream cone — the shape of a real crawl-snapshot refresh."""
    cfg = cfg or cc.CrawlConfig(n_domains=32, n_pages_per_domain=4, n_seed=24,
                                max_links=6, tokens_per_page=32)
    hints = hints or {}
    salt = salt or {}
    parts = partitions if partitions is not None else PARTS
    retry = RetryPolicy(max_attempts=6, backoff_s=0.0, failover_after=2)

    def crawl_shard(ctx):
        dims = ctx.partition_key.split("/")
        return dims[0], dims[-1]

    @asset(name="nodes", partitions=parts, compute=PROFILES["nodes"],
           retry=retry, platform_hint=hints.get("nodes"))
    def nodes(ctx):
        crawl, shard = crawl_shard(ctx)
        out = cc.nodes_asset(crawl, shard, cfg)
        tok = salt.get(ctx.partition_key)
        if tok is not None:
            # a refreshed snapshot crawls different seed pages: rotate one
            # seed out so the new data propagates through every downstream
            # value (edges/graph/graph_aggr), not just this record
            out = {**out, "seed_pages": out["seed_pages"][1:], "salt": tok}
        return out

    @asset(name="edges", deps=("nodes",), partitions=parts,
           compute=PROFILES["edges"], retry=retry,
           platform_hint=hints.get("edges"))
    def edges(ctx, nodes):
        crawl, shard = crawl_shard(ctx)
        return cc.edges_asset(crawl, shard, nodes, cfg, device=device)

    @asset(name="graph", deps=("nodes", "edges"), partitions=parts,
           compute=PROFILES["graph"], retry=retry,
           platform_hint=hints.get("graph"))
    def graph(ctx, nodes, edges):
        return cc.graph_asset(nodes, edges)

    @asset(name="graph_aggr", deps=("graph",), partitions=parts,
           compute=PROFILES["graph_aggr"], retry=retry,
           platform_hint=hints.get("graph_aggr"))
    def graph_aggr(ctx, graph):
        return cc.graph_aggr_asset(graph, cfg, device=device)

    return AssetGraph([nodes, edges, graph, graph_aggr])


def run_policy(policy: str, seed: int = 0, partitions=None,
               objective: Objective | None = None,
               device: torch.device | str = "cuda"):
    """policy: 'orchestrated' (dynamic factory) | 'planned' (DAG-level
    RunPlanner) | 'all-spot' | 'all-premium' | 'paper-mix' (run-1 of
    Table 1: edges on EMR, graph on DBR)."""
    hints = {}
    if policy == "all-spot":
        hints = {k: "pod-spot" for k in PROFILES}
    elif policy == "all-premium":
        hints = {k: "pod-premium" for k in PROFILES}
    elif policy == "paper-mix":
        hints = {"nodes": "pod-spot", "edges": "pod-spot",
                 "graph": "pod-premium", "graph_aggr": "pod-spot"}
    g = build_graph(partitions=partitions, hints=hints, device=device)
    reader = MessageReader()
    factory = DynamicClientFactory(default_catalog(), CostModel(),
                                   objective or Objective.balanced(),
                                   sim_seed=seed)
    coord = RunCoordinator(g, factory, reader=reader, use_cache=False)
    plan = coord.plan(["graph_aggr"]) if policy == "planned" else None
    report = coord.materialize(["graph_aggr"], run_id=f"{policy}-{seed}",
                               plan=plan)
    return report, reader
