"""The paper's example use case (§5): mining web-based inter-firm networks
from Common-Crawl-style data (port of ``repro.data.commoncrawl``).

A deterministic synthetic WARC-like corpus stands in for CC-MAIN (the real
dataset is a remote multi-TB archive; the *pipeline semantics* — the paper's
contribution — are fully implemented).  The four assets match Figure 2:

    nodes      : extract + preprocess seed-node info
    edges      : extract hyperlinks from seed-node pages
    graph      : join nodes x edges into a hyperlink graph
    graph_aggr : aggregate the graph to domain level (an ordered segment sum)

Partitioning matches the paper: time (crawl id) x domain-shard.

``edges`` and ``graph_aggr`` do their tensor work in torch on ``device``
(the card unless the caller passes ``"cpu"``) and return numpy, whose
bytes equal the JAX package's: the store content-hashes pickled outputs,
so a last-bit difference would change every downstream fingerprint.
``synth_crawl``, ``nodes`` and ``graph`` are numpy, as in the reference.
"""
from __future__ import annotations

import collections
import dataclasses
import threading

import numpy as np
import torch

#: (asset, device type) -> calls whose tensors lived there, since the last
#: ``clear()``; assets run in the orchestrator's client threads
device_calls: collections.Counter = collections.Counter()
_calls_lock = threading.Lock()


def _note(asset: str, t: torch.Tensor) -> None:
    with _calls_lock:
        device_calls[(asset, t.device.type)] += 1


@dataclasses.dataclass(frozen=True)
class CrawlConfig:
    n_domains: int = 256
    n_pages_per_domain: int = 12
    n_seed: int = 64
    max_links: int = 24
    tokens_per_page: int = 128
    vocab: int = 4096


def _rng(crawl: str, shard: str, salt: int) -> np.random.RandomState:
    # hashlib, not hash(): Python string hashing is salted per process, and
    # asset outputs must be reproducible across workers (paper §3)
    import hashlib

    digest = hashlib.sha1(repr(("cc", crawl, shard, salt)).encode()).digest()
    return np.random.RandomState(int.from_bytes(digest[:4], "little") % (2**31))


def synth_crawl(crawl: str, shard: str, cfg: CrawlConfig) -> dict:
    """WARC-stub: page records (page_id, domain_id, out-link page ids, text)."""
    rng = _rng(crawl, shard, 0)
    n_pages = cfg.n_domains * cfg.n_pages_per_domain
    domain_of_page = np.repeat(np.arange(cfg.n_domains), cfg.n_pages_per_domain)
    # power-law-ish link targets: preferential attachment to low page ids
    n_links = rng.randint(1, cfg.max_links, size=n_pages)
    links = []
    for i in range(n_pages):
        raw = rng.pareto(1.5, size=n_links[i]) * 10
        tgt = (raw.astype(np.int64) * 131 + rng.randint(0, n_pages, n_links[i])) % n_pages
        links.append(tgt)
    text = rng.randint(0, cfg.vocab, size=(n_pages, cfg.tokens_per_page))
    return {
        "page_ids": np.arange(n_pages),
        "domain_of_page": domain_of_page,
        "links": links,
        "text": text.astype(np.int32),
    }


# ---------------------------------------------------------------------------
# The four assets (Figure 2)
# ---------------------------------------------------------------------------


def nodes_asset(crawl: str, shard: str, cfg: CrawlConfig) -> dict:
    """Seed-node extraction + preprocessing (dedupe, validity filter)."""
    rng = _rng(crawl, shard, 1)
    raw = rng.randint(0, cfg.n_domains * cfg.n_pages_per_domain,
                      size=cfg.n_seed * 2)
    seeds = np.unique(raw)[: cfg.n_seed]  # dedupe + cap, like URL cleaning
    return {"seed_pages": seeds.astype(np.int64)}


def edges_asset(crawl: str, shard: str, nodes: dict, cfg: CrawlConfig,
                device: torch.device | str = "cuda") -> dict:
    """HTML/link extraction from seed pages (the compute-heavy asset)."""
    pages = synth_crawl(crawl, shard, cfg)
    src, dst = [], []
    for pid in nodes["seed_pages"]:
        for tgt in pages["links"][int(pid)]:
            src.append(int(pid))
            dst.append(int(tgt))
    src_a = np.asarray(src, np.int64)
    dst_a = np.asarray(dst, np.int64)
    # text-derived edge weights (token-overlap score), batched on the
    # device — the combined text+graph extraction the paper's pipeline
    # customizes
    text = torch.from_numpy(pages["text"]).to(device)
    _note("edges", text)
    a = text[torch.from_numpy(src_a).to(device)]
    b = text[torch.from_numpy(dst_a).to(device)]
    hit = (a[:, :, None] == b[:, None, :]).any(dim=1).to(torch.float32)
    # the mean as sum * (1/T) in f32, which is how the reference's jnp.mean
    # rounds; sum / T (torch.mean) differs in the last bit, e.g. at T = 33
    weight = hit.sum(dim=-1) * (1.0 / hit.shape[-1])
    return {
        "src": src_a,
        "dst": dst_a,
        "weight": weight.cpu().numpy(),
        "domain_of_page": pages["domain_of_page"],
    }


def graph_asset(nodes: dict, edges: dict) -> dict:
    """Join nodes x edges -> deduplicated hyperlink graph."""
    pairs = edges["src"] * np.int64(1 << 32) + edges["dst"]
    uniq, inv = np.unique(pairs, return_inverse=True)
    w = np.zeros(len(uniq), np.float32)
    np.add.at(w, inv, edges["weight"])
    src = (uniq >> 32).astype(np.int64)
    dst = (uniq & ((1 << 32) - 1)).astype(np.int64)
    return {"src": src, "dst": dst, "weight": w,
            "domain_of_page": edges["domain_of_page"]}


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """``out[s]`` = the sum of ``data[i]`` over ``segment_ids[i] == s``,
    added in input order from 0: the bits of a sequential scatter-add (the
    reference's CPU ``segment_sum``) on any device and on every run.  A
    stable sort groups each segment's values in input order; the k-th
    round adds every segment's k-th value, so the work is one elementwise
    add per round for as many rounds as the largest segment has values.
    Float atomics (``index_add_`` on the card) would add in whatever order
    the threads arrive."""
    out = torch.zeros(num_segments, dtype=data.dtype, device=data.device)
    if data.numel() == 0:
        return out
    ids, order = torch.sort(segment_ids, stable=True)
    uniq, counts = torch.unique_consecutive(ids, return_counts=True)
    starts = torch.cumsum(counts, 0) - counts
    slot = torch.repeat_interleave(torch.arange(len(uniq), device=ids.device),
                                   counts)
    rank = torch.arange(len(ids), device=ids.device) - starts[slot]
    grid = torch.zeros(len(uniq), int(counts.max()), dtype=data.dtype,
                       device=data.device)
    grid[slot, rank] = data[order]
    acc = torch.zeros(len(uniq), dtype=data.dtype, device=data.device)
    for k in range(grid.shape[1]):
        acc = acc + grid[:, k]
    out[uniq] = acc
    return out


def graph_aggr_asset(graph: dict, cfg: CrawlConfig,
                     device: torch.device | str = "cuda") -> dict:
    """Aggregate the page graph to domain level (an ordered segment sum)."""
    dom = torch.from_numpy(graph["domain_of_page"]).to(device)
    _note("graph_aggr", dom)
    src_d = dom[torch.from_numpy(graph["src"]).to(device)]
    dst_d = dom[torch.from_numpy(graph["dst"]).to(device)]
    # int64 here, int32 in the reference (JAX runs without x64): the same
    # values while n_domains**2 < 2**31
    pair = src_d * cfg.n_domains + dst_d
    w = segment_sum(torch.from_numpy(graph["weight"]).to(device), pair,
                    cfg.n_domains * cfg.n_domains)
    # the first 65536 nonzero bins in ascending order, the reference's
    # nonzero(size=min(w.size, 65536)) truncation
    nz = torch.nonzero(w).flatten()[: min(w.numel(), 65536)].cpu().numpy()
    w = w.cpu().numpy()
    return {
        "src_domain": (nz // cfg.n_domains).astype(np.int64),
        "dst_domain": (nz % cfg.n_domains).astype(np.int64),
        "weight": w[nz].astype(np.float32),
        "n_domains": cfg.n_domains,
    }


#: relative sizing of each asset's compute, calibrated to Table 1 durations
#: (edges dominates by ~2 orders of magnitude).
ASSET_COST_WEIGHTS = {"nodes": 0.4, "edges": 66.6, "graph": 0.9, "graph_aggr": 0.3}
