"""The port's orchestrator against the reference's, on the same seeded
inputs, compared exactly: costs, plans, routes, store data hashes and the
Common Crawl assets' bytes.

The reference prices with its own hardware constants; the port is handed
the same numbers through an ``Accelerator`` (``REF``), so every float must
agree bit for bit.  With its default ``H100_SXM`` the port's roofline moves
as the datasheet rates say.
"""
import hashlib
import pickle

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import benchmarks.cc_pipeline as ref_pipeline  # noqa: E402
import benchmarks.torch_cc_pipeline as port_pipeline  # noqa: E402
import repro.core as ref_core  # noqa: E402
import repro_torch.core as port_core  # noqa: E402
from repro.core import platforms as ref_platforms  # noqa: E402
from repro.data import commoncrawl as ref_cc  # noqa: E402
from repro.launch import router as ref_router  # noqa: E402
from repro_torch.core.platforms import H100_SXM, Accelerator  # noqa: E402
from repro_torch.data import commoncrawl as port_cc  # noqa: E402
from repro_torch.launch import router as port_router  # noqa: E402

REF = Accelerator(name="reference", peak_flops=ref_platforms.PEAK_FLOPS,
                  hbm_bw=ref_platforms.HBM_BW, link_bw=ref_platforms.ICI_BW,
                  hbm_gb=16.0)
POLICIES = ("orchestrated", "planned", "all-spot", "all-premium", "paper-mix")
# (name, CrawlConfig fields): the reference's default, the pipeline's
# reduced config, and 33 tokens a page, where sum / T and sum * (1/T) part
# in the last bit for overlap counts 19, 23, 27 and 31 -- counts that a
# 16-token vocabulary makes common
CRAWLS = {
    "default": {},
    "pipeline": dict(n_domains=32, n_pages_per_domain=4, n_seed=24,
                     max_links=6, tokens_per_page=32),
    "t33": dict(tokens_per_page=33),
    "t33_vocab16": dict(tokens_per_page=33, vocab=16),
    "pipeline_t33_vocab16": dict(n_domains=32, n_pages_per_domain=4,
                                 n_seed=24, max_links=6, tokens_per_page=33,
                                 vocab=16),
}


def _hash(value) -> str:
    return hashlib.sha1(pickle.dumps(value, protocol=4)).hexdigest()


# ---------------------------------------------------------------- pipeline
def _run_policy(pipeline, core, policy, seed, monkeypatch, **kw):
    made = []

    class Recording(core.RunCoordinator):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(self)

    monkeypatch.setattr(pipeline, "RunCoordinator", Recording)
    report, _ = pipeline.run_policy(policy, seed=seed, **kw)
    store = made[0].store
    # a local attempt's duration is its wall clock, the rest are simulated
    tasks = {(r.asset, r.partition): (
        r.status, r.platform,
        [(a.platform, a.status,
          None if a.platform == "local" else a.sim_duration_s, a.cost_usd,
          a.error) for a in r.attempts],
        store.data_hash(r.asset, r.partition)) for r in report.records}
    return report, tasks


@pytest.mark.parametrize("seed", (0, 7))
@pytest.mark.parametrize("policy", POLICIES)
def test_run_policy_matches_reference(policy, seed, monkeypatch):
    ref, ref_tasks = _run_policy(ref_pipeline, ref_core, policy, seed,
                                 monkeypatch)
    port, port_tasks = _run_policy(port_pipeline, port_core, policy, seed,
                                   monkeypatch, device="cpu")
    assert ref.ok and port.ok
    assert port.total_cost == ref.total_cost
    assert port.by_asset_cost() == ref.by_asset_cost()
    assert port_tasks == ref_tasks
    assert any(len(t[2]) > 1 for t in ref_tasks.values()), \
        "no attempt failed: the retry path went untested"


# ----------------------------------------------------------------- planner
def _random_graph(core, seed: int):
    """A seeded DAG of work-profiled and analytic assets, some partitioned."""
    rng = np.random.RandomState(seed)
    parts = core.StaticPartitions(("a", "b", "c"))
    specs, names = [], []
    for i in range(int(rng.randint(4, 12))):
        k = min(len(names), int(rng.randint(0, 4)))
        deps = tuple(rng.choice(names, size=k, replace=False)) if k else ()
        if rng.uniform() < 0.5:
            compute = core.ComputeProfile(
                work_chip_hours=float(rng.uniform(1.0, 500.0)),
                speedup_class=str(rng.choice(["scan", "shuffle", "light"])),
                min_chips=int(rng.choice([1, 8])))
        else:
            compute = core.ComputeProfile(
                flops=float(10 ** rng.uniform(18, 22)),
                bytes_hbm=float(10 ** rng.uniform(14, 18)),
                collective_bytes=float(10 ** rng.uniform(12, 16)),
                speedup_class=str(rng.choice(["train", "serve"])),
                memory_gb_per_chip=float(rng.uniform(0.0, 15.0)))
        name = f"a{i}"
        specs.append(core.asset(
            name=name, deps=deps, compute=compute,
            partitions=parts if rng.uniform() < 0.4 else None)(
                lambda ctx, **kw: None))
        names.append(name)
    return core.AssetGraph(specs)


def _plan(core, cost_model, seed, objective):
    g = _random_graph(core, seed)
    factory = core.DynamicClientFactory(core.default_catalog(), cost_model,
                                        objective(core))
    return core.RunPlanner(g, factory, slots=core.SlotConfig()).plan()


OBJECTIVES = {
    "balanced": lambda core: core.Objective.balanced(),
    "min_cost": lambda core: core.Objective.min_cost(),
    "min_time": lambda core: core.Objective.min_time(),
}


@pytest.mark.parametrize("objective", sorted(OBJECTIVES))
@pytest.mark.parametrize("seed", range(6))
def test_planner_matches_reference(seed, objective):
    ref = _plan(ref_core, ref_core.CostModel(), seed, OBJECTIVES[objective])
    port = _plan(port_core, port_core.CostModel(accelerator=REF), seed,
                 OBJECTIVES[objective])
    assert port.table(max_rows=1000) == ref.table(max_rows=1000)
    assert port.choices == {k: port_core.PlannedChoice(
        **{**vars(c), "estimate": port_core.CostEstimate(
            **vars(c.estimate))}) for k, c in ref.choices.items()}
    for field in ("predicted_cost_usd", "predicted_makespan_s",
                  "greedy_cost_usd", "greedy_makespan_s", "feasible",
                  "iterations", "platform_peaks", "pert_makespan_s",
                  "slot_wait_s"):
        assert getattr(port, field) == getattr(ref, field), field


# --------------------------------------------------------------- cost model
def _lm_profiles(core):
    """Analytic LM work: compute-, memory- and collective-bound profiles,
    with and without an HBM need past 16 GB a chip."""
    return [core.asset(name=f"p{i}", compute=core.ComputeProfile(
        flops=f, bytes_hbm=b, collective_bytes=c, speedup_class=cls,
        memory_gb_per_chip=m, min_chips=mc))(lambda ctx: None)
        for i, (f, b, c, cls, m, mc) in enumerate([
            (6 * 1.8e9 * 2e12, 4e15, 1e13, "train", 12.0, 1),
            (2e18, 8e17, 1e14, "serve", 4.0, 1),
            (1e19, 1e16, 5e17, "train", 0.0, 8),
            (3e21, 2e17, 2e16, "train", 40.0, 64),
            (5e17, 1e15, 0.0, "serve", 0.0, 300),
        ])]


def _estimates(core, model):
    specs = _lm_profiles(core)
    platforms = list(core.default_catalog().values())
    scalar = [[model.estimate(s, p) for p in platforms] for s in specs]
    return scalar, model.estimate_batch(specs, platforms)


@pytest.mark.parametrize("online", (False, True))
def test_cost_model_matches_reference(online):
    ref_model, port_model = ref_core.CostModel(), port_core.CostModel(
        accelerator=REF)
    if online:
        ref_model = ref_core.OnlineCostModel(ref_model)
        port_model = port_core.OnlineCostModel(port_model)
        assert port_model.accelerator is REF and port_model.hbm_gb == 16.0
        for m in (ref_model, port_model):
            m.observe("p1", "pod-spot", "success", predicted_s=10.0,
                      realized_s=14.0)
            m.observe("p0", "pod-premium", "failure")
    ref_scalar, ref_batch = _estimates(ref_core, ref_model)
    port_scalar, port_batch = _estimates(port_core, port_model)
    assert [[vars(e) for e in row] for row in port_scalar] == \
        [[vars(e) for e in row] for row in ref_scalar]
    assert sorted(port_batch) == sorted(ref_batch)
    for key, arr in ref_batch.items():
        np.testing.assert_array_equal(port_batch[key], arr, err_msg=key)
    # the batched path still agrees with the scalar one cell for cell
    for i, row in enumerate(port_scalar):
        for j, e in enumerate(row):
            assert port_batch["duration_s"][i, j] == e.duration_s
            assert port_batch["total_usd"][i, j] == e.total_usd


def test_h100_roofline_scales_compute_bound_work():
    """A compute-bound profile's compute seconds scale by the ratio of the
    peaks; HBM feasibility follows the accelerator's 80 GB."""
    spec = port_core.asset(name="t", compute=port_core.ComputeProfile(
        flops=1e21, bytes_hbm=1e12, speedup_class="train",
        memory_gb_per_chip=40.0))(lambda ctx: None)
    pod = port_core.default_catalog()["pod-spot"]
    h100 = port_core.CostModel()
    assert h100.accelerator is H100_SXM and h100.hbm_gb == 80.0
    assert port_core.OnlineCostModel(h100).accelerator is H100_SXM
    assert not port_core.CostModel(accelerator=REF).estimate(spec, pod).feasible
    ref_s = ref_core.CostModel(hbm_gb_per_chip=80.0).estimate(
        ref_core.asset(name="t", compute=ref_core.ComputeProfile(
            flops=1e21, bytes_hbm=1e12, speedup_class="train",
            memory_gb_per_chip=40.0))(lambda ctx: None), pod).compute_s
    got = h100.estimate(spec, pod).compute_s
    assert got == pytest.approx(ref_s * 197e12 / 989e12, rel=1e-12)
    assert port_core.CostModel().estimate_batch([spec], [pod])[
        "compute_s"][0, 0] == got


# ------------------------------------------------------------------ router
def _route_stream(router_mod, model, seed: int):
    router = router_mod.ReplicaRouter(router_mod.default_replicas(), model,
                                      breaker_failures=2,
                                      breaker_cooldown_s=5.0)
    classes = [router_mod.ServeClass("chat", 2.0),
               router_mod.ServeClass("batch", None),
               router_mod.ServeClass("tight", 0.05)]
    rng = np.random.RandomState(seed)
    out, inflight, now = [], [], 0.0
    for rid in range(300):
        now += float(rng.exponential(0.05))
        cls = classes[int(rng.randint(len(classes)))]
        d = router.route(rid, int(rng.randint(16, 4096)), cls, now=now)
        out.append(None if d is None else (
            d.replica, d.cls, vars(d.estimate), d.expected_usd,
            d.expected_wall_s, d.deadline_feasible))
        if d is not None:
            inflight.append(d)
        while inflight and rng.uniform() < 0.6:
            done = inflight.pop(int(rng.randint(len(inflight))))
            outcome = ("failure" if done.replica == "spot-1"
                       and rng.uniform() < 0.5 else
                       str(rng.choice(["success", "success", "preemption"])))
            router.complete(done.rid, outcome,
                            done.estimate.compute_s * float(
                                rng.uniform(0.5, 2.5)), now=now)
    return out, router.stats()


@pytest.mark.parametrize("seed", (0, 1, 2))
def test_router_matches_reference(seed):
    ref = _route_stream(ref_router, ref_core.OnlineCostModel(), seed)
    port = _route_stream(port_router, port_core.OnlineCostModel(
        port_core.CostModel(accelerator=REF)), seed)
    assert port == ref
    assert ref[1]["breaker_denials"] > 0 and ref[1]["slo_infeasible"] > 0


# ------------------------------------------------------------ common crawl
def _assets(cc, cfg, crawl, shard, **device):
    nodes = cc.nodes_asset(crawl, shard, cfg)
    edges = cc.edges_asset(crawl, shard, nodes, cfg, **device)
    graph = cc.graph_asset(nodes, edges)
    return {"nodes": nodes, "edges": edges, "graph": graph,
            "graph_aggr": cc.graph_aggr_asset(graph, cfg, **device)}


def _assert_same(port: dict, ref: dict) -> None:
    for name, value in ref.items():
        assert port[name].keys() == value.keys(), name
        for key, arr in value.items():
            if isinstance(arr, np.ndarray):
                assert port[name][key].dtype == arr.dtype, (name, key)
                assert np.array_equal(port[name][key], arr), (name, key)
        assert _hash(port[name]) == _hash(value), name


@pytest.mark.parametrize("part", (("2023-10", "shard-0"),
                                  ("2023-11", "shard-1")))
@pytest.mark.parametrize("crawl", sorted(CRAWLS))
def test_commoncrawl_assets_match_reference(crawl, part):
    ref = _assets(ref_cc, ref_cc.CrawlConfig(**CRAWLS[crawl]), *part)
    port = _assets(port_cc, port_cc.CrawlConfig(**CRAWLS[crawl]), *part,
                   device="cpu")
    _assert_same(port, ref)
    assert len(ref["graph_aggr"]["weight"]) > 0


def test_commoncrawl_t33_weights_part_from_plain_mean():
    """The t33_vocab16 case holds overlap counts where torch.mean's sum / T
    rounds away from the reference's sum * (1/T): the case can tell them
    apart."""
    cfg = port_cc.CrawlConfig(**CRAWLS["t33_vocab16"])
    port = _assets(port_cc, cfg, "2023-10", "shard-0", device="cpu")
    ref = _assets(ref_cc, ref_cc.CrawlConfig(**CRAWLS["t33_vocab16"]),
                  "2023-10", "shard-0")
    counts = torch.from_numpy(np.round(ref["edges"]["weight"] * 33))
    assert not torch.equal(counts / 33, counts * (1.0 / 33))
    assert not np.array_equal((counts.float() / 33).numpy(),
                              ref["edges"]["weight"])
    np.testing.assert_array_equal(port["edges"]["weight"],
                                  ref["edges"]["weight"])


def test_segment_sum_matches_reference_bit_for_bit():
    import jax
    import jax.numpy as jnp

    rng = np.random.RandomState(0)
    data = rng.standard_normal(200_000).astype(np.float32)
    ids = rng.randint(0, 1000, size=200_000)
    ref = np.asarray(jax.ops.segment_sum(jnp.asarray(data), jnp.asarray(ids),
                                         num_segments=1024))
    port = port_cc.segment_sum(torch.from_numpy(data), torch.from_numpy(ids),
                               1024).numpy()
    assert port.tobytes() == ref.tobytes()


def test_commoncrawl_counts_the_device_of_its_tensors():
    port_cc.device_calls.clear()
    _assets(port_cc, port_cc.CrawlConfig(**CRAWLS["pipeline"]), "2023-10",
            "shard-0", device="cpu")
    assert port_cc.device_calls == {("edges", "cpu"): 1,
                                    ("graph_aggr", "cpu"): 1}


def test_store_refuses_tensors():
    store = port_core.MaterializationStore()
    store.put("a", "p", {"x": np.ones(3, np.float32)}, "fp")
    with pytest.raises(TypeError, match="torch.Tensor"):
        store.put("a", "p", {"x": [torch.ones(3)]}, "fp")
