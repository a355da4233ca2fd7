"""Multi-node dry run: one train, prefill or decode step of every
(architecture x input shape x H100 mesh) cell, priced without a card (the
port's counterpart of ``repro.launch.dryrun``).

The reference lowers and compiles each cell for a 512-device host mesh and
reads XLA's analyses.  Here each cell runs once on a fake process group
(``fake`` backend, ``FakeStore``) of 256 or 512 ranks, as rank 0 of the
catalog's H100 meshes (``core/platforms.py``): ``32x8`` is ``(data 32,
model 8)``, ``2x32x8`` is ``(pod 2, data 32, model 8)``.  The model, its
AdamW state, the batch and the cache are fake tensors (``FakeTensorMode``:
shapes and dtypes, no storage) laid out as DTensors by ``param_axes``; the
step runs under ``use_mesh_info`` through the port's own code, and:

* argument bytes per rank are the local shards of everything the step
  takes (``analysis.argument_bytes``), exact, against the card's 80 GB;
* collective bytes per rank are counted from the collectives that run
  issues (``analysis.CollectiveCounter``);
* FLOPs and HBM bytes come from ``launch/flops.py``, the roofline from
  ``analysis.roofline`` at the H100's rates.

The cell JSON keeps the reference's schema.  ``lower_s`` is the time to lay
out the fake state and ``compile_s`` the time of the fake step (the
counterparts of lowering and compiling).  The reference's
``cost_analysis_raw`` (XLA's own count) has no counterpart and is left out,
and so is any peak: ``memory_analysis`` holds the argument bytes only.

The fake process group is global to the process: a process that has a real
one must run ``run_cell`` in a child.  Run from the repository root:

    python -m repro_torch.launch.dryrun --arch gemma-2b --shape train_4k \\
        --mesh single
    python -m repro_torch.launch.dryrun --plan [--objective min_cost]
    python -m repro_torch.launch.dryrun --resume RUN --journal-dir DIR
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
import traceback

import torch
import torch.distributed as dist

from repro_torch.configs import (SHAPES, applicable_shapes, get_config,
                                 list_configs)
from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.core.platforms import H100_SXM, default_catalog
from repro_torch.distributed.sharding import MeshInfo, use_mesh_info
from repro_torch.launch import analysis, flops as flops_mod
from repro_torch.launch.specs import (batch_specs, cache_input_specs,
                                      decode_token_specs, param_specs)
from repro_torch.launch.train import make_train_step
from repro_torch.models import LanguageModel
from repro_torch.optim import AdamW, OptConfig

#: cell name -> catalog platform whose (shape, axes) it runs
MESHES = {"32x8": "pod-spot", "2x32x8": "multipod-spot"}
MESH_ARGS = {"single": ["32x8"], "multi": ["2x32x8"],
             "both": ["32x8", "2x32x8"]}
HBM_LIMIT_BYTES = H100_SXM.hbm_gb * 1e9


def model_flops(cfg: ModelConfig, shape: ShapeSpec) -> float:
    """Assignment formula: 6*N*D train (N_active for MoE); 2*N*D inference."""
    n = active_param_count(cfg)
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch  # decode: one token per sequence


def active_param_count(cfg: ModelConfig) -> int:
    if cfg.n_experts == 0:
        return cfg.param_count()
    n_moe_layers = sum(
        1 for i, t in enumerate(cfg.layer_types())
        if cfg.n_experts > 0 and i >= cfg.first_dense_layers
        and t in ("attn", "swa"))
    routed = cfg.n_experts * 3 * cfg.d_model * cfg.d_ff_expert
    active = cfg.top_k * 3 * cfg.d_model * cfg.d_ff_expert
    return cfg.param_count() - n_moe_layers * (routed - active)


def mesh_layout(mesh_name: str) -> tuple[tuple[int, ...], tuple[str, ...]]:
    """The (shape, axis names) of a named cell mesh, from the catalog."""
    plat = default_catalog()[MESHES[mesh_name]]
    return tuple(plat.mesh_shape), tuple(plat.mesh_axes)


@contextlib.contextmanager
def fake_world(shape: tuple[int, ...], axes: tuple[str, ...]):
    """A fake process group of prod(shape) ranks (this process is rank 0)
    and a CPU ``DeviceMesh`` over it; the group is destroyed on exit."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group is already up: run the dry run "
                           "in a process of its own")
    from torch.distributed.tensor import placement_types

    n = 1
    for s in shape:
        n *= s
    dist.init_process_group("fake", rank=0, world_size=n, store=FakeStore())
    # DTensor swaps a split dim over gloo (a CPU mesh) as an all-gather and a
    # chunk; the cards' NCCL swaps it all-to-all, which is what is counted
    cpu_swap = getattr(placement_types, "shard_dim_alltoall", None)
    if cpu_swap is not None:
        placement_types.shard_dim_alltoall = _nccl_swap
    try:
        yield MeshInfo(init_device_mesh("cpu", shape, mesh_dim_names=axes))
    finally:
        if cpu_swap is not None:
            placement_types.shard_dim_alltoall = cpu_swap
        dist.destroy_process_group()


def _nccl_swap(input, gather_dim, shard_dim, mesh, mesh_dim):
    """DTensor's shard-dim swap as it runs on a non-CPU mesh: one
    all-to-all (``_dtensor::shard_dim_alltoall``)."""
    return torch.ops._dtensor.shard_dim_alltoall(
        input, gather_dim, shard_dim, mesh.get_group(mesh_dim).group_name)


def _step(cfg: ModelConfig, shape: ShapeSpec, info: MeshInfo):
    """Lay out the cell's fake arguments, then return (its arguments, the
    function that runs its step)."""
    if shape.kind == "train":
        model = LanguageModel(cfg, device="cpu")
        opt = AdamW(OptConfig())
        params = param_specs(model, info)
        args = (params, opt.init(params), batch_specs(cfg, shape, info))
        step = make_train_step(model, opt)
        return args, lambda: step(*args)

    # serving cells carry bf16 weights (no optimizer state)
    serve_cfg = cfg.scaled(param_dtype="bfloat16")
    model = LanguageModel(serve_cfg, device="cpu")
    params = param_specs(model, info)
    cache = cache_input_specs(model, shape, info)
    if shape.kind == "prefill":
        args = (params, batch_specs(serve_cfg, shape, info), cache)
        return args, lambda: model.prefill(*args)
    tokens, pos = decode_token_specs(serve_cfg, shape, info)
    args = (params, tokens, cache, pos)
    return args, lambda: model.decode_step(*args)


def run_cell(arch: str, shape_name: str, mesh_name: str = "32x8", *,
             cfg: ModelConfig | None = None, shape: ShapeSpec | None = None,
             layout: tuple | None = None) -> dict:
    """One cell's record in the reference's schema.  ``cfg``, ``shape`` and
    ``layout`` ((mesh shape, axis names)) replace the registry's config,
    the named shape and the named mesh (the tests run smoke widths on a
    small fake mesh)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    cfg = cfg or get_config(arch)
    shape = shape or SHAPES[shape_name]
    mesh_shape, axes = layout or mesh_layout(mesh_name)
    cell = {"arch": arch, "shape": shape.name, "mesh": mesh_name,
            "kind": shape.kind}
    if shape.name == "long_500k" and not cfg.is_subquadratic:
        cell["status"] = "skipped"
        cell["reason"] = "full-attention arch: long_500k skipped per assignment"
        return cell

    t0 = time.time()
    try:
        with fake_world(mesh_shape, axes) as info, use_mesh_info(info), \
                FakeTensorMode(allow_non_fake_inputs=True):
            n_chips = dist.get_world_size()
            args, run = _step(cfg, shape, info)
            t_lower = time.time() - t0
            counter = analysis.CollectiveCounter()
            grad = torch.enable_grad() if shape.kind == "train" \
                else torch.no_grad()
            with grad, counter:
                run()
            t_step = time.time() - t0 - t_lower
            arg_bytes = analysis.argument_bytes(*args)
            tp = info.axis_size("model")
        coll = counter.summary()
        mf = model_flops(cfg, shape)
        step_cfg = cfg if shape.kind == "train" else \
            cfg.scaled(param_dtype="bfloat16")
        flops = flops_mod.step_flops(step_cfg, shape) / n_chips
        hbm_bytes = flops_mod.step_hbm_bytes(step_cfg, shape, n_chips, tp)
        cell.update({
            "status": "ok",
            "n_chips": n_chips,
            "lower_s": round(t_lower, 2),
            "compile_s": round(t_step, 2),
            "memory_analysis": {"argument_size_in_bytes": float(arg_bytes)},
            "hbm_limit_bytes": HBM_LIMIT_BYTES,
            "fits_hbm": arg_bytes <= HBM_LIMIT_BYTES,
            "analytic_flops_per_device": flops,
            "analytic_hbm_bytes_per_device": hbm_bytes,
            "collective_bytes": coll,
            "collective_ops": counter.op_counts(),
            "model_flops": mf,
            "params_total": cfg.param_count(),
            "params_active": active_param_count(cfg),
            "roofline": analysis.roofline(
                flops_per_device=flops, hbm_bytes_per_device=hbm_bytes,
                coll_bytes_per_device=coll["total"], model_flops_total=mf,
                n_chips=n_chips),
        })
    except Exception as e:
        cell["status"] = "error"
        cell["error"] = f"{type(e).__name__}: {e}"
        cell["traceback"] = traceback.format_exc()[-4000:]
    return cell


def plan_preview(objective_name: str, time_value: float,
                 budget_usd: float | None, deadline_h: float | None,
                 plan_rows: int = 50, select: str | None = None,
                 adaptive: bool = False,
                 drift: "list[str] | None" = None) -> None:
    """Orchestration dry run: the global planner's assignment for the paper's
    Common Crawl pipeline, printed as a per-task table (truncated past
    ``plan_rows`` tasks to a per-asset/platform summary) with predicted
    cost, slot contention and makespan against the greedy per-task factory;
    no tensor work.  ``select`` is an asset-selection expression (e.g.
    ``"cc_fetch+"``, ``"tag:k=v"``, ``"*"``) parsed by
    ``AssetSelection.parse``, the surface ``RunCoordinator.plan()`` and
    ``materialize()`` accept.

    ``adaptive`` previews the closed-loop planner: pricing through an
    ``OnlineCostModel`` and a preemption-aware schedule.  ``drift`` entries
    ``asset@platform=ratio`` seed the online model with assumed realized /
    predicted duration ratios."""
    from repro_torch.core import (AssetSelection, CostModel,
                                  DynamicClientFactory, Objective,
                                  OnlineCostModel, RunPlanner, SlotConfig,
                                  default_catalog)

    try:
        from benchmarks.torch_cc_pipeline import SMALL, build_graph
        graph, default_sel = build_graph(partitions=SMALL), "graph_aggr"
    except ImportError:  # installed as a package without the benchmarks dir
        from repro_torch.core import AssetGraph, ComputeProfile, asset
        a = asset(name="extract",
                  compute=ComputeProfile(work_chip_hours=200.0,
                                         speedup_class="scan"))(lambda ctx: 0)
        b = asset(name="transform", deps=("extract",),
                  compute=ComputeProfile(work_chip_hours=26.0,
                                         speedup_class="shuffle"))(
                      lambda ctx, extract: 0)
        graph, default_sel = AssetGraph([a, b]), "transform"
    selection = AssetSelection.parse(select or default_sel)

    objective = {
        "min_cost": Objective.min_cost,
        "min_time": Objective.min_time,
        "balanced": lambda: Objective.balanced(time_value),
    }[objective_name]().constrained(budget_usd=budget_usd,
                                    deadline_s=None if deadline_h is None
                                    else deadline_h * 3600.0)
    cost_model = CostModel()
    if adaptive or drift:
        online = OnlineCostModel(base=cost_model)
        for spec_str in drift or []:
            # asset@platform=ratio: seed the EWMA well past
            # min_observations so the ratio dominates
            lhs, _, ratio = spec_str.partition("=")
            a, _, p = lhs.partition("@")
            if not (a and p and ratio):
                raise SystemExit(f"bad --drift {spec_str!r} "
                                 f"(want asset@platform=ratio)")
            for _ in range(8):
                online.observe(a, p, "success", predicted_s=1.0,
                               realized_s=float(ratio))
        cost_model = online
    factory = DynamicClientFactory(default_catalog(), cost_model, objective)
    # the default SlotConfig matches RunCoordinator's execution limits, so
    # the previewed makespan accounts for finite per-platform slots
    plan = RunPlanner(graph, factory, slots=SlotConfig(),
                      preemption_aware=adaptive or bool(drift)).plan(selection)
    mode = " adaptive" if adaptive or drift else ""
    print(f"run plan ({objective.name}{mode}, "
          f"select={select or default_sel!r}, "
          f"{len(plan.choices)} tasks, {plan.iterations} iterations):")
    print(plan.table(max_rows=plan_rows))


def resume_preview(journal_dir: str, run_id: str) -> None:
    """Crash-recovery dry run: replay a run journal (torn-tail tolerant)
    and print what ``RunCoordinator.resume`` would do -- landed work, money
    already spent, and the in-flight frontier it would re-launch -- without
    executing anything."""
    from repro_torch.core import JournalState, RunJournal

    if not RunJournal.exists(journal_dir, run_id):
        raise SystemExit(f"no journal for run {run_id!r} in {journal_dir}")
    records, dropped = RunJournal.load(journal_dir, run_id)
    state = JournalState.from_records(records, dropped)
    print(state.summary())
    if state.ended and state.ok:
        print("run ended ok: nothing to resume")
    else:
        print(f"resume would re-launch {len(state.frontier())} frontier "
              f"task(s) and carry {len(state.succeeded)} landed "
              f"materialization(s)")


def main() -> None:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default=None, help="one arch (default: all)")
    ap.add_argument("--shape", default=None, help="one shape (default: all)")
    ap.add_argument("--mesh", default="both", choices=list(MESH_ARGS),
                    help="single: 32x8 (256 ranks); multi: 2x32x8 (512)")
    ap.add_argument("--out", default="artifacts/dryrun_torch")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--plan", action="store_true",
                    help="print the DAG-level run-plan preview and exit")
    ap.add_argument("--objective", default="balanced",
                    choices=["min_cost", "min_time", "balanced"])
    ap.add_argument("--time-value", type=float, default=60.0,
                    help="USD/hour of wall-clock (balanced objective)")
    ap.add_argument("--budget-usd", type=float, default=None)
    ap.add_argument("--deadline-h", type=float, default=None)
    ap.add_argument("--plan-rows", type=int, default=50,
                    help="max per-task rows in the --plan table before "
                         "truncating to a per-asset/platform summary")
    ap.add_argument("--select", default=None,
                    help="asset selection for --plan, e.g. 'cc_fetch+' "
                         "(asset + downstream cone), '+graph_aggr', "
                         "'tag:stage=ingest', '*'")
    ap.add_argument("--adaptive", action="store_true",
                    help="with --plan: preview the closed-loop planner "
                         "(online cost model + preemption-aware schedule)")
    ap.add_argument("--drift", action="append", default=None,
                    metavar="ASSET@PLATFORM=RATIO",
                    help="with --plan: seed an assumed duration drift, e.g. "
                         "cc_edges@pod-spot=3.0 (repeatable; implies "
                         "adaptive pricing)")
    ap.add_argument("--resume", default=None, metavar="RUN_ID",
                    help="preview crash recovery for a journaled run: "
                         "replay its journal and print landed/billed/"
                         "frontier state (requires --journal-dir)")
    ap.add_argument("--journal-dir", default=None,
                    help="run-journal directory for --resume")
    args = ap.parse_args()

    if args.resume:
        if not args.journal_dir:
            raise SystemExit("--resume requires --journal-dir")
        resume_preview(args.journal_dir, args.resume)
        return

    if args.plan:
        plan_preview(args.objective, args.time_value, args.budget_usd,
                     args.deadline_h, plan_rows=args.plan_rows,
                     select=args.select, adaptive=args.adaptive,
                     drift=args.drift)
        return

    if args.list:
        for a in list_configs():
            cfg = get_config(a)
            print(a, [s.name for s in applicable_shapes(cfg)])
        return

    archs = [args.arch] if args.arch else list_configs()
    os.makedirs(args.out, exist_ok=True)
    failures = 0
    for arch in archs:
        # every shape: run_cell records inapplicable cells as 'skipped'
        for shape_name in [args.shape] if args.shape else list(SHAPES):
            for mesh_name in MESH_ARGS[args.mesh]:
                cell = run_cell(arch, shape_name, mesh_name)
                out_path = os.path.join(
                    args.out, f"{arch}__{shape_name}__{mesh_name}.json")
                with open(out_path, "w") as f:
                    json.dump(cell, f, indent=1)
                status = cell["status"]
                extra = ""
                if status == "ok":
                    r = cell["roofline"]
                    extra = (f" bottleneck={r['bottleneck']}"
                             f" step={r['step_time_s']:.4f}s"
                             f" args={cell['memory_analysis']['argument_size_in_bytes'] / 1e9:.2f}GB"
                             f"{'' if cell['fits_hbm'] else ' (does not fit 80 GB)'}"
                             f" fake step={cell['compile_s']:.1f}s")
                elif status == "error":
                    failures += 1
                    extra = " " + cell["error"][:200]
                print(f"DRYRUN {arch} x {shape_name} x {mesh_name}: "
                      f"{status}{extra}", flush=True)
    if failures:
        raise SystemExit(f"{failures} dry-run cells failed")


if __name__ == "__main__":
    main()
