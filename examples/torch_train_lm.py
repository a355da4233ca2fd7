"""End-to-end training driver example: orchestrated LM training on the
PyTorch port (the twin of ``examples/train_lm.py``).

The orchestrator treats each training STAGE (a span of steps ending in a
checkpoint) as an asset, so platform selection / retries / caching apply to
training itself: a preempted stage re-runs from its upstream checkpoint.
Each stage logs a CHECKPOINT event with the step it resumed from and the
seconds and bytes of its restore and its save.

Defaults are small (the arch's smoke config, B 4 x S 64, about a minute on
the CPU).  ``--full`` trains the arch at full width, B 2 x S 1024 at peak
lr 3e-4, on the card:
    python examples/torch_train_lm.py --full --stages 2 --steps 5

    PYTHONPATH=src python examples/torch_train_lm.py [--device cpu]
"""
import argparse

import torch

from repro_torch.core import (AssetGraph, ComputeProfile, CostModel,
                              DynamicClientFactory, Objective, RunCoordinator,
                              asset, default_catalog)
from repro_torch.launch.train import train

#: train() arguments of a stage: the smoke config's, and --full's
SMOKE = {"global_batch": 4, "seq_len": 64, "peak_lr": 5e-3}
FULL = {"global_batch": 2, "seq_len": 1024, "peak_lr": 3e-4}


def stage_graph(arch: str, stages: int, steps: int, ckpt_dir: str,
                full: bool = False,
                device: torch.device | str = "cuda") -> AssetGraph:
    """``stage0`` .. ``stage{stages-1}``: stage i trains to step
    ``(i + 1) * steps``, resuming from the checkpoint stage i - 1 wrote."""
    specs = []
    for i in range(stages):
        deps = (f"stage{i - 1}",) if i else ()

        def stage_fn(ctx, _i=i, **up):
            out = train(arch=arch, smoke=not full,
                        steps=(_i + 1) * steps, log_every=1,
                        ckpt_dir=ckpt_dir, resume=True, device=device,
                        **(FULL if full else SMOKE))
            ctx.log("CHECKPOINT", **out["checkpoint"])
            return {"losses": [h["loss"] for h in out["history"]],
                    "final_loss": out["final_loss"], "steps": out["steps"],
                    "resumed_step": out["checkpoint"]["resumed_step"]}

        specs.append(asset(
            name=f"stage{i}", deps=deps,
            compute=ComputeProfile(work_chip_hours=120.0,
                                   speedup_class="train"),
        )(stage_fn))
    return AssetGraph(specs)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="h2o-danube-1.8b")
    ap.add_argument("--stages", type=int, default=3)
    ap.add_argument("--steps", type=int, default=10, help="steps per stage")
    ap.add_argument("--ckpt-dir", default="artifacts/torch_train_lm_example")
    ap.add_argument("--full", action="store_true",
                    help="the arch at full width, B 2 x S 1024")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    graph = stage_graph(args.arch, args.stages, args.steps, args.ckpt_dir,
                        full=args.full, device=args.device)
    factory = DynamicClientFactory(default_catalog(), CostModel(),
                                   Objective.balanced(), sim_seed=1)
    coord = RunCoordinator(graph, factory)
    report = coord.materialize([f"stage{args.stages - 1}"])
    print(report.summary())
    last = coord.store.get(f"stage{args.stages - 1}", "__all__")
    print(f"trained {last['steps']} steps total; "
          f"final loss {last['final_loss']:.4f}")


if __name__ == "__main__":
    main()
