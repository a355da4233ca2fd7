"""The paper's decision logic applied to the LM substrate: feed each
(arch x shape) cell's dry-run roofline terms into the Dynamic Factory and
let the cost model choose the execution platform and price the job (the
port's copy of ``benchmarks/lm_platform_choice.py``).

It reads the port's dry-run cells, ``artifacts/dryrun_torch/*__32x8.json``
(``python -m repro_torch.launch.dryrun --mesh single``; another directory
through ``REPRO_TORCH_DRYRUN_DIR``), and prices each through
``repro_torch.core``: duration = max(compute, memory, collective roofline
term) x steps / perf_factor; cost = Table-1 structure.  A cell whose
arguments do not fit the card's 80 GB is priced all the same and marked.
"""
from __future__ import annotations

import glob
import json
import os

from repro_torch.core import (ComputeProfile, CostModel, DynamicClientFactory,
                              Objective, asset, default_catalog)

ART_DIR = os.environ.get("REPRO_TORCH_DRYRUN_DIR", "artifacts/dryrun_torch")


def profile_from_cell(cell: dict, steps: int = 1000) -> ComputeProfile:
    n = cell["n_chips"]
    return ComputeProfile(
        flops=cell["analytic_flops_per_device"] * n * steps,
        bytes_hbm=cell["analytic_hbm_bytes_per_device"] * n * steps,
        collective_bytes=cell["collective_bytes"]["total"] * n * steps,
        speedup_class="train" if cell["kind"] == "train" else "serve",
        min_chips=64,
        memory_gb_per_chip=(cell["memory_analysis"]
                            .get("argument_size_in_bytes", 0) / 2**30),
    )


def run(steps: int = 1000, art_dir: str | None = None) -> dict:
    factory = DynamicClientFactory(default_catalog(), CostModel(),
                                   Objective.balanced(), sim_seed=0)
    out = {}
    pattern = os.path.join(art_dir or ART_DIR, "*__32x8.json")
    for path in sorted(glob.glob(pattern)):
        with open(path) as f:
            cell = json.load(f)
        if cell.get("status") != "ok":
            continue
        name = f"{cell['arch']}:{cell['shape']}"
        spec = asset(name=name, compute=profile_from_cell(cell, steps))(
            lambda ctx: None)
        platform, est = factory.choose(spec)
        out[name] = {
            "platform": platform.name,
            "duration_h": round(est.duration_s / 3600.0, 2),
            "cost_usd": round(est.total_usd, 2),
            "surcharge_usd": round(est.surcharge_usd, 2),
            "fits_hbm": cell.get("fits_hbm", True),
        }
    return out


if __name__ == "__main__":
    table = run()
    print(f"{'cell':<38} {'platform':<16} {'hours':>7} {'cost':>10}")
    for k, v in table.items():
        print(f"{k:<38} {v['platform']:<16} {v['duration_h']:>7.2f} "
              f"${v['cost_usd']:>9.2f}"
              f"{'' if v['fits_hbm'] else '  (does not fit 80 GB)'}")
