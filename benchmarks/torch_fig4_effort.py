"""Fig 4: cumulative platform-adaptation effort until production stability.

The paper: EMR needed ~2x the trial runs of DBR before stabilizing, each
failure prompting a configuration change (YARN node labels, memory doubling,
vacuum parallelism...).  Model: a learning curve — every failed trial run
triggers one config change that multiplicatively reduces the platform's
failure odds toward its steady-state rate (the catalog value); a platform is
"production stable" after K consecutive clean runs.  Cumulative changes vs
trial index reproduces Fig 4's shape, and the trial-count ratio its ~2x gap.

The port's copy of ``benchmarks/fig4_effort.py``: a host-side simulation
with no tensor work, so ``run``'s ``device`` only keeps the interface the
other figures share.
"""
from __future__ import annotations

import numpy as np
import torch

# initial failure odds reflect each platform's out-of-box experience
# (§6: EMR "labor-intensive and fraught with technical challenges")
INITIAL_FAIL = {"pod-spot": 0.60, "pod-premium": 0.30}
STEADY_FAIL = {"pod-spot": 0.30, "pod-premium": 0.12}  # Fig-3 rates
LEARN = 0.85  # each config change removes 15% of the excess failure odds
STABLE_AFTER = 5  # consecutive clean trial runs


def simulate(platform: str, seed: int) -> dict:
    rng = np.random.RandomState(seed)
    fail = INITIAL_FAIL[platform]
    steady = STEADY_FAIL[platform]
    changes, trials, streak = 0, 0, 0
    curve = [(0, 0)]
    while streak < STABLE_AFTER and trials < 400:
        trials += 1
        if rng.rand() < fail:
            streak = 0
            changes += 1  # a failure forces a config revision
            fail = steady + (fail - steady) * LEARN
        else:
            streak += 1
        curve.append((trials, changes))
    return {"trials": trials, "changes": changes, "curve": curve}


def run(n_seeds: int = 40, device: torch.device | str = "cuda") -> dict:
    out = {}
    for plat in INITIAL_FAIL:
        runs = [simulate(plat, 1000 + s) for s in range(n_seeds)]
        out[plat] = {
            "mean_trials": float(np.mean([r["trials"] for r in runs])),
            "mean_changes": float(np.mean([r["changes"] for r in runs])),
            "p90_trials": float(np.percentile([r["trials"] for r in runs],
                                              90)),
            "example_curve": runs[0]["curve"][-1],
        }
    ratio = out["pod-spot"]["mean_trials"] / out["pod-premium"]["mean_trials"]
    out["trial_ratio_spot_over_premium"] = float(ratio)
    # the paper's "almost double the number of trial runs for EMR"
    assert 1.5 < ratio < 3.0, ratio
    return out


if __name__ == "__main__":
    import argparse
    import json
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda")
    print(json.dumps(run(device=ap.parse_args().device), indent=1,
                     default=float))
