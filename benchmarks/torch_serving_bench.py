"""Serving throughput sweep on the port: the paged engine against the dense
lockstep batcher.

The port's copy of ``benchmarks/serving_bench.py``: the same slots x
arrival x length-mix grid over the same traces (seeds 5, 11, 7, 3;
``FIXED_LENS``; arrival rates 0.3 and 1.0 in the full mode), the same
engine parameters (dense: 4 slots; paged: 16 and 64 slots, page 16,
``chunk_max`` 32, ``drain_every`` 8, ``prefill_chunks_per_tick`` 4;
``max_len`` 128), the same request counts (``--smoke``: 96 requests x 24
new tokens, else 192 x 48) and the same ``summary`` keys, so the unchanged
``check_serving_regression.py`` gates it.

Model: gemma-2b.  ``--width full`` (the default on the card) serves it at
its full width in bf16 with seed-0 random weights -- 18 layers, or the
first ``--layers`` L of them, a labelled depth cut ``gemma-2b@L``;
``--width smoke`` (the default on the host) the reference's smoke config in
f32.  ``mode`` is ``"cuda"`` or ``"cpu"``.

* ``dense_*``  -- ``ContinuousBatcher``: 4 lockstep slots, one host read a
  tick, a full prefill (the flash kernel on the card) at admission.
* ``paged_*``  -- ``PagedServingEngine`` at 16 / 64 slots: chunked prefill
  on the power-of-two ladder, device-resident decode blocks, one host read
  a block of ``drain_every`` ticks.
* ``steady``   -- the paged engine on single-chunk prompts arriving at t=0:
  its median tick wall is the no-prefill steady state the p99 gate reads.

Eager PyTorch traces nothing, so unlike the reference on JAX's CPU
(``speedup_64`` 29.6 there, from the dense batcher re-tracing each novel
prompt length; 0.87 warm) the port's ``speedup_64`` is the batching gain
alone: 64 slots decode in one step what 4 slots decode in sixteen.

    python benchmarks/torch_serving_bench.py [--smoke] [--device cuda|cpu]
        [--width full|smoke] [--layers L] [--requests N] [--out FILE]

Gate: ``python benchmarks/check_serving_regression.py --current
BENCH_torch_serving_smoke.json --baseline
benchmarks/baselines/torch_serving_baseline.json`` (unchanged).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

# make `python benchmarks/torch_serving_bench.py` work from the root
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for _p in (_ROOT, os.path.join(_ROOT, "src")):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.gemma_2b import smoke  # noqa: E402
from repro_torch.launch.serve import (ContinuousBatcher, PagedServingEngine,  # noqa: E402
                                      Request)
from repro_torch.models import LanguageModel  # noqa: E402
from repro_torch.models.layers import torch_dtype  # noqa: E402

FIXED_LENS = (4, 11, 23, 40, 57)
MAX_LEN = 128


def make_trace(n_requests: int, kind: str, max_new: int, vocab: int,
               seed: int = 0, arrival_rate: float = 0.0) -> list[Request]:
    """Deterministic trace per seed so every engine sees identical requests.
    ``kind``: "mixed" = lengths uniform in [4, 60]; "fixed" = the five
    warmed lengths; "short" = single-chunk prompts.  ``arrival_rate`` 0 =
    burst at t=0, else geometric inter-arrival in ticks."""
    rng = np.random.RandomState(seed)
    reqs, t = [], 0
    for i in range(n_requests):
        if kind == "mixed":
            plen = int(rng.randint(4, 61))
        elif kind == "fixed":
            plen = FIXED_LENS[i % len(FIXED_LENS)]
        else:
            plen = int(rng.choice([3, 6, 9]))
        prompt = rng.randint(0, vocab, size=plen).tolist()
        reqs.append(Request(rid=i, prompt=prompt, max_new=max_new, arrival=t))
        if arrival_rate > 0:
            t += int(rng.geometric(min(1.0, arrival_rate)))
    return reqs


def clone(trace: list[Request]) -> list[Request]:
    return [Request(r.rid, list(r.prompt), r.max_new, r.arrival)
            for r in trace]


def run_scenario(engine, requests: list[Request]) -> dict:
    t0 = time.perf_counter()
    stats = engine.run(requests)
    stats["bench_wall_s"] = time.perf_counter() - t0
    return stats


def warm(engine, vocab: int) -> None:
    """The reference's warm-up: a 63-token prompt walks the paged engine's
    whole chunk ladder (32+16+8+4+2+1) and the five FIXED_LENS prefill once
    in the dense batcher.  Eager PyTorch compiles nothing; this pays the
    first launches, the allocator's first blocks and the kernels' load."""
    rng = np.random.RandomState(99)
    plens = [63, *FIXED_LENS]
    reqs = [Request(rid=-1 - i, prompt=rng.randint(0, vocab, p).tolist(),
                    max_new=3) for i, p in enumerate(plens)]
    engine.run(reqs)


def build_model(width: str, layers: int | None, device: str):
    """(model, weights in the compute dtype, KV dtype, the model's label)."""
    if width == "full":
        cfg = get_config("gemma-2b")
        if layers:
            cfg = cfg.scaled(name=f"gemma-2b@{layers}", n_layers=layers)
        label = f"{cfg.name}-full-bf16"
    else:
        cfg = smoke().scaled(compute_dtype="float32")
        label = "gemma-2b-smoke-f32"
    model = LanguageModel(cfg, device=device)
    params = model.cast_for_compute(model.init(0))
    return model, params, torch_dtype(cfg.compute_dtype), label


def _card(device: str) -> str | None:
    if device != "cuda":
        return None
    import subprocess

    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.CalledProcessError, IndexError):
        return torch.cuda.get_device_name(0)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--smoke", action="store_true",
                    help="CI subset: fewer requests, shorter generations")
    ap.add_argument("--out", default=None)
    ap.add_argument("--requests", type=int, default=None)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--width", choices=("full", "smoke"), default=None,
                    help="full: gemma-2b at full width, bf16 (default on the "
                         "card); smoke: the smoke config in f32 (default on "
                         "the host)")
    ap.add_argument("--layers", type=int, default=None,
                    help="a depth cut of the full width: its first L layers")
    args = ap.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("torch_serving_bench: no CUDA device (--device cpu "
                         "serves on the host)")
    width = args.width or ("full" if args.device == "cuda" else "smoke")

    from repro_torch.kernels import flash_attention as fa

    model, params, dtype, label = build_model(width, args.layers, args.device)
    vocab = model.cfg.vocab_size
    n_req = args.requests or (96 if args.smoke else 192)
    max_new = 24 if args.smoke else 48

    def paged(n_slots):
        return PagedServingEngine(model, params, n_slots=n_slots,
                                  max_len=MAX_LEN, page_size=16,
                                  chunk_max=32, drain_every=8,
                                  prefill_chunks_per_tick=4, dtype=dtype)

    engines = {
        "dense": ContinuousBatcher(model, params, n_slots=4, max_len=MAX_LEN,
                                   enc_len=0),
        16: paged(16),
        64: paged(64),
    }
    for eng in engines.values():
        warm(eng, vocab)
    fa.launches = 0

    scenarios: dict[str, dict] = {}
    t_grid = time.perf_counter()

    # --- warmed fixed-length burst -------------------------------------
    fixed_tr = make_trace(n_req, "fixed", max_new, vocab, seed=5)
    scenarios["dense_s4_fixed"] = run_scenario(engines["dense"],
                                               clone(fixed_tr))
    scenarios["paged_s64_fixed"] = run_scenario(engines[64], clone(fixed_tr))

    # --- headline: continuous mixed lengths, 64+ concurrent streams -----
    mixed_tr = make_trace(n_req, "mixed", max_new, vocab, seed=11)
    for n_slots in (16, 64):
        scenarios[f"paged_s{n_slots}_mixed"] = run_scenario(
            engines[n_slots], clone(mixed_tr))
    scenarios["dense_s4_mixed"] = run_scenario(engines["dense"],
                                               clone(mixed_tr))

    # --- arrival-rate sweep on the paged engine (full mode only) --------
    if not args.smoke:
        for rate in (0.3, 1.0):
            tr = make_trace(n_req, "mixed", max_new, vocab, seed=7,
                            arrival_rate=rate)
            scenarios[f"paged_s64_mixed_r{rate}"] = run_scenario(
                engines[64], tr)

    # --- no-prefill steady state: single-chunk prompts, batch arrival ---
    steady_tr = make_trace(n_req, "short", max_new, vocab, seed=3)
    scenarios["steady_s64_short"] = run_scenario(engines[64], steady_tr)
    grid_s = time.perf_counter() - t_grid

    dense_tps = scenarios["dense_s4_mixed"]["tok_per_s"]
    paged_tps = scenarios["paged_s64_mixed"]["tok_per_s"]
    steady_p50 = scenarios["steady_s64_short"]["tick_ms_p50"]
    mixed_p99 = scenarios["paged_s64_mixed"]["tick_ms_p99"]
    out = {
        "mode": torch.device(args.device).type,
        "model": label,
        "card": _card(args.device),
        "n_requests": n_req,
        "max_new": max_new,
        "grid_wall_s": grid_s,
        "launches": {"flash": fa.launches},
        "scenarios": scenarios,
        "summary": {
            "dense_tok_per_s": dense_tps,
            "paged64_tok_per_s": paged_tps,
            "speedup_64": paged_tps / max(dense_tps, 1e-9),
            "speedup_64_warm": (scenarios["paged_s64_fixed"]["tok_per_s"]
                                / max(scenarios["dense_s4_fixed"]
                                      ["tok_per_s"], 1e-9)),
            "steady_tick_ms_p50": steady_p50,
            "mixed_tick_ms_p99": mixed_p99,
            "p99_over_steady_p50": mixed_p99 / max(steady_p50, 1e-9),
        },
    }
    path = args.out or ("BENCH_torch_serving_smoke.json" if args.smoke
                        else "BENCH_torch_serving.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=2)

    s = out["summary"]
    print(f"{label} [{out['mode']}; {out['card']}], grid {grid_s:.1f} s")
    print(f"dense 4-slot  : {dense_tps:8.1f} tok/s (mixed lengths)")
    print(f"paged 64-slot : {paged_tps:8.1f} tok/s "
          f"({s['speedup_64']:.2f}x; warm fixed-length "
          f"{s['speedup_64_warm']:.2f}x)")
    print(f"p99 tick {mixed_p99:.2f}ms vs steady p50 {steady_p50:.2f}ms "
          f"({s['p99_over_steady_p50']:.2f}x)")
    for name, sc in scenarios.items():
        print(f"  {name:>24}: {sc['tok_per_s']:8.1f} tok/s  "
              f"p99_lat {sc.get('p99_latency_ticks', -1.0):6.0f} ticks  "
              f"stall {sc.get('prefill_stall_fraction', 0.0):.3f}  "
              f"syncs {sc['host_syncs']}/{sc['ticks']} ticks  "
              f"wall {sc['wall_s']:.2f} s")
    print(f"wrote {path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
