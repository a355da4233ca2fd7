"""Kernel tile sweep on the port: autotune the flash-attention and WKV
kernels over the model-config zoo and record tuned-vs-default speedups.

The port's copy of ``benchmarks/kernel_bench.py`` on
``repro_torch.kernels``: the same twelve configs at the same shapes, the
same ``--smoke`` subset, the same JSON keys and the same sweep through
``Autotuner.tune(force=True)``, on the hand-written Hopper kernels.  The
tiles are the kernels' own: 64-row q tiles against 64- or 128-key tiles on
the flash kernel's ``wgmma`` body at Dv <= 128 (one tile on its ``mma.sync``
body at D 80 and 96 and at Dv 256), 32- or 64-step chunks on the WKV
chunked body; the default is 64 / 64 / 64 (``kernels/ops.py``).

For each config the sweep:

1. generates the valid tile candidates (``attention_candidates`` /
   ``scan_candidates``: the SM shared-memory fit, the default always among
   them),
2. times every candidate through the tuner with ``force=True``, so a
   shipped cache never mixes another card's numbers into this run, and
   persists the winner (``REPRO_TORCH_AUTOTUNE_CACHE`` picks the file),
3. reads the default tile's time out of the same sweep, so
   ``speedup = default_us / tuned_us >= 1.0`` by construction,
4. derives the roofline fraction (FLOPs over the H100's 989 TFLOP/s,
   ``repro_torch.core.platforms.H100_SXM``), and beside it the tuned
   tile's device time (``torch.profiler``) against one library call
   computing the same function (``F.scaled_dot_product_attention``, its
   backend named; none for the WKV scan) and the least time the card could
   take (``bound_ms``: the unmasked pairs' FLOPs or the bytes moved once).

``mode`` is ``"cuda"`` on the card and ``"cpu"`` with ``--device cpu``,
where the plain versions run, every tile alike, on the host's clock.

    python benchmarks/torch_kernel_bench.py [--smoke] [--device cuda|cpu]
        [--out BENCH_torch_kernels.json]

Gate: ``python benchmarks/check_kernel_regression.py --current
BENCH_torch_kernels.json --baseline
benchmarks/baselines/torch_kernel_bench_baseline.json`` (unchanged).
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys

# make `python benchmarks/torch_kernel_bench.py` work from the root
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for _p in (_ROOT, os.path.join(_ROOT, "src")):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.core.platforms import H100_SXM  # noqa: E402
from repro_torch.kernels import autotune as at  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import linear_scan as ls  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

PEAK_FLOPS = H100_SXM.peak_flops
PEAK_BYTES = H100_SXM.hbm_bw
#: the f32 rate on the CUDA cores, which bound the WKV recurrence's
#: arithmetic (H100 SXM data sheet)
PEAK_F32 = 67e12

#: the 12 kernel workload configs of ``benchmarks/kernel_bench.py`` (11
#: attention variants + WKV), at its shapes
ATTN_CONFIGS = [
    dict(name="whisper-medium-enc-self", B=1, Sq=512, Skv=512, Hq=2, Hkv=2,
         D=64, Dv=64, causal=False, window=0),
    dict(name="whisper-medium-dec-self", B=1, Sq=512, Skv=512, Hq=2, Hkv=2,
         D=64, Dv=64, causal=True, window=0),
    dict(name="whisper-medium-xattn", B=1, Sq=256, Skv=512, Hq=2, Hkv=2,
         D=64, Dv=64, causal=False, window=0),
    dict(name="danube3-500m-swa-gqa", B=1, Sq=512, Skv=512, Hq=2, Hkv=1,
         D=80, Dv=80, causal=True, window=256),
    dict(name="gemma-2b-mqa", B=1, Sq=512, Skv=512, Hq=2, Hkv=1,
         D=256, Dv=256, causal=True, window=0),
    dict(name="minicpm3-mla", B=1, Sq=512, Skv=512, Hq=2, Hkv=2,
         D=96, Dv=64, causal=True, window=0),
    dict(name="deepseek-7b-mha", B=1, Sq=512, Skv=512, Hq=2, Hkv=2,
         D=128, Dv=128, causal=True, window=0),
    dict(name="recurrentgemma-2b-swa-mqa", B=1, Sq=512, Skv=512, Hq=2, Hkv=1,
         D=256, Dv=256, causal=True, window=128),
    dict(name="deepseek-v2-lite-mla", B=1, Sq=512, Skv=512, Hq=2, Hkv=2,
         D=192, Dv=128, causal=True, window=0),
    dict(name="granite-moe-gqa", B=1, Sq=512, Skv=512, Hq=2, Hkv=1,
         D=64, Dv=64, causal=True, window=0),
    dict(name="qwen2-vl-2b-gqa", B=1, Sq=512, Skv=512, Hq=2, Hkv=1,
         D=128, Dv=128, causal=True, window=0),
]
WKV_CONFIGS = [
    dict(name="rwkv6-1b6-wkv", B=1, S=512, H=2, N=64),
]

#: the reference's CI subset: one config per kernel family
SMOKE_NAMES = ("whisper-medium-enc-self", "gemma-2b-mqa", "deepseek-7b-mha",
               "rwkv6-1b6-wkv")

DEFAULT_ATTN = {"block_q": ops.DEFAULT_BLOCK_Q, "block_k": ops.DEFAULT_BLOCK_K}
DEFAULT_SCAN = {"chunk": ops.DEFAULT_CHUNK}


def _attn_flops(c: dict) -> float:
    """QK^T + PV matmul FLOPs the reference counts (mask-aware: causal
    halves the score area, a window caps the k extent per query)."""
    Skv = c["Skv"]
    if c["window"]:
        pairs = c["Sq"] * min(c["window"] + 1, Skv)
    elif c["causal"]:
        pairs = c["Sq"] * (Skv - (c["Sq"] - 1) / 2.0)
    else:
        pairs = c["Sq"] * Skv
    return 2.0 * c["B"] * c["Hq"] * pairs * (c["D"] + c["Dv"])


def _wkv_flops(c: dict) -> float:
    """State update (k v^T + decay) plus readout (r . S) per step."""
    return 4.0 * c["B"] * c["S"] * c["H"] * c["N"] * c["N"]


def _cfg_key(cfg: dict) -> str:
    return json.dumps(cfg, sort_keys=True)


def _visible(c: dict, q_offset: int) -> torch.Tensor:
    """(Sq, Skv) bool: which keys each query sees."""
    pq = q_offset + torch.arange(c["Sq"])[:, None]
    pk = torch.arange(c["Skv"])[None, :]
    mask = torch.ones((c["Sq"], c["Skv"]), dtype=torch.bool)
    if c["causal"]:
        mask &= pk <= pq
    if c["window"]:
        mask &= (pq - pk) < c["window"]
    return mask


def _bound(ops_: float, peak: float, nbytes: int) -> tuple[float, str]:
    """Least time in ms: the operations at the peak rate or the bytes moved
    once at the memory rate, whichever is longer."""
    t_ops, t_bytes = ops_ / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def device_ms(fn, reps: int = 5, kernels: dict | None = None) -> float | None:
    """Device ms a call from a ``torch.profiler`` trace of ``reps`` calls
    (``kernels`` receives the kernel names); None where the trace holds no
    device time (not measured)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = 0.0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            total += e.device_time / 1e3
            if kernels is not None:
                kernels[e.name] = kernels.get(e.name, 0.0) + e.device_time / 1e3 / reps
    return total / reps if total > 0 else None


def sdpa_backend(kernels: dict) -> str:
    """Which SDPA backend ran, from the names of the kernels it launched."""
    names = " ".join(kernels).lower()
    for key, backend in (("cudnn", "cudnn"), ("fmha", "efficient"),
                         ("efficient", "efficient"), ("flash", "flash")):
        if key in names:
            return backend
    return "math" if kernels else "not measured"


def _library_call(c: dict, q, k, v, q_offset: int):
    """One PyTorch call computing the same function: SDPA on (B, H, S, D)
    views with K/V heads repeated, the band mask given where it is not a
    plain causal or full one.  The port never calls it."""
    G = c["Hq"] // c["Hkv"]
    qt = q.transpose(1, 2)
    kt = k.repeat_interleave(G, dim=2).transpose(1, 2)
    vt = v.repeat_interleave(G, dim=2).transpose(1, 2)
    if c["causal"] and not c["window"] and q_offset == 0 and c["Sq"] == c["Skv"]:
        return lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    if not c["causal"] and not c["window"]:
        return lambda: F.scaled_dot_product_attention(qt, kt, vt)
    mask = _visible(c, q_offset).to(q.device)
    return lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)


def bench_attention(c: dict, tuner: at.Autotuner, *, device: str,
                    iters: int, warmup: int) -> dict:
    g = torch.Generator(device=device).manual_seed(0)
    dt = torch.bfloat16
    q, k, v = (torch.randn(s, generator=g, device=device).to(dt) for s in (
        (c["B"], c["Sq"], c["Hq"], c["D"]), (c["B"], c["Skv"], c["Hkv"], c["D"]),
        (c["B"], c["Skv"], c["Hkv"], c["Dv"])))
    q_offset = c["Skv"] - c["Sq"] if c["causal"] else 0

    def call(cfg: dict):
        return ops.flash_attention(
            q, k, v, causal=c["causal"], window=c["window"],
            q_offset=q_offset, block_q=cfg["block_q"], block_k=cfg["block_k"])

    def measure(cfg: dict) -> float:
        return at.measure_us(lambda: call(cfg), iters=iters, warmup=warmup)

    key = at.attention_key(q.shape, k.shape, v.shape, dt, causal=c["causal"],
                           window=c["window"], backend=at.backend_tag(device))
    cands = at.attention_candidates(c["Sq"], c["Skv"], c["D"], c["Dv"], dt)
    entry = tuner.tune(key, cands, measure, force=True, mode=_mode(device))
    row = _report(c, entry, DEFAULT_ATTN, measure, _attn_flops(c), key)
    out = call(row["tuned"])
    pairs = int(_visible(c, q_offset).sum())
    nbytes = sum(t.nbytes for t in (q, k, v, out))
    row["bound_ms"], row["bound_by"] = _bound(
        2.0 * c["B"] * c["Hq"] * pairs * (c["D"] + c["Dv"]), PEAK_FLOPS, nbytes)
    row["body"] = fa.body_of(dt, c["D"], c["Dv"])
    lib, lib_kernels = _library_call(c, q, k, v, q_offset), {}
    if device == "cuda":
        row["device_ms"] = device_ms(lambda: call(row["tuned"]))
        row["library_device_ms"] = device_ms(lib, kernels=lib_kernels)
        row["library_backend"] = sdpa_backend(lib_kernels)
    else:
        row["device_ms"] = row["library_device_ms"] = None
        row["library_backend"] = "not measured"
    row["library"] = "F.scaled_dot_product_attention"
    return row


def bench_wkv(c: dict, tuner: at.Autotuner, *, device: str,
              iters: int, warmup: int) -> dict:
    g = torch.Generator(device=device).manual_seed(1)
    shp = (c["B"], c["S"], c["H"], c["N"])
    r, k, v = (torch.randn(shp, generator=g, device=device) for _ in range(3))
    lw = -torch.exp(torch.rand(shp, generator=g, device=device) * 6.0 - 6.0)
    u = torch.randn((c["H"], c["N"]), generator=g, device=device) * 0.1
    s0 = torch.zeros((c["B"], c["H"], c["N"], c["N"]), device=device)
    args = (r, k, v, lw, u, s0)

    def measure(cfg: dict) -> float:
        return at.measure_us(
            lambda: ops.linear_scan(*args, chunk=cfg["chunk"])[0],
            iters=iters, warmup=warmup)

    key = at.scan_key(shp, torch.float32, backend=at.backend_tag(device))
    cands = at.scan_candidates(c["S"], c["N"])
    entry = tuner.tune(key, cands, measure, force=True, mode=_mode(device))
    row = _report(c, entry, DEFAULT_SCAN, measure, _wkv_flops(c), key)
    y, s_fin = ops.linear_scan(*args, chunk=row["tuned"]["chunk"])
    B, S, H, N = shp
    row["bound_ms"], row["bound_by"] = _bound(
        float(B * S * H) * (5 * N * N + 6 * N), PEAK_F32,
        sum(t.nbytes for t in args) + y.nbytes + s_fin.nbytes)
    row["body"] = "chunked"
    row["device_ms"] = (device_ms(lambda: ops.linear_scan(
        *args, chunk=row["tuned"]["chunk"])) if device == "cuda" else None)
    row["library"] = row["library_device_ms"] = row["library_backend"] = None
    return row


def _report(c: dict, entry: dict, default_cfg: dict, measure, flops: float,
            key: str) -> dict:
    """Per-config result row, as the reference's.  The default tile is
    always in the timed candidate set (same sweep, same noise), so the tuned
    minimum can never lose to it; were it not, it is timed now and a winner
    slower than the default is never reported."""
    tuned_cfg, tuned_us = entry["config"], float(entry["us"])
    default_us = entry["candidates"].get(_cfg_key(default_cfg))
    if default_us is None:
        default_us = measure(default_cfg)
    default_us = float(default_us)
    if tuned_us > default_us:  # only reachable when default wasn't swept
        tuned_cfg, tuned_us = dict(default_cfg), default_us
    shape = {k: v for k, v in c.items() if k != "name"}
    return {
        "kind": "attention" if "block_q" in tuned_cfg else "wkv",
        "shape": shape,
        "cache_key": key,
        "n_candidates": len(entry["candidates"]),
        "candidates_us": entry["candidates"],
        "tuned": tuned_cfg,
        "tuned_us": round(tuned_us, 2),
        "default": default_cfg,
        "default_us": round(default_us, 2),
        "speedup_vs_default": round(default_us / max(tuned_us, 1e-9), 3),
        "flops": flops,
        "roofline_frac": flops / (max(tuned_us, 1e-9) * 1e-6) / PEAK_FLOPS,
    }


def _mode(device: str) -> str:
    return torch.device(device).type


def _card() -> str | None:
    """The card's name and power limit, as nvidia-smi reports them."""
    import subprocess

    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.CalledProcessError, IndexError):
        return None


def run(*, smoke: bool = False, iters: int = 3, warmup: int = 1,
        device: str = "cuda") -> dict:
    if device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("torch_kernel_bench: no CUDA device (--device cpu "
                         "runs the plain versions)")
    tuner = at.get_tuner()
    fa.launches = ls.launches = 0
    out: dict = {
        "mode": _mode(device),
        "backend": at.backend_tag(device),
        "card": _card() if device == "cuda" else None,
        "peak_flops": PEAK_FLOPS,
        "configs": {},
    }
    sweep = [("attention", c) for c in ATTN_CONFIGS] + \
            [("wkv", c) for c in WKV_CONFIGS]
    if smoke:
        sweep = [(kind, c) for kind, c in sweep if c["name"] in SMOKE_NAMES]
    for kind, c in sweep:
        fn = bench_attention if kind == "attention" else bench_wkv
        row = fn(c, tuner, device=device, iters=iters, warmup=warmup)
        out["configs"][c["name"]] = row
        print(f"{c['name']:>28}: tuned {row['tuned']} {row['tuned_us']:9.2f}us"
              f"  default {row['default_us']:9.2f}us"
              f"  speedup {row['speedup_vs_default']:.3f}x"
              f"  ({row['n_candidates']} candidates)  device "
              f"{row['device_ms']} ms, library {row['library_device_ms']} ms"
              f" ({row['library_backend']}), bound {row['bound_ms']:.5f} ms",
              flush=True)
    attn_sp = [r["speedup_vs_default"] for r in out["configs"].values()
               if r["kind"] == "attention"]
    sp = [r["speedup_vs_default"] for r in out["configs"].values()]
    out["summary"] = {
        "n_configs": len(sp),
        "min_speedup": round(min(sp), 3),
        "attention_geomean_speedup": round(
            math.exp(sum(math.log(s) for s in attn_sp) / len(attn_sp)), 3)
        if attn_sp else None,
        "timing_calls": tuner.timing_calls,
    }
    out["launches"] = {"flash": fa.launches, "wkv": ls.launches}
    print(f"geomean attention speedup "
          f"{out['summary']['attention_geomean_speedup']}x, "
          f"min {out['summary']['min_speedup']}x [{out['mode']} mode; "
          f"{out['card']}]", flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--smoke", action="store_true",
                    help=f"CI subset: {', '.join(SMOKE_NAMES)}")
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--warmup", type=int, default=1)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out", default="BENCH_torch_kernels.json")
    args = ap.parse_args()
    out = run(smoke=args.smoke, iters=args.iters, warmup=args.warmup,
              device=args.device)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1, sort_keys=True)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
