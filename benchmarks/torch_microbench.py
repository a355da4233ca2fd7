"""Substrate microbenchmarks of the port: microseconds a call of six hot
paths, each iteration on its own between a synchronise and the next, with
the mean and the per-iteration standard deviation (a high ``std_us`` flags
a noisy cell before anyone chases a phantom regression).

The port's copy of ``benchmarks/microbench.py``, with the same six entries
at the same shapes.  Two are renamed, because what they time is no longer
a Pallas kernel in interpret mode: ``flash_attention_pallas_512`` is
``flash_attention_kernel_512`` and ``wkv_scan_pallas_512`` is
``wkv_scan_kernel_512``, the hand-written Hopper kernels through
``kernels/ops.py`` with ``tuned=True`` (on the card a miss times the tiles
once, in the warm-up; on the host the heuristic tile, and the plain
versions run).  The MoE and train-step entries run the port's ``moe``,
``make_train_step`` and ``AdamW``.

    python benchmarks/torch_microbench.py [--device cuda|cpu] [--out FILE]

On the card the times are the host's clock around each synchronised call,
launch work included; ``device`` in the JSON names the card.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

# make `python benchmarks/torch_microbench.py` work from the root
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for _p in (_ROOT, os.path.join(_ROOT, "src")):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import numpy as np  # noqa: E402
import torch  # noqa: E402


def _sync(device: str) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _stats(samples: list[float]) -> dict:
    mean = sum(samples) / len(samples)
    var = sum((s - mean) ** 2 for s in samples) / len(samples)
    return {"us": mean, "std_us": var ** 0.5, "iters": len(samples)}


def _bench(fn, *args, device: str, iters: int = 5, warmup: int = 2) -> dict:
    for _ in range(warmup):
        fn(*args)
        _sync(device)
    samples = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn(*args)
        _sync(device)
        samples.append((time.perf_counter() - t0) * 1e6)
    return _stats(samples)


def _randn(gen, shape, device, dtype=torch.float32):
    return torch.randn(shape, generator=gen, device=device).to(dtype)


def _wkv_args(gen, B, S, H, N, device):
    r, k, v = (_randn(gen, (B, S, H, N), device) for _ in range(3))
    lw = -torch.exp(torch.rand((B, S, H, N), generator=gen, device=device)
                    * 6.0 - 6.0)
    u = _randn(gen, (H, N), device) * 0.1
    s0 = torch.zeros((B, H, N, N), device=device)
    return r, k, v, lw, u, s0


def attention_core_us(device: str) -> dict:
    from repro_torch.models.attention import attention_core

    g = torch.Generator(device=device).manual_seed(0)
    B, S, H, D = 1, 2048, 4, 64
    q, k, v = (_randn(g, (B, S, H, D), device, torch.bfloat16) for _ in range(3))
    pos = torch.arange(S, dtype=torch.int32, device=device).expand(B, S)
    return _bench(lambda q, k, v: attention_core(q, k, v, pos, pos, causal=True),
                  q, k, v, device=device)


def flash_attention_kernel_us(device: str) -> dict:
    """The hand-written flash kernel through ``ops`` with ``tuned=True``."""
    from repro_torch.kernels import ops

    g = torch.Generator(device=device).manual_seed(2)
    B, S, H, D = 1, 512, 2, 64
    q, k, v = (_randn(g, (B, S, H, D), device, torch.bfloat16) for _ in range(3))
    return _bench(lambda q, k, v: ops.flash_attention(q, k, v, causal=True,
                                                      tuned=True),
                  q, k, v, device=device, iters=3)


def wkv_chunked_us(device: str) -> dict:
    from repro_torch.models.recurrent import wkv_chunked

    g = torch.Generator(device=device).manual_seed(1)
    args = _wkv_args(g, 1, 1024, 4, 64, device)
    return _bench(lambda *a: wkv_chunked(*a)[0], *args, device=device)


def wkv_scan_kernel_us(device: str) -> dict:
    """The hand-written WKV kernel through ``ops`` with ``tuned=True``."""
    from repro_torch.kernels import ops

    g = torch.Generator(device=device).manual_seed(3)
    args = _wkv_args(g, 1, 512, 2, 64, device)
    return _bench(lambda *a: ops.linear_scan(*a, tuned=True)[0], *args,
                  device=device, iters=3)


def moe_dense_us(device: str) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.layers import split

    cfg = get_config("granite-moe-1b-a400m").scaled(
        d_model=256, n_experts=8, top_k=2, d_ff_expert=128)
    p, _ = split(moe_mod.init_moe(torch.Generator(device=device).manual_seed(0),
                                  cfg, device=device))
    g = torch.Generator(device=device).manual_seed(1)
    x = _randn(g, (4, 128, 256), device, torch.bfloat16)
    return _bench(lambda p, x: moe_mod.apply_moe(p, cfg, x)[0], p, x,
                  device=device)


def train_step_us(device: str) -> dict:
    from repro_torch.launch.train import make_train_step, smoke_config
    from repro_torch.models import LanguageModel
    from repro_torch.optim import AdamW, OptConfig

    cfg = smoke_config("deepseek-7b")
    model = LanguageModel(cfg, device=device)
    opt = AdamW(OptConfig())
    params = model.init(0)
    state = opt.init(params)
    rng = np.random.RandomState(0)
    batch = {
        "tokens": torch.as_tensor(rng.randint(0, cfg.vocab_size, (4, 64)),
                                  dtype=torch.int32, device=device),
        "targets": torch.as_tensor(rng.randint(0, cfg.vocab_size, (4, 64)),
                                   dtype=torch.int32, device=device),
        "weights": torch.ones((4, 64), dtype=torch.float32, device=device),
    }
    step = make_train_step(model, opt)
    params, state, _ = step(params, state, batch)  # warm-up
    _sync(device)
    samples = []
    for _ in range(5):
        t0 = time.perf_counter()
        params, state, m = step(params, state, batch)
        float(m["loss"])  # waits for the step
        samples.append((time.perf_counter() - t0) * 1e6)
    return _stats(samples)


def run(device: str = "cuda") -> dict:
    if device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("torch_microbench: no CUDA device (--device cpu "
                         "runs on the host)")
    return {
        "attention_core_2k": attention_core_us(device),
        "flash_attention_kernel_512": flash_attention_kernel_us(device),
        "wkv_chunked_1k": wkv_chunked_us(device),
        "wkv_scan_kernel_512": wkv_scan_kernel_us(device),
        "moe_dense_small": moe_dense_us(device),
        "train_step_smoke_7b_cfg": train_step_us(device),
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out", default=None,
                    help="also write the rows, the device and the kernels' "
                         "launches as JSON")
    args = ap.parse_args()
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import linear_scan as ls

    fa.launches = ls.launches = 0
    rows = run(args.device)
    for k, v in rows.items():
        print(f"{k}: {v['us']:.1f} us  (+/- {v['std_us']:.1f} us, "
              f"n={v['iters']})")
    if args.out:
        device = (torch.cuda.get_device_name(0) if args.device == "cuda"
                  else "cpu")
        with open(args.out, "w") as f:
            json.dump({"device": device, "rows": rows,
                       "launches": {"flash": fa.launches, "wkv": ls.launches}},
                      f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
