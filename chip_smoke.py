#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which raises on failure (no phase is skipped, nothing falls
back to the CPU):

1. env      -- card name and power limit (nvidia-smi), torch and CUDA versions;
2. build    -- every CUDA kernel of the port, compiled from this checkout;
3. kernels  -- each kernel against its plain PyTorch version on the card, at
               the serving path's shapes and the head dims of the model zoo,
               with its time, the plain version's, a PyTorch library call's
               (a yardstick the port never calls) and the card's bound;
4. serve    -- gemma-2b at full width (18 layers, d_model 2048, vocab 256000,
               random weights from seed 0, bf16 compute) serving 6 ragged
               prompts through ``ContinuousBatcher`` (full prefill: the flash
               kernel) and ``PagedServingEngine`` (chunked prefill + paged
               decode); the kernel's launch count is read around the first;
5. parity   -- the same weights in f32 compute: first-token logits of the
               dense path (flash kernel) against the paged path (plain
               attention), and greedy agreement of the two engines;
6. the kernels JSON line, then the card line, then the result line.

Exits non-zero, printing no result, without a CUDA card or outside the
repository.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

# H100 SXM data-sheet peaks (dense): bf16 tensor cores, f32 on the CUDA
# cores (the f32 kernel keeps full f32, so TF32's rate does not apply), HBM3
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12
TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-5}
FLASH_SOURCE = "src/repro_torch/kernels/csrc/flash_attention.cu"
FLASH_REPLACES = "src/repro/kernels/flash_attention.py:45"

# (name, B, Sq, Skv, Hq, Hkv, D, Dv, causal, window, q_offset, out_scale,
#  residual, dtype); the first is the serving path's (gemma-2b prefill)
KERNEL_CASES = [
    ("gemma_prefill", 1, 1000, 1000, 8, 1, 256, 256, True, 0, 0, 1.0, False,
     torch.bfloat16),
    ("deepseek7b_prefill", 1, 2048, 2048, 32, 32, 128, 128, True, 0, 0, 1.0,
     False, torch.bfloat16),
    ("window_d80", 1, 1024, 1024, 32, 8, 80, 80, True, 256, 0, 1.0, False,
     torch.bfloat16),
    ("d192_dv128", 1, 512, 512, 16, 16, 192, 128, True, 0, 0, 1.0, False,
     torch.bfloat16),
    ("q_offset", 1, 256, 1280, 8, 1, 256, 256, True, 0, 1024, 1.0, False,
     torch.bfloat16),
    ("epilogue", 1, 1000, 1000, 8, 1, 256, 256, True, 0, 0, 0.5, True,
     torch.bfloat16),
    ("f32", 1, 512, 512, 8, 1, 256, 256, True, 0, 0, 1.0, False,
     torch.float32),
]
PROMPT_LENS = [97, 1000, 351, 742, 180, 563]
MAX_NEW = 16
PARITY_TOL = 1e-3  # f32 logits of magnitude ~1; only summation order differs


def log(*a) -> None:
    print(*a, flush=True)


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median of per-call CUDA-event times (inputs warm in L2, as a prefill
    finds the q/k/v its projections just wrote)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def phase_env() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(f"[env] {card}")
    log(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} devices {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return card


def phase_build() -> None:
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    secs = build.build_all()
    log(f"[build] {json.dumps(secs)} total {time.perf_counter() - t0:.1f}s")
    for name, text in build.build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")


def _visible(case) -> torch.Tensor:
    """(Sq, Skv) bool: which keys each query sees."""
    _, _, Sq, Skv, _, _, _, _, causal, window, q_offset, *_ = case
    pq = q_offset + torch.arange(Sq, device="cuda")[:, None]
    pk = torch.arange(Skv, device="cuda")[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device="cuda")
    if causal:
        mask &= pk <= pq
    if window:
        mask &= (pq - pk) < window
    return mask


def _bound(case, q, k, v, out, res) -> tuple[float, str]:
    """Least time for this call: FLOPs of the unmasked (query, key) pairs
    this run's masks leave, or the bytes moved once, whichever is longer."""
    _, B, _, _, Hq, _, D, Dv, *_ = case
    pairs = int(_visible(case).sum())
    flops = 2.0 * (D + Dv) * B * Hq * pairs
    nbytes = sum(t.nbytes for t in (q, k, v, out) + ((res,) if res is not None
                                                     else ()))
    t_ops = flops / PEAK_FLOPS[q.dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _library_call(case, q, k, v):
    """One PyTorch call computing the same function (no epilogue), or None."""
    import torch.nn.functional as F

    _, _, Sq, Skv, Hq, Hkv, _, _, causal, window, q_offset, out_scale, \
        residual, _ = case
    if residual or out_scale != 1.0:
        return None
    G = Hq // Hkv
    qt = q.transpose(1, 2)
    kt = k.repeat_interleave(G, dim=2).transpose(1, 2)
    vt = v.repeat_interleave(G, dim=2).transpose(1, 2)
    if causal and not window and q_offset == 0 and Sq == Skv:
        return lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    mask = _visible(case)
    return lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)


def phase_kernels() -> list[dict]:
    from repro_torch.kernels import flash_attention as fa

    results = []
    for case in KERNEL_CASES:
        (name, B, Sq, Skv, Hq, Hkv, D, Dv, causal, window, q_offset,
         out_scale, residual, dt) = case
        g = torch.Generator(device="cuda").manual_seed(len(results))
        q, k, v, r = (torch.randn(s, generator=g, device="cuda").to(dt) for s in
                      ((B, Sq, Hq, D), (B, Skv, Hkv, D), (B, Skv, Hkv, Dv),
                       (B, Sq, Hq, Dv)))
        res = r if residual else None
        kw = dict(causal=causal, window=window, q_offset=q_offset,
                  out_scale=out_scale, residual=res)
        out = fa.flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        ref = fa.flash_attention_plain(q, k, v, **kw)
        diff = (out.float() - ref.float()).abs()
        err = float(diff.max())
        tol = TOL[dt]
        if not bool(torch.isfinite(out).all()) or bool(
                (diff > tol + tol * ref.float().abs()).any()):
            raise AssertionError(f"[kernels] {name}: kernel disagrees with its "
                                 f"plain version, max abs err {err}")
        ms = cuda_ms(lambda: fa.flash_attention(q, k, v, **kw))
        plain_ms = cuda_ms(lambda: fa.flash_attention_plain(q, k, v, **kw),
                           reps=5)
        lib = _library_call(case, q, k, v)
        library_ms = cuda_ms(lib) if lib is not None else None
        bound_ms, bound_by = _bound(case, q, k, v, out, res)
        row = dict(case=name, shape=[B, Sq, Skv, Hq, Hkv, D, Dv],
                   dtype=str(dt).replace("torch.", ""), causal=causal,
                   window=window, q_offset=q_offset, max_abs_err=err,
                   tol=tol, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                   bound_ms=bound_ms, bound_by=bound_by)
        log(f"[kernels] {json.dumps(row)}")
        results.append(row)
    return results


def _prompts(vocab: int) -> list[list[int]]:
    rng = np.random.RandomState(0)
    return [rng.randint(0, vocab, n).tolist() for n in PROMPT_LENS]


def phase_serve(model, params) -> int:
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.serve import (ContinuousBatcher,
                                          PagedServingEngine, Request)

    cfg = model.cfg
    prompts = _prompts(cfg.vocab_size)

    def reqs():
        return [Request(rid=i, prompt=list(p), max_new=MAX_NEW)
                for i, p in enumerate(prompts)]

    dense_reqs = reqs()
    batcher = ContinuousBatcher(model, params, n_slots=4, max_len=1024)
    fa.launches = 0
    stats = batcher.run(dense_reqs)
    torch.cuda.synchronize()
    launches = fa.launches
    log(f"[serve] dense: wall_s {stats['wall_s']:.3f} tok/s "
        f"{stats['tok_per_s']:.2f} host_syncs {stats['host_syncs']} "
        f"flash launches {launches}")
    expect = cfg.n_layers * len(prompts)
    if not all(r.done and not r.rejected for r in dense_reqs):
        raise AssertionError("[serve] dense: a request did not finish")
    if stats["tokens"] != len(prompts) * MAX_NEW:
        raise AssertionError(f"[serve] dense: {stats['tokens']} tokens")
    if launches != expect:
        raise AssertionError(f"[serve] flash launches {launches} != {expect}")

    paged_reqs = reqs()
    eng = PagedServingEngine(model, params, n_slots=8, max_len=1024,
                             page_size=16, chunk_max=64, drain_every=8)
    pstats = eng.run(paged_reqs)
    log(f"[serve] paged: wall_s {pstats['wall_s']:.3f} tok/s "
        f"{pstats['tok_per_s']:.2f} host_syncs {pstats['host_syncs']} "
        f"decode_ticks {pstats['decode_ticks']} prefill_chunks "
        f"{pstats['prefill_chunks']}")
    if not all(r.done and not r.rejected and len(r.out) == MAX_NEW
               for r in paged_reqs):
        raise AssertionError("[serve] paged: a request did not finish")
    if eng.kv.stats().pages_in_use or any(eng.slot_req):
        raise AssertionError("[serve] paged: pages or slots not returned")
    for r in dense_reqs + paged_reqs:
        if not all(0 <= t < cfg.vocab_size for t in r.out):
            raise AssertionError(f"[serve] token out of vocab in {r.rid}")
    agree = sum(a == b for d, p in zip(dense_reqs, paged_reqs)
                for a, b in zip(d.out, p.out))
    log(f"[serve] bf16 greedy tokens equal across engines: {agree}/"
        f"{len(prompts) * MAX_NEW} (flash keeps P in f32, the plain path "
        f"rounds it to bf16, so bf16 streams may part)")
    return launches


def phase_parity(model32, params) -> None:
    from repro_torch.launch.paged_kv import PagedKVCache, decompose
    from repro_torch.launch.serve import (ContinuousBatcher,
                                          PagedServingEngine, Request)

    prompts = _prompts(model32.cfg.vocab_size)[:2]
    for i, p in enumerate(prompts):
        tokens = torch.tensor([p], dtype=torch.int32, device="cuda")
        cache = model32.init_cache(1, 1024, dtype=torch.float32)
        dense, _ = model32.prefill(params, {"tokens": tokens}, cache)
        kv = PagedKVCache(model32, n_slots=1, n_pages=64, page_size=16,
                          max_pages=64, dtype=torch.float32)
        kv.alloc(0, len(p) + 1)
        start = 0
        for c in decompose(len(p), 64):
            view = kv.gather_slot(0)
            paged, view = model32.prefill_chunk(
                params, {"tokens": tokens[:, start:start + c]}, view,
                torch.full((1,), start, dtype=torch.int32, device="cuda"))
            kv.scatter_slot(0, view)
            start += c
        err = float((dense - paged).abs().max())
        scale = float(dense.abs().max())
        log(f"[parity] prompt {i} (len {len(p)}): max |dense - paged| logits "
            f"{err:.3e} (max |logit| {scale:.3f}, tol {PARITY_TOL})")
        if not bool(torch.isfinite(dense).all()) or err > PARITY_TOL:
            raise AssertionError(f"[parity] prompt {i}: {err} > {PARITY_TOL}")

    d = [Request(rid=i, prompt=list(p), max_new=8) for i, p in enumerate(prompts)]
    q = [Request(rid=i, prompt=list(p), max_new=8) for i, p in enumerate(prompts)]
    ContinuousBatcher(model32, params, n_slots=2, max_len=1024).run(d)
    PagedServingEngine(model32, params, n_slots=2, max_len=1024, page_size=16,
                       chunk_max=64, drain_every=8, dtype=torch.float32).run(q)
    agree = sum(a == b for x, y in zip(d, q) for a, b in zip(x.out, y.out))
    log(f"[parity] f32 greedy tokens equal across engines: {agree}/"
        f"{sum(len(x.out) for x in d)}")


def main() -> None:
    card = phase_env()
    phase_build()
    kernel_rows = phase_kernels()

    from repro_torch.configs import get_config
    from repro_torch.models import LanguageModel

    cfg = get_config("gemma-2b")
    model = LanguageModel(cfg, device="cuda")
    t0 = time.perf_counter()
    params = model.init(0)
    torch.cuda.synchronize()
    log(f"[serve] {cfg.name} full width: {cfg.param_count() / 1e9:.3f}B params, "
        f"{cfg.n_layers} layers, init {time.perf_counter() - t0:.1f}s")
    launches = phase_serve(model, model.cast_for_compute(params))
    torch.cuda.empty_cache()
    model32 = LanguageModel(cfg.scaled(compute_dtype="float32"), device="cuda")
    phase_parity(model32, params)
    log(f"[mem] peak allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    head = kernel_rows[0]
    log(json.dumps({"kernels": [{
        "name": "flash_attention", "route": "cuda", "source": FLASH_SOURCE,
        "replaces": FLASH_REPLACES, "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in kernel_rows),
        "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": head["library_ms"], "shape": head["shape"],
        "cases": kernel_rows}]}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
