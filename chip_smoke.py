#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which raises on failure (no phase is skipped, nothing falls
back to the CPU):

1. env      -- card name and power limit (nvidia-smi), torch and CUDA versions;
2. build    -- every CUDA kernel of the port, compiled from this checkout,
               with ptxas' registers and spill stores of each function, read
               from the log kept beside each library (the flash kernel's
               wgmma body at D = Dv = 256 and 128 must report no spill);
3. kernels  -- each kernel against its plain PyTorch version on the card, at
               the serving paths' shapes (flash at every prompt length of the
               gemma-2b trace, and at the head dims of the model zoo), with
               the body that ran and its split-KV plan, its time, the plain
               version's, a PyTorch library call's (a yardstick the port
               never calls) where one exists, and the card's bound; at the
               gemma-2b and deepseek-7b prefill shapes also the mma.sync
               body, asked for through ``_body``, on the same inputs; at
               minicpm3-4b's MLA prefill (MHA 40/40, D 96 / Dv 64: mma.sync)
               and granite-moe-1b-a400m's (GQA 16/8, D 64: wgmma); at
               whisper-medium's non-causal encoder (B 4 x 1500 frames) and
               cross-attention (224, and 4 rows of 4, queries over 1500
               frames; each also held to the relative limit REL_TOL, which
               the plain version with the ragged last key tile left
               unmasked and zero-filled must fail) and its decoder's causal
               self-attention (4 x 4, 224), qwen2-vl-72b's
               GQA 64/8 at D 128 and deepseek-v2-236b's MLA at D 192 /
               Dv 128 with 128 heads (all wgmma); the
               WKV scan's chunked body at every WKV case, its step body
               checked at every case too and timed beside it at the
               rwkv6-1.6b prefill and paged chunk-round shapes;
4. serve    -- gemma-2b at full width (18 layers, d_model 2048, vocab 256000,
               random weights from seed 0, bf16 compute) serving 6 ragged
               prompts through ``ContinuousBatcher`` (full prefill: the flash
               kernel) and ``PagedServingEngine`` (chunked prefill + paged
               decode); the launch counts are read around each engine;
               then one more dense run under ``torch.profiler``, whose trace
               gives the flash kernel's device time over the trace's
               prefills (``trace_device_ms``);
5. parity   -- the same weights in f32 compute: first-token logits of the
               dense path (flash kernel) against the paged path (plain
               attention), and greedy agreement of the two engines;
6. serve    -- rwkv6-1.6b at full width (24 layers, d_model 2048, 32 heads
               of 64, vocab 65536, seed 0, bf16 compute), the same prompts
               through both engines; the WKV scan kernel runs once per layer
               per full prefill (24 x 6 = 144 in the dense engine) and per
               chunk round (24 x rounds in the paged engine); then one
               more dense run under ``torch.profiler`` for the WKV kernels'
               device time over the trace's prefills;
7. parity   -- rwkv6 in f32 compute: full-prefill first-token logits (WKV
               kernel) against token-by-token decode (the plain per-step
               recurrence), and greedy agreement of the two engines;
8. serve    -- h2o-danube-1.8b (24 SWA layers, window 4096, GQA 32/8 at
               head_dim 80: the flash kernel's mma.sync body with a window),
               recurrentgemma-9b (12 x (RG-LRU, RG-LRU, SWA) + 2 RG-LRU,
               window 2048, MQA at head_dim 256: the wgmma body with a
               window), deepseek-7b (30 MHA layers, head_dim 128: the
               wgmma body), minicpm3-4b (62 MLA layers: flash at D 96 /
               Dv 64 in the expanded prefill, the absorbed latent path in
               decode and chunked prefill, slot-dense latents in the paged
               engine), granite-moe-1b-a400m (24 GQA layers at D 64,
               each with 32 experts top-8, all 32 computed on every token),
               qwen2-vl-72b at a depth cut of 8 of its 80 layers (M-RoPE,
               GQA 64/8 at D 128) and deepseek-v2-236b at a depth cut of
               its dense first layer and one MoE layer (MLA at D 192 /
               Dv 128, 160 experts all computed),
               one after the other, each at full width with seed-0 weights
               (RG-LRU's zero-init conv drawn from a seeded normal) and
               freed before the next.  First the f32 parity phases on the
               f32 masters: for the two sliding-window models a
               4500-token prompt, longer than both windows, through the
               flash kernel against the plain banded path; for
               recurrentgemma-9b also full prefill (the doubling scan)
               against token-by-token decode (the per-step recurrence); for
               the others the gemma-2b phase 5; for qwen2-vl also prefill
               with three equal M-RoPE streams given (plain) against none
               (flash).  Then the bf16 copy is made and the masters'
               matrices dropped (qwen2-vl: one multimodal prefill over a
               16 x 16 patch grid with distinct t/h/w streams, then 8
               decode steps, finite logits), and the trace (the
               4500-token prompt added for the sliding-window models)
               goes through both engines, with flash launches read
               around each: one per attention layer per full prefill in
               the dense engine, none in the paged one;
8b. whisper  -- whisper-medium at full width, no cut (no engine serves it, in
               the reference or here: neither passes encoder frames), through
               ``LanguageModel.prefill`` with 1500 seeded frames per row and
               ``decode_step``: f32 on the masters, flash (72 launches a
               prefill: 24 encoder, 24 self, 24 cross) against the plain
               path, and 8 decode steps against a full prefill of the prompt
               plus those tokens; then bf16, run a (4 rows x 4 tokens) and
               run b (1 x 224), each prefill plus 64 greedy steps, with
               flash launches read around each, wall, tokens/s, peak memory,
               greedy agreement with f32 (each row's first step that
               parts), and the first-token logits against the same bf16
               prefill on the plain path (within WHISPER_BF16_REL); one
               run a prefill and 8 decode steps under ``torch.profiler``;
9. train    -- the serving models freed: gemma-2b, rwkv6-1.6b,
               h2o-danube-1.8b, recurrentgemma-9b, minicpm3-4b,
               granite-moe-1b-a400m, deepseek-v2-236b, whisper-medium (with
               frames) and qwen2-vl-72b (with embeds and 3-stream positions)
               smoke configs, 3 train steps on the card against the CPU in
               f32 (with the router loss for the MoE ones); preempt at step 8
               and resume
               to 12 on the card against a straight run; gemma-2b,
               h2o-danube-1.8b and granite-moe-1b-a400m at full width
               (bf16, remat full, B 2 x S 1024, seed 0), 20 steps of
               ``train``: finite and falling loss (and a finite, non-zero
               router loss for granite), no flash or WKV launch, the step
               wall, tokens/s, model-FLOP share (of the active parameters
               for MoE, with the work ``_moe_dense`` executes beside it),
               peak memory; then one step
               under ``torch.profiler`` (busy share, top kernels, time by
               kernel kind) and one cut into forward, backward and
               optimizer (host enqueue against device time);
9b. orchestrator -- ``repro_torch.core`` on the card: the Common Crawl
               pipeline at the reference's ``CrawlConfig()`` (256 domains
               x 12 pages, 64 seeds, 24 links, 128 tokens), 2 crawls x 2
               shards, planned and materialized through ``RunCoordinator``
               with injected failures, retries and failovers; edges and
               graph_aggr must run their tensors on the card, one
               partition's four outputs must hash as on the CPU, a second
               materialize must be all cache hits, and at 33 tokens a page
               two card runs and the CPU must give the same bytes (the
               ordered segment sum).  Then examples/torch_train_lm.py's
               stages: h2o-danube-1.8b at full width, 2 stages of 5 steps
               (B 2 x S 1024), the second resuming from the first's
               checkpoint (21.97 GB: its bytes, save and restore seconds),
               one stage attempt injected-failed and retried, a falling
               loss, a cached second run; the checkpoints are deleted.  An
               asset error that is not an injected fault fails the phase;
               neither path launches a kernel;
10. distributed -- training under a mesh: a (data 1, model 1) DeviceMesh
               over an NCCL group of one rank (no fallback to gloo or the
               CPU).  granite-moe-1b-a400m@4 (4 of 24 layers, full width)
               in f32 at capacity_factor E / top_k, B 4 x S 2048 (8192
               tokens, above moe._SMALL_T): the capacity path (asserted)
               on the mesh against the dense path without it, the loss to
               rtol 2e-4 and every gradient leaf to 1e-3 of its max |g|;
               then granite at full width, bf16, remat full, 10 steps of
               ``train(mesh_info=...)`` at capacity_factor 1.25 and 10
               without a mesh (the dense path): finite, falling loss, the
               step wall, tokens/s, peak memory, the dropped share of each
               layer's (token, slot) assignments at steps 1 and 10, the
               experts' executed FLOPs against their active ones, and one
               profiled step of each (busy share, top kernels); one layer's
               expert einsums, forward and backward, timed alone on each
               path; ``compressed_psum_tree`` twice over a step's gradients
               on the NCCL group, bit-equal to the int8 round trip;
               neither kernel launches;
11. the kernels JSON line, then the card line, then the result line.

Exits non-zero, printing no result, without a CUDA card or outside the
repository.
"""
from __future__ import annotations

import json
import math
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
# beside TOL, each flash case's relative error over its whole output,
# ||out - plain|| / ||plain||: at D 64 over 1500 keys a non-causal output is
# of order 0.04, where TOL's absolute term alone would pass a fault of a
# few percent (an unmasked, zero-filled ragged key tile shifts the softmax
# normalizer by 36 / (1500 e^0.5), 1.5 %); limits from sound runs' readings
# (PERF.md)
REL_TOL = {torch.bfloat16: 5e-3, torch.float32: 1e-5}
FLASH_SOURCE = "src/repro_torch/kernels/csrc/flash_attention.cu"
FLASH_REPLACES = "src/repro/kernels/flash_attention.py:45"
WKV_SOURCE = "src/repro_torch/kernels/csrc/linear_scan.cu"
WKV_REPLACES = "src/repro/kernels/linear_scan.py:36"
# relative to max(1, max |plain|): the kernel sums in chunks of 64 with
# 3xTF32 products (or token by token, the step body), the plain version
# chunk-parallel through exp of decay differences
WKV_TOL = 1e-4

# (name, B, Sq, Skv, Hq, Hkv, D, Dv, causal, window, q_offset, out_scale,
#  residual, dtype); the first is the serving path's (gemma-2b prefill)
KERNEL_CASES = [
    ("gemma_prefill", 1, 1000, 1000, 8, 1, 256, 256, True, 0, 0, 1.0, False,
     torch.bfloat16),
    ("deepseek7b_prefill", 1, 2048, 2048, 32, 32, 128, 128, True, 0, 0, 1.0,
     False, torch.bfloat16),
    # gemma-2b at the serving trace's other prompt lengths (PROMPT_LENS)
    *((f"gemma_p{n}", 1, n, n, 8, 1, 256, 256, True, 0, 0, 1.0, False,
       torch.bfloat16) for n in (97, 180, 351, 563, 742)),
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
    # the sliding-window models' full prefill of LONG_PROMPT tokens
    ("danube_swa_prefill", 1, 4500, 4500, 32, 8, 80, 80, True, 4096, 0, 1.0,
     False, torch.bfloat16),
    ("rgemma_swa_prefill", 1, 4500, 4500, 16, 1, 256, 256, True, 2048, 0,
     1.0, False, torch.bfloat16),
    # the MLA and MoE models' full prefill of the trace's 1000-token prompt:
    # minicpm3-4b's MLA heads (D = nope + rope = 96, Dv 64: mma.sync) and
    # granite-moe-1b-a400m's GQA heads (D 64: wgmma)
    ("minicpm3_mla_prefill", 1, 1000, 1000, 40, 40, 96, 64, True, 0, 0, 1.0,
     False, torch.bfloat16),
    ("granite_prefill", 1, 1000, 1000, 16, 8, 64, 64, True, 0, 0, 1.0, False,
     torch.bfloat16),
        # whisper-medium's full prefill: the encoder over 1500 frames (B 4,
    # MHA 16/16, D 64, non-causal; 1500 is not a multiple of the 64-key
    # tile) and the cross-attention of run b's 224-token prompt over them,
    # then run a's (4 rows of 4 tokens: split-KV and the merge kernel) and
    # the decoder's causal self-attention of runs a and b;
    # qwen2-vl-72b's prefill of the trace's 1000-token prompt (GQA 64/8,
    # D 128) and deepseek-v2-236b's MLA prefill (MHA 128/128, D = nope +
    # rope = 192, Dv 128), all on the wgmma body
    ("whisper_encoder", 4, 1500, 1500, 16, 16, 64, 64, False, 0, 0, 1.0,
     False, torch.bfloat16),
    ("whisper_cross_prefill", 1, 224, 1500, 16, 16, 64, 64, False, 0, 0, 1.0,
     False, torch.bfloat16),
    ("whisper_cross_a", 4, 4, 1500, 16, 16, 64, 64, False, 0, 0, 1.0, False,
     torch.bfloat16),
    ("whisper_self_a", 4, 4, 4, 16, 16, 64, 64, True, 0, 0, 1.0, False,
     torch.bfloat16),
    ("whisper_self_b", 1, 224, 224, 16, 16, 64, 64, True, 0, 0, 1.0, False,
     torch.bfloat16),
    ("qwen2vl_prefill", 1, 1000, 1000, 64, 8, 128, 128, True, 0, 0, 1.0,
     False, torch.bfloat16),
    ("dsv2_mla_prefill", 1, 1000, 1000, 128, 128, 192, 128, True, 0, 0, 1.0,
     False, torch.bfloat16),
]
# (name, B, S, H, N, w_hi); the first is the serving path's (rwkv6-1.6b
# prefill), then a paged chunk round (8 slots x 64 tokens), an odd length,
# tests/test_kernels.py's WKV cases and its padded S = 100 case, and strong
# decays: log_w = -exp(w_raw), w_raw in [-6, w_hi] (w_hi 3: log_w to -20)
WKV_CASES = [
    ("rwkv6_prefill", 1, 1000, 32, 64, 0.0),
    ("chunk_round", 8, 64, 32, 64, 0.0),
    ("odd_97", 1, 97, 32, 64, 0.0),
    ("kernels_1", 1, 64, 2, 16, 0.0),
    ("kernels_2", 2, 128, 2, 32, 0.0),
    ("kernels_3", 1, 128, 4, 64, 0.0),
    ("kernels_4", 2, 96, 2, 16, 0.0),
    ("padded_100", 2, 100, 2, 32, 0.0),
    ("strong_decay", 1, 1000, 32, 64, 3.0),
]
# cases where the WKV scan's step body is timed beside the chunked one
PREV_WKV_BODY_CASES = ("rwkv6_prefill", "chunk_round")
PROMPT_LENS = [97, 1000, 351, 742, 180, 563]
# the sliding-window models' trace adds one prompt longer than both windows
# (4096, 2048): the SWA rings wrap and the plain path takes its KV band
LONG_PROMPT = 4500
LONG_MAX_LEN = 4608  # prompt + MAX_NEW + 1, rounded up to 16-token pages
# the models served after rwkv6-1.6b, in order, each with its f32 parity
# phases first (``phase_model``); "arch@L" is a depth cut, the arch at its
# full width with L layers: qwen2-vl-72b keeps 8 of its 80 layers (9.51 B
# parameters, 19.0 GB in bf16), deepseek-v2-236b its dense first layer and
# one MoE layer of 160 experts (5.359 B, 10.7 GB in bf16), where the whole
# models hold 144 and 472 GB in bf16
SERVE_MODELS = ("h2o-danube-1.8b", "recurrentgemma-9b", "deepseek-7b",
                "minicpm3-4b", "granite-moe-1b-a400m", "qwen2-vl-72b@8",
                "deepseek-v2-236b@2")
# qwen2-vl's multimodal prefill: text, a PATCH_GRID x PATCH_GRID grid of
# seeded patch embeddings (the vision frontend is a stub), text
PATCH_GRID, MM_TEXT = 16, 8
# whisper-medium (no engine serves it, in the reference or here: neither
# passes encoder frames): LanguageModel.prefill with frames, then greedy
# decode_step, at its 1500 encoder frames and 448-token decoder context;
# run a: 4 rows of a 4-token prompt, run b: one 224-token prompt
WHISPER_ENC_LEN, WHISPER_MAX_LEN, WHISPER_STEPS = 1500, 448, 64
WHISPER_RUNS = (("a", 4, 4), ("b", 1, 224))  # (run, rows, prompt tokens)
# bf16 first-token logits, the prefill through flash against the same
# prefill with positions given (plain everywhere), relative over the whole
# (rows, vocab) array; limit from sound runs' readings (PERF.md)
WHISPER_BF16_REL = 3e-2
# RG-LRU's conv weights, drawn at this scale x a seeded normal: the config's
# init sets them to zero (as JAX's), which zeros every RG-LRU output
CONV_SCALE = 0.5
# cases where the wgmma body replaces the mma.sync body, which is timed
# beside it in the same run (``_body="mma"``)
PREV_BODY_CASES = ("gemma_prefill", "deepseek7b_prefill")
# kernels that must compile without spills: the flash wgmma body at
# Dv = D = 256, 128 and 64, every instantiation of the WKV chunked body's
# kernels
NO_SPILL = ("flash_fwd_wgmma_kernelILi256ELi256E",
            "flash_fwd_wgmma_kernelILi128ELi128E",
            "flash_fwd_wgmma_kernelILi64ELi64E",
            "wkv_chunk_kernel", "wkv_state_scan_kernel", "wkv_out_kernel")
# the kernels each wrapper launches, as torch.profiler names them
FLASH_KERNELS = ("flash_fwd", "flash_merge")
WKV_KERNELS = ("wkv_chunk_kernel", "wkv_state_scan_kernel", "wkv_out_kernel")
MAX_NEW = 16
PARITY_TOL = 1e-3  # f32 logits of magnitude ~1; only summation order differs
# train steps, card against CPU in f32: sums in another order, through 3
# steps of AdamW (whose first steps move each weight by about the lr)
TRAIN_TOL = 1e-4
# resumed against straight, as tests/test_train_resume.py bounds it
RESUME_TOL = 1e-3
# the full-width train phases (TRAIN_FULL), 2 x 1024 tokens a step; peak lr
# OptConfig's default (train()'s 3e-3 is for the smoke configs).
# At 16 bytes a parameter (f32 masters, gradients, m, v) before
# activations, recurrentgemma-9b needs 150 GB and minicpm3-4b 65 GB (where
# gemma-2b's 2.5 B already peaks at 45.8 GB): neither trains at full
# width.  deepseek-v2-236b does not fit the card at all (472 GB in bf16).
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_LR = 20, 2, 1024, 3e-4
TRAIN_FULL = ("gemma-2b", "h2o-danube-1.8b", "granite-moe-1b-a400m")
# smoke configs trained on the card against the CPU
TRAIN_PARITY = ("gemma-2b", "rwkv6-1.6b", "h2o-danube-1.8b",
                "recurrentgemma-9b", "minicpm3-4b", "granite-moe-1b-a400m",
                "deepseek-v2-236b", "whisper-medium", "qwen2-vl-72b")
# kernel kinds of the profiled train step, by substrings of their names
TRACE_KINDS = (("matmul", ("nvjet", "gemm", "xmma", "cutlass")),
               ("reduce", ("reduce_kernel",)),
               ("elementwise", ("elementwise_kernel",)),
               ("copy", ("Memcpy", "Memset", "CatArrayBatchedCopy")))

# the orchestrator phase (phase_orchestrator): the Common Crawl pipeline at
# the reference's CrawlConfig() over 2 crawls x 2 shards, then danube's
# training stages as assets at full width.  Fault injection is a function of
# (sim seed, run id, asset, partition, attempt, platform): under run id
# "cc-1" seed 3 fails and fails over edges and graph tasks; under
# "train-stages" seed 2 fails stage1's first attempt, which is retried
ORCH_CC_SEED, ORCH_TRAIN_SEED = 3, 2
ORCH_ARCH, ORCH_STAGES, ORCH_STEPS = "h2o-danube-1.8b", 2, 5
ORCH_CKPT = ROOT / "build" / "orchestrator_stages"
# crawls whose segment sums the card must give in the CPU's bits on every
# run: 33 tokens a page (weights in 33rds), and with a 16-token vocabulary
# (overlap counts up to 33, where sum / 33 and sum * (1/33) part)
ORCH_T33 = ({"tokens_per_page": 33}, {"tokens_per_page": 33, "vocab": 16})

# the distributed phase (phase_distributed): granite-moe-1b-a400m on a
# (data 1, model 1) mesh of the card, NCCL at world size 1.  B x S = 8192
# tokens is above moe._SMALL_T (4096), so apply_moe takes the capacity
# path (_moe_shard_map).  Parity: the first DIST_PARITY_LAYERS layers at
# full width in f32 at capacity_factor E / top_k (cap = T: nothing drops)
# against the no-mesh dense path, the loss to the reference's own sharded-
# vs-unsharded rtol (tests/test_multidevice.py:68) and every gradient leaf
# to DIST_GRAD_TOL of its max |g|; then DIST_STEPS full-width steps on the
# mesh at the config's capacity_factor 1.25, and as many without a mesh
# (the dense path), bf16, remat full
DIST_ARCH, DIST_PARITY_LAYERS = "granite-moe-1b-a400m", 4
DIST_BATCH, DIST_SEQ, DIST_STEPS = 4, 2048, 10
DIST_PARITY_RTOL, DIST_GRAD_TOL = 2e-4, 1e-3

def log(*a) -> None:
    print(*a, flush=True)


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean device time per call of ``reps`` back-to-back calls between two
    CUDA events (inputs warm in L2, as a prefill finds the q/k/v its
    projections just wrote).  Back to back, the host's ~30 us per wrapper
    call overlaps the previous call's device work; a call shorter than its
    host overhead still shows the host's time."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(reps):
        fn()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / reps


def _profiled(fn, cpu: bool = False):
    """One call of ``fn`` under ``torch.profiler`` (CUDA activity, and the
    host's with ``cpu``): (what it returned, its wall in s up to a sync, its
    device events, their device ms summed by name)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name: dict[str, float] = {}
    for e in events:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time / 1e3
    return out, wall, events, by_name


def device_ms(fn, reps: int = 5, tries: int = 3,
              by_kernel: dict | None = None) -> float | None:
    """Device time per call from a ``torch.profiler`` trace: the summed time
    of every kernel (and memset) the call runs on the card, without the
    host's launch overhead; ``by_kernel``, if given, receives it per kernel
    name.  A trace now and then comes back without device events; it is
    taken again, and after ``tries`` empty traces the time is reported as
    not measured (None) -- a supplementary number, not a check."""
    import re

    def calls() -> None:
        for _ in range(reps):
            fn()

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        _, _, _, by_name = _profiled(calls)
        ms = sum(by_name.values())
        if ms > 0:
            if by_kernel is not None:
                for name, t in by_name.items():
                    m = re.search(r"\w+_kernel\w*?(?:<[^>]*>|I\w+?E(?=E))?", name)
                    key = m.group(0) if m else name[:60]
                    by_kernel[key] = by_kernel.get(key, 0.0) + t / reps
            return ms / reps
    log(f"[kernels] device_ms: {tries} profiler traces held no device "
        f"time; not measured")
    return None


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


def _ptxas_report(text: str) -> dict[str, dict]:
    """Registers and spill stores of each kernel in one nvcc log (-Xptxas
    -v): {function: {"registers": n, "spill_stores": bytes}}.  A spill line
    belongs to the function its "Function properties for" line names, which
    may be a device function called by the kernel being compiled."""
    import re

    report, entry, props = {}, None, None
    for line in text.splitlines():
        if m := re.search(r"Compiling entry function '(\S+)'", line):
            entry = props = m.group(1)
            report[entry] = {}
        elif m := re.search(r"Function properties for (\S+)", line):
            props = m.group(1)
        elif entry and props == entry and (
                m := re.search(r"(\d+) bytes spill stores", line)):
            report[entry]["spill_stores"] = int(m.group(1))
        elif entry and (m := re.search(r"Used (\d+) registers", line)):
            report[entry]["registers"] = int(m.group(1))
    return report


def phase_build() -> dict[str, dict]:
    """Builds every kernel; logs ptxas' report of each function (the flash
    kernel's bodies: flash_fwd_wgmma_kernel<D, Dv>, flash_merge_kernel<Dv>,
    flash_fwd_mma_kernel<Dv>, flash_fwd_fma_kernel<Dv>; the WKV scan's
    wkv_chunk_kernel<N>, wkv_state_scan_kernel<N>, wkv_out_kernel<N> and
    wkv_step_kernel<N>) from the log kept
    beside each library, so a cached build reports too; fails if a NO_SPILL
    instantiation spills or has no report."""
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    secs = build.build_all()
    log(f"[build] {json.dumps(secs)} total {time.perf_counter() - t0:.1f}s")
    ptxas = {}
    for name in build.sources():
        text = build.build_log(name)
        for line in text.splitlines():
            if "warning" in line or "Potential Performance Loss" in line:
                log(f"[build] {name}: {line.strip()}")
        for fn, rep in _ptxas_report(text).items():
            ptxas[fn] = rep
            log(f"[build] {name}: {fn}: {json.dumps(rep)}")
    for key in NO_SPILL:
        hits = [r for fn, r in ptxas.items() if key in fn]
        if not hits or any("spill_stores" not in r for r in hits):
            raise AssertionError(f"[build] no ptxas spill report for {key}")
        if any(r["spill_stores"] for r in hits):
            raise AssertionError(f"[build] {key} spills: {hits}")
    return ptxas


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


def _rel_err(out: torch.Tensor, ref: torch.Tensor) -> float:
    """||out - ref|| / ||ref|| over the whole tensor, in f32."""
    ref = ref.float()
    return float((out.float() - ref).norm() / ref.norm())


def _planted_ragged(case, q, k, v, ref, kw) -> float | None:
    """The relative error of a kernel that left a ragged last key tile
    unmasked, TMA zero-filling the keys past Skv: the plain version over K
    and V zero-padded to a whole tile.  None where no tile is ragged or the
    causal mask hides the pad anyway."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa

    Skv, causal = case[3], case[8]
    pad = -Skv % fa.BLOCK_K
    if causal or not pad:
        return None
    kp, vp = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (k, v))
    return _rel_err(fa.flash_attention_plain(q, kp, vp, **kw), ref)


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


def _sdpa_backend(kernels: dict) -> str:
    """Which SDPA backend ran, from the names of the kernels it launched."""
    names = " ".join(kernels).lower()
    for key, backend in (("cudnn", "cudnn"), ("fmha", "efficient"),
                         ("efficient", "efficient"), ("flash", "flash")):
        if key in names:
            return backend
    return "math" if kernels else "not measured"


def _library_call(case, q, k, v):
    """One PyTorch call computing the same function (no epilogue), or None.
    With a window or an offset SDPA gets the explicit (Sq, Skv) band mask,
    and picks a backend that takes one (``_sdpa_backend`` names it)."""
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
    if not causal and not window:  # every key visible: no mask
        return lambda: F.scaled_dot_product_attention(qt, kt, vt)
    mask = _visible(case)
    return lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)


def phase_kernels() -> list[dict]:
    """The flash kernel's cases (KERNEL_CASES)."""
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
        err, rel = float(diff.max()), _rel_err(out, ref)
        tol, rel_tol = TOL[dt], REL_TOL[dt]
        planted = _planted_ragged(case, q, k, v, ref, kw)
        if not bool(torch.isfinite(out).all()) or bool(
                (diff > tol + tol * ref.float().abs()).any()) or rel > rel_tol:
            raise AssertionError(f"[kernels] {name}: kernel disagrees with its "
                                 f"plain version, max abs err {err}, relative "
                                 f"{rel} (limit {rel_tol}; an unmasked ragged "
                                 f"tile would give {planted})")
        if planted is not None and planted <= rel_tol:
            raise AssertionError(f"[kernels] {name}: the relative limit "
                                 f"{rel_tol} passes an unmasked ragged tile "
                                 f"({planted})")
        ms = cuda_ms(lambda: fa.flash_attention(q, k, v, **kw))
        dev_kernels = {}
        dev_ms = device_ms(lambda: fa.flash_attention(q, k, v, **kw),
                           by_kernel=dev_kernels)
        scale = D ** -0.5
        body = fa.select_body(dt, D, Dv, scale)
        plan = (fa.split_plan(B, Sq, Skv, Hq, causal, window, q_offset)
                if body == "wgmma" else None)
        prev = {}
        if name in PREV_BODY_CASES:  # the mma.sync body, same inputs, same run
            prev_out = fa.flash_attention(q, k, v, _body="mma", **kw)
            torch.cuda.synchronize()
            prev_diff = (prev_out.float() - ref.float()).abs()
            prev_err = float(prev_diff.max())
            if bool((prev_diff > tol + tol * ref.float().abs()).any()) or (
                    _rel_err(prev_out, ref) > rel_tol):
                raise AssertionError(f"[kernels] {name}: mma body disagrees, "
                                     f"max abs err {prev_err}")
            prev = dict(
                prev_body="mma", prev_body_max_abs_err=prev_err,
                prev_body_ms=cuda_ms(
                    lambda: fa.flash_attention(q, k, v, _body="mma", **kw)),
                prev_body_device_ms=device_ms(
                    lambda: fa.flash_attention(q, k, v, _body="mma", **kw)))
        plain_ms = cuda_ms(lambda: fa.flash_attention_plain(q, k, v, **kw),
                           reps=5)
        lib = _library_call(case, q, k, v)
        library_ms = cuda_ms(lib) if lib is not None else None
        lib_kernels = {}
        library_device_ms = (device_ms(lib, by_kernel=lib_kernels)
                             if lib is not None else None)
        bound_ms, bound_by = _bound(case, q, k, v, out, res)
        row = dict(case=name, shape=[B, Sq, Skv, Hq, Hkv, D, Dv],
                   dtype=str(dt).replace("torch.", ""), causal=causal,
                   window=window, q_offset=q_offset, max_abs_err=err,
                   tol=tol, rel_err=rel, rel_tol=rel_tol,
                   planted_ragged_rel_err=planted, body=body,
                   splits=len(plan.merges) if plan else 0,
                   items=len(plan.items) if plan else None,
                   critical_tiles=max(it[4] - it[3] for it in plan.items)
                   if plan else None,
                   ms=ms, device_ms=dev_ms, device_ms_by_kernel=dev_kernels,
                   plain_ms=plain_ms,
                   library_ms=library_ms, library_device_ms=library_device_ms,
                   library_backend=(_sdpa_backend(lib_kernels)
                                    if lib is not None else None),
                   library_kernels=sorted(lib_kernels),
                   bound_ms=bound_ms, bound_by=bound_by, **prev)
        log(f"[kernels] {json.dumps(row)}")
        results.append(row)
    return results


def _wkv_inputs(B, S, H, N, seed, w_hi=0.0):
    """Realistic decays (tests/test_kernels.py::_wkv_inputs): log_w =
    -exp(w_raw), w_raw in [-6, w_hi] (0 there); nonzero s0."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda")

    w_raw = torch.rand((B, S, H, N), generator=g, device="cuda") * (w_hi + 6.0) - 6.0
    return (randn(B, S, H, N), randn(B, S, H, N), randn(B, S, H, N),
            -torch.exp(w_raw), randn(H, N) * 0.1, randn(B, H, N, N) * 0.5)


def _wkv_bound(args, y, s_fin) -> tuple[float, str]:
    """Least time for one scan: each input read once and y, s_fin written
    once, against the operations of the recurrence on the CUDA cores.  Per
    (step, head): r.S 2N^2, the state update w*S + k v^T 3N^2, the u-bonus
    and its rank-1 term 5N, one exp per n: 5N^2 + 6N, all f32."""
    B, S, H, N = args[0].shape
    flops = float(B * S * H) * (5 * N * N + 6 * N)
    nbytes = sum(t.nbytes for t in args) + y.nbytes + s_fin.nbytes
    t_ops = flops / PEAK_FLOPS[torch.float32] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _wkv_check(name, body, outs, refs) -> float:
    """Max abs error of (y, s_fin) against the plain version's; raises past
    WKV_TOL x max(1, max |plain|) or on a non-finite value."""
    err = 0.0
    for out, ref in zip(outs, refs):
        e = float((out - ref).abs().max())
        scale = max(1.0, float(ref.abs().max()))
        if not bool(torch.isfinite(out).all()) or e > WKV_TOL * scale:
            raise AssertionError(f"[kernels] wkv {name} ({body} body): kernel "
                                 f"disagrees with its plain version, max abs "
                                 f"err {e} (scale {scale})")
        err = max(err, e)
    return err


def phase_wkv_kernel() -> list[dict]:
    """The WKV scan's cases (WKV_CASES): the chunked body, the default, and
    the step body on the same inputs (``_body="step"``)."""
    from repro_torch.kernels import linear_scan as ls

    results = []
    for name, B, S, H, N, w_hi in WKV_CASES:
        args = _wkv_inputs(B, S, H, N, seed=len(results), w_hi=w_hi)
        y, s_fin = ls.linear_scan(*args)
        torch.cuda.synchronize()
        refs = ls.linear_scan_plain(*args)
        err = _wkv_check(name, "chunked", (y, s_fin), refs)
        step_err = _wkv_check(name, "step", ls.linear_scan(*args, _body="step"),
                              refs)
        ms = cuda_ms(lambda: ls.linear_scan(*args))
        dev_kernels = {}
        dev_ms = device_ms(lambda: ls.linear_scan(*args), by_kernel=dev_kernels)
        prev = {}
        if name in PREV_WKV_BODY_CASES:  # the step body, same inputs, same run
            prev = dict(
                prev_body="step", prev_body_max_abs_err=step_err,
                prev_body_ms=cuda_ms(lambda: ls.linear_scan(*args, _body="step")),
                prev_body_device_ms=device_ms(
                    lambda: ls.linear_scan(*args, _body="step")))
        plain_ms = cuda_ms(lambda: ls.linear_scan_plain(*args), reps=5)
        bound_ms, bound_by = _wkv_bound(args, y, s_fin)
        row = dict(case=name, shape=[B, S, H, N], dtype="float32",
                   w_raw_max=w_hi, max_abs_err=err, step_max_abs_err=step_err,
                   max_abs_plain=float(refs[0].abs().max()),
                   tol=f"{WKV_TOL} x max(1, max |plain|)",
                   body="chunked", splits=0, ms=ms,
                   device_ms=dev_ms, device_ms_by_kernel=dev_kernels,
                   plain_ms=plain_ms, library_ms=None,
                   library_device_ms=None, bound_ms=bound_ms,
                   bound_by=bound_by, **prev)
        log(f"[kernels] wkv {json.dumps(row)}")
        results.append(row)
    return results


def _config(arch: str):
    """The config of "arch", or of "arch@L": the arch at its full width with
    its first L layers (a depth cut, labelled so wherever it is logged)."""
    from repro_torch.configs import get_config

    name, _, layers = arch.partition("@")
    cfg = get_config(name)
    return cfg.scaled(name=arch, n_layers=int(layers)) if layers else cfg


def _depth(cfg) -> str:
    """How a config is cut, for its log lines."""
    from repro_torch.configs import get_config

    name, _, layers = cfg.name.partition("@")
    if not layers:
        return "no depth cut"
    return (f"depth cut: {cfg.n_layers} of {get_config(name).n_layers} "
            f"layers, full width")


def _prompts(vocab: int, long: bool = False) -> list[list[int]]:
    """The trace's prompts (PROMPT_LENS), then LONG_PROMPT if ``long``."""
    rng = np.random.RandomState(0)
    lens = PROMPT_LENS + ([LONG_PROMPT] if long else [])
    return [rng.randint(0, vocab, n).tolist() for n in lens]


def _attn_layers(cfg) -> int:
    return sum(t in ("attn", "swa") for t in cfg.layer_types())


def _draw_conv(params: dict, seed: int = 0) -> None:
    """RG-LRU's ``conv_w`` leaves, in place, from CONV_SCALE x a seeded
    normal (the init's zeros would zero every RG-LRU output and state)."""
    from repro_torch.utils import tree_flatten

    for path, t in tree_flatten(params):
        if path.endswith("conv_w"):
            g = torch.Generator(device=t.device).manual_seed(seed)
            t.copy_(CONV_SCALE * torch.randn(t.shape, generator=g,
                                             device=t.device))
            seed += 1


def phase_serve(model, params, kernel, per_prefill, paged_launches,
                prompts=None, max_len=1024) -> dict:
    """Serve the prompts (default: the trace's) through both engines;
    ``kernel`` is the module of the path's kernel wrapper, whose launch
    count is set to 0 just before each engine runs and read just after.
    The dense engine runs one full prefill per prompt, ``per_prefill``
    launches each; ``paged_launches(stats)`` is the paged engine's expected
    count."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import linear_scan as ls
    from repro_torch.launch.serve import (ContinuousBatcher,
                                          PagedServingEngine, Request)
    from repro_torch.utils import tree_leaves

    cfg = model.cfg
    prompts = prompts or _prompts(cfg.vocab_size)
    name = kernel.__name__.rsplit(".", 1)[-1]

    def reqs():
        return [Request(rid=i, prompt=list(p), max_new=MAX_NEW)
                for i, p in enumerate(prompts)]

    def reset():
        fa.launches = ls.launches = 0

    dense_reqs = reqs()
    batcher = ContinuousBatcher(model, params, n_slots=4, max_len=max_len)
    reset()
    stats = batcher.run(dense_reqs)
    torch.cuda.synchronize()
    launches = {"dense": kernel.launches}
    others = fa.launches + ls.launches - kernel.launches
    log(f"[serve] {cfg.name} dense: wall_s {stats['wall_s']:.3f} tok/s "
        f"{stats['tok_per_s']:.2f} host_syncs {stats['host_syncs']} "
        f"{name} launches {launches['dense']}")
    expect = per_prefill * len(prompts)
    if not all(r.done and not r.rejected for r in dense_reqs):
        raise AssertionError("[serve] dense: a request did not finish")
    if stats["tokens"] != len(prompts) * MAX_NEW:
        raise AssertionError(f"[serve] dense: {stats['tokens']} tokens")
    if launches["dense"] != expect or others:
        raise AssertionError(f"[serve] dense {name} launches "
                             f"{launches['dense']} != {expect} (others {others})")

    paged_reqs = reqs()
    eng = PagedServingEngine(model, params, n_slots=8, max_len=max_len,
                             page_size=16, chunk_max=64, drain_every=8)
    reset()
    pstats = eng.run(paged_reqs)
    torch.cuda.synchronize()
    launches["paged"] = kernel.launches
    others = fa.launches + ls.launches - kernel.launches
    log(f"[serve] {cfg.name} paged: wall_s {pstats['wall_s']:.3f} tok/s "
        f"{pstats['tok_per_s']:.2f} host_syncs {pstats['host_syncs']} "
        f"decode_ticks {pstats['decode_ticks']} prefill_rounds "
        f"{pstats['prefill_rounds']} prefill_chunks {pstats['prefill_chunks']} "
        f"{name} launches {launches['paged']}")
    if not all(r.done and not r.rejected and len(r.out) == MAX_NEW
               for r in paged_reqs):
        raise AssertionError("[serve] paged: a request did not finish")
    if eng.kv.stats().pages_in_use or any(eng.slot_req):
        raise AssertionError("[serve] paged: pages or slots not returned")
    view = sum(math.prod(sp.shape) * sp.dtype.itemsize for sp in tree_leaves(
        model.cache_specs(eng.prefill_group, eng.kv.view_len)))
    log(f"[serve] {cfg.name} paged: each prefill round gathers and scatters "
        f"a {eng.prefill_group}-slot view, {2 * view / 1e6:.1f} MB (from the "
        f"cache specs)")
    if launches["paged"] != paged_launches(pstats) or others:
        raise AssertionError(f"[serve] paged {name} launches "
                             f"{launches['paged']} != {paged_launches(pstats)} "
                             f"(others {others})")
    for r in dense_reqs + paged_reqs:
        if not all(0 <= t < cfg.vocab_size for t in r.out):
            raise AssertionError(f"[serve] token out of vocab in {r.rid}")
    agree = sum(a == b for d, p in zip(dense_reqs, paged_reqs)
                for a, b in zip(d.out, p.out))
    log(f"[serve] {cfg.name} bf16 greedy tokens equal across engines: "
        f"{agree}/{len(prompts) * MAX_NEW} (the two engines round in bf16 at "
        f"other places, so bf16 streams may part)")
    return launches


def _engines_agree(model32, params, prompts) -> None:
    from repro_torch.launch.serve import (ContinuousBatcher,
                                          PagedServingEngine, Request)

    d = [Request(rid=i, prompt=list(p), max_new=8) for i, p in enumerate(prompts)]
    q = [Request(rid=i, prompt=list(p), max_new=8) for i, p in enumerate(prompts)]
    ContinuousBatcher(model32, params, n_slots=2, max_len=1024).run(d)
    PagedServingEngine(model32, params, n_slots=2, max_len=1024, page_size=16,
                       chunk_max=64, drain_every=8, dtype=torch.float32).run(q)
    agree = sum(a == b for x, y in zip(d, q) for a, b in zip(x.out, y.out))
    log(f"[parity] {model32.cfg.name} f32 greedy tokens equal across engines: "
        f"{agree}/{sum(len(x.out) for x in d)}")


def _prefill_both(model, params, prompt, dtype):
    """First-token logits of one prompt through full ``prefill`` and through
    ``prefill_chunk`` over a paged cache (the paged engine's prefill)."""
    from repro_torch.launch.paged_kv import PagedKVCache, decompose

    tokens = torch.tensor([prompt], dtype=torch.int32, device="cuda")
    cache = model.init_cache(1, 1024, dtype=dtype)
    full, _ = model.prefill(params, {"tokens": tokens}, cache)
    kv = PagedKVCache(model, n_slots=1, n_pages=64, page_size=16,
                      max_pages=64, dtype=dtype)
    kv.alloc(0, len(prompt) + 1)
    start = 0
    for c in decompose(len(prompt), 64):
        view = kv.gather_slot(0)
        chunked, view = model.prefill_chunk(
            params, {"tokens": tokens[:, start:start + c]}, view,
            torch.full((1,), start, dtype=torch.int32, device="cuda"))
        kv.scatter_slot(0, view)
        start += c
    return full, chunked


def phase_bf16_gap(model, params) -> None:
    """Why bf16 greedy streams of the two engines may part: the gap between
    full and chunked prefill's first-token logits against the top-2 margin
    (a report, not a check)."""
    for i, p in enumerate(_prompts(model.cfg.vocab_size)[:2]):
        full, chunked = _prefill_both(model, params, p, torch.bfloat16)
        top = full[0].float().topk(2).values
        log(f"[serve] {model.cfg.name} bf16 prompt {i} (len {len(p)}): max "
            f"|full - chunked| first-token logits "
            f"{float((full - chunked).abs().max()):.3e}, top-2 margin "
            f"{float(top[0] - top[1]):.3e}, argmax equal "
            f"{bool(full.argmax() == chunked.argmax())}")


def phase_parity(model32, params) -> None:
    prompts = _prompts(model32.cfg.vocab_size)[:2]
    for i, p in enumerate(prompts):
        dense, paged = _prefill_both(model32, params, p, torch.float32)
        err = float((dense - paged).abs().max())
        scale = float(dense.abs().max())
        log(f"[parity] prompt {i} (len {len(p)}): max |dense - paged| logits "
            f"{err:.3e} (max |logit| {scale:.3f}, tol {PARITY_TOL})")
        if not bool(torch.isfinite(dense).all()) or err > PARITY_TOL:
            raise AssertionError(f"[parity] prompt {i}: {err} > {PARITY_TOL}")

    _engines_agree(model32, params, prompts)


def phase_parity_decode(model32, params, prompts, kernel,
                        per_prefill) -> None:
    """Full prefill (``per_prefill`` launches of ``kernel``, the module of
    the path's kernel wrapper; rwkv6's WKV scan, or recurrentgemma's flash
    attention beside the RG-LRU doubling scan) against the prompt fed token
    by token through ``decode_step`` (the plain per-step recurrences, no
    kernel)."""
    name = model32.cfg.name
    for i, p in enumerate(prompts):
        tokens = torch.tensor([p], dtype=torch.int32, device="cuda")
        cache = model32.init_cache(1, 1024, dtype=torch.float32)
        before = kernel.launches
        full, _ = model32.prefill(params, {"tokens": tokens}, cache)
        if kernel.launches - before != per_prefill:
            raise AssertionError(f"[parity] {name} prefill missed the kernel")
        cache = model32.init_cache(1, 1024, dtype=torch.float32)
        before = kernel.launches
        for t in range(len(p)):
            step, cache = model32.decode_step(
                params, tokens[:, t:t + 1], cache,
                torch.full((1,), t, dtype=torch.int32, device="cuda"))
        if kernel.launches != before:
            raise AssertionError(f"[parity] {name} decode launched the kernel")
        err = float((full - step).abs().max())
        scale = float(full.abs().max())
        log(f"[parity] {name} prompt {i} (len {len(p)}): max |prefill - "
            f"decode| logits {err:.3e} (max |logit| {scale:.3f}, tol "
            f"{PARITY_TOL})")
        if not bool(torch.isfinite(full).all()) or err > PARITY_TOL:
            raise AssertionError(f"[parity] {name} prompt {i}: {err} > "
                                 f"{PARITY_TOL}")


def phase_parity_long(model32, params, prompt) -> None:
    """A prompt longer than window + q-chunk, f32: first-token logits of
    full prefill through the flash kernel against full prefill with the
    positions given, whose plain attention slices a KV band per q-chunk
    (``_attention_expanded``); both wrap the SWA rings."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.attention import _pick_chunk

    cfg = model32.cfg
    S = len(prompt)
    chunk = _pick_chunk(S)
    if not S > cfg.window + chunk:
        raise AssertionError(f"[parity] {S} tokens do not take the band")
    tokens = torch.tensor([prompt], dtype=torch.int32, device="cuda")
    cache = model32.init_cache(1, LONG_MAX_LEN, dtype=torch.float32)
    before = fa.launches
    flash, _ = model32.prefill(params, {"tokens": tokens}, cache)
    if fa.launches - before != _attn_layers(cfg):
        raise AssertionError(f"[parity] {cfg.name}: flash launches "
                             f"{fa.launches - before}")
    cache = model32.init_cache(1, LONG_MAX_LEN, dtype=torch.float32)
    before = fa.launches
    t0 = time.perf_counter()
    plain, _ = model32.prefill(params, {"tokens": tokens, "positions":
                                        model32._positions(1, S, None)}, cache)
    torch.cuda.synchronize()
    if fa.launches != before:
        raise AssertionError("[parity] the plain path launched flash")
    err = float((flash - plain).abs().max())
    scale = float(flash.abs().max())
    log(f"[parity] {cfg.name} prompt of {S} tokens (window {cfg.window}, "
        f"q-chunk {chunk}, banded plain path {time.perf_counter() - t0:.1f}s):"
        f" max |flash - plain| first-token logits {err:.3e} (max |logit| "
        f"{scale:.3f}, tol {PARITY_TOL})")
    if not bool(torch.isfinite(flash).all()) or err > PARITY_TOL:
        raise AssertionError(f"[parity] {cfg.name}: {err} > {PARITY_TOL}")


def phase_model(arch: str) -> dict[str, int]:
    """One model of SERVE_MODELS at full width: the f32 parity phases on the
    f32 masters, then the bf16 copy, the masters' matrices dropped (so the
    card never holds the masters, an f32 forward and the copy at once), and
    the trace through both engines.  Returns the flash launches by
    engine."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import LanguageModel
    from repro_torch.utils import tree_leaves

    cfg = _config(arch)
    torch.cuda.reset_peak_memory_stats()
    model = LanguageModel(cfg, device="cuda")
    t0 = time.perf_counter()
    params = model.init(0)
    _draw_conv(params)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(params))
    log(f"[serve] {cfg.name} full width ({_depth(cfg)}): "
        f"{n_params / 1e9:.3f}B params held ({cfg.param_count() / 1e9:.3f}B "
        f"by the config's count), {cfg.n_layers} layers ({_attn_layers(cfg)} "
        f"attention), init {time.perf_counter() - t0:.1f}s")
    long = bool(cfg.window)
    prompts = _prompts(cfg.vocab_size, long=long)
    model32 = LanguageModel(cfg.scaled(compute_dtype="float32"), device="cuda")
    if long:
        phase_parity_long(model32, params, prompts[-1])
    else:
        phase_parity(model32, params)
    if "rglru" in cfg.layer_types():
        phase_parity_decode(model32, params, [prompts[2]], fa,
                            _attn_layers(cfg))
    if cfg.pos_type == "mrope":
        phase_mrope_streams(model32, params, prompts[:2])
    moe = (f" (_moe_dense computes all {cfg.n_experts} experts on every "
           f"token)" if cfg.n_experts else "")
    log(f"[mem] {cfg.name} f32 phases: peak allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB{moe}")
    cast = model.cast_for_compute(params)
    del model32, params
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    if cfg.pos_type == "mrope":
        phase_multimodal(model, cast)
    launches = phase_serve(model, cast, fa, _attn_layers(cfg),
                           lambda stats: 0, prompts,
                           LONG_MAX_LEN if long else 1024)
    log(f"[mem] {cfg.name} serving: peak allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB{moe}")
    del model, cast
    torch.cuda.empty_cache()
    return launches


def _mm_positions(n_text: int, grid: int, n_after: int) -> np.ndarray:
    """(3, 1, S) M-RoPE coordinates of ``n_text`` text tokens, a ``grid`` x
    ``grid`` patch grid, ``n_after`` text tokens.  The temporal stream is
    the token's index (the model's masks and cache slots read it, so it
    stays unique); height and width carry the grid's rows and columns from
    where the text left off, and equal the temporal stream on text."""
    n = n_text + grid * grid + n_after
    t = np.arange(n)
    h, w = t.copy(), t.copy()
    r, c = np.divmod(np.arange(grid * grid), grid)
    h[n_text:n_text + grid * grid] = n_text + r
    w[n_text:n_text + grid * grid] = n_text + c
    return np.stack([t, h, w])[:, None].astype(np.int32)


def phase_mrope_streams(model32, params, prompts) -> None:
    """M-RoPE on the card, f32: prefill with explicit (3, B, S) positions,
    three equal streams (the plain attention path), against prefill with
    none (the model builds the same streams; the flash kernel), first-token
    logits within PARITY_TOL."""
    from repro_torch.kernels import flash_attention as fa

    cfg = model32.cfg
    for i, p in enumerate(prompts):
        tokens = torch.tensor([p], dtype=torch.int32, device="cuda")
        streams = torch.arange(len(p), dtype=torch.int32,
                               device="cuda").expand(3, 1, len(p))
        before = fa.launches
        flash, _ = model32.prefill(params, {"tokens": tokens},
                                   model32.init_cache(1, 1024,
                                                      dtype=torch.float32))
        mid = fa.launches
        plain, _ = model32.prefill(params, {"tokens": tokens,
                                            "positions": streams},
                                   model32.init_cache(1, 1024,
                                                      dtype=torch.float32))
        if mid - before != _attn_layers(cfg) or fa.launches != mid:
            raise AssertionError(f"[parity] {cfg.name}: flash launches "
                                 f"{mid - before}, {fa.launches - mid}")
        err = float((flash - plain).abs().max())
        log(f"[parity] {cfg.name} M-RoPE prompt {i} (len {len(p)}): max "
            f"|no positions (flash) - three equal streams given (plain)| "
            f"first-token logits {err:.3e} (max |logit| "
            f"{float(flash.abs().max()):.3f}, tol {PARITY_TOL})")
        if not bool(torch.isfinite(flash).all()) or err > PARITY_TOL:
            raise AssertionError(f"[parity] {cfg.name} M-RoPE: {err}")


def phase_multimodal(model, params, steps: int = 8) -> None:
    """One multimodal prefill in the compute dtype: MM_TEXT text tokens, a
    PATCH_GRID x PATCH_GRID grid of seeded patch embeddings (0.02 x a
    normal, the embedding init's scale; the vision frontend is a stub), then
    MM_TEXT text tokens, with distinct temporal / height / width streams
    (the plain path), then ``steps`` greedy decode steps; every logit must
    be finite.  The same construction is held against JAX on the CPU at
    smoke width (tests/test_torch_encdec_mrope.py)."""
    cfg = model.cfg
    pos = torch.from_numpy(_mm_positions(MM_TEXT, PATCH_GRID, MM_TEXT)).to("cuda")
    n = pos.shape[-1]
    g = torch.Generator(device="cuda").manual_seed(0)
    tokens = torch.randint(0, cfg.vocab_size, (1, n), generator=g,
                           device="cuda", dtype=torch.int32)
    embeds = params["embed"][tokens.long()]  # the text's own embeddings
    patches = slice(MM_TEXT, MM_TEXT + PATCH_GRID ** 2)
    embeds[:, patches] = 0.02 * torch.randn(
        (1, PATCH_GRID ** 2, cfg.d_model), generator=g, device="cuda").to(
        embeds.dtype)
    cache = model.init_cache(1, n + steps + 1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = model.prefill(params, {"tokens": tokens, "embeds": embeds,
                                           "positions": pos}, cache)
    outs = [logits]
    for t in range(n, n + steps):
        tok = logits.argmax(-1).to(torch.int32)[:, None]
        logits, cache = model.decode_step(
            params, tok, cache, torch.full((1,), t, dtype=torch.int32,
                                           device="cuda"))
        outs.append(logits)
    torch.cuda.synchronize()
    out = torch.stack(outs)
    finite = bool(torch.isfinite(out).all())
    log(f"[serve] {cfg.name} multimodal: {MM_TEXT} text + "
        f"{PATCH_GRID}x{PATCH_GRID} patches + {MM_TEXT} text = {n} tokens "
        f"with distinct t/h/w streams (the patches' t {MM_TEXT}.."
        f"{MM_TEXT + PATCH_GRID ** 2 - 1}, h and w {MM_TEXT}.."
        f"{MM_TEXT + PATCH_GRID - 1}), then {steps} decode steps: "
        f"{time.perf_counter() - t0:.3f}s, logits finite {finite}, max "
        f"|logit| {float(out.abs().max()):.3f}, greedy tokens "
        f"{out.argmax(-1)[:, 0].tolist()}")
    if not finite:
        raise AssertionError(f"[serve] {cfg.name} multimodal: logits not "
                             f"finite")


def _whisper_batch(run: str, rows: int, n: int, vocab: int, d: int):
    """Seeded tokens (rows, n) and frames (rows, WHISPER_ENC_LEN, d): each
    frame set a standard normal of its own seed."""
    g = torch.Generator(device="cuda").manual_seed(ord(run))
    tokens = torch.randint(0, vocab, (rows, n), generator=g, device="cuda",
                           dtype=torch.int32)
    frames = torch.stack([torch.randn(
        (WHISPER_ENC_LEN, d), device="cuda",
        generator=torch.Generator(device="cuda").manual_seed(100 * ord(run) + r))
        for r in range(rows)])
    return tokens, frames


def _whisper_greedy(model, params, tokens, frames, steps, dtype):
    """prefill with frames, then ``steps`` greedy decode steps: (the
    prefill's logits, the logits of every step, the greedy tokens fed, the
    prefill's wall, the decode wall)."""
    rows, n = tokens.shape
    cache = model.init_cache(rows, WHISPER_MAX_LEN, WHISPER_ENC_LEN,
                             dtype=dtype)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    first, cache = model.prefill(params, {"tokens": tokens, "frames": frames},
                                 cache)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    logits, fed, outs = first, [], []
    for t in range(n, n + steps):
        tok = logits.argmax(-1).to(torch.int32)[:, None]
        fed.append(tok)
        logits, cache = model.decode_step(
            params, tok, cache, torch.full((rows,), t, dtype=torch.int32,
                                           device="cuda"))
        outs.append(logits)
    torch.cuda.synchronize()
    return (first, torch.stack(outs), torch.cat(fed, 1), t1 - t0,
            time.perf_counter() - t1)


def phase_whisper() -> dict[str, int]:
    """whisper-medium at full width, no cut (0.791 B parameters held; the
    config counts 0.758 B, leaving out ``pos_embed``, as the reference
    does), seed-0 weights.  f32 on the masters first: the full prefill
    through the flash kernel (encoder, self- and cross-attention, 72
    launches) against the same prefill with positions given (plain
    everywhere), both runs, first-token logits within PARITY_TOL; the
    logits after 8 greedy decode steps against a full prefill of the prompt
    plus those 8 tokens; each run's WHISPER_STEPS greedy tokens.  Then the
    bf16 copy, the masters dropped: runs a and b, prefill plus
    WHISPER_STEPS greedy steps, with the flash launches read around each
    (72 a prefill), wall, tokens/s, peak memory, and greedy agreement with
    the f32 tokens.  Returns the launches by run."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import LanguageModel
    from repro_torch.utils import tree_leaves

    cfg = get_config("whisper-medium")
    per_prefill = cfg.n_enc_layers + 2 * cfg.n_layers
    torch.cuda.reset_peak_memory_stats()
    model = LanguageModel(cfg, device="cuda")
    params = model.init(0)
    n_params = sum(t.numel() for t in tree_leaves(params))
    log(f"[whisper] {cfg.name} full width (no depth cut): "
        f"{n_params / 1e9:.3f}B params held ({cfg.param_count() / 1e9:.3f}B "
        f"by the config's count, which leaves out pos_embed), "
        f"{cfg.n_enc_layers} encoder + {cfg.n_layers} decoder layers, "
        f"{WHISPER_ENC_LEN} frames, decoder context {WHISPER_MAX_LEN}")
    model32 = LanguageModel(cfg.scaled(compute_dtype="float32"), device="cuda")
    batches = {run: _whisper_batch(run, rows, n, cfg.vocab_size, cfg.d_model)
               for run, rows, n in WHISPER_RUNS}
    f32_tokens = {}
    for run, (tokens, frames) in batches.items():
        rows, n = tokens.shape
        before = fa.launches
        first, steps, fed, _, _ = _whisper_greedy(
            model32, params, tokens, frames, WHISPER_STEPS, torch.float32)
        if fa.launches - before != per_prefill:
            raise AssertionError(f"[whisper] f32 prefill: flash launches "
                                 f"{fa.launches - before} != {per_prefill}")
        f32_tokens[run] = fed
        before = fa.launches
        plain, _ = model32.prefill(
            params, {"tokens": tokens, "frames": frames,
                     "positions": model32._positions(rows, n, None)},
            model32.init_cache(rows, WHISPER_MAX_LEN, WHISPER_ENC_LEN,
                               dtype=torch.float32))
        if fa.launches != before:
            raise AssertionError("[whisper] the plain path launched flash")
        err = float((first - plain).abs().max())
        full, _ = model32.prefill(
            params, {"tokens": torch.cat([tokens, fed[:, :8]], 1),
                     "frames": frames},
            model32.init_cache(rows, WHISPER_MAX_LEN, WHISPER_ENC_LEN,
                               dtype=torch.float32))
        dec_err = float((steps[7] - full).abs().max())
        log(f"[whisper] f32 run {run} ({rows} x {n} tokens): max |flash - "
            f"plain| first-token logits {err:.3e}; max |decode step 8 - full "
            f"prefill of prompt + 8| logits {dec_err:.3e} (max |logit| "
            f"{float(first.abs().max()):.3f}, tol {PARITY_TOL})")
        if (not bool(torch.isfinite(steps).all()) or err > PARITY_TOL
                or dec_err > PARITY_TOL):
            raise AssertionError(f"[whisper] f32 run {run}: {err}, {dec_err}")
    log(f"[mem] {cfg.name} f32 phases: peak allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    cast = model.cast_for_compute(params)
    del model32, params
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    launches = {}
    for run, (tokens, frames) in batches.items():
        rows, n = tokens.shape
        fa.launches = 0
        first, steps, fed, pre_s, dec_s = _whisper_greedy(
            model, cast, tokens, frames, WHISPER_STEPS, torch.bfloat16)
        launches[f"{cfg.name} prefill {run}"] = fa.launches
        ok = bool(torch.isfinite(steps).all()) and bool(
            ((fed >= 0) & (fed < cfg.vocab_size)).all())
        agree = int((fed == f32_tokens[run]).sum())
        leads = (fed == f32_tokens[run]).int().cumprod(1).sum(1).tolist()
        plain, _ = model.prefill(
            cast, {"tokens": tokens, "frames": frames,
                   "positions": model._positions(rows, n, None)},
            model.init_cache(rows, WHISPER_MAX_LEN, WHISPER_ENC_LEN,
                             dtype=torch.bfloat16))
        rel = _rel_err(first, plain)
        top = first.float().topk(2, dim=-1).values
        log(f"[whisper] bf16 run {run} ({rows} x {n} tokens, "
            f"{WHISPER_STEPS} greedy steps): prefill {pre_s * 1e3:.2f} ms "
            f"(time to first token), decode {dec_s:.3f} s "
            f"({dec_s / WHISPER_STEPS * 1e3:.2f} ms a step), tok/s "
            f"{rows * WHISPER_STEPS / (pre_s + dec_s):.2f}, flash launches "
            f"{fa.launches}; greedy tokens equal to f32's {agree}/"
            f"{fed.numel()}, each row's equal for its first {leads}; "
            f"first-token logits flash against plain: relative {rel:.3e} "
            f"(limit {WHISPER_BF16_REL}), max abs "
            f"{float((first - plain).abs().max()):.3e}, top-2 margins "
            f"{(top[:, 0] - top[:, 1]).tolist()}")
        if fa.launches != per_prefill or not ok or rel > WHISPER_BF16_REL:
            raise AssertionError(f"[whisper] bf16 run {run}: flash launches "
                                 f"{fa.launches}, finite {ok}, flash against "
                                 f"plain {rel}")
    log(f"[mem] {cfg.name} serving: peak allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    _whisper_trace(model, cast, *batches["a"])
    del model, cast
    torch.cuda.empty_cache()
    return launches


def _whisper_trace(model, params, tokens, frames, steps: int = 8) -> None:
    """Where a whisper call's time goes, one run a prefill and then
    ``steps`` decode steps, each under ``torch.profiler``: the wall, the
    summed device time of its kernels and copies (the busy share), their
    count and the largest five by name.  A trace without device events
    reports the share as not measured."""
    rows, n = tokens.shape
    cache = model.init_cache(rows, WHISPER_MAX_LEN, WHISPER_ENC_LEN)

    def prefill():
        return model.prefill(params, {"tokens": tokens, "frames": frames},
                             cache)[0]

    def decode(logits):
        for t in range(n, n + steps):
            tok = logits.argmax(-1).to(torch.int32)[:, None]
            logits, _ = model.decode_step(
                params, tok, cache, torch.full((rows,), t, dtype=torch.int32,
                                               device="cuda"))
        return logits

    logits = prefill()  # warm: the profiled calls run on a built cache
    torch.cuda.synchronize()
    for what, fn in (("prefill", prefill), (f"{steps} decode steps",
                                            lambda: decode(logits))):
        _, wall, events, by_name = _profiled(fn)
        if not events:
            log(f"[whisper-trace] {what}: no device events; busy share not "
                f"measured")
            continue
        busy = sum(by_name.values())
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
        log(f"[whisper-trace] run a {what} under torch.profiler: wall "
            f"{wall * 1e3:.2f} ms, {len(events)} device events, device time "
            f"{busy:.2f} ms (busy {busy / (wall * 1e3):.4f}); top: " + "; ".join(
                f"{ms:.3f} ms {name[:70]}" for name, ms in top))


def _kernel_entry(name, source, replaces, launches, rows, library, ptxas,
                  **extra):
    head = rows[0]
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": sum(launches.values()),
            "launches_by_engine": launches,
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": head["ms"], "device_ms": head["device_ms"],
            "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"], "library": library,
            "body": head["body"], "splits": head["splits"],
            "shape": head["shape"], "ptxas": ptxas, **extra, "cases": rows}


def phase_trace(model, params, kernels: tuple[str, ...],
                tries: int = 2) -> float | None:
    """Device time of one wrapper's kernels over the trace's full prefills,
    measured: one more dense-engine run of the same requests under
    ``torch.profiler``, summing every kernel whose name holds one of
    ``kernels``.  Also logs their counts and their share of all device time
    in the run.  A trace without device events is taken again; after
    ``tries`` the time is not measured (None)."""
    from repro_torch.launch.serve import ContinuousBatcher, Request

    prompts = _prompts(model.cfg.vocab_size)
    for _ in range(tries):
        reqs = [Request(rid=i, prompt=list(p), max_new=MAX_NEW)
                for i, p in enumerate(prompts)]
        batcher = ContinuousBatcher(model, params, n_slots=4, max_len=1024)
        _, _, events, by_name = _profiled(lambda: batcher.run(reqs))
        if not events:
            continue
        hits = {n: [e for e in events if n in e.name] for n in kernels}
        ms = sum(t for name, t in by_name.items()
                 if any(n in name for n in kernels))
        all_ms = sum(by_name.values())
        counts = " and ".join(f"{len(es)} {n}" for n, es in hits.items())
        log(f"[trace] {model.cfg.name} dense run under torch.profiler: "
            f"device time {ms} ms over {counts} launches "
            f"({model.cfg.n_layers} layers x prompts {PROMPT_LENS}); all "
            f"kernels {all_ms} ms, share {ms / all_ms}")
        return ms
    log(f"[trace] {tries} profiler traces held no device time; the trace's "
        f"{kernels} time is not measured")
    return None


def _train_extras(cfg, batch: int, seq: int, seed: int) -> dict:
    """What a batch of ``cfg`` carries beside the tokens, as numpy, from a
    seed: an encoder-decoder model's frames (B, seq, d); an M-RoPE model's
    embeds (B, seq, d) and 3-stream positions over a patch grid."""
    rng = np.random.RandomState(seed)
    if cfg.enc_dec:
        return {"frames": rng.standard_normal(
            (batch, seq, cfg.d_model)).astype(np.float32)}
    if cfg.pos_type == "mrope":
        grid = int(math.isqrt(seq // 2))
        pos = _mm_positions(4, grid, seq - 4 - grid * grid)
        return {"embeds": (0.02 * rng.standard_normal(
                    (batch, seq, cfg.d_model))).astype(np.float32),
                "positions": np.broadcast_to(pos, (3, batch, seq)).copy()}
    return {}


def _train_steps(model, params, batches):
    """Losses and router losses of ``make_train_step`` over ``batches``
    (updates ``params``)."""
    from repro_torch.launch.train import make_train_step
    from repro_torch.optim import AdamW, OptConfig

    opt = AdamW(OptConfig(peak_lr=3e-3, warmup_steps=2, decay_steps=10))
    step, state = make_train_step(model, opt), opt.init(params)
    losses, auxes = [], []
    dev = model.device
    for b in batches:
        params, state, m = step(params, state, {
            k: torch.from_numpy(v).to(dev) for k, v in b.items()})
        losses.append(float(m["loss"]))
        auxes.append(float(m["aux_loss"]))
    return losses, auxes, params


def phase_train_parity() -> None:
    """Train steps on the card against the CPU, smoke size, f32 compute
    (the CPU path is the one the CPU tests hold against JAX): 3 steps of
    ``make_train_step`` from the same seed-0 weights on the same batches
    (with seeded frames for whisper, embeds and 3-stream positions for
    qwen2-vl);
    losses and router losses within TRAIN_TOL relative (the router loss
    non-zero in an MoE model), every parameter after the steps within
    TRAIN_TOL x max(1, max |p|)."""
    from repro_torch.data import TokenDataset
    from repro_torch.launch.train import smoke_config
    from repro_torch.models import LanguageModel
    from repro_torch.utils import tree_leaves, tree_map

    for arch in TRAIN_PARITY:
        cfg = smoke_config(arch).scaled(compute_dtype="float32")
        cpu = LanguageModel(cfg, device="cpu")
        p_cpu = cpu.init(0)
        _draw_conv(p_cpu)
        p_gpu = tree_map(lambda t: t.to("cuda", copy=True), p_cpu)
        data = TokenDataset(vocab_size=cfg.vocab_size, seq_len=64,
                            global_batch=2)
        batches = [{**data.batch(i), **_train_extras(cfg, 2, 64, i)}
                   for i in range(3)]
        l_cpu, a_cpu, p_cpu = _train_steps(cpu, p_cpu, batches)
        l_gpu, a_gpu, p_gpu = _train_steps(LanguageModel(cfg, device="cuda"),
                                           p_gpu, batches)
        loss_err = max(abs(a - b) / abs(b) for a, b in zip(l_gpu, l_cpu))
        if cfg.n_experts:
            if not all(np.isfinite(a_cpu)) or 0.0 in a_cpu:
                raise AssertionError(f"[train] {arch}: router loss {a_cpu}")
            loss_err = max([loss_err] + [abs(a - b) / abs(b)
                                         for a, b in zip(a_gpu, a_cpu)])
        par_err = 0.0
        for a, b in zip(tree_leaves(p_gpu), tree_leaves(p_cpu)):
            a, b = a.detach().cpu(), b.detach()
            err = float((a - b).abs().max())
            par_err = max(par_err, err / max(1.0, float(b.abs().max())))
        log(f"[train] {arch} smoke, card vs CPU over 3 steps: losses "
            f"{l_gpu} vs {l_cpu}; router losses {a_gpu} vs {a_cpu}; max "
            f"rel loss diff {loss_err:.3e}, max "
            f"param diff / max(1, max |p|) {par_err:.3e} (tol {TRAIN_TOL})")
        if not (loss_err <= TRAIN_TOL and par_err <= TRAIN_TOL):
            raise AssertionError(f"[train] {arch}: card and CPU part")


def phase_train_resume() -> None:
    """Preempt at step 8 (exit 17), resume to 12 from the committed
    checkpoint, against a straight 12-step run, on the card (smoke size)."""
    import tempfile

    from repro_torch.launch.train import train

    kw = dict(arch="gemma-2b", smoke=True, steps=12, global_batch=2,
              seq_len=32, save_every=4, log_every=12, device="cuda")
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
        ref = train(ckpt_dir=f"{d}/straight", **kw)
        try:
            train(ckpt_dir=f"{d}/resumed", preempt_at=8, **kw)
            raise AssertionError("[train] preempt_at=8 did not exit")
        except SystemExit as e:
            if e.code != 17:
                raise AssertionError(f"[train] preempt exit code {e.code}")
        res = train(ckpt_dir=f"{d}/resumed", **kw)
    gap = abs(res["final_loss"] - ref["final_loss"])
    log(f"[train] gemma-2b smoke on the card: preempted at 8 (exit 17), "
        f"resumed to 12: final loss {res['final_loss']:.6f} vs straight "
        f"{ref['final_loss']:.6f}, |diff| {gap:.3e} (tol {RESUME_TOL}; "
        f"atomics in the embedding backward may move the last bits)")
    if not gap < RESUME_TOL:
        raise AssertionError(f"[train] resume differs by {gap}")


def _moe_layers(cfg) -> int:
    from repro_torch.models.transformer import layer_kinds

    return sum(is_moe for _, is_moe in layer_kinds(cfg))


def active_params(cfg) -> int:
    """Parameters one token's forward uses: the config's count with each
    MoE layer's routed experts cut to ``top_k`` of ``n_experts``."""
    idle = cfg.n_experts - cfg.top_k
    return cfg.param_count() - _moe_layers(cfg) * idle * 3 * cfg.d_model * \
        cfg.d_ff_expert


def train_flops(cfg, batch: int, seq: int, executed: bool = False) -> float:
    """Model FLOPs of one train step: 6 N per token (forward 2 N, backward
    4 N; N the active parameters, counting the tied embedding once, as the
    head's product) plus attention's two products over the full S x S
    scores the plain path computes, 6 L S Hq (Dqk + Dv) per token, with
    Dqk = nope + rope and Dv = v_head_dim for MLA (12 L S Hq D when both are
    head_dim); remat's recompute is not counted.  ``executed`` counts every
    expert, as ``_moe_dense`` runs them all."""
    dqk, dv = ((cfg.qk_nope_head_dim + cfg.qk_rope_head_dim, cfg.v_head_dim)
               if cfg.use_mla else (cfg.head_dim, cfg.head_dim))
    n = cfg.param_count() if executed else active_params(cfg)
    per_token = 6 * n + 6 * cfg.n_layers * seq * cfg.n_heads * (dqk + dv)
    return per_token * batch * seq


def phase_train_full(card: str, arch: str) -> dict[str, int]:
    """``arch`` at full width, 20 steps of ``train`` (bf16 compute, remat
    full, B x S = TRAIN_BATCH x TRAIN_SEQ, seed 0, no checkpoint: gemma-2b's
    f32 masters plus m and v would write 30 GB a save), then one more step
    under ``torch.profiler``.  Returns the kernels' launches across the
    20 steps."""
    from repro_torch.configs import get_config
    from repro_torch.data import TokenDataset
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import linear_scan as ls
    from repro_torch.launch.train import make_train_step, train
    from repro_torch.models import LanguageModel
    from repro_torch.optim import AdamW, OptConfig

    cfg = get_config(arch)
    torch.cuda.reset_peak_memory_stats()
    fa.launches = ls.launches = 0
    out = train(arch=arch, smoke=False, steps=TRAIN_STEPS,
                global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ,
                peak_lr=TRAIN_LR, ckpt_dir=None, log_every=1, device="cuda")
    torch.cuda.synchronize()
    launches = {"flash": fa.launches, "wkv": ls.launches}
    peak = torch.cuda.max_memory_allocated()
    hist = out["history"]
    losses = [h["loss"] for h in hist]
    gnorms = [h["grad_norm"] for h in hist]
    walls = [b["wall_s"] - a["wall_s"] for a, b in zip(hist, hist[1:])]
    wall = float(np.median(walls))  # steps 2 .. TRAIN_STEPS
    tokens = TRAIN_BATCH * TRAIN_SEQ
    flops = train_flops(cfg, TRAIN_BATCH, TRAIN_SEQ)
    peak_flops = PEAK_FLOPS[torch.bfloat16]
    first5, last5 = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    log(f"[train] {cfg.name} full width ({cfg.param_count() / 1e9:.3f}B "
        f"params, {cfg.n_layers} layers, remat {cfg.remat}, "
        f"{cfg.compute_dtype}), B {TRAIN_BATCH} x S {TRAIN_SEQ}, "
        f"{TRAIN_STEPS} steps, peak lr {TRAIN_LR}: losses {losses}")
    log(f"[train] grad norms {gnorms}")
    log(f"[train] mean loss of the first 5 steps {first5} and of the last 5 "
        f"{last5}")
    log(f"[train] launches across the phase: {launches}")
    if cfg.n_experts:
        auxes = [h["aux_loss"] for h in hist]
        log(f"[train] router losses (sum over {_moe_layers(cfg)} MoE layers) "
            f"{auxes}")
        if not all(np.isfinite(auxes)) or 0.0 in auxes:
            raise AssertionError(f"[train] router loss {auxes}")
        done = train_flops(cfg, TRAIN_BATCH, TRAIN_SEQ, executed=True)
        log(f"[train] {active_params(cfg) / 1e9:.3f}B of "
            f"{cfg.param_count() / 1e9:.3f}B params active a token (top "
            f"{cfg.top_k} of {cfg.n_experts} experts); _moe_dense computes "
            f"all {cfg.n_experts}: {done / 1e12:.3f} T FLOPs a step executed, "
            f"{done / flops:.3f}x the model FLOPs, "
            f"{cfg.n_experts / cfg.top_k:.1f}x in the experts; executed "
            f"share of the peak {done / wall / peak_flops:.4f}")
    log(f"[train] step wall (median of steps 2-{TRAIN_STEPS}, each ending in "
        f"a host read) {wall * 1e3:.2f} ms; tokens/s {tokens / wall:.1f}; "
        f"model FLOPs a step {flops / 1e12:.3f} T (6 N_active tokens + "
        f"attention 6 L S Hq (Dqk + Dv) tokens, no recompute); model-FLOP "
        f"share of the dense "
        f"bf16 peak {peak_flops / 1e12:.0f} TFLOP/s: "
        f"{flops / wall / peak_flops:.4f} ({card})")
    log(f"[train] peak allocated {peak / 2**30:.2f} GiB ({peak / 1e9:.2f} GB)")
    if not all(np.isfinite(losses + gnorms)):
        raise AssertionError("[train] a loss or grad norm is not finite")
    if not last5 < first5:
        raise AssertionError(f"[train] loss did not fall: {first5} -> {last5}")
    if launches != {"flash": 0, "wkv": 0}:
        raise AssertionError(f"[train] the train path launched {launches}")

    model = LanguageModel(cfg, device="cuda")
    params = out.pop("params")
    del out
    opt = AdamW(OptConfig(peak_lr=TRAIN_LR))
    state, step = opt.init(params), make_train_step(model, opt)
    batch = {k: torch.from_numpy(v).to("cuda") for k, v in TokenDataset(
        cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH).batch(TRAIN_STEPS).items()}
    torch.cuda.synchronize()
    (params, state, m), prof_wall, events, by_name = _profiled(
        lambda: step(params, state, batch), cpu=True)
    busy = sum(by_name.values()) / 1e3
    if events:
        log(f"[train-trace] one more step under torch.profiler: wall "
            f"{prof_wall * 1e3:.2f} ms, {len(events)} device events, summed "
            f"device time {busy * 1e3:.2f} ms: busy {busy / prof_wall:.4f} "
            f"of that wall, {busy / wall:.4f} of the unprofiled median wall")
    else:
        log("[train-trace] the trace held no device time: busy share not "
            "measured")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:5]:
        log(f"[train-trace] {ms:.3f} ms {name[:110]}")
    kinds: dict[str, list] = {}
    for name, ms in by_name.items():
        kind = next((k for k, keys in TRACE_KINDS if any(
            key in name for key in keys)), "other")
        kinds.setdefault(kind, [0.0, 0])
        kinds[kind][0] += ms
        kinds[kind][1] += sum(1 for e in events if e.name == name)
    log("[train-trace] device ms (kernels) by kind: " + ", ".join(
        f"{k} {ms:.2f} ({n})" for k, (ms, n) in sorted(
            kinds.items(), key=lambda kv: -kv[1][0])))
    phase_train_parts(model, opt, params, state, batch)
    del params, state, m, batch, model
    torch.cuda.empty_cache()
    return launches


def phase_train_parts(model, opt, params, state, batch) -> None:
    """One more step cut into its parts, the forward (``train_loss``), the
    backward (``autograd.grad``) and the optimizer (``opt.update``), each
    timed twice: on the host up to the end of its enqueueing (no sync in
    between) and on the card between CUDA events.  A part whose host time
    exceeds its device time leaves the card waiting for the host."""
    from repro_torch.utils import tree_leaves, tree_unflatten

    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    host = [time.perf_counter()]
    ev[0].record()
    leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
    total, _ = model.train_loss(params, batch)
    ev[1].record()
    host.append(time.perf_counter())
    grads = torch.autograd.grad(total, leaves)
    del total
    ev[2].record()
    host.append(time.perf_counter())
    opt.update(tree_unflatten(params, grads), state, params)
    ev[3].record()
    host.append(time.perf_counter())
    torch.cuda.synchronize()
    end = time.perf_counter()
    parts = ("forward", "backward", "optimizer")
    # AdamW must read p, g, m, v and write p, m, v once: 28 bytes a parameter
    opt_bound = 28 * sum(p.numel() for p in leaves) / PEAK_BYTES * 1e3
    log("[train-parts] one step: " + "; ".join(
        f"{n} device {ev[i].elapsed_time(ev[i + 1]):.2f} ms, host enqueue "
        f"{(host[i + 1] - host[i]) * 1e3:.2f} ms" for i, n in enumerate(parts))
        + f"; step to the last sync {(end - host[0]) * 1e3:.2f} ms; the "
        f"optimizer's bound (28 bytes a parameter) {opt_bound:.2f} ms")


def _fatal(graph, errors: list):
    """``graph`` with each asset function wrapped to keep what it raises in
    ``errors``.  The simulated clients raise their injected failures before
    the function runs, so whatever reaches the wrapper is real (a CUDA
    error, a bug): the coordinator retries it as any failure, and
    ``_materialize`` then fails the phase on it."""
    import dataclasses
    import functools

    from repro_torch.core import AssetGraph

    def wrap(fn):
        @functools.wraps(fn)  # the store hashes the source of ``fn``
        def run(*a, **k):
            try:
                return fn(*a, **k)
            except BaseException as e:
                errors.append(e)
                raise
        return run

    return AssetGraph([dataclasses.replace(graph[n], fn=wrap(graph[n].fn))
                       for n in graph.names()])


def _materialize(coord, targets, run_id: str, errors: list, **kw):
    try:
        return coord.materialize(targets, run_id=run_id, **kw)
    finally:
        if errors:
            raise RuntimeError(f"[orch] run {run_id}: an asset raised "
                               f"{errors[0]!r}") from errors[0]


def _orch_report(tag: str, report, reader) -> tuple[int, int]:
    """Log the report, its retries, failovers, per-platform outcomes and
    cost by asset; returns (retries, failovers)."""
    for line in report.summary().splitlines():
        log(f"[{tag}] {line}")
    retries = sum(len(r.attempts) - 1 for r in report.records)
    failovers = len(reader.events(kind="FAILOVER"))
    log(f"[{tag}] retries {retries}, failovers {failovers}; per-platform "
        f"outcomes {reader.outcome_counts()}")
    log(f"[{tag}] cost by asset " + json.dumps(
        {k: round(v, 2) for k, v in report.by_asset_cost().items()}))
    return retries, failovers


def _cc_hashes(cfg, device: str) -> dict:
    """Data hashes of edges and graph_aggr of two partitions of ``cfg``."""
    from repro_torch.core import MaterializationStore
    from repro_torch.data import commoncrawl as cc

    out = {}
    for crawl, shard in (("2023-10", "shard-0"), ("2023-11", "shard-1")):
        nodes = cc.nodes_asset(crawl, shard, cfg)
        edges = cc.edges_asset(crawl, shard, nodes, cfg, device=device)
        aggr = cc.graph_aggr_asset(cc.graph_asset(nodes, edges), cfg,
                                   device=device)
        for name, value in (("edges", edges), ("graph_aggr", aggr)):
            out[f"{name}[{crawl}/{shard}]"] = \
                MaterializationStore.data_fingerprint(value)[1]
    return out


def phase_orchestrator_cc() -> None:
    """The Common Crawl pipeline through ``RunCoordinator`` on the card, as
    examples/torch_commoncrawl_graph.py runs it but at the reference's
    CrawlConfig(); its bytes against the CPU's; a cached second run; the
    segment sum's bits at 33 tokens a page, card against card and CPU."""
    from benchmarks.torch_cc_pipeline import build_graph
    from examples.torch_commoncrawl_graph import PARTS
    from repro_torch.core import (CostModel, DynamicClientFactory,
                                  MaterializationStore, MessageReader,
                                  Objective, RunCoordinator, default_catalog)
    from repro_torch.data import commoncrawl as cc

    cfg = cc.CrawlConfig()
    errors: list = []
    reader = MessageReader()
    coord = RunCoordinator(
        _fatal(build_graph(cfg, partitions=PARTS, device="cuda"), errors),
        DynamicClientFactory(default_catalog(), CostModel(),
                             Objective.balanced(), sim_seed=ORCH_CC_SEED),
        reader=reader)
    cc.device_calls.clear()
    t0 = time.perf_counter()
    plan = coord.plan(["graph_aggr"])
    report = _materialize(coord, ["graph_aggr"], "cc-1", errors, plan=plan)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    calls = dict(cc.device_calls)
    log(f"[orch-cc] CrawlConfig() ({cfg.n_domains} domains x "
        f"{cfg.n_pages_per_domain} pages, {cfg.n_seed} seeds, "
        f"{cfg.max_links} links, {cfg.tokens_per_page} tokens) over "
        f"{len(PARTS.keys())} partitions: plan + materialize {wall:.3f} s "
        f"(host clock up to a sync)")
    retries, failovers = _orch_report("orch-cc", report, reader)
    log(f"[orch-cc] tensor work by (asset, device): {calls}")
    if not report.ok or not retries or not failovers:
        raise AssertionError("[orch-cc] want a successful run with retries "
                             "and failovers")
    if {d for _, d in calls} != {"cuda"} or min(calls.values()) < 4 or \
            len(calls) != 2:
        raise AssertionError(f"[orch-cc] edges and graph_aggr must run on "
                             f"the card for every partition: {calls}")

    part = "2023-10/shard-0"
    nodes = cc.nodes_asset("2023-10", "shard-0", cfg)
    edges = cc.edges_asset("2023-10", "shard-0", nodes, cfg, device="cpu")
    graph = cc.graph_asset(nodes, edges)
    cpu = {"nodes": nodes, "edges": edges, "graph": graph,
           "graph_aggr": cc.graph_aggr_asset(graph, cfg, device="cpu")}
    for name, value in cpu.items():
        card_hash = coord.store.data_hash(name, part)
        cpu_hash = MaterializationStore.data_fingerprint(value)[1]
        log(f"[orch-cc] {name}[{part}] data hash: card {card_hash}, cpu "
            f"{cpu_hash}")
        if card_hash != cpu_hash:
            raise AssertionError(f"[orch-cc] {name}[{part}]: the card's "
                                 "bytes differ from the CPU's")
    log(f"[orch-cc] graph_aggr[{part}]: {len(cpu['graph_aggr']['weight'])} "
        f"inter-domain edges")

    again = _materialize(coord, ["graph_aggr"], "cc-2", errors)
    cached = sum(r.cached for r in again.records)
    log(f"[orch-cc] second materialize: {cached} of {len(again.records)} "
        f"tasks cached, cost ${again.total_cost:.2f}")
    if cached != len(again.records) or again.total_cost != 0:
        raise AssertionError("[orch-cc] the second run was not all cache hits")

    for kw in ORCH_T33:
        cfg33 = cc.CrawlConfig(**kw)
        runs = [_cc_hashes(cfg33, "cuda"), _cc_hashes(cfg33, "cuda"),
                _cc_hashes(cfg33, "cpu")]
        log(f"[orch-cc] CrawlConfig({kw}) data hashes, card run 1 / card "
            f"run 2 / cpu: " + json.dumps({k: [r[k] for r in runs]
                                          for k in runs[0]}))
        if not runs[0] == runs[1] == runs[2]:
            raise AssertionError(f"[orch-cc] CrawlConfig({kw}): the card's "
                                 "bytes differ between runs or from the CPU's")
    rng = np.random.RandomState(0)
    data = torch.from_numpy(rng.standard_normal(200_000).astype(np.float32))
    ids = torch.from_numpy(rng.randint(0, 1000, size=200_000))
    cpu_sum = cc.segment_sum(data, ids, 1024)
    card = [cc.segment_sum(data.cuda(), ids.cuda(), 1024).cpu()
            for _ in range(2)]
    atomics = torch.zeros(1024, device="cuda").index_add_(
        0, ids.cuda(), data.cuda()).cpu()
    log(f"[orch-cc] segment_sum of 200000 normal f32 values into 1000 of "
        f"1024 bins: card runs equal {torch.equal(card[0], card[1])}, card "
        f"equal to the CPU {torch.equal(card[0], cpu_sum)}; index_add_ "
        f"(float atomics, not used) differs from it in "
        f"{int((atomics != cpu_sum).sum())} bins")
    if not (torch.equal(card[0], card[1]) and torch.equal(card[0], cpu_sum)):
        raise AssertionError("[orch-cc] segment_sum's bits differ")


def phase_orchestrator_train(card: str) -> None:
    """examples/torch_train_lm.py's stage graph: ORCH_ARCH at full width,
    ORCH_STAGES stages of ORCH_STEPS steps through ``RunCoordinator``, each
    stage resuming from the checkpoint the one before wrote; a retried
    stage attempt, the checkpoint's bytes and its save and restore
    seconds, a falling loss, a cached second run.  The checkpoint directory
    is deleted at the end."""
    import shutil

    from examples.torch_train_lm import FULL, stage_graph
    from repro_torch.configs import get_config
    from repro_torch.core import (CostModel, DynamicClientFactory,
                                  MessageReader, Objective, RunCoordinator,
                                  default_catalog)

    cfg = get_config(ORCH_ARCH)
    want = cfg.param_count() * 12  # f32 params, m and v
    shutil.rmtree(ORCH_CKPT, ignore_errors=True)
    ORCH_CKPT.mkdir(parents=True)
    free = shutil.disk_usage(ORCH_CKPT).free
    log(f"[orch-train] {ORCH_CKPT}: {free / 1e9:.1f} GB free; a checkpoint "
        f"of {cfg.name} ({cfg.param_count() / 1e9:.3f}B params, f32 params, "
        f"m and v) {want / 1e9:.3f} GB, {ORCH_STAGES} kept ({card})")
    if free < 1.1 * ORCH_STAGES * want:
        raise RuntimeError(f"[orch-train] {free / 1e9:.1f} GB free, "
                           f"{ORCH_STAGES} checkpoints need "
                           f"{ORCH_STAGES * want / 1e9:.1f} GB")
    last = f"stage{ORCH_STAGES - 1}"
    errors: list = []
    reader = MessageReader()
    coord = RunCoordinator(
        _fatal(stage_graph(ORCH_ARCH, ORCH_STAGES, ORCH_STEPS, str(ORCH_CKPT),
                           full=True, device="cuda"), errors),
        DynamicClientFactory(default_catalog(), CostModel(),
                             Objective.balanced(), sim_seed=ORCH_TRAIN_SEED),
        reader=reader)
    try:
        t0 = time.perf_counter()
        report = _materialize(coord, [last], "train-stages", errors)
        wall = time.perf_counter() - t0
        retries, _ = _orch_report("orch-train", report, reader)
        losses = []
        for i in range(ORCH_STAGES):
            name = f"stage{i}"
            out = coord.store.get(name, "__all__")
            ck = reader.events(kind="CHECKPOINT", asset=name)[-1].payload
            losses += out["losses"]
            log(f"[orch-train] {name}: resumed from step "
                f"{ck['resumed_step']} (restore {ck['restore_s']:.3f} s), "
                f"trained to step {out['steps']}, losses {out['losses']}; "
                f"checkpoint {ck['bytes']} bytes ({ck['bytes'] / 1e9:.3f} GB) "
                f"saved in {ck['save_s']:.3f} s "
                f"({ck['bytes'] / 1e9 / ck['save_s']:.2f} GB/s)")
            if ck["resumed_step"] != i * ORCH_STEPS or not ck["bytes"]:
                raise AssertionError(f"[orch-train] {name} did not resume "
                                     f"from stage{i - 1}'s checkpoint")
        log(f"[orch-train] {ORCH_STAGES} stages of {ORCH_STEPS} steps (B "
            f"{FULL['global_batch']} x S {FULL['seq_len']}): {wall:.3f} s")
        if not retries:
            raise AssertionError("[orch-train] no stage attempt was retried")
        if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
            raise AssertionError(f"[orch-train] loss {losses}")
        n_ckpt = len(reader.events(kind="CHECKPOINT"))
        again = _materialize(coord, [last], "train-stages-2", errors)
        cached = sum(r.cached for r in again.records)
        log(f"[orch-train] second materialize of {last}: {cached} of "
            f"{len(again.records)} tasks cached")
        if cached != len(again.records) or \
                len(reader.events(kind="CHECKPOINT")) != n_ckpt:
            raise AssertionError("[orch-train] the second run trained again")
    finally:
        shutil.rmtree(ORCH_CKPT, ignore_errors=True)


def phase_orchestrator(card: str) -> None:
    """Both orchestrator phases with the kernels' launch counts read around
    them: neither the Common Crawl assets nor training launch a kernel."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import linear_scan as ls

    fa.launches = ls.launches = 0
    t0 = time.perf_counter()
    phase_orchestrator_cc()
    phase_orchestrator_train(card)
    torch.cuda.synchronize()
    launches = {"flash": fa.launches, "wkv": ls.launches}
    log(f"[orch] phase {time.perf_counter() - t0:.3f} s; launches {launches}")
    if launches != {"flash": 0, "wkv": 0}:
        raise AssertionError(f"[orch] the orchestrator's path launched "
                             f"{launches}")


def _dist_parity(info) -> None:
    """granite@DIST_PARITY_LAYERS in f32 at capacity_factor E / top_k: the
    loss and every gradient of the capacity path on the mesh against the
    dense path without one, from the same weights and batch."""
    from repro_torch.data import TokenDataset
    from repro_torch.distributed.sharding import distribute_tree, use_mesh_info
    from repro_torch.models import LanguageModel, moe
    from repro_torch.utils import tree_flatten, tree_leaves, tree_map

    cfg = _config(f"{DIST_ARCH}@{DIST_PARITY_LAYERS}")
    cfg = cfg.scaled(compute_dtype="float32",
                     capacity_factor=cfg.n_experts / cfg.top_k)
    model = LanguageModel(cfg, device="cuda")
    params = model.init(0)
    batch = {k: torch.from_numpy(v).cuda() for k, v in TokenDataset(
        cfg.vocab_size, DIST_SEQ, DIST_BATCH).batch(0).items()}
    leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
    moe.PATH_CALLS.update(dense=0, shard_map=0)
    ref, _ = model.train_loss(params, batch)
    ref_grads = torch.autograd.grad(ref, leaves)
    ref = float(ref.detach())
    dense_calls = dict(moe.PATH_CALLS)
    with use_mesh_info(info):
        moe.PATH_CALLS.update(dense=0, shard_map=0)
        dp = distribute_tree(tree_map(lambda t: t.detach(), params),
                             model.param_axes, info)
        del params, leaves
        dl = [p.requires_grad_(True) for p in tree_leaves(dp)]
        db = {k: info.distribute(v, ("batch", "seq_act"))
              for k, v in batch.items()}
        tot, _ = model.train_loss(dp, db)
        grads = torch.autograd.grad(tot, dl)
        calls = dict(moe.PATH_CALLS)
        if dl[0].device.type != "cuda":
            raise AssertionError(f"[dist] params on {dl[0].device}")
        loss = float(tot.detach().full_tensor())
        worst, where = 0.0, ""
        for (key, _), a, b in zip(tree_flatten(dp), grads, ref_grads):
            err = float((a.full_tensor() - b).abs().max()
                        / b.abs().max().clamp(min=1e-30))
            if err >= worst:
                worst, where = err, key
    n_moe = _moe_layers(cfg) * (1 if cfg.remat == "none" else 2)  # reruns
    rel = abs(loss - ref) / abs(ref)
    log(f"[dist] {cfg.name} ({_depth(cfg)}), f32, B {DIST_BATCH} x S "
        f"{DIST_SEQ} = {DIST_BATCH * DIST_SEQ} tokens (_SMALL_T "
        f"{moe._SMALL_T}), capacity_factor {cfg.capacity_factor} (cap "
        f"{moe._capacity(DIST_BATCH * DIST_SEQ, cfg)}): paths without the "
        f"mesh {dense_calls}, on it {calls}; loss {loss!r} on the mesh vs "
        f"{ref!r} dense, rel {rel:.3e} (rtol {DIST_PARITY_RTOL}); worst "
        f"gradient leaf {where} at {worst:.3e} of its max |g| (tol "
        f"{DIST_GRAD_TOL}), over {len(grads)} leaves")
    if (calls != {"dense": 0, "shard_map": n_moe}
            or dense_calls != {"dense": n_moe, "shard_map": 0}):
        raise AssertionError(f"[dist] paths {dense_calls} / {calls}")
    if not (rel <= DIST_PARITY_RTOL and worst <= DIST_GRAD_TOL):
        raise AssertionError("[dist] the capacity path parts from dense")
    del dp, dl, grads, ref_grads, tot
    torch.cuda.empty_cache()


def _expert_flops(cfg, tokens: int, path: str) -> float:
    """FLOPs of one layer's expert einsums in one forward: 2 d ff a row for
    each of the three products, over T x top_k rows (active), E x cap slots
    (capacity path) or T x E (dense path)."""
    from repro_torch.models import moe

    rows = {"active": tokens * cfg.top_k,
            "capacity": cfg.n_experts * moe._capacity(tokens, cfg),
            "dense": tokens * cfg.n_experts}[path]
    return 3 * 2 * rows * cfg.d_model * cfg.d_ff_expert


def _dist_train(card: str, info) -> dict:
    """DIST_STEPS full-width steps of ``train`` at B x S = DIST_BATCH x
    DIST_SEQ, on the mesh (``info``: the capacity path) or without one
    (the dense path), then one more step under ``torch.profiler``."""
    from repro_torch.configs import get_config
    from repro_torch.data import TokenDataset
    from repro_torch.distributed.sharding import use_mesh_info
    from repro_torch.launch.train import make_train_step, train
    from repro_torch.models import LanguageModel, moe
    from repro_torch.optim import AdamW, OptConfig

    cfg = get_config(DIST_ARCH)
    tag = "mesh (1, 1), capacity path" if info else "no mesh, dense path"
    torch.cuda.reset_peak_memory_stats()
    moe.PATH_CALLS.update(dense=0, shard_map=0)
    moe.DROPS = [] if info else None
    out = train(arch=DIST_ARCH, smoke=False, steps=DIST_STEPS,
                global_batch=DIST_BATCH, seq_len=DIST_SEQ, peak_lr=TRAIN_LR,
                ckpt_dir=None, log_every=1, mesh_info=info, device="cuda")
    torch.cuda.synchronize()
    drops, moe.DROPS = moe.DROPS, None
    calls = dict(moe.PATH_CALLS)
    peak = torch.cuda.max_memory_allocated()
    hist = out["history"]
    losses = [h["loss"] for h in hist]
    walls = [b["wall_s"] - a["wall_s"] for a, b in zip(hist, hist[1:])]
    wall = float(np.median(walls))  # steps 2 .. DIST_STEPS
    tokens = DIST_BATCH * DIST_SEQ
    flops = train_flops(cfg, DIST_BATCH, DIST_SEQ)
    n_moe = _moe_layers(cfg)
    log(f"[dist] {cfg.name} full width, {tag}, bf16, remat {cfg.remat}, B "
        f"{DIST_BATCH} x S {DIST_SEQ}, {DIST_STEPS} steps, peak lr "
        f"{TRAIN_LR}: losses {losses}; router losses "
        f"{[h['aux_loss'] for h in hist]}; MoE calls {calls}")
    log(f"[dist] {tag}: step wall (median of steps 2-{DIST_STEPS}) "
        f"{wall * 1e3:.2f} ms; tokens/s {tokens / wall:.1f}; model-FLOP "
        f"share {flops / wall / PEAK_FLOPS[torch.bfloat16]:.4f}; peak "
        f"allocated {peak / 2**30:.2f} GiB ({peak / 1e9:.2f} GB) ({card})")
    path = "capacity" if info else "dense"
    active = _expert_flops(cfg, tokens, "active")
    log(f"[dist] {tag}: the experts execute "
        f"{_expert_flops(cfg, tokens, path) / active:.3f}x their active "
        f"FLOPs ({_expert_flops(cfg, tokens, path) * n_moe / 1e12:.3f} T "
        f"against {active * n_moe / 1e12:.3f} T a forward over {n_moe} "
        f"layers)")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"[dist] {tag}: losses {losses}")
    want = {"dense": 0, "shard_map": 2 * n_moe * DIST_STEPS} if info else \
        {"dense": 2 * n_moe * DIST_STEPS, "shard_map": 0}  # remat reruns each
    if calls != want:
        raise AssertionError(f"[dist] {tag}: MoE calls {calls}, not {want}")
    if info:
        per_step = len(drops) // DIST_STEPS
        if per_step != 2 * n_moe or len(drops) % DIST_STEPS:
            raise AssertionError(f"[dist] {len(drops)} drop records")
        slots = drops[0][1]
        for step in (1, DIST_STEPS):  # the forward's layers, in order
            share = [float(d) / slots for d, _ in
                     drops[(step - 1) * per_step:(step - 1) * per_step + n_moe]]
            log(f"[dist] dropped share of the {slots} (token, slot) "
                f"assignments a layer at step {step}: "
                f"{[round(x, 5) for x in share]} (mean "
                f"{float(np.mean(share)):.5f})")

    model = LanguageModel(cfg, device="cuda")
    params = out.pop("params")
    del out
    opt = AdamW(OptConfig(peak_lr=TRAIN_LR))
    with use_mesh_info(info):
        state, step = opt.init(params), make_train_step(model, opt)
        batch = {k: torch.from_numpy(v).cuda() for k, v in TokenDataset(
            cfg.vocab_size, DIST_SEQ, DIST_BATCH).batch(DIST_STEPS).items()}
        if info:
            batch = {k: info.distribute(v, ("batch", "seq_act"))
                     for k, v in batch.items()}
        torch.cuda.synchronize()
        (params, state, _), prof_wall, events, by_name = _profiled(
            lambda: step(params, state, batch))
    busy = sum(by_name.values()) / 1e3
    log(f"[dist-trace] {tag}: one more step under torch.profiler: wall "
        f"{prof_wall * 1e3:.2f} ms, {len(events)} device events, device time "
        f"{busy * 1e3:.2f} ms: busy {busy / prof_wall:.4f} of that wall"
        if events else f"[dist-trace] {tag}: no device time in the trace: "
        "busy share not measured")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:4]:
        log(f"[dist-trace] {ms:.3f} ms {name[:110]}")
    del params, state, batch, model
    torch.cuda.empty_cache()
    return {"wall": wall, "peak": peak, "busy": busy / prof_wall
            if events else None}


def _dist_experts(card: str) -> None:
    """One layer's expert einsums, forward and backward, timed alone at the
    full-width step's shapes (bf16): the capacity path's (E, cap, d)
    buffer against the dense path's (T, d) tokens over every expert."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    from repro_torch.models.layers import _act

    cfg = get_config(DIST_ARCH)
    E, d, ff = cfg.n_experts, cfg.d_model, cfg.d_ff_expert
    T = DIST_BATCH * DIST_SEQ
    cap = moe._capacity(T, cfg)
    g = torch.Generator(device="cuda").manual_seed(0)
    bf = dict(dtype=torch.bfloat16, device="cuda")
    w = [(torch.randn(E, *s, generator=g, **bf) * 0.03).requires_grad_(True)
         for s in ((d, ff), (d, ff), (ff, d))]
    cases = {"capacity": ("ecd,edf->ecf", "ecf,efd->ecd", (E, cap, d)),
             "dense": ("td,edf->tef", "tef,efd->ted", (T, d))}
    ms = {}
    for path, (up, down, shape) in cases.items():
        x = torch.randn(*shape, generator=g, **bf).requires_grad_(True)

        def fwd_bwd():
            h = torch.einsum(up, x, w[0])
            u = torch.einsum(up, x, w[1])
            y = torch.einsum(down, _act(cfg, h) * u, w[2])
            torch.autograd.grad(y.float().square().sum(), [x] + w)

        ms[path] = device_ms(fwd_bwd)
        flops = 3 * _expert_flops(cfg, T, path)  # forward + 2x backward
        log(f"[dist-experts] {path}: one layer's expert einsums at {shape}, "
            f"forward + backward, {ms[path]} device ms; {flops / 1e12:.3f} T "
            f"FLOPs, bound {flops / PEAK_FLOPS[torch.bfloat16] * 1e3:.3f} ms "
            f"({card})")
    if None not in ms.values():
        n = _moe_layers(cfg)
        log(f"[dist-experts] capacity / dense {ms['capacity'] / ms['dense']:.3f}"
            f"; a step's experts (x {n} layers, + the remat forward) about "
            f"{4 / 3 * n * ms['capacity']:.1f} vs {4 / 3 * n * ms['dense']:.1f}"
            f" device ms")


def _dist_collectives(info) -> None:
    """``compressed_psum_tree`` over one step's gradient tree on the mesh's
    group (world size 1), twice: the mean must equal the int8 round trip of
    g + e bit for bit, and the new error g + e - q scale."""
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.data import TokenDataset
    from repro_torch.distributed.collectives import (compressed_psum_tree,
                                                     dequantize_int8,
                                                     init_error_state,
                                                     quantize_int8)
    from repro_torch.distributed.sharding import distribute_tree, use_mesh_info
    from repro_torch.models import LanguageModel
    from repro_torch.utils import tree_leaves, tree_unflatten

    cfg = get_config(DIST_ARCH)
    model = LanguageModel(cfg, device="cuda")
    with use_mesh_info(info):
        params = distribute_tree(model.init(0), model.param_axes, info)
        batch = {k: info.distribute(torch.from_numpy(v).cuda(),
                                    ("batch", "seq_act"))
                 for k, v in TokenDataset(cfg.vocab_size, DIST_SEQ,
                                          DIST_BATCH).batch(0).items()}
        leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
        total, _ = model.train_loss(params, batch)
        grads = [g.to_local() for g in torch.autograd.grad(total, leaves)]
    del params, leaves, total
    grads = tree_unflatten(model.param_shapes(), grads)
    group = info.mesh.get_group("data")
    errors = init_error_state(grads)
    n = sum(g.numel() for g in tree_leaves(grads))
    for rnd in (1, 2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        means, new_errors = compressed_psum_tree(grads, group, errors)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        bad = 0
        for g, e, m, ne in zip(tree_leaves(grads), tree_leaves(errors),
                               tree_leaves(means), tree_leaves(new_errors)):
            x = g.float() + e
            q, scale = quantize_int8(x)
            bad += int(not torch.equal(m, dequantize_int8(q, scale).to(m.dtype)))
            bad += int(not torch.equal(ne, x - q.float() * scale))
        log(f"[dist-compress] round {rnd}: compressed_psum_tree over "
            f"{len(tree_leaves(grads))} gradient leaves ({n} values) on "
            f"the {dist.get_backend(group)} group of world size "
            f"{group.size()}: {ms:.2f} ms wall; leaves whose mean or error "
            f"parts from the int8 round trip: {bad}")
        if bad:
            raise AssertionError("[dist-compress] not the int8 round trip")
        errors = new_errors
    del grads, errors, means, new_errors
    torch.cuda.empty_cache()


def phase_distributed(card: str) -> None:
    """Training under a mesh: a (data 1, model 1) DeviceMesh over an NCCL
    group of one rank (a FileStore rendezvous in a temporary directory; no
    fallback to gloo or the CPU), then ``_dist_parity``, ``_dist_train`` on
    the mesh and without one, ``_dist_experts`` and ``_dist_collectives``.
    Neither kernel runs: the mesh path trains through ``attention_core``."""
    import tempfile

    import torch.distributed as dist

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import linear_scan as ls
    from repro_torch.launch.mesh import init_process_group, small_mesh_info

    fa.launches = ls.launches = 0
    t0 = time.perf_counter()
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
        init_process_group("nccl", f"file://{d}/rendezvous", rank=0,
                           world_size=1)
        try:
            info = small_mesh_info((1, 1), device_type="cuda")
            log(f"[dist] process group {dist.get_backend()}, world size "
                f"{dist.get_world_size()}, mesh {info.axis_sizes} on "
                f"{info.mesh.device_type}")
            _dist_parity(info)
            on = _dist_train(card, info)
            off = _dist_train(card, None)
            log(f"[dist] step wall on the mesh / without {on['wall'] * 1e3:.2f}"
                f" / {off['wall'] * 1e3:.2f} ms; peak {on['peak'] / 2**30:.2f}"
                f" / {off['peak'] / 2**30:.2f} GiB; busy {on['busy']} / "
                f"{off['busy']} ({card})")
            _dist_experts(card)
            _dist_collectives(info)
        finally:
            dist.destroy_process_group()
    torch.cuda.synchronize()
    launches = {"flash": fa.launches, "wkv": ls.launches}
    log(f"[dist] phase {time.perf_counter() - t0:.3f} s; launches {launches}")
    if launches != {"flash": 0, "wkv": 0}:
        raise AssertionError(f"[dist] the mesh path launched {launches}")


def main() -> None:
    card = phase_env()
    ptxas = phase_build()
    flash_rows = phase_kernels()
    wkv_rows = phase_wkv_kernel()

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import linear_scan as ls
    from repro_torch.models import LanguageModel

    flash_launches, wkv_launches = {}, {}
    cfg = get_config("gemma-2b")
    model = LanguageModel(cfg, device="cuda")
    t0 = time.perf_counter()
    params = model.init(0)
    torch.cuda.synchronize()
    log(f"[serve] {cfg.name} full width: {cfg.param_count() / 1e9:.3f}B params, "
        f"{cfg.n_layers} layers, init {time.perf_counter() - t0:.1f}s")
    cast = model.cast_for_compute(params)
    for engine, n in phase_serve(model, cast, fa, cfg.n_layers,
                                 lambda stats: 0).items():
        flash_launches[f"{cfg.name} {engine}"] = n
    trace_ms = phase_trace(model, cast, FLASH_KERNELS)
    phase_bf16_gap(model, cast)
    del cast
    torch.cuda.empty_cache()
    model32 = LanguageModel(cfg.scaled(compute_dtype="float32"), device="cuda")
    phase_parity(model32, params)
    log(f"[mem] {cfg.name} peak allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del model, model32, params
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    cfg = get_config("rwkv6-1.6b")
    model = LanguageModel(cfg, device="cuda")
    t0 = time.perf_counter()
    params = model.init(0)
    torch.cuda.synchronize()
    log(f"[serve] {cfg.name} full width: {cfg.param_count() / 1e9:.3f}B params, "
        f"{cfg.n_layers} layers, init {time.perf_counter() - t0:.1f}s")
    cast = model.cast_for_compute(params)
    for engine, n in phase_serve(
            model, cast, ls, cfg.n_layers,
            lambda stats: cfg.n_layers * stats["prefill_rounds"]).items():
        wkv_launches[f"{cfg.name} {engine}"] = n
    wkv_trace_ms = phase_trace(model, cast, WKV_KERNELS)
    phase_bf16_gap(model, cast)
    del cast
    torch.cuda.empty_cache()
    model32 = LanguageModel(cfg.scaled(compute_dtype="float32"), device="cuda")
    phase_parity_decode(model32, params, _prompts(cfg.vocab_size)[:2], ls,
                        cfg.n_layers)
    _engines_agree(model32, params, _prompts(cfg.vocab_size)[:2])
    log(f"[mem] {cfg.name} peak allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del model, model32, params
    torch.cuda.empty_cache()

    for arch in SERVE_MODELS:
        for engine, n in phase_model(arch).items():
            flash_launches[f"{arch} {engine}"] = n
    flash_launches.update(phase_whisper())

    phase_train_parity()
    phase_train_resume()
    for arch in TRAIN_FULL:
        train_launches = phase_train_full(card, arch)
        flash_launches[f"train {arch}"] = train_launches["flash"]
        wkv_launches[f"train {arch}"] = train_launches["wkv"]
    phase_orchestrator(card)
    phase_distributed(card)

    log(json.dumps({"kernels": [
        _kernel_entry("flash_attention", FLASH_SOURCE, FLASH_REPLACES,
                      flash_launches, flash_rows,
                      "F.scaled_dot_product_attention",
                      {f: r for f, r in ptxas.items() if "flash" in f},
                      prev_body_device_ms=flash_rows[0].get(
                          "prev_body_device_ms"),
                      trace_device_ms=trace_ms),
        _kernel_entry("linear_scan", WKV_SOURCE, WKV_REPLACES, wkv_launches,
                      wkv_rows, "none: no single PyTorch call computes the "
                      "WKV scan", {f: r for f, r in ptxas.items()
                                   if "wkv" in f or "scan" in f},
                      prev_body_device_ms=wkv_rows[0].get(
                          "prev_body_device_ms"),
                      trace_device_ms=wkv_trace_ms),
    ]}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
