#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which raises on failure (no phase is skipped, nothing falls
back to the CPU):

1. env      -- card name and power limit (nvidia-smi), torch and CUDA versions;
2. build    -- every CUDA kernel of the port, compiled from this checkout,
               with ptxas' registers and spill stores of each function, read
               from the log kept beside each library (the flash kernel's
               wgmma body at D = Dv = 256, 128, 80 and 64 and at D 96 /
               Dv 64, at both key tiles, must report no spill), those of
               the second tiles (128-key
               flash bodies, 32-step WKV chunks) logged apart; then the
               tuner's fit model (kernels/autotune.py) against the C
               entries' shared-memory sizing of every tile, byte for byte,
               and the host's body choice against C's at every bf16 (D, Dv)
               in multiples of 16 up to 256;
3. kernels  -- each kernel against its plain PyTorch version on the card, at
               the serving paths' shapes (flash at every prompt length of the
               gemma-2b, h2o-danube-1.8b and minicpm3-4b traces, the short
               ones split, and at the head dims of the model zoo), with
               the body that ran and its split-KV plan, its time, the plain
               version's, a PyTorch library call's (a yardstick the port
               never calls) where one exists, and the card's bound; at the
               gemma-2b, deepseek-7b, h2o-danube-1.8b (D 80, window) and
               minicpm3-4b prefill shapes also the mma.sync body, asked for
               through ``_body``, on the same inputs (danube's and
               minicpm3's at every prompt length; after the serve phases
               each body's time over one trace, layers x each length's
               row, is logged); at minicpm3-4b's MLA
               prefill (MHA 40/40, D 96 / Dv 64) and granite-moe-1b-a400m's
               (GQA 16/8, D 64), both wgmma; at
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
               rwkv6-1.6b prefill and paged chunk-round shapes; every case
               whose body has a second tile runs it too on the same inputs
               (flash: 128-key tiles on the wgmma body at Dv <= 128; WKV:
               32-step chunks), held to the case's tolerances and timed;
               the paged decode-attention kernel against the gather path
               at granite-moe-1b-a400m's serve-cell shapes (bf16 and f32),
               gemma-2b's, qwen2-vl-72b's, deepseek-7b's and the smoke
               configs' (PAGED_CASES), also held to PAGED_REL_TOL over
               the whole output against the gather path in f32, a limit
               that two controls (the query's own key dropped; P V summed
               in bf16) must exceed at the serve cells' shapes; timed
               beside the gather path, SDPA over the gathered view and the
               live pages' byte bound;
3b. tuner   -- kernels/ops.py's tuned dispatch through a fresh cache file: a
               miss times each candidate once and persists the winner, a hit
               times nothing, an explicit tile bypasses the tuner; then in
               children benchmarks/torch_kernel_bench.py --smoke and its
               unchanged gate (check_kernel_regression.py against
               benchmarks/baselines/torch_kernel_bench_baseline.json), and
               benchmarks/torch_microbench.py;
4. serve    -- gemma-2b at full width (18 layers, d_model 2048, vocab 256000,
               random weights from seed 0, bf16 compute) serving 6 ragged
               prompts through ``ContinuousBatcher`` (full prefill: the flash
               kernel) and ``PagedServingEngine`` (chunked prefill + paged
               decode through the paged-attention kernel, once a
               full-attention layer a tick: the engine's count,
               ``paged_attention_launches``, held to layers x decode
               ticks in every served model; the captured block then
               replayed under torch.profiler, whose trace must hold
               ``paged_attn_kernel`` once a layer a tick, as many as the
               engine adds a replay); the launch counts are read around
               each engine;
               then one more dense run under ``torch.profiler``, whose trace
               gives the flash kernel's device time over the trace's
               prefills (``trace_device_ms``);
5. parity   -- the same weights in f32 compute: first-token logits of the
               dense path (flash kernel) against the paged path (plain
               attention in chunked prefill, the paged-attention kernel in
               decode), and greedy agreement of the two engines;
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
               head_dim 80: the flash kernel's wgmma body with a window),
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
               the dense engine, none in the paged one, and the body each
               dense launch ran (every bf16 one on wgmma);
8b. whisper  -- whisper-medium at full width, no cut (no engine serves it, in
               the reference or here: neither passes encoder frames), through
               ``LanguageModel.prefill`` with 1500 seeded frames per row and
               ``decode_step``: f32 on the masters, flash (72 launches a
               prefill: 24 encoder, 24 self, 24 cross) against the plain
               path, and 8 decode steps against a full prefill of the prompt
               plus those tokens; then bf16, run a (4 rows x 4 tokens) and
               run b (1 x 224), each prefill plus 32 greedy steps, with
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
               (bf16, remat full, B 2 x S 1024, seed 0), 10 steps of
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
               then granite at full width, bf16, remat full, 5 steps of
               ``train(mesh_info=...)`` at capacity_factor 1.25 and 5
               without a mesh (the dense path): finite, falling loss, the
               step wall, tokens/s, peak memory, the dropped share of each
               layer's (token, slot) assignments at steps 1 and 10, the
               experts' executed FLOPs against their active ones, and one
               profiled step of each (busy share, top kernels); one layer's
               expert einsums, forward and backward, timed alone on each
               path; ``compressed_psum_tree`` twice over a step's gradients
               on the NCCL group, bit-equal to the int8 round trip;
               rwkv6-1.6b trained 5 steps on the mesh and 5 without;
               neither kernel launches in training.  Then serving on the
               same mesh: gemma-2b and rwkv6-1.6b at full width, 6
               layers each (a labelled depth cut), the trace's prompts one bf16 prefill each and 16 greedy decode
               steps, on the mesh and without one (time to first token, ms
               a decode step, busy share, peak; the greedy tokens equal;
               flash or WKV launched once a prefill per layer on the local
               shards), and one prompt in f32, every logit on the mesh
               within 1e-3 of the no-mesh run's;
10b. claims, dry run -- the paper's claims with the crawl on the card,
               equal to the CPU's; the dry run's predictions for one card
               against it;
10c. serving benchmarks -- in children: benchmarks/torch_serving_bench.py
               --smoke at full width (gemma-2b, bf16) at the labelled depth
               cut gemma-2b@6 (SERVE_BENCH_LAYERS) and its unchanged gate
               (check_serving_regression.py against
               benchmarks/baselines/torch_serving_baseline.json, taken at
               that cut),
               benchmarks/torch_run.py --smoke, and
               examples/torch_serve_lm.py --width full;
10d. host -- in children: one training cell and four serving cells of
               the 32x8 mesh on fake process groups, all five at once,
               started with the run (beside the build and the kernel
               phases, which read device time) and checked here; then the
               five orchestration twins (benchmarks/torch_*.py) --smoke at
               once, the crawl on the card, and nothing else beside them;
               their unchanged check_*_regression.py gates against
               benchmarks/baselines/torch_*_baseline.json.  The runner and
               the serving example of 10c run beside the orchestrator
               phase 9b;
11. the kernels JSON line (launches by phase: the main path's, then the
    tuner's and the benchmarks' children's under their own keys; the paged
    kernel's by served model), then the card line, then the result line.

Exits non-zero, printing no result, without a CUDA card or outside the
repository.
"""
from __future__ import annotations

import itertools
import json
import math
import os
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
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
PAGED_SOURCE = "src/repro_torch/kernels/csrc/paged_attention.cu"
PAGED_REPLACES = ("none: src/repro/kernels/ops.py:148 gathers the pages with "
                  "XLA, then plain attention")
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
    # minicpm3-4b's MLA heads (D = nope + rope = 96, Dv 64) and
    # granite-moe-1b-a400m's GQA heads (D 64), both on wgmma
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
    # h2o-danube-1.8b and minicpm3-4b at the serving trace's other prompt
    # lengths (PROMPT_LENS), as gemma_p{n}: at 97 and 180 tokens the split
    # plan splits, so the padded partials and flash_merge_kernel<80> run
    *((f"danube_p{n}", 1, n, n, 32, 8, 80, 80, True, 4096, 0, 1.0, False,
       torch.bfloat16) for n in (97, 180, 351, 563, 742, 1000)),
    *((f"minicpm3_p{n}", 1, n, n, 40, 40, 96, 64, True, 0, 0, 1.0, False,
       torch.bfloat16) for n in (97, 180, 351, 563, 742)),
]
# rows that must split on the main path's 64-key tile (``split_plan``), so
# the merge kernel is held to the plain version at each served head dim
SPLIT_CASES = ("gemma_p97", "danube_p97", "danube_p180", "minicpm3_p97",
               "minicpm3_p180")
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
# the paged decode-attention kernel's cases: (name, B, Hkv, G, D, max_pages,
# page_size, dtype, prompt range, new-token range).  A slot decodes at a
# prompt drawn log-uniform from the range plus a uniform share of its new
# tokens, its pages reserved as the engine reserves them; the first two are
# granite-moe-1b-a400m's serve cells at their mixes' lengths
# (portbench/traffic/serve_{long,short}.json), the rest the other paged
# models' decode (gemma-2b MQA at D 256, qwen2-vl-72b G 8 at D 128,
# deepseek-7b G 1 at D 128) at phase_serve's engine (8 slots, 64 pages of
# 16) and the smoke configs' head dims
PAGED_CASES = [
    ("granite_serve_long", 64, 8, 2, 64, 256, 16, torch.bfloat16,
     (1024, 3968), (32, 127)),
    ("granite_serve_short", 64, 8, 2, 64, 64, 16, torch.bfloat16, (32, 512),
     (128, 511)),
    ("granite_serve_short_f32", 64, 8, 2, 64, 64, 16, torch.float32,
     (32, 512), (128, 511)),
    ("gemma_decode", 8, 1, 8, 256, 64, 16, torch.bfloat16, (97, 1000),
     (1, 16)),
    ("qwen2vl_decode", 8, 8, 8, 128, 64, 16, torch.bfloat16, (97, 1000),
     (1, 16)),
    ("deepseek7b_decode", 8, 32, 1, 128, 64, 16, torch.bfloat16, (97, 1000),
     (1, 16)),
    ("smoke_d16", 3, 2, 2, 16, 8, 16, torch.float32, (5, 60), (4, 24)),
    ("smoke_d32", 3, 1, 4, 32, 8, 16, torch.bfloat16, (5, 60), (4, 24)),
]
# the kernel against the gather path on active rows: in bf16 the gather
# path rounds P to bf16 before P V, the kernel keeps f32 to the end
PAGED_TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-5}
# beside PAGED_TOL, by q's dtype, the relative error over the active rows,
# ||out - ref|| / ||ref||, against the gather path in f32 over the same
# pools: at serve.long's ~2,200 live keys an output is of order 0.035,
# where PAGED_TOL's absolute term alone would pass a kernel that drops the
# query's own key or sums P V in bf16.  Limits from sound runs' readings
# and those two controls (PERF.md); the controls are held above the limit
# in PAGED_CONTROL_CASES, the shapes of the serve cells
PAGED_REL_TOL = {torch.bfloat16: 5e-3, torch.float32: 1e-5}
PAGED_CONTROL_CASES = ("granite_serve_long", "granite_serve_short",
                       "granite_serve_short_f32")
# cases where the WKV scan's step body is timed beside the chunked one
PREV_WKV_BODY_CASES = ("rwkv6_prefill", "chunk_round")
PROMPT_LENS = [97, 1000, 351, 742, 180, 563]
# the sliding-window models' trace adds one prompt longer than both windows
# (4096, 2048): the SWA rings wrap and the plain path takes its KV band
LONG_PROMPT = 4500
LONG_MAX_LEN = 4608  # prompt + MAX_NEW + 1, rounded up to 16-token pages
# the dense engine's flash launches of one serving trace, per model: its
# attention layers times one prefill of each prompt length, the kernel row
# at each length; ``_trace_sums`` adds their times
TRACE_ROWS = {
    "gemma-2b": (18, ["gemma_prefill"]
                 + [f"gemma_p{n}" for n in (97, 180, 351, 563, 742)]),
    "h2o-danube-1.8b": (24, [f"danube_p{n}" for n in PROMPT_LENS]
                        + ["danube_swa_prefill"]),
    "minicpm3-4b": (62, ["minicpm3_mla_prefill"]
                    + [f"minicpm3_p{n}" for n in (97, 180, 351, 563, 742)]),
}
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
WHISPER_ENC_LEN, WHISPER_MAX_LEN, WHISPER_STEPS = 1500, 448, 32
WHISPER_RUNS = (("a", 4, 4), ("b", 1, 224))  # (run, rows, prompt tokens)
# bf16 first-token logits, the prefill through flash against the same
# prefill with positions given (plain everywhere), relative over the whole
# (rows, vocab) array; limit from sound runs' readings (PERF.md)
WHISPER_BF16_REL = 3e-2
# RG-LRU's conv weights, drawn at this scale x a seeded normal: the config's
# init sets them to zero (as JAX's), which zeros every RG-LRU output
CONV_SCALE = 0.5
# cases where the wgmma body replaces the mma.sync body, which is timed
# beside it in the same run (``_body="mma"``): the multiples of 64 since
# the wgmma body came, the padded head dims 80 and 96 since it took them
PREV_BODY_CASES = ("gemma_prefill", "deepseek7b_prefill", "window_d80",
                   "danube_swa_prefill", "minicpm3_mla_prefill",
                   *(c[0] for c in KERNEL_CASES
                     if c[0].startswith(("danube_p", "minicpm3_p"))))
# kernels that must compile without spills: the flash wgmma body at
# Dv = D = 256, 128, 80 and 64 and at D 96 / Dv 64 (below 256 both key
# tiles, 64 and 128: the mangled names <D, Dv, block_k> share these
# prefixes), every instantiation of the WKV chunked body's kernels (both
# chunks)
NO_SPILL = ("flash_fwd_wgmma_kernelILi256ELi256E",
            "flash_fwd_wgmma_kernelILi128ELi128E",
            "flash_fwd_wgmma_kernelILi80ELi80E",
            "flash_fwd_wgmma_kernelILi96ELi64E",
            "flash_fwd_wgmma_kernelILi64ELi64E",
            "wkv_chunk_kernel", "wkv_state_scan_kernel", "wkv_out_kernel",
            "paged_attn_kernel", "paged_attn_merge_kernel")
# the second tiles: flash's 128-key tiles on the wgmma body, where
# the body has them (Dv <= 128), and the WKV chunked body's 32-step chunks
SECOND_BLOCK_K, SECOND_CHUNK = 128, 32
# the shapes whose tiles' shared memory the build phase holds to the tuner's
# fit model: every (D, Dv) of the wgmma body -- (80, 80) and (96, 64) sized
# as wgmma since it takes them, in whole 64-column boxes -- and the mma.sync
# body's at the smoke configs' D 32; the WKV scan at every N
FIT_SHAPES = [(d, dv) for d in (64, 128, 192, 256) for dv in (64, 128, 256)] \
    + [(80, 80), (96, 64), (32, 32)]
FIT_N = (16, 32, 64)
# the kernels each wrapper launches, as torch.profiler names them
FLASH_KERNELS = ("flash_fwd", "flash_merge")
WKV_KERNELS = ("wkv_chunk_kernel", "wkv_state_scan_kernel", "wkv_out_kernel")
# the paged engine's kernel launches, by served model (phase_serve)
PAGED_LAUNCHES: dict[str, int] = {}
MAX_NEW = 16
# the trace that holds the paged engine's CUDA-graph decode block against
# the eager block: six requests (prompt length, new tokens) on three slots,
# all queued at tick 0, one prefill chunk each; at a drain every 8 ticks
# slots free and take the next request before and after the capture (the
# second block), and two requests decode across the replays
GRAPH_TRACE = ((32, 12), (16, 5), (32, 6), (16, 12), (32, 7), (16, 4))
GRAPH_TRACE_SLOTS = 3
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
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_LR = 10, 2, 1024, 3e-4
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
DIST_BATCH, DIST_SEQ, DIST_STEPS = 4, 2048, 5
DIST_PARITY_RTOL, DIST_GRAD_TOL = 2e-4, 1e-3
# rwkv6-1.6b on the same mesh (ROADMAP §3, fault 4): full width, bf16,
# remat full, B x S = TRAIN_BATCH x TRAIN_SEQ, DIST_RWKV_STEPS steps on
# the mesh and as many without one from the same weights and batches; the
# first step's loss on the mesh against the one without, relative
DIST_RWKV, DIST_RWKV_STEPS, DIST_RWKV_RTOL = "rwkv6-1.6b", 5, 1e-3

# serving on the same mesh (_dist_serve; ROADMAP §3, fault 5): gemma-2b
# (MQA at D 256: flash's wgmma body) and rwkv6-1.6b (the WKV kernel) at full
# width, cut to their first 6 layers (the mesh's host dispatch is paid a
# layer; the full depths serve without a mesh in phase_serve), the trace's
# prompts (PROMPT_LENS) one prefill each (B 1), then MAX_NEW greedy decode
# steps, bf16, on the mesh and without one; then the first DIST_SERVE_F32
# prompts in f32, the mesh fed the no-mesh run's tokens, every logit held
# to PARITY_TOL
DIST_SERVE, DIST_SERVE_F32 = ("gemma-2b@6", "rwkv6-1.6b@6"), 1

# the serving benchmark's grid (phase_serving_benches): gemma-2b at full
# width in bf16, cut to its first 6 layers (a labelled depth cut,
# gemma-2b@6, gated against its own H100 baseline): at its 18 layers the
# grid takes about 100 s and the whole run passed 1100 s (PERF.md); the
# full depth's grid runs on its own (torch_serving_bench.py --smoke)
SERVE_BENCH_LAYERS = 6

# the paper-claims phase (phase_paper_claims): the seeds and limits of
# tests/test_paper_claims.py.  The card's numbers must equal the CPU's but
# for the simulated makespan share, whose runs differ in the last digits
# from one run to the next (in the reference too: tests/
# test_torch_launch_tools.py), held to CLAIMS_MAKESPAN_RTOL
CLAIM_SEEDS, FIG3_SEEDS, FIG4_SEEDS, FIG6_SEEDS = 16, 14, 30, 5
CLAIMS_MAKESPAN_RTOL = 1e-6

# the dry-run phase (phase_dryrun): gemma-2b at full width as
# phase_train_full trains it, priced on the `local` platform's one-card
# mesh; the analytic FLOPs against a counted step within the band of
# tests/test_flops_model.py:45; then one cell of the 32x8 H100 mesh, on a
# fake process group in a child process on the host
DRY_ARCH, DRY_STEPS, DRY_BAND = "gemma-2b", 5, (0.4, 2.5)
DRY_CELL = ("gemma-2b", "train_4k", "32x8")
# the dry run's serving cells (ROADMAP §3, fault 5), each in a child on the
# host at once: each must run (status ok) with its argument bytes a rank
# under the card's 80 GB
DRY_SERVE_CELLS = (("gemma-2b", "prefill_32k", "32x8"),
                   ("gemma-2b", "decode_32k", "32x8"),
                   ("minicpm3-4b", "decode_32k", "32x8"),
                   ("rwkv6-1.6b", "long_500k", "32x8"))

# the orchestration benchmarks' twins (phase_orch_benches), --smoke, each
# in a child at once, the crawl assets on the card; twin -> (its gate
# benchmarks/check_<gate>_regression.py, its baseline under
# benchmarks/baselines/), or None for the one without a gate
ORCH_BENCHES = {
    "torch_planner_vs_greedy": None,
    "torch_planner_scale": ("planner", "torch_planner_scale"),
    "torch_store_cache": ("store", "torch_store_cache"),
    "torch_recovery_bench": ("recovery", "torch_recovery"),
    "torch_adaptive_drift": ("adaptive", "torch_adaptive_drift"),
}
ORCH_CRAWL = ("torch_store_cache", "torch_recovery_bench",
              "torch_adaptive_drift")

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
    second = {fn: r for fn, r in ptxas.items()
              if ("flash_fwd_wgmma_kernel" in fn and "ELi128EE" in fn)
              or ("wkv_" in fn and "ELi32EE" in fn)}
    log(f"[build] second tiles (128-key flash bodies, 32-step WKV chunks): "
        f"{len(second)} functions, {json.dumps(second)}")
    if not any("flash" in fn for fn in second) or not any(
            "wkv" in fn for fn in second):
        raise AssertionError("[build] no ptxas report of the second tiles")
    phase_fit()
    for fn, rep in second.items():
        if rep.get("spill_stores") and "flash_fwd_wgmma_kernel" in fn:
            _spill_time(fn, rep)
    return ptxas


def _spill_time(fn: str, rep: dict) -> None:
    """A second-tile flash instantiation that spills, run at a prefill of
    its (D, Dv) (B 1, 1000 tokens, 16 heads, causal): held to the plain
    version and timed against its 64-key tile on the same inputs."""
    import re

    from repro_torch.kernels import flash_attention as fa

    D, Dv, bk = map(int, re.search(r"kernelILi(\d+)ELi(\d+)ELi(\d+)E",
                                   fn).groups())
    case = (f"spill_d{D}_dv{Dv}", 1, 1000, 1000, 16, 16, D, Dv, True, 0, 0,
            1.0, False, torch.bfloat16)
    g = torch.Generator(device="cuda").manual_seed(7)
    q, k, v = (torch.randn(s, generator=g, device="cuda").to(torch.bfloat16)
               for s in ((1, 1000, 16, D), (1, 1000, 16, D), (1, 1000, 16, Dv)))
    kw = dict(causal=True, window=0, q_offset=0, out_scale=1.0, residual=None)
    ref = fa.flash_attention_plain(q, k, v, **kw)
    err, rel, _ = _flash_check(case[0], case, fa.flash_attention(
        q, k, v, block_k=bk, **kw), ref, q, k, v, kw, bk)
    times = {b: device_ms(lambda b=b: fa.flash_attention(q, k, v, block_k=b,
                                                          **kw))
             for b in (fa.BLOCK_K, bk)}
    log(f"[build] spill: D {D} Dv {Dv} block_k {bk}: {json.dumps(rep)}; at "
        f"B 1 x 1000, 16 heads, causal: max abs err {err}, relative {rel}; "
        f"device ms by key tile {json.dumps(times)}")


def phase_fit() -> None:
    """The tuner's SM fit model (kernels/autotune.py) against the C
    entries: the bytes of every tile at FIT_SHAPES and FIT_N equal
    ``repro_flash_attention_smem`` / ``repro_linear_scan_smem`` exactly,
    the wgmma body's CTAs an SM its launch bound, the host's body choice
    the C entry's, and a tile a body lacks is refused (-1)."""
    from repro_torch.kernels import autotune as at
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import linear_scan as ls

    rows, bf16 = [], torch.bfloat16
    widths = range(16, fa.MAX_D + 1, 16)
    for D, Dv in itertools.product(widths, widths):  # WGMMA_SHAPES == C's
        body = fa.select_body(bf16, D, Dv, D ** -0.5)
        if body != fa.body_of(bf16, D, Dv):
            raise AssertionError(f"[fit] D {D} Dv {Dv}: the host picks "
                                 f"{fa.body_of(bf16, D, Dv)}, C {body}")
    for D, Dv in FIT_SHAPES:
        body = fa.select_body(bf16, D, Dv, D ** -0.5)
        for bk in (fa.BLOCK_K, SECOND_BLOCK_K):
            c_bytes = fa.smem_bytes(D, Dv, bk)
            built = bk in fa.key_tiles(body, Dv)
            if not built:
                if c_bytes != -1:
                    raise AssertionError(f"[fit] {body} D {D} Dv {Dv}: C sizes"
                                         f" an unbuilt {bk}-key tile")
                continue
            py = at.attention_smem_bytes(fa.BLOCK_Q, bk, D, Dv, bf16)
            ctas = at.attention_ctas(fa.BLOCK_Q, bk, D, Dv, bf16)
            c_ctas = fa.wgmma_ctas(D, Dv, bk) if body == "wgmma" else None
            rows.append((body, D, Dv, bk, c_bytes, py, ctas, c_ctas))
            if c_bytes != py or (c_ctas is not None and c_ctas != ctas):
                raise AssertionError(f"[fit] {body} D {D} Dv {Dv} block_k "
                                     f"{bk}: C {c_bytes} bytes, {c_ctas} "
                                     f"CTAs; the model {py}, {ctas}")
    for N in FIT_N:
        for chunk in ls.KERNEL_CHUNKS:
            c_bytes, py = ls.smem_bytes(N, chunk), at.scan_smem_bytes(chunk, N)
            rows.append(("wkv", N, N, chunk, c_bytes, py,
                         at.scan_ctas(chunk, N), None))
            if c_bytes != py:
                raise AssertionError(f"[fit] wkv N {N} chunk {chunk}: C "
                                     f"{c_bytes} bytes, the model {py}")
    if ls.smem_bytes(64, 16) != -1:
        raise AssertionError("[fit] wkv: C sizes an unbuilt 16-step chunk")
    log(f"[fit] {len(rows)} tiles, C bytes == the tuner's model: "
        f"{json.dumps(rows)}")


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


def _planted_ragged(case, q, k, v, ref, kw, block_k: int = 64) -> float | None:
    """The relative error of a kernel that left a ragged last key tile
    unmasked, TMA zero-filling the keys past Skv: the plain version over K
    and V zero-padded to a whole tile of ``block_k`` keys.  None where no
    tile is ragged or the causal mask hides the pad anyway."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa

    Skv, causal = case[3], case[8]
    pad = -Skv % block_k
    if causal or not pad:
        return None
    kp, vp = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (k, v))
    return _rel_err(fa.flash_attention_plain(q, kp, vp, **kw), ref)


def _flash_check(name, case, out, ref, q, k, v, kw, block_k):
    """(max abs err, relative err, the planted ragged tile's relative err)
    of one flash output against the plain version's; raises past TOL or
    REL_TOL, on a non-finite value, or where REL_TOL would pass an
    unmasked ragged tile of ``block_k`` keys."""
    dt = case[-1]
    diff = (out.float() - ref.float()).abs()
    err, rel = float(diff.max()), _rel_err(out, ref)
    tol, rel_tol = TOL[dt], REL_TOL[dt]
    planted = _planted_ragged(case, q, k, v, ref, kw, block_k)
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
    return err, rel, planted


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
        err, rel, planted = _flash_check(name, case, out, ref, q, k, v, kw,
                                         fa.BLOCK_K)
        tol, rel_tol = TOL[dt], REL_TOL[dt]
        ms = cuda_ms(lambda: fa.flash_attention(q, k, v, **kw))
        dev_kernels = {}
        dev_ms = device_ms(lambda: fa.flash_attention(q, k, v, **kw),
                           by_kernel=dev_kernels)
        scale = D ** -0.5
        body = fa.select_body(dt, D, Dv, scale)
        plan = (fa.split_plan(B, Sq, Skv, Hq, causal, window, q_offset)
                if body == "wgmma" else None)
        if name in SPLIT_CASES and not (plan and plan.merges):
            raise AssertionError(f"[kernels] {name}: no split unit on the "
                                 f"{body} body; the merge goes unchecked")
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
        second = {}
        if SECOND_BLOCK_K in fa.key_tiles(body, Dv):  # same inputs, same run
            kw2 = dict(kw, block_k=SECOND_BLOCK_K)
            out2 = fa.flash_attention(q, k, v, **kw2)
            torch.cuda.synchronize()
            err2, rel2, planted2 = _flash_check(
                f"{name} block_k {SECOND_BLOCK_K}", case, out2, ref, q, k, v,
                kw, SECOND_BLOCK_K)
            plan2 = fa.split_plan(B, Sq, Skv, Hq, causal, window, q_offset,
                                  block_k=SECOND_BLOCK_K)
            second = {"second_tile": dict(
                block_q=fa.BLOCK_Q, block_k=SECOND_BLOCK_K, max_abs_err=err2,
                rel_err=rel2, planted_ragged_rel_err=planted2,
                splits=len(plan2.merges), items=len(plan2.items),
                ms=cuda_ms(lambda: fa.flash_attention(q, k, v, **kw2)),
                device_ms=device_ms(lambda: fa.flash_attention(q, k, v, **kw2)),
                bound_ms=bound_ms, bound_by=bound_by)}
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
                   bound_ms=bound_ms, bound_by=bound_by, block_q=fa.BLOCK_Q,
                   block_k=fa.BLOCK_K, **prev, **second)
        log(f"[kernels] {json.dumps(row)}")
        results.append(row)
    return results


def _trace_sums(rows: list[dict], launches: dict[str, int]) -> dict:
    """Each TRACE_ROWS model's flash device time over one serving trace:
    layers x the row's time at each prompt length, for the wgmma body, the
    mma.sync body timed beside it and the bound; fails unless the rows
    cover the dense engine's launches of that model."""
    by_name = {r["case"]: r for r in rows}
    sums = {}
    for arch, (layers, names) in TRACE_ROWS.items():
        if launches.get(f"{arch} dense") != layers * len(names):
            raise AssertionError(f"[kernels] {arch}: {layers} x {len(names)}"
                                 f" rows, {launches.get(f'{arch} dense')} "
                                 f"dense launches")
        got = [by_name[n] for n in names]
        wg = layers * sum(r["device_ms"] for r in got)
        bound = layers * sum(r["bound_ms"] for r in got)
        prev = [r.get("prev_body_device_ms") for r in got]
        sums[arch] = dict(
            launches=layers * len(names), device_ms=wg, bound_ms=bound,
            minus_bound_ms=wg - bound,
            prev_body_device_ms=(layers * sum(prev) if None not in prev
                                 else None))
    log(f"[kernels] one serving trace's dense flash launches, layers x each "
        f"prompt length's row: {json.dumps(sums)}")
    return sums


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


def _paged_inputs(case, seed: int):
    """A pool as the paged engine leaves it (PAGED_CASES): each slot's
    reserved pages drawn from a shuffled pool, positions -1 past the
    query's own, the rest of the row unallocated, the trash page NaN."""
    name, B, Hkv, G, D, P, ps, dt, (plo, phi), (nlo, nhi) = case
    rng = np.random.RandomState(seed)
    prompt = np.exp(rng.uniform(np.log(plo), np.log(phi), B)).astype(int)
    new = rng.randint(nlo, nhi + 1, B)
    pos_q = np.minimum(prompt + rng.randint(0, new), P * ps - 1)
    n_pages = B * P
    g = torch.Generator(device="cuda").manual_seed(seed)
    kp = torch.randn((n_pages + 1, ps, Hkv, D), generator=g, device="cuda")
    vp = torch.randn((n_pages + 1, ps, Hkv, D), generator=g, device="cuda")
    kp[n_pages], vp[n_pages] = math.nan, math.nan
    posp = torch.full((n_pages + 1, ps), -1, dtype=torch.int32)
    table = torch.full((B, P), n_pages, dtype=torch.int32)
    free = rng.permutation(n_pages).tolist()
    for b in range(B):
        for lp in range(min(P, -(-(prompt[b] + new[b] + 1) // ps))):
            page = free.pop()
            table[b, lp] = page
            t = lp * ps + torch.arange(ps)
            posp[page] = torch.where(t <= int(pos_q[b]), t, -1).int()
    q = torch.randn((B, 1, Hkv * G, D), generator=g, device="cuda")
    return (q.to(dt), kp.to(dt), vp.to(dt), posp.cuda(), table.cuda(),
            torch.tensor(pos_q, dtype=torch.int32, device="cuda")[:, None])


def _paged_bound(args) -> float:
    """The least time of one call, ms: the live keys' K, V and positions,
    the table entries of their pages, q and out, each moved once, over
    PEAK_BYTES (about one FLOP a byte: bytes bound it)."""
    q, kp, _, _, table, pos_q = args
    live = (pos_q[:, 0].long() + 1).clamp(min=0)
    ps, Hkv, D = kp.shape[1:]
    keys = int(live.sum())
    pages = int((-(-live // ps)).sum())
    nbytes = (keys * (2 * Hkv * D * kp.element_size() + 4) + pages * 4
              + 2 * q.numel() * q.element_size())
    return nbytes / PEAK_BYTES * 1e3


def _paged_controls(args, ref32, active) -> dict[str, float]:
    """Relative errors against ``ref32`` (the f32 gather path) of two faulty
    computations: ``own_key_dropped``, the f32 gather path with each
    query's own key masked out; ``bf16_pv``, the f32 softmax with P V
    summed key by key, in position order, into a bf16 accumulator."""
    from repro_torch.kernels import ops
    from repro_torch.models.attention import _mask
    from repro_torch.utils import take_fill

    q, kp, vp, posp, table, pos_q = args
    B, P = table.shape
    n_pages, ps = posp.shape[0] - 1, posp.shape[1]
    Hkv, D = kp.shape[2:]
    G = q.shape[2] // Hkv
    qf, kf, vf = q.float(), kp.float(), vp.float()
    own = posp.clone()
    pq = pos_q[:, 0].long()
    b = torch.nonzero(pq >= 0)[:, 0]
    own[table[b, pq[b] // ps].long(), pq[b] % ps] = -1
    dropped = ops.paged_attention_gather(qf, kf, vf, own, table, pos_q)
    flat = table.reshape(-1)
    n = int(pq.max()) + 1  # keys past every query's position weigh 0
    k, v = (take_fill(t, flat, 0, 0, bound=n_pages)
            .reshape(B, P * ps, Hkv, D)[:, :n].repeat_interleave(G, 2)
            for t in (kf, vf))
    pos_k = take_fill(posp, flat, 0, -1, bound=n_pages).reshape(B, P * ps)
    s = torch.einsum("bhd,bkhd->bhk", qf[:, 0], k) * D ** -0.5
    mask = _mask(pq[:, None, None], pos_k[:, None, :n], True, 0)
    p = torch.softmax(torch.where(mask, s, -math.inf), -1).nan_to_num(0.0)
    acc = torch.zeros((B, q.shape[2], D), dtype=torch.bfloat16,
                      device=q.device)
    for j in range(n):
        acc = (acc.float() + p[:, :, j, None] * v[:, j]).to(torch.bfloat16)
    return {"own_key_dropped": _rel_err(dropped[active], ref32[active]),
            "bf16_pv": _rel_err(acc[:, None][active], ref32[active])}


def phase_paged_kernel() -> list[dict]:
    """The paged decode-attention kernel's cases (PAGED_CASES) against the
    gather path (``ops.paged_attention_gather``, the port's path before the
    kernel), on the active rows to PAGED_TOL, and to PAGED_REL_TOL against
    the gather path in f32, a limit the controls (``_paged_controls``)
    must exceed in PAGED_CONTROL_CASES; with its time beside the
    gather path's, SDPA's over the view the gather path builds (gathered
    and expanded to the query heads beforehand: a yardstick the port never
    calls) and the live pages' byte bound."""
    import torch.nn.functional as F

    from repro_torch.kernels import ops
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.models.attention import _mask
    from repro_torch.utils import take_fill

    results = []
    for case in PAGED_CASES:
        name, B, Hkv, G, D, P, ps, dt = case[:8]
        args = _paged_inputs(case, seed=len(results))
        out = ops.paged_attention(*args)
        torch.cuda.synchronize()
        ref = ops.paged_attention_gather(*args)
        q, kp, vp, posp, table, pos_q = args
        ref32 = ops.paged_attention_gather(q.float(), kp.float(), vp.float(),
                                           posp, table, pos_q)
        active = pos_q[:, 0] >= 0
        diff = (out[active].float() - ref[active].float()).abs()
        err, rel = float(diff.max()), _rel_err(out[active], ref32[active])
        tol, rel_tol = PAGED_TOL[dt], PAGED_REL_TOL[dt]
        controls = _paged_controls(args, ref32, active)
        if not bool(torch.isfinite(out).all()) or bool(
                (diff > tol + tol * ref[active].float().abs()).any()) \
                or rel > rel_tol:
            raise AssertionError(f"[paged] {name}: kernel disagrees with the "
                                 f"gather path, max abs err {err}, relative "
                                 f"{rel} (limit {rel_tol}; controls "
                                 f"{controls})")
        if name in PAGED_CONTROL_CASES and min(controls.values()) <= rel_tol:
            raise AssertionError(f"[paged] {name}: the relative limit "
                                 f"{rel_tol} passes a control {controls}")
        ms = cuda_ms(lambda: ops.paged_attention(*args))
        dev_kernels = {}
        dev_ms = device_ms(lambda: ops.paged_attention(*args),
                           by_kernel=dev_kernels)
        plain_ms = cuda_ms(lambda: ops.paged_attention_gather(*args), reps=5)
        plain_device_ms = device_ms(lambda: ops.paged_attention_gather(*args))
        flat = table.reshape(-1)
        n_pages = posp.shape[0] - 1
        kv = [take_fill(t, flat, 0, 0, bound=n_pages).to(dt)
              .reshape(B, P * ps, Hkv, D).repeat_interleave(G, 2)
              .transpose(1, 2) for t in (kp, vp)]
        pos_k = take_fill(posp, flat, 0, -1, bound=n_pages).reshape(B, P * ps)
        mask = _mask(pos_q[:, None, :, None], pos_k[:, None, None, :], True, 0)
        qt = q.transpose(1, 2)

        def lib():
            return F.scaled_dot_product_attention(qt, kv[0], kv[1],
                                                  attn_mask=mask)

        lib_kernels = {}
        library_device_ms = device_ms(lib, by_kernel=lib_kernels)
        row = dict(case=name, shape=[B, Hkv * G, Hkv, D, P, ps],
                   dtype=str(dt).replace("torch.", ""), max_abs_err=err,
                   tol=tol, rel_err=rel, rel_tol=rel_tol,
                   controls_rel_err=controls, live_keys=int((pos_q[:, 0] + 1).clamp(min=0)
                                          .sum()),
                   view_keys=B * P * ps, body="fma",
                   splits=pa.page_split(B, Hkv, G, P, ps)[1], ms=ms,
                   device_ms=dev_ms, device_ms_by_kernel=dev_kernels,
                   plain_ms=plain_ms, plain_device_ms=plain_device_ms,
                   library_ms=cuda_ms(lib), library_device_ms=library_device_ms,
                   library_backend=_sdpa_backend(lib_kernels),
                   bound_ms=_paged_bound(args), bound_by="bytes")
        log(f"[paged] {json.dumps(row)}")
        del args, kv, out, ref, ref32
        torch.cuda.empty_cache()
        results.append(row)
    return results


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
        c2 = SECOND_CHUNK  # the second chunk, same inputs, same run
        second = {"second_tile": dict(
            chunk=c2, max_abs_err=_wkv_check(
                name, f"chunked/{c2}", ls.linear_scan(*args, chunk=c2), refs),
            ms=cuda_ms(lambda: ls.linear_scan(*args, chunk=c2)),
            device_ms=device_ms(lambda: ls.linear_scan(*args, chunk=c2)),
            bound_ms=bound_ms, bound_by=bound_by)}
        row = dict(case=name, shape=[B, S, H, N], dtype="float32",
                   w_raw_max=w_hi, max_abs_err=err, step_max_abs_err=step_err,
                   max_abs_plain=float(refs[0].abs().max()),
                   tol=f"{WKV_TOL} x max(1, max |plain|)",
                   body="chunked", splits=0, ms=ms,
                   device_ms=dev_ms, device_ms_by_kernel=dev_kernels,
                   plain_ms=plain_ms, library_ms=None,
                   library_device_ms=None, bound_ms=bound_ms,
                   bound_by=bound_by, chunk=ls.KERNEL_CHUNK, **prev, **second)
        log(f"[kernels] wkv {json.dumps(row)}")
        results.append(row)
    return results


def phase_tuner() -> dict[str, int]:
    """kernels/ops.py's tuned dispatch on the card, through a fresh cache
    file under build/ (no baseline): a miss times each candidate once
    (``timing_calls``) and persists the winner, the next call does no
    timing and launches the winner, an explicit tile never reaches the
    tuner, and a new tuner reads the winner back from the file with no
    timing.  Flash at the zoo's deepseek-7b-mha shape (two candidates), the
    WKV scan at its rwkv6 shape (two).  Returns the launches of the phase
    (the timing runs' among them)."""
    from repro_torch.kernels import autotune as at
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import linear_scan as ls
    from repro_torch.kernels import ops

    path = ROOT / "build" / "tuner_phase" / "cache.json"
    path.unlink(missing_ok=True)
    at.reset_tuner()
    tuner = at._TUNER = at.Autotuner(cache_path=str(path), baseline_path="")
    fa.launches = ls.launches = 0
    bf16 = torch.bfloat16
    g = torch.Generator(device="cuda").manual_seed(23)
    q, k, v = (torch.randn((1, 512, 2, 128), generator=g, device="cuda").to(bf16)
               for _ in range(3))
    scan = _wkv_inputs(1, 512, 2, 64, seed=23)
    calls = {
        "flash": (lambda **kw: ops.flash_attention(q, k, v, causal=True, **kw),
                  at.attention_key(q.shape, k.shape, v.shape, bf16,
                                   causal=True, window=0, backend="cuda"),
                  at.attention_candidates(512, 512, 128, 128, bf16)),
        "wkv": (lambda **kw: ops.linear_scan(*scan, **kw)[0],
                at.scan_key(scan[0].shape, torch.float32, backend="cuda"),
                at.scan_candidates(512, 64)),
    }
    refs = {"flash": fa.flash_attention_plain(q, k, v, causal=True),
            "wkv": ls.linear_scan_plain(*scan)[0]}
    rows = {}
    for name, (call, key, cands) in calls.items():
        before = tuner.timing_calls
        out = call(tuned=True)
        timed = tuner.timing_calls - before
        stored = json.loads(path.read_text())["entries"][key]
        hit_launches = fa.launches + ls.launches
        again = call(tuned=True)
        torch.cuda.synchronize()
        if timed != len(cands) or tuner.timing_calls - before != timed:
            raise AssertionError(f"[tuner] {name}: {timed} timings on the miss "
                                 f"for {len(cands)} candidates, "
                                 f"{tuner.timing_calls - before - timed} on the hit")
        if fa.launches + ls.launches != hit_launches + 1:
            raise AssertionError(f"[tuner] {name}: the hit launched "
                                 f"{fa.launches + ls.launches - hit_launches}")
        for o in (out, again):
            err = float((o.float() - refs[name].float()).abs().max())
            scale = 1.0 if name == "flash" else max(1.0, float(refs[name].abs().max()))
            lim = TOL[bf16] * 2 if name == "flash" else WKV_TOL
            if err > lim * scale:
                raise AssertionError(f"[tuner] {name}: tuned output off its "
                                     f"plain version by {err}")
        rows[name] = dict(key=key, candidates=stored["candidates"],
                          winner=stored["config"], us=stored["us"],
                          timing_calls=timed)
    real = at.get_tuner

    def consulted():
        raise AssertionError("[tuner] an explicit tile consulted the tuner")

    at.get_tuner = consulted
    try:
        calls["flash"][0](tuned=True, block_q=64, block_k=SECOND_BLOCK_K)
        calls["wkv"][0](tuned=True, chunk=SECOND_CHUNK)
    finally:
        at.get_tuner = real
    fresh = at.Autotuner(cache_path=str(path), baseline_path="")
    for name, row in rows.items():
        if fresh.lookup(row["key"])["config"] != row["winner"]:
            raise AssertionError(f"[tuner] {name}: the file holds another tile")
    if fresh.timing_calls:
        raise AssertionError("[tuner] a reload timed something")
    torch.cuda.synchronize()
    launches = {"flash": fa.launches, "wkv": ls.launches}
    log(f"[tuner] {json.dumps(rows)}; explicit tiles bypassed the tuner; "
        f"reloaded with 0 timings; launches {json.dumps(launches)}")
    at.reset_tuner()
    return launches


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
    launches each, and every bf16 flash launch there runs the wgmma body
    (the bodies the wrapper selected are tallied around the engine);
    ``paged_launches(stats)`` is the paged engine's expected count."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import linear_scan as ls
    from repro_torch.launch.serve import (ContinuousBatcher,
                                          PagedServingEngine, Request)

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
    bodies, select = {}, fa.select_body

    def tally(*args):  # the flash wrapper asks once per launch
        body = select(*args)
        bodies[body] = bodies.get(body, 0) + 1
        return body

    reset()
    fa.select_body = tally
    try:
        stats = batcher.run(dense_reqs)
    finally:
        fa.select_body = select
    torch.cuda.synchronize()
    launches = {"dense": kernel.launches}
    others = fa.launches + ls.launches - kernel.launches
    log(f"[serve] {cfg.name} dense: wall_s {stats['wall_s']:.3f} tok/s "
        f"{stats['tok_per_s']:.2f} host_syncs {stats['host_syncs']} "
        f"{name} launches {launches['dense']}, flash bodies of the prefills "
        f"{json.dumps(bodies)}")
    if sum(bodies.values()) != fa.launches or (
            cfg.compute_dtype == "bfloat16" and set(bodies) - {"wgmma"}):
        raise AssertionError(f"[serve] dense: flash bodies {bodies} for "
                             f"{fa.launches} launches (bf16: wgmma only)")
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
    view = eng.kv.view_bytes(eng.prefill_group)
    log(f"[serve] {cfg.name} paged: each prefill round gathers and scatters "
        f"a {eng.prefill_group}-slot view, {2 * view / 1e6:.1f} MB (from the "
        f"cache specs)")
    if launches["paged"] != paged_launches(pstats) or others:
        raise AssertionError(f"[serve] paged {name} launches "
                             f"{launches['paged']} != {paged_launches(pstats)} "
                             f"(others {others})")
    # the decode block's paged-attention kernel: once a full-attention
    # layer a tick, eager, captured or replayed (the engine's count, which
    # adds the launches its captured block holds at every replay); then the
    # captured block replayed under torch.profiler, whose trace must hold
    # paged_attn_kernel once a layer a tick of the block
    paged = pstats["paged_attention_launches"]
    layers = 0 if cfg.use_mla else sum(t == "attn" for t in cfg.layer_types())
    traced = _paged_replays_traced(eng)
    log(f"[serve] {cfg.name} paged: paged_attention launches {paged} "
        f"({layers} layers x {pstats['decode_ticks']} decode ticks); the "
        f"captured block replayed under torch.profiler: {traced}")
    if paged != layers * pstats["decode_ticks"] or not (
            traced["kernels"] == traced["engine_adds"]
            == traced["replays"] * layers * eng.drain_every):
        raise AssertionError(f"[serve] paged {cfg.name}: {paged} "
                             f"paged_attention launches, not {layers} x "
                             f"{pstats['decode_ticks']}, or the trace's "
                             f"{traced}")
    PAGED_LAUNCHES[f"{cfg.name} paged"] = paged
    for r in dense_reqs + paged_reqs:
        if not all(0 <= t < cfg.vocab_size for t in r.out):
            raise AssertionError(f"[serve] token out of vocab in {r.rid}")
    agree = sum(a == b for d, p in zip(dense_reqs, paged_reqs)
                for a, b in zip(d.out, p.out))
    log(f"[serve] {cfg.name} bf16 greedy tokens equal across engines: "
        f"{agree}/{len(prompts) * MAX_NEW} (the two engines round in bf16 at "
        f"other places, so bf16 streams may part)")
    _graph_matches_eager(model, params)
    return launches


def _paged_replays_traced(eng, replays: int = 2,
                          tries: int = 3) -> dict[str, int]:
    """The engine's captured decode block, after its run, replayed
    ``replays`` times under ``torch.profiler`` (every slot inactive now, as
    between waves: each tick appends to the trash page and attends over
    nothing): the trace's ``paged_attn_kernel`` launches (the merge kernel
    not counted) and what the engine's count adds for as many replays.  A
    trace without device events is taken again; after ``tries`` the run
    fails."""
    def replay():
        for _ in range(replays):
            eng._graph.replay()

    torch.cuda.synchronize()
    for _ in range(tries):
        _, _, events, _ = _profiled(replay)
        if events:
            return {"replays": replays,
                    "kernels": sum("paged_attn_kernel" in e.name
                                   for e in events),
                    "engine_adds": replays * eng._graph_launches}
    raise AssertionError(f"[serve] {tries} profiler traces of the paged "
                         f"engine's block held no device events")


def _graph_matches_eager(model, params) -> None:
    """The paged engine's decode block replayed as a CUDA graph against the
    same block run eagerly: one trace (GRAPH_TRACE, more requests than
    slots, so slots and pages are freed and admitted again after the
    capture) through two engines at the serving grid's parameters, one of
    whose ``_tick_block`` runs ``_decode_ticks``.
    At every drain the slot state, the block table and every cache leaf
    must be equal bit for bit, and so must every request's tokens.  A
    pool's last page is left out: it is the write-only trash page, which
    padded prefill rows and inactive decode rows write in no fixed order
    (two eager runs part there too) and no read reaches."""
    from repro_torch.launch.paged_kv import _pages_dim
    from repro_torch.launch.serve import PagedServingEngine, Request
    from repro_torch.utils import tree_leaves, tree_map

    rng = np.random.RandomState(1)
    prompts = [rng.randint(0, model.cfg.vocab_size, n).tolist()
               for n, _ in GRAPH_TRACE]

    class Engine(PagedServingEngine):
        eager = False

        def _tick_block(self):
            if self.eager:
                self._decode_ticks()
            else:
                super()._tick_block()

        def _drain(self, now):
            kv = self.kv
            pages = tree_map(lambda leaf, spec: leaf if _pages_dim(spec) is None
                             else leaf.narrow(_pages_dim(spec), 0, kv.n_pages),
                             kv.cache, kv.specs)
            self.snaps.append([t.clone() for t in (
                self.out_buf, self.out_cnt, self.pos, self.last_token,
                self.remaining, kv.table, *tree_leaves(pages))])
            super()._drain(now)

    runs = {}
    for eager in (False, True):
        reqs = [Request(rid=i, prompt=p, max_new=n)
                for i, (p, (_, n)) in enumerate(zip(prompts, GRAPH_TRACE))]
        eng = Engine(model, params, n_slots=GRAPH_TRACE_SLOTS, max_len=128,
                     page_size=16, chunk_max=32, drain_every=8,
                     prefill_chunks_per_tick=4)
        eng.eager, eng.snaps = eager, []
        eng.run(reqs)
        torch.cuda.synchronize()
        if not eager and eng._graph is None:
            raise AssertionError("[serve] the paged engine captured no graph")
        runs[eager] = (eng.snaps, reqs, eng.drain_every)
    (g_snaps, g_reqs, K), (e_snaps, e_reqs, _) = runs[False], runs[True]
    late = sum(r.admit_tick >= 2 * K for r in g_reqs)
    if len(g_snaps) != len(e_snaps) or len(g_snaps) < 4 or late == 0:
        raise AssertionError(f"[serve] graph run drained {len(g_snaps)} "
                             f"times, eager {len(e_snaps)}; {late} "
                             f"admissions after the capture")
    for i, (a, b) in enumerate(zip(g_snaps, e_snaps)):
        bad = [j for j, (x, y) in enumerate(zip(a, b)) if not torch.equal(x, y)]
        if bad:
            raise AssertionError(f"[serve] {model.cfg.name} drain {i}: the "
                                 f"graph's state parts from eager's at "
                                 f"tensors {bad[:8]}")
    if [r.out for r in g_reqs] != [r.out for r in e_reqs]:
        raise AssertionError(f"[serve] {model.cfg.name}: graph tokens part "
                             f"from eager tokens")
    log(f"[serve] {model.cfg.name} paged decode block, CUDA graph against "
        f"eager: {len(g_snaps)} drains bit-equal ({len(g_snaps[0])} tensors "
        f"each: slot state, block table, cache leaves but the trash page), "
        f"{sum(len(r.out) for r in g_reqs)} tokens equal, {late} of "
        f"{len(g_reqs)} requests admitted after the capture")


def _engines_agree(model32, params, prompts) -> None:
    from repro_torch.launch.serve import (ContinuousBatcher,
                                          PagedServingEngine, Request)

    d = [Request(rid=i, prompt=list(p), max_new=8) for i, p in enumerate(prompts)]
    q = [Request(rid=i, prompt=list(p), max_new=8) for i, p in enumerate(prompts)]
    ContinuousBatcher(model32, params, n_slots=2, max_len=1024).run(d)
    PagedServingEngine(model32, params, n_slots=2, max_len=1024, page_size=16,
                       chunk_max=64, drain_every=8, dtype=torch.float32).run(q)
    agree = sum(a == b for x, y in zip(d, q) for a, b in zip(x.out, y.out))
    total = sum(len(x.out) for x in d)
    log(f"[parity] {model32.cfg.name} f32 greedy tokens equal across engines: "
        f"{agree}/{total}")
    if agree != total or total != len(prompts) * 8:
        raise AssertionError(f"[parity] {model32.cfg.name}: f32 greedy "
                             f"tokens of the paged engine part from the "
                             f"dense engine's ({agree}/{total})")


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
    """``arch`` at full width, TRAIN_STEPS steps of ``train`` (bf16, remat
    full, B x S = TRAIN_BATCH x TRAIN_SEQ, seed 0, no checkpoint: gemma-2b's
    f32 masters plus m and v would write 30 GB a save), then one more step
    under ``torch.profiler``.  Returns the kernels' launches across the
    TRAIN_STEPS steps."""
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


def _dist_rwkv(card: str, info) -> None:
    """rwkv6-1.6b at full width: DIST_RWKV_STEPS steps of ``train`` on the
    mesh and as many without one (the same seed-0 weights and batches),
    then one more step of each under ``torch.profiler``.  The first step's
    loss on the mesh must be within DIST_RWKV_RTOL of the one without.
    Later steps are reported, not gated: at this width and lr the chunked
    WKV form's gradient turns NaN by step 3 with or without the mesh (its
    masked ``exp`` gives 0 x inf in the backward, as JAX's form would)."""
    from repro_torch.configs import get_config
    from repro_torch.data import TokenDataset
    from repro_torch.distributed.sharding import use_mesh_info
    from repro_torch.launch.train import make_train_step, train
    from repro_torch.models import LanguageModel
    from repro_torch.optim import AdamW, OptConfig

    cfg = get_config(DIST_RWKV)
    runs = {}
    for tag, mesh in (("mesh (1, 1)", info), ("no mesh", None)):
        torch.cuda.reset_peak_memory_stats()
        out = train(arch=DIST_RWKV, smoke=False, steps=DIST_RWKV_STEPS,
                    global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ,
                    peak_lr=TRAIN_LR, ckpt_dir=None, log_every=1,
                    mesh_info=mesh, device="cuda")
        torch.cuda.synchronize()
        hist = out["history"]
        losses = [h["loss"] for h in hist]
        wall = float(np.median([b["wall_s"] - a["wall_s"]
                                for a, b in zip(hist, hist[1:])]))
        peak = torch.cuda.max_memory_allocated()
        model = LanguageModel(cfg, device="cuda")
        params = out.pop("params")
        del out
        opt = AdamW(OptConfig(peak_lr=TRAIN_LR))
        with use_mesh_info(mesh):
            state, step = opt.init(params), make_train_step(model, opt)
            batch = {k: torch.from_numpy(v).cuda() for k, v in TokenDataset(
                cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH).batch(
                    DIST_RWKV_STEPS).items()}
            if mesh:
                batch = {k: mesh.distribute(v, ("batch", "seq_act"))
                         for k, v in batch.items()}
            torch.cuda.synchronize()
            (params, state, _), prof_wall, events, by_name = _profiled(
                lambda: step(params, state, batch))
        busy = sum(by_name.values()) / 1e3 / prof_wall if events else None
        runs[tag] = losses
        log(f"[dist-rwkv] {cfg.name} full width, {tag}, bf16, remat "
            f"{cfg.remat}, B {TRAIN_BATCH} x S {TRAIN_SEQ}: losses {losses}; "
            f"step wall (median of steps 2-{DIST_RWKV_STEPS}) "
            f"{wall * 1e3:.2f} ms; tokens/s "
            f"{TRAIN_BATCH * TRAIN_SEQ / wall:.1f}; peak allocated "
            f"{peak / 2**30:.2f} GiB; one profiled step {prof_wall * 1e3:.2f}"
            f" ms, {len(events)} device events, busy "
            f"{'not measured' if busy is None else f'{busy:.4f}'} ({card})")
        for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:3]:
            log(f"[dist-rwkv] {ms:.3f} ms {name[:110]}")
        del params, state, batch, model
        torch.cuda.empty_cache()
    on, off = runs["mesh (1, 1)"], runs["no mesh"]
    rel = abs(on[0] - off[0]) / abs(off[0])
    log(f"[dist-rwkv] first step's loss on the mesh {on[0]!r} against "
        f"{off[0]!r} without: rel {rel:.3e} (rtol {DIST_RWKV_RTOL}); later "
        f"losses finite on the mesh / without: {bool(np.isfinite(on).all())}"
        f" / {bool(np.isfinite(off).all())}")
    if not (np.isfinite(on[0]) and np.isfinite(off[0])
            and rel <= DIST_RWKV_RTOL):
        raise AssertionError("[dist-rwkv] the mesh step parts from the "
                             "no-mesh step")


def _serve_run(model, params, prompts, info, steps: int,
               follow: list | None = None) -> list[tuple]:
    """Each prompt (B 1) through ``prefill`` and then ``steps`` greedy
    ``decode_step``s, on ``info``'s mesh (``params`` laid out already; the
    cache, tokens and positions laid out here as ``launch/specs.py`` lays
    them) or without one (None).  ``follow`` (a token list a prompt) feeds
    those tokens in place of the run's own argmax.  A prompt's result:
    (its logits, (1 + steps, vocab) f32 on the host; its argmax tokens; the
    time to the first token, s; each decode step's wall, s), each wall up
    to the argmax read on the host."""
    from repro_torch.distributed.sharding import full_value, use_mesh_info
    from repro_torch.utils import tree_map

    def lay(t, axes):
        return t if info is None else info.distribute(t, axes)

    dtype = torch.float32 if model.cfg.compute_dtype == "float32" \
        else torch.bfloat16
    out = []
    with use_mesh_info(info), torch.no_grad():
        for i, p in enumerate(prompts):
            S = len(p)
            cache = model.init_cache(1, S + steps, dtype=dtype)
            if info is not None:
                cache = tree_map(lambda sp, t: info.distribute(t, sp.axes),
                                 model.cache_specs(1, S + steps, dtype=dtype),
                                 cache)
            tokens = lay(torch.tensor([p], dtype=torch.int32, device="cuda"),
                         ("batch", "seq_act"))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, cache = model.prefill(params, {"tokens": tokens}, cache)
            rows = [full_value(logits).float()]
            picked = [int(rows[-1][0].argmax())]
            ttft = time.perf_counter() - t0
            walls = []
            for t in range(steps):
                tok = follow[i][t] if follow else picked[-1]
                t0 = time.perf_counter()
                logits, cache = model.decode_step(
                    params, lay(torch.tensor([[tok]], dtype=torch.int32,
                                             device="cuda"), ("batch", None)),
                    cache, lay(torch.tensor([S + t], dtype=torch.int32,
                                            device="cuda"), ("batch",)))
                rows.append(full_value(logits).float())
                picked.append(int(rows[-1][0].argmax()))
                walls.append(time.perf_counter() - t0)
            out.append((torch.cat(rows).cpu(), picked, ttft, walls))
            del cache
    return out


def _dist_serve(card: str, info) -> dict[str, dict[str, int]]:
    """Serving on the (1, 1) mesh (ROADMAP §3, fault 5): DIST_SERVE at full
    width, the trace's prompts one prefill each then MAX_NEW greedy decode
    steps in bf16, on the mesh and without one: time to first token, ms a
    decode step, the busy share of one profiled prompt, the peak; the
    greedy tokens equal; the kernel -- flash (gemma-2b) or WKV (rwkv6) --
    launched once a prefill per layer that attends or scans, on the mesh
    inside ``shard_map`` on the local shards.  Then DIST_SERVE_F32 prompts
    with f32 compute, every logit on the mesh within PARITY_TOL of the
    no-mesh run's.  Returns the mesh run's launches, by kernel."""
    from repro_torch.distributed.sharding import distribute_tree
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import linear_scan as ls
    from repro_torch.models import LanguageModel

    launches: dict[str, dict[str, int]] = {"flash": {}, "wkv": {}}
    for arch in DIST_SERVE:
        cfg = _config(arch)
        if "rwkv6" in cfg.layer_types():
            kernel, key, per_prefill = ls, "wkv", cfg.n_layers
        else:
            kernel, key, per_prefill = fa, "flash", _attn_layers(cfg)
        model = LanguageModel(cfg, device="cuda")
        params = model.init(0)
        prompts = _prompts(cfg.vocab_size)
        cast = model.cast_for_compute(params)
        picked = {}
        for tag, mesh in (("no mesh", None), ("mesh (1, 1)", info)):
            p = cast if mesh is None else distribute_tree(
                cast, model.param_axes, info)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            kernel.launches = 0
            runs = _serve_run(model, p, prompts, mesh, MAX_NEW)
            n = kernel.launches
            peak = torch.cuda.max_memory_allocated()
            _, wall, events, by_name = _profiled(
                lambda: _serve_run(model, p, prompts[:1], mesh, 4))
            busy = (f"{sum(by_name.values()) / 1e3 / wall:.4f}" if events
                    else "not measured")
            ttft = [r[2] * 1e3 for r in runs]
            step = [w * 1e3 for r in runs for w in r[3]]
            picked[tag] = [r[1] for r in runs]
            log(f"[dist-serve] {cfg.name} ({_depth(cfg)}), {tag}, bf16, "
                f"prompts {PROMPT_LENS} one prefill each + {MAX_NEW} "
                f"greedy steps: time to first token {ttft} ms (median "
                f"{np.median(ttft):.2f}); a decode step median "
                f"{np.median(step):.2f} ms (min {min(step):.2f}, max "
                f"{max(step):.2f}); busy {busy} (prompt 0, 4 steps, "
                f"{len(events)} device events); peak "
                f"{peak / 2**30:.2f} GiB; {key} launches {n} ({card})")
            if n != per_prefill * len(prompts):
                raise AssertionError(f"[dist-serve] {cfg.name} {tag}: {n} "
                                     f"{key} launches, not {per_prefill} x "
                                     f"{len(prompts)}")
            if mesh is not None:
                launches[key][f"{cfg.name} mesh (1, 1) serve"] = n
            del p, runs
        same = picked["mesh (1, 1)"] == picked["no mesh"]
        log(f"[dist-serve] {cfg.name} greedy tokens on the mesh equal to the "
            f"no-mesh run's: {same}")
        if not same:
            raise AssertionError(f"[dist-serve] {cfg.name}: greedy tokens "
                                 "part on the mesh")
        del cast
        torch.cuda.empty_cache()

        model32 = LanguageModel(cfg.scaled(compute_dtype="float32"),
                                device="cuda")
        few = prompts[:DIST_SERVE_F32]
        kernel.launches = 0
        off = _serve_run(model32, params, few, None, MAX_NEW)
        dp = distribute_tree(params, model.param_axes, info)
        on = _serve_run(model32, dp, few, info, MAX_NEW,
                        follow=[r[1] for r in off])
        if kernel.launches != 2 * per_prefill * len(few):
            raise AssertionError(f"[dist-serve] {cfg.name} f32: "
                                 f"{kernel.launches} {key} launches")
        for i, (a, b) in enumerate(zip(on, off)):
            err = float((a[0] - b[0]).abs().max())
            scale = float(b[0].abs().max())
            log(f"[dist-serve] {cfg.name} f32 prompt {i} (len {len(few[i])}):"
                f" max |mesh - no mesh| logits over the prefill and "
                f"{MAX_NEW} decode steps {err:.3e} (max |logit| "
                f"{scale:.3f}, tol {PARITY_TOL})")
            if not bool(torch.isfinite(a[0]).all()) or err > PARITY_TOL:
                raise AssertionError(f"[dist-serve] {cfg.name} prompt {i}: "
                                     f"{err} > {PARITY_TOL}")
        del model, model32, params, dp, on, off
        torch.cuda.empty_cache()
    return launches


def phase_distributed(card: str) -> dict[str, dict[str, int]]:
    """Training and serving under a mesh: a (data 1, model 1) DeviceMesh
    over an NCCL group of one rank (a FileStore rendezvous in a temporary
    directory; no fallback to gloo or the CPU), then ``_dist_parity``,
    ``_dist_train`` on the mesh and without one, ``_dist_experts``,
    ``_dist_collectives`` and ``_dist_rwkv``: neither kernel runs there,
    the mesh path trains through ``attention_core``.  Then
    ``_dist_serve``, whose launches are counted on their own and
    returned."""
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
            _dist_rwkv(card, info)
            torch.cuda.synchronize()
            launches = {"flash": fa.launches, "wkv": ls.launches}
            log(f"[dist] training phases {time.perf_counter() - t0:.3f} s; "
                f"launches {launches}")
            if launches != {"flash": 0, "wkv": 0}:
                raise AssertionError(f"[dist] the mesh's training launched "
                                     f"{launches}")
            t1 = time.perf_counter()
            serve = _dist_serve(card, info)
        finally:
            dist.destroy_process_group()
    log(f"[dist] serving {time.perf_counter() - t1:.3f} s, launches {serve}; "
        f"phase {time.perf_counter() - t0:.3f} s")
    return serve


def _claims(device: str) -> dict:
    """The paper's numbers from the port's benchmarks, with the crawl
    assets' tensor work on ``device``."""
    from benchmarks import torch_fig3_reliability as fig3
    from benchmarks import torch_fig4_effort as fig4
    from benchmarks import torch_fig6_durations as fig6
    from benchmarks import torch_table1_cost as table1

    return {"claims": table1.headline_claims(n_seeds=CLAIM_SEEDS,
                                             device=device),
            "table": table1.per_cell_table(device=device),
            "fig3": fig3.run(n_seeds=FIG3_SEEDS, device=device),
            "fig4": fig4.run(n_seeds=FIG4_SEEDS, device=device),
            "fig6": fig6.run(n_seeds=FIG6_SEEDS, device=device)}


def phase_paper_claims(card: str) -> None:
    """The source paper's claims on the port (``benchmarks/torch_*``): Table
    1's cells and headline claims and Figs. 3, 4 and 6 with the crawl
    assets on the card, equal to the same calls on the CPU, and within the
    limits of tests/test_paper_claims.py.  Neither kernel launches."""
    from benchmarks.torch_table1_cost import TABLE1
    from repro_torch.data import commoncrawl as cc
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import linear_scan as ls

    fa.launches = ls.launches = 0
    cc.device_calls.clear()
    t0 = time.perf_counter()
    card_out = _claims("cuda")
    t_card = time.perf_counter() - t0
    calls = dict(cc.device_calls)
    cpu_out = _claims("cpu")
    t_all = time.perf_counter() - t0
    claims = card_out["claims"]
    log(f"[claims] headline_claims(n_seeds={CLAIM_SEEDS}) on the card: "
        f"{json.dumps(claims)}")
    log(f"[claims] fig3 {json.dumps(card_out['fig3'])}")
    log(f"[claims] fig4 trial ratio "
        f"{card_out['fig4']['trial_ratio_spot_over_premium']!r}; fig6 edges "
        f"{card_out['fig6']['edges@pod-spot']} spot, "
        f"{card_out['fig6']['edges@pod-premium']} premium")
    log(f"[claims] the crawl assets' tensor calls by device {calls}; the "
        f"card's calls {t_card:.3f} s, the phase {t_all:.3f} s ({card})")
    timed = "makespan_improvement_vs_spot_simulated"
    rel = abs(claims[timed] - cpu_out["claims"][timed]) / \
        abs(cpu_out["claims"][timed])
    same = {k: v for k, v in card_out.items() if k != "claims"} == \
        {k: v for k, v in cpu_out.items() if k != "claims"} and \
        {k: v for k, v in claims.items() if k != timed} == \
        {k: v for k, v in cpu_out["claims"].items() if k != timed}
    log(f"[claims] card equal to CPU: {same}; {timed} rel {rel:.3e} "
        f"(rtol {CLAIMS_MAKESPAN_RTOL})")
    if not same or rel > CLAIMS_MAKESPAN_RTOL:
        raise AssertionError("[claims] the card's numbers part from the CPU's")
    if not any(dev == "cuda" for _, dev in calls) or any(
            dev != "cuda" for _, dev in calls):
        raise AssertionError(f"[claims] crawl tensors on {calls}")
    edges = [(r, ref) for ref in TABLE1 if ref[0] == "edges"
             for r in card_out["table"]
             if (r["asset"], r["platform"]) == ref[:2]]
    fig3, fig4, fig6 = card_out["fig3"], card_out["fig4"], card_out["fig6"]
    limits = {
        "cost cut vs DBR >= 40 % (table basis)":
            claims["cost_reduction_vs_premium_table_basis"] >= 0.40,
        "cost cut >= 32 % (simulated)":
            claims["cost_reduction_vs_premium_simulated"] >= 0.32,
        "savings >= 300 a run": claims["savings_usd_per_run"] >= 300.0,
        "tuning gain 12 % +- 1": abs(
            claims["tuning_improvement_vs_untuned_spot"] - 0.12) < 0.01,
        "Table 1 edges rows within 10 %": len(edges) == 2 and all(
            abs(r["duration_h"] - ref[2]) / ref[2] < 0.10
            and abs(r["total_usd"] - ref[3]) / ref[3] < 0.10
            for r, ref in edges),
        "Fig 3 spot fails more, > 1.08x the trials":
            fig3["failure_rate"]["pod-spot"] > fig3["failure_rate"][
                "pod-premium"] and fig3["trial_ratio_spot_over_premium"] > 1.08,
        "Fig 4 trial ratio in (1.5, 3), changes > 2x":
            1.5 < fig4["trial_ratio_spot_over_premium"] < 3.0
            and fig4["pod-spot"]["mean_changes"]
            > 2.0 * fig4["pod-premium"]["mean_changes"],
        "Fig 6 premium edges > 1.25x faster":
            fig6["edges@pod-spot"]["median_h"]
            > 1.25 * fig6["edges@pod-premium"]["median_h"],
    }
    log(f"[claims] the paper's limits: {limits}")
    if not all(limits.values()):
        raise AssertionError("[claims] a claim misses its limit")
    if (fa.launches, ls.launches) != (0, 0):
        raise AssertionError(f"[claims] launched {fa.launches} flash, "
                             f"{ls.launches} WKV")


def _dry_cell(arch: str, shape_name: str, mesh: str, timeout: float,
              **kw: str) -> dict:
    """``dryrun.run_cell`` in a child process on the host (its fake process
    group is global to a process); ``kw`` are Python sources of
    ``run_cell``'s keyword arguments."""
    extra = "".join(f", {k}={v}" for k, v in kw.items())
    code = ("import json\n"
            "from repro_torch.configs.base import ShapeSpec\n"
            "from repro_torch.launch.dryrun import run_cell\n"
            f"print(json.dumps(run_cell({arch!r}, {shape_name!r}, {mesh!r}"
            f"{extra})))")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "CUDA_VISIBLE_DEVICES": ""}
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=timeout, env=env, cwd=ROOT)
    if r.returncode != 0:
        raise AssertionError(f"[dryrun] run_cell failed: {r.stderr[-2000:]}")
    cell = json.loads(r.stdout.strip().splitlines()[-1])
    if cell["status"] != "ok":
        raise AssertionError(f"[dryrun] {cell.get('traceback', cell)}")
    return cell


def phase_dryrun(card: str) -> None:
    """The dry run's predictions for one card against that card: gemma-2b
    at full width (bf16, remat full, B TRAIN_BATCH x S TRAIN_SEQ, seed 0),
    priced by ``run_cell`` on the ``local`` platform's mesh (1,); (a)
    ``FlopCounterMode`` over one real step against ``flops.step_flops``,
    within DRY_BAND; (b) the predicted argument bytes against the bytes of
    the parameters, AdamW state and batch the card holds, equal; (c) the
    roofline's step time beside the measured step wall (printed).  The
    cells of the H100 meshes, (d) and (e), run in ``phase_host``."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data import TokenDataset
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import linear_scan as ls
    from repro_torch.launch import flops
    from repro_torch.launch.train import make_train_step
    from repro_torch.models import LanguageModel
    from repro_torch.optim import AdamW, OptConfig
    from repro_torch.utils import tree_leaves

    fa.launches = ls.launches = 0
    t0 = time.perf_counter()
    cfg = get_config(DRY_ARCH)
    shape = ShapeSpec("card", "train", TRAIN_SEQ, TRAIN_BATCH)
    local = _dry_cell(DRY_ARCH, "card", "local", 600,
                      shape=f"ShapeSpec('card', 'train', {TRAIN_SEQ}, "
                            f"{TRAIN_BATCH})",
                      layout="((1,), ('data',))")
    predicted = int(local["memory_analysis"]["argument_size_in_bytes"])

    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    model = LanguageModel(cfg, device="cuda")
    params = model.init(0)
    opt = AdamW(OptConfig(peak_lr=TRAIN_LR))
    state = opt.init(params)
    data = TokenDataset(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH)
    batch = {k: torch.from_numpy(v).cuda() for k, v in data.batch(0).items()}
    torch.cuda.synchronize()
    allocated = torch.cuda.memory_allocated() - before
    tensors = tree_leaves(params) + tree_leaves(state) + list(batch.values())
    held = sum(t.untyped_storage().nbytes() for t in tensors)
    log(f"[dryrun] (b) {cfg.name} full width: predicted argument bytes "
        f"{predicted} ({predicted / 1e9:.4f} GB); the card holds {held} in "
        f"{len(tensors)} tensors (allocator: {allocated}, rounded up per "
        f"block)")
    if held != predicted:
        raise AssertionError("[dryrun] predicted argument bytes part from "
                             "the card's")

    step = make_train_step(model, opt)
    with FlopCounterMode(display=False) as counter:
        params, state, _ = step(params, state, batch)
    torch.cuda.synchronize()
    counted = counter.get_total_flops()
    analytic = flops.step_flops(cfg, shape)
    ratio = counted / analytic
    log(f"[dryrun] (a) one step's FLOPs counted by FlopCounterMode "
        f"{counted:.6e} against flops.step_flops {analytic:.6e}: ratio "
        f"{ratio:.4f} (band {DRY_BAND})")
    if not DRY_BAND[0] < ratio < DRY_BAND[1]:
        raise AssertionError("[dryrun] analytic FLOPs outside the band")

    walls = []
    for i in range(1, DRY_STEPS + 1):
        b = {k: torch.from_numpy(v).cuda() for k, v in data.batch(i).items()}
        torch.cuda.synchronize()
        t = time.perf_counter()
        params, state, m = step(params, state, b)
        float(m["loss"])
        walls.append(time.perf_counter() - t)
    wall = float(np.median(walls[1:]))
    roof = local["roofline"]
    log(f"[dryrun] (c) roofline on one card: compute {roof['t_compute_s']:.6f}"
        f" s, memory {roof['t_memory_s']:.6f} s, collective "
        f"{roof['t_collective_s']:.6f} s -> step {roof['step_time_s']:.6f} s "
        f"({roof['bottleneck']}); measured step wall (median of steps 2-"
        f"{DRY_STEPS}) {wall:.6f} s: {wall / roof['step_time_s']:.3f}x the "
        f"roofline ({card})")
    del params, state, batch, b, model, step
    torch.cuda.empty_cache()

    log(f"[dryrun] phase {time.perf_counter() - t0:.3f} s; launches "
        f"{fa.launches} flash, {ls.launches} WKV")
    if (fa.launches, ls.launches) != (0, 0):
        raise AssertionError("[dryrun] the dry-run path launched a kernel")


def _start_orch_benches(out: Path) -> dict:
    """The orchestration benchmarks' twins (``benchmarks/torch_*.py``), each
    ``--smoke`` in a child, the crawl assets' tensor work on the card
    (``--device cuda``), each writing ``out/<twin>.json``."""
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([str(ROOT / "src"),
                                                        str(ROOT)])}
    return {name: subprocess.Popen(
        [sys.executable, str(ROOT / "benchmarks" / f"{name}.py"), "--smoke",
         "--out", str(out / f"{name}.json"),
         *(["--device", "cuda"] if name in ORCH_CRAWL else [])],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env,
        cwd=ROOT) for name in ORCH_BENCHES}


def _dry_cells_check(cells: list[dict]) -> None:
    """(d) the training cell DRY_CELL and (e) the serving cells
    DRY_SERVE_CELLS, each ``ok`` with its argument bytes a rank under the
    card's 80 GB."""
    cell = cells[0]
    log(f"[dryrun] (d) {' x '.join(DRY_CELL)} on a fake group of "
        f"{cell['n_chips']} ranks, torch {torch.__version__}: fake step "
        f"{cell['compile_s']} s; argument bytes a rank "
        f"{cell['memory_analysis']['argument_size_in_bytes']:.0f} (fits 80 "
        f"GB: {cell['fits_hbm']}); roofline {json.dumps(cell['roofline'])}; "
        f"collective bytes a rank {json.dumps(cell['collective_bytes'])}; "
        f"ops {json.dumps(cell['collective_ops'])}")
    for (arch, shape, mesh), cell in zip(DRY_SERVE_CELLS, cells[1:]):
        nbytes = cell["memory_analysis"]["argument_size_in_bytes"]
        log(f"[dryrun] (e) {arch} x {shape} x {mesh} on a fake group of "
            f"{cell['n_chips']} ranks: {cell['status']}, fake step "
            f"{cell['compile_s']} s; argument bytes a rank {nbytes:.0f} "
            f"(fits 80 GB: {cell['fits_hbm']}); roofline "
            f"{json.dumps(cell['roofline'])}; collective bytes a rank "
            f"{json.dumps(cell['collective_bytes'])}")
    for cell in cells:
        if not cell["fits_hbm"]:
            raise AssertionError(
                f"[dryrun] {cell['arch']} x {cell['shape']}: "
                f"{cell['memory_analysis']['argument_size_in_bytes']} "
                "argument bytes a rank")
    log(f"[dryrun] (d), (e) {len(cells)} cells ok")


def _orch_benches_check(procs: dict, out: Path, card: str) -> None:
    """Each twin's run, its numbers, then each unchanged
    ``check_*_regression.py`` gate on its output against
    ``benchmarks/baselines/torch_*_baseline.json``."""
    for name, p in procs.items():
        text, _ = p.communicate(timeout=900)
        if p.returncode != 0:
            raise AssertionError(f"[orch-bench] {name} failed: {text[-2000:]}")
    res = {n: json.loads((out / f"{n}.json").read_text())
           for n in ORCH_BENCHES}
    pvg = res["torch_planner_vs_greedy"]["summary"]
    scale = res["torch_planner_scale"]["shapes"]
    store = res["torch_store_cache"]
    rec = res["torch_recovery_bench"]
    drift = res["torch_adaptive_drift"]["levels"]
    log(f"[orch-bench] planner vs greedy: {json.dumps(pvg)}")
    for shape, cells in scale.items():
        c = cells["1000"]
        log(f"[orch-bench] planner scale {shape} @ 1000 tasks: new "
            f"{c['new']['plan_time_s']} s, legacy "
            f"{c['legacy']['plan_time_s']} s ({c['speedup']}x), cost_ok "
            f"{c['cost_ok']}, makespan_ok {c['makespan_ok']}")
    log(f"[orch-bench] store: cold {store['cold']['wall_s']} s, warm "
        f"{store['warm']['wall_s']} s ({store['warm_speedup']}x), backfill "
        f"{store['backfill']['tasks_executed']} tasks, cutoff "
        f"{store['cutoff']['tasks_executed']}")
    log(f"[orch-bench] recovery: journaling overhead "
        f"{rec['overhead']['overhead_frac']} ({rec['overhead']['plain_s']} /"
        f" {rec['overhead']['journaled_s']} s), rework fractions "
        f"{ {k: v['rework_fraction'] for k, v in rec['kills'].items()} }")
    log(f"[orch-bench] drift: makespan / cost reductions "
        f"{ {k: (v['makespan_reduction'], v['cost_reduction']) for k, v in drift.items()} }")
    for name, gate in ORCH_BENCHES.items():
        if gate is None:
            continue
        checks = res[name].get("checks", {})
        r = subprocess.run(
            [sys.executable,
             str(ROOT / "benchmarks" / f"check_{gate[0]}_regression.py"),
             "--current", str(out / f"{name}.json"), "--baseline",
             str(ROOT / "benchmarks" / "baselines"
                 / f"{gate[1]}_baseline.json")],
            capture_output=True, text=True, timeout=120, cwd=ROOT)
        log(f"[orch-bench] {name}: {sum(checks.values())} of {len(checks)} "
            f"checks; check_{gate[0]}_regression.py rc {r.returncode}: "
            f"{(r.stdout + r.stderr).strip().splitlines()[-1]}")
        if r.returncode != 0:
            raise AssertionError(f"[orch-bench] {name} fails its gate: "
                                 f"{r.stdout}{r.stderr}")
    log(f"[orch-bench] the twins' gates passed ({card})")


def _since_start() -> float:
    """Seconds since ``main`` started, the clock of the ``[time]`` stamps."""
    return time.perf_counter() - _RUN_START


def start_dry_cells() -> tuple[ThreadPoolExecutor, list, float]:
    """The dry run's cells of the 32x8 H100 mesh, all at once, each in a
    child on a fake process group on the host's CPU: (d) DRY_CELL, the whole
    sharded train path at full width, and (e) the serving cells
    DRY_SERVE_CELLS.  They start with the run and take five of the host's
    cores until they end, beside the build, the kernel phases (whose ``ms``
    and ``plain_ms`` include the host's launch work) and whatever phases
    follow until then; ``phase_host`` takes their results and logs when
    the last one ended, on the ``[time]`` stamps' clock."""
    every = (DRY_CELL,) + DRY_SERVE_CELLS
    ex = ThreadPoolExecutor(len(every))

    def cell(c):
        return _dry_cell(*c, timeout=900), _since_start()

    return ex, [ex.submit(cell, c) for c in every], _since_start()


def phase_host(card: str, dry_cells) -> None:
    """The host's own work in children: the dry run's cells started by
    ``start_dry_cells``, waited for and checked; then the orchestration
    benchmarks' twins (ORCH_BENCHES, the crawl on the card) with nothing
    else beside them, and their gates, since two of the recovery
    benchmark's checks read its timing (the journaling overhead, a
    wall-time ratio, and what a crash finds in flight, its threads' timing:
    beside the dry run's children on an eight-core host the latter failed
    once)."""
    ex, futures, t_cells = dry_cells
    t0 = time.perf_counter()
    cells, ends = zip(*(f.result() for f in futures))
    ex.shutdown()
    _dry_cells_check(list(cells))
    log(f"[host] the dry-run cells ran from {t_cells:.1f} to "
        f"{max(ends):.1f} s into the run (each ended at "
        f"{', '.join(f'{e:.1f}' for e in ends)}): every phase stamped "
        f"before {max(ends):.1f} s ran beside them")
    out = ROOT / "build" / "orch_benches"
    out.mkdir(parents=True, exist_ok=True)
    t1 = time.perf_counter()
    procs = _start_orch_benches(out)
    _orch_benches_check(procs, out, card)
    log(f"[host] phase {time.perf_counter() - t0:.1f} s: {len(cells)} "
        f"dry-run cells at once, started with the run, waited for "
        f"{t1 - t0:.1f} s; then {len(procs)} twins alone "
        f"{time.perf_counter() - t1:.1f} s")


def _child(args: list[str], tag: str, timeout: float = 900, cwd=None,
           **env) -> str:
    """One of the repo's scripts in a child process (the root and src on
    its path): its output, or a failure with the output's end."""
    full_env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(ROOT / "src"), str(ROOT)]), **env}
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, *map(str, args)], cwd=cwd or ROOT,
                       env=full_env, capture_output=True, text=True,
                       timeout=timeout)
    text = r.stdout + r.stderr
    if r.returncode != 0:
        raise AssertionError(f"[{tag}] {' '.join(map(str, args))} exited "
                             f"{r.returncode}: {text[-3000:]}")
    log(f"[{tag}] {Path(str(args[0])).name} {time.perf_counter() - t0:.1f} s")
    return text


def _gate(check: str, current: Path, baseline: str, tag: str) -> None:
    """An unchanged ``benchmarks/check_<check>_regression.py`` on
    ``current`` against ``benchmarks/baselines/<baseline>``."""
    text = _child([ROOT / "benchmarks" / f"check_{check}_regression.py",
                   "--current", current, "--baseline",
                   ROOT / "benchmarks" / "baselines" / baseline], tag,
                  timeout=120)
    for line in text.strip().splitlines():
        log(f"[{tag}] gate: {line}")


def phase_tuner_benches(card: str) -> dict[str, dict[str, int]]:
    """``benchmarks/torch_kernel_bench.py --smoke`` in a child (its tuner
    sweep persisted in a cache file under build/, not the committed one),
    then its unchanged gate against the H100 baseline; then
    ``benchmarks/torch_microbench.py``.  Returns each child's launches."""
    out = ROOT / "build" / "benches"
    out.mkdir(parents=True, exist_ok=True)
    kb = out / "torch_kernels_smoke.json"
    (out / "tuner_cache.json").unlink(missing_ok=True)
    text = _child([ROOT / "benchmarks" / "torch_kernel_bench.py", "--smoke",
                   "--out", kb], "kernel-bench",
                  REPRO_TORCH_AUTOTUNE_CACHE=str(out / "tuner_cache.json"))
    for line in text.strip().splitlines()[:-1]:
        log(f"[kernel-bench] {line}")
    res = json.loads(kb.read_text())
    if res["mode"] != "cuda" or any(r["speedup_vs_default"] < 1.0
                                    for r in res["configs"].values()):
        raise AssertionError(f"[kernel-bench] {json.dumps(res['summary'])}")
    log(f"[kernel-bench] {json.dumps({n: {k: r[k] for k in ('tuned', 'candidates_us', 'device_ms', 'library_device_ms', 'library_backend', 'bound_ms', 'bound_by', 'roofline_frac')} for n, r in res['configs'].items()})} ({card})")
    _gate("kernel", kb, "torch_kernel_bench_baseline.json", "kernel-bench")
    mb = out / "torch_micro.json"
    text = _child([ROOT / "benchmarks" / "torch_microbench.py", "--out", mb],
                  "microbench")
    for line in text.strip().splitlines():
        log(f"[microbench] {line}")
    micro = json.loads(mb.read_text())
    return {"kernel bench": res["launches"], "microbench": micro["launches"]}


def start_host_children() -> dict[str, tuple]:
    """``benchmarks/torch_run.py --smoke`` (its JSON under build/benches)
    and ``examples/torch_serve_lm.py --width full --arch gemma-2b``, each in
    a child, started beside the orchestrator phase (neither child's numbers
    are gated).  They share the host's cores with it and the example the
    card too, so the orchestrator's walls and checkpoint rates, and those
    of any phase that starts before they end, are taken beside them; a
    thread a child waits for it and notes when it ended, and
    ``phase_serving_benches`` takes their output and logs those times."""
    out = ROOT / "build" / "benches"
    out.mkdir(parents=True, exist_ok=True)
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(ROOT / "src"), str(ROOT)])}
    runs = {"run": ([ROOT / "benchmarks" / "torch_run.py", "--smoke"], out),
            "serve-example": ([ROOT / "examples" / "torch_serve_lm.py",
                               "--width", "full", "--arch", "gemma-2b"], ROOT)}
    import atexit

    procs = {tag: subprocess.Popen([sys.executable, *map(str, args)],
                                   cwd=cwd, env=env, stdout=subprocess.PIPE,
                                   stderr=subprocess.STDOUT, text=True)
             for tag, (args, cwd) in runs.items()}
    t0 = _since_start()
    # a failed run stops them too
    atexit.register(lambda: [p.kill() for p in procs.values()
                             if p.poll() is None])

    done: dict[str, tuple[int, str, float]] = {}

    def wait(tag, proc):
        text, _ = proc.communicate(timeout=900)
        done[tag] = proc.returncode, text, _since_start()

    # daemon threads: a failed run exits without waiting for them
    threads = {tag: threading.Thread(target=wait, args=(tag, p), daemon=True)
               for tag, p in procs.items()}
    for t in threads.values():
        t.start()
    return {tag: (t, done, t0) for tag, t in threads.items()}


def phase_serving_benches(card: str, beside: dict) -> dict[str, dict[str, int]]:
    """``benchmarks/torch_serving_bench.py --smoke`` at full width (gemma-2b,
    bf16; SERVE_BENCH_LAYERS cuts its depth, labelled) in a child, then its
    unchanged gate against the H100 baseline; then the output of the
    children ``start_host_children`` started (``benchmarks/torch_run.py
    --smoke``, ``examples/torch_serve_lm.py --width full --arch
    gemma-2b``).  Returns the serving grid's launches."""
    out = ROOT / "build" / "benches"
    out.mkdir(parents=True, exist_ok=True)
    sb = out / "torch_serving_smoke.json"
    text = _child([ROOT / "benchmarks" / "torch_serving_bench.py", "--smoke",
                   "--out", sb, *(["--layers", SERVE_BENCH_LAYERS]
                                  if SERVE_BENCH_LAYERS else [])],
                  "serving-bench")
    for line in text.strip().splitlines():
        log(f"[serving-bench] {line}")
    res = json.loads(sb.read_text())
    log(f"[serving-bench] {res['model']} ({card}): "
        f"{json.dumps(res['summary'])}, grid {res['grid_wall_s']:.1f} s")
    _gate("serving", sb, "torch_serving_baseline.json", "serving-bench")
    texts = {}
    for tag, (thread, done, t0) in beside.items():
        thread.join(timeout=900)
        if tag not in done:
            raise AssertionError(f"[{tag}] did not end")
        rc, texts[tag], end = done[tag]
        if rc != 0:
            raise AssertionError(f"[{tag}] exited {rc}: {texts[tag][-3000:]}")
        for line in texts[tag].strip().splitlines():
            log(f"[{tag}] {line}")
        log(f"[{tag}] ran from {t0:.1f} to {end:.1f} s into the run: every "
            f"phase stamped between those ran beside it")
    if "name,us_per_call,derived\ntable1_cost," not in texts["run"]:
        raise AssertionError(f"[run] {texts['run'][-600:]}")
    if "[serve gemma-2b] 6 requests, 72 tokens" not in texts["serve-example"]:
        raise AssertionError(f"[serve-example] {texts['serve-example'][-600:]}")
    return {"serving bench": res["launches"]}


_RUN_START = time.perf_counter()


def main() -> None:
    global _RUN_START
    t_start = _RUN_START = time.perf_counter()

    def stamp(phase: str) -> None:
        log(f"[time] {phase} done {time.perf_counter() - t_start:.1f} s into "
            f"the run")

    card = phase_env()
    dry_cells = start_dry_cells()
    ptxas = phase_build()
    flash_rows = phase_kernels()
    wkv_rows = phase_wkv_kernel()
    paged_rows = phase_paged_kernel()
    stamp("kernels")
    tuned = {"tuner": phase_tuner(), **phase_tuner_benches(card)}
    stamp("tuner and kernel benchmarks")

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
    stamp("serving gemma-2b, rwkv6-1.6b")

    for arch in SERVE_MODELS:
        for engine, n in phase_model(arch).items():
            flash_launches[f"{arch} {engine}"] = n
        stamp(f"serving {arch}")
    flash_launches.update(phase_whisper())
    trace_sums = _trace_sums(flash_rows, flash_launches)
    stamp("serving models")

    phase_train_parity()
    phase_train_resume()
    for arch in TRAIN_FULL:
        train_launches = phase_train_full(card, arch)
        flash_launches[f"train {arch}"] = train_launches["flash"]
        wkv_launches[f"train {arch}"] = train_launches["wkv"]
    stamp("training")
    beside = start_host_children()
    phase_orchestrator(card)
    stamp("orchestrator")
    serve = phase_distributed(card)
    stamp("distributed")
    flash_launches.update(serve["flash"])
    wkv_launches.update(serve["wkv"])
    phase_paper_claims(card)
    phase_dryrun(card)
    torch.cuda.empty_cache()
    tuned.update(phase_serving_benches(card, beside))
    stamp("serving benchmarks")
    phase_host(card, dry_cells)
    stamp("host")
    # the new phases' own keys: the tuned dispatch and the benchmarks'
    # children, apart from the main path's
    for phase, n in tuned.items():
        flash_launches[phase] = n.get("flash", 0)
        if "wkv" in n:
            wkv_launches[phase] = n["wkv"]

    log(json.dumps({"kernels": [
        _kernel_entry("flash_attention", FLASH_SOURCE, FLASH_REPLACES,
                      flash_launches, flash_rows,
                      "F.scaled_dot_product_attention",
                      {f: r for f, r in ptxas.items() if "flash" in f},
                      prev_body_device_ms=flash_rows[0].get(
                          "prev_body_device_ms"),
                      trace_device_ms=trace_ms, trace_sums=trace_sums),
        _kernel_entry("linear_scan", WKV_SOURCE, WKV_REPLACES, wkv_launches,
                      wkv_rows, "none: no single PyTorch call computes the "
                      "WKV scan", {f: r for f, r in ptxas.items()
                                   if "wkv" in f or "scan" in f},
                      prev_body_device_ms=wkv_rows[0].get(
                          "prev_body_device_ms"),
                      trace_device_ms=wkv_trace_ms),
        _kernel_entry("paged_attention", PAGED_SOURCE, PAGED_REPLACES,
                      PAGED_LAUNCHES, paged_rows,
                      "F.scaled_dot_product_attention over the gathered "
                      "view", {f: r for f, r in ptxas.items()
                               if "paged" in f}),
    ]}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
