"""The port's CUDA kernels (flash attention, the RWKV-6 WKV scan, each of
its bodies) against their plain versions, on the card, the flash kernel
also at the sliding-window models' full prefill shapes and at the MLA and
MoE models' (minicpm3-4b's D 96 / Dv 64, granite-moe-1b-a400m's D 64); the
sliding-window, MLA and MoE smoke models' prefill and decode on the card
against the CPU; the encoder-decoder path's non-causal shapes (whisper's
encoder and cross-attention, 1500 keys: a ragged last key tile) and
qwen2-vl's GQA 64/8 at D 128; whisper's smoke prefill then decode on the
card against a full prefill and against the CPU; and train steps on the
card against the same steps on the CPU, which launch neither kernel.

Run on a machine with an NVIDIA card (no JAX needed there):

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py

Without a card every test skips: the kernel has no CPU mode.
"""
import math

import pytest

torch = pytest.importorskip("torch")

from repro_torch.data import TokenDataset  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import linear_scan as ls  # noqa: E402
from repro_torch.launch.train import make_train_step, smoke_config  # noqa: E402
from repro_torch.models import LanguageModel  # noqa: E402
from repro_torch.optim import AdamW, OptConfig  # noqa: E402
from repro_torch.utils import (tree_flatten, tree_leaves, tree_map,  # noqa: E402
                               tree_unflatten)

GPU_CASES = [
    # (B, Sq, Skv, Hq, Hkv, D, Dv, causal, window, q_offset, out_scale, dtype)
    (1, 1000, 1000, 8, 1, 256, 256, True, 0, 0, 1.0, torch.bfloat16),
    (1, 300, 300, 4, 2, 80, 80, True, 64, 0, 1.0, torch.bfloat16),
    (1, 100, 300, 2, 2, 192, 128, True, 0, 200, 1.0, torch.bfloat16),
    (2, 130, 130, 4, 4, 64, 64, False, 0, 0, 0.5, torch.float32),
    # the wgmma body: D = Dv = 128; D = 64 with a window and q_offset; a
    # short gemma-2b prompt that splits; the residual epilogue, ragged Sq
    (1, 512, 512, 4, 4, 128, 128, True, 0, 0, 1.0, torch.bfloat16),
    (1, 200, 456, 4, 2, 64, 64, True, 96, 256, 1.0, torch.bfloat16),
    (1, 97, 97, 8, 1, 256, 256, True, 0, 0, 1.0, torch.bfloat16),
    (2, 130, 130, 4, 1, 128, 128, True, 0, 0, 0.5, torch.bfloat16),
]


def _flash_inputs(case):
    B, Sq, Skv, Hq, Hkv, D, Dv, causal, window, q_offset, out_scale, dt = case
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, res = (torch.randn(s, generator=g, device="cuda").to(dt) for s in
                    ((B, Sq, Hq, D), (B, Skv, Hkv, D), (B, Skv, Hkv, Dv),
                     (B, Sq, Hq, Dv)))
    kw = dict(causal=causal, window=window, q_offset=q_offset,
              out_scale=out_scale, residual=res)
    return q, k, v, kw


@pytest.mark.gpu
@pytest.mark.parametrize("case", GPU_CASES)
def test_flash_kernel_matches_plain_on_gpu(case):
    """The CUDA kernel against its plain version on the card (2e-2 bf16,
    2e-5 f32 -- the f32 kernel sums in another order than the einsum)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernel has no CPU mode")
    q, k, v, kw = _flash_inputs(case)
    before = fa.launches
    out = fa.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    ref = fa.flash_attention_plain(q, k, v, **kw)
    tol = 2e-2 if q.dtype == torch.bfloat16 else 2e-5
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)


# the sliding-window models' full prefill of a 4500-token prompt, longer
# than both windows: h2o-danube-1.8b (GQA 32/8, D 80: the mma.sync body,
# window 4096) and recurrentgemma-9b (MQA 16/1, D 256: the wgmma body and
# its window-limited split plan, window 2048)
SWA_PREFILL_CASES = [
    ((1, 4500, 4500, 32, 8, 80, 80, True, 4096, 0, 1.0, torch.bfloat16), "mma"),
    ((1, 4500, 4500, 16, 1, 256, 256, True, 2048, 0, 1.0, torch.bfloat16),
     "wgmma"),
]


@pytest.mark.gpu
@pytest.mark.parametrize("case,body", SWA_PREFILL_CASES,
                         ids=["danube", "recurrentgemma"])
def test_flash_windowed_prefill_matches_plain_on_gpu(case, body):
    """The serving path's windowed prefill (no epilogue) against the plain
    version on the card, 2e-2 in bf16, through the body it must take."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernel has no CPU mode")
    q, k, v, kw = _flash_inputs(case)
    kw = dict(kw, residual=None)
    assert fa.select_body(q.dtype, case[5], case[6], case[5] ** -0.5) == body
    before = fa.launches
    out = fa.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    ref = fa.flash_attention_plain(q, k, v, **kw)
    torch.testing.assert_close(out.float(), ref.float(), rtol=2e-2, atol=2e-2)


# the MLA and MoE models' full prefill of a 1000-token prompt: minicpm3-4b's
# MLA heads (MHA 40/40, D = nope + rope = 96, Dv 64: the mma.sync body) and
# granite-moe-1b-a400m's (GQA 16/8, D = Dv = 64: the wgmma body)
MLA_MOE_PREFILL_CASES = [
    ((1, 1000, 1000, 40, 40, 96, 64, True, 0, 0, 1.0, torch.bfloat16), "mma"),
    ((1, 1000, 1000, 16, 8, 64, 64, True, 0, 0, 1.0, torch.bfloat16), "wgmma"),
]


@pytest.mark.gpu
@pytest.mark.parametrize("case,body", MLA_MOE_PREFILL_CASES,
                         ids=["minicpm3_mla", "granite"])
def test_flash_mla_moe_prefill_matches_plain_on_gpu(case, body):
    """The serving path's prefill at the two new head-dim pairs against the
    plain version on the card, 2e-2 in bf16, through the body it must take."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernel has no CPU mode")
    q, k, v, kw = _flash_inputs(case)
    kw = dict(kw, residual=None)
    assert fa.select_body(q.dtype, case[5], case[6], case[5] ** -0.5) == body
    before = fa.launches
    out = fa.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    ref = fa.flash_attention_plain(q, k, v, **kw)
    torch.testing.assert_close(out.float(), ref.float(), rtol=2e-2, atol=2e-2)


# whisper-medium's full prefill, non-causal over 1500 encoder frames (not a
# multiple of the 64-key tile): the cross-attention of 224 decoder tokens
# (Sq != Skv), of 4 rows of 4 tokens (split-KV and the merge kernel) and
# the encoder's self-attention, MHA 16/16 at D 64; and qwen2-vl-72b's
# causal GQA 64/8 at D 128
ENCDEC_MROPE_CASES = [
    (2, 224, 1500, 16, 16, 64, 64, False, 0, 0, 1.0, torch.bfloat16),
    (4, 4, 1500, 16, 16, 64, 64, False, 0, 0, 1.0, torch.bfloat16),
    (4, 1500, 1500, 16, 16, 64, 64, False, 0, 0, 1.0, torch.bfloat16),
    (1, 1000, 1000, 64, 8, 128, 128, True, 0, 0, 1.0, torch.bfloat16),
]
# ||out - plain|| / ||plain|| in bf16, as chip_smoke.py's REL_TOL: at D 64
# over 1500 keys an output is of order 0.04, where the 2e-2 absolute term
# would pass an unmasked, zero-filled ragged key tile (1.4 % relative)
REL_TOL_BF16 = 5e-3


@pytest.mark.gpu
@pytest.mark.parametrize("case", ENCDEC_MROPE_CASES,
                         ids=["whisper_cross", "whisper_cross_a",
                              "whisper_encoder", "qwen2vl"])
def test_flash_encdec_mrope_prefill_matches_plain_on_gpu(case):
    """The new serving shapes against the plain version on the card, 2e-2
    in bf16 elementwise and REL_TOL_BF16 over the whole output, through the
    wgmma body; the non-causal cases split no row past Skv (their last key
    tile is masked at 1500)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernel has no CPU mode")
    q, k, v, kw = _flash_inputs(case)
    kw = dict(kw, residual=None)
    assert fa.select_body(q.dtype, case[5], case[6], case[5] ** -0.5) == "wgmma"
    before = fa.launches
    out = fa.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    ref = fa.flash_attention_plain(q, k, v, **kw)
    torch.testing.assert_close(out.float(), ref.float(), rtol=2e-2, atol=2e-2)
    rel = float((out.float() - ref.float()).norm() / ref.float().norm())
    assert rel <= REL_TOL_BF16, rel


@pytest.mark.gpu
def test_whisper_smoke_prefill_then_decode_on_card():
    """whisper smoke in f32 on the card (the flash kernel's FMA body:
    encoder, self and cross, 3 launches a layer): prefill with frames, 4
    decode steps, against a full prefill of the prompt plus those tokens
    on the card, and against the same steps on the CPU, 1e-4."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernel has no CPU mode")
    cfg = smoke_config("whisper-medium").scaled(compute_dtype="float32")
    gen = torch.Generator().manual_seed(0)
    p_cpu = LanguageModel(cfg, device="cpu").init(0)
    tokens = torch.randint(0, cfg.vocab_size, (2, 24), generator=gen,
                           dtype=torch.int32)
    frames = torch.randn((2, 30, cfg.d_model), generator=gen)
    outs = {}
    for dev in ("cpu", "cuda"):
        model = LanguageModel(cfg, device=dev)
        params = tree_map(lambda t: t.to(dev), p_cpu)
        toks, fr = tokens.to(dev), frames.to(dev)
        cache = model.init_cache(2, 32, enc_len=30, dtype=torch.float32)
        before = fa.launches
        logits, cache = model.prefill(params, {"tokens": toks[:, :20],
                                               "frames": fr}, cache)
        per = cfg.n_enc_layers + 2 * cfg.n_layers
        assert fa.launches - before == (per if dev == "cuda" else 0)
        steps = [logits]
        for t in range(20, 24):
            logits, cache = model.decode_step(
                params, toks[:, t:t + 1], cache,
                torch.full((2,), t, dtype=torch.int32, device=dev))
            steps.append(logits)
        full, _ = model.prefill(params, {"tokens": toks, "frames": fr},
                                model.init_cache(2, 32, enc_len=30,
                                                 dtype=torch.float32))
        torch.testing.assert_close(steps[-1], full, rtol=1e-4, atol=1e-4)
        outs[dev] = torch.stack(steps).cpu()
    torch.testing.assert_close(outs["cuda"], outs["cpu"], rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "recurrentgemma-9b"])
def test_swa_smoke_prefill_on_card_matches_cpu(arch):
    """Smoke size in f32 (the flash kernel's FMA body, window 16): a
    40-token prompt, longer than the window, prefilled and then decoded for
    4 tokens on the card against the CPU, 1e-4 on the logits; one flash
    launch per attention layer.  RG-LRU's zero-init conv is drawn first
    (0.5 x a seeded normal), so its states carry weight."""
    _smoke_serving_on_card_matches_cpu(arch)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["minicpm3-4b", "granite-moe-1b-a400m",
                                  "deepseek-v2-236b"])
def test_mla_moe_smoke_prefill_on_card_matches_cpu(arch):
    """The same at the MLA and MoE smoke configs: MLA's 24-dim heads reach
    the FMA body padded to 32; decode runs the absorbed latent path."""
    _smoke_serving_on_card_matches_cpu(arch)


def _smoke_serving_on_card_matches_cpu(arch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernel has no CPU mode")
    cfg = smoke_config(arch).scaled(compute_dtype="float32")
    gen = torch.Generator().manual_seed(0)
    p_cpu = LanguageModel(cfg, device="cpu").init(0)
    p_cpu = tree_unflatten(p_cpu, [
        0.5 * torch.randn(t.shape, generator=gen) if path.endswith("conv_w")
        else t for path, t in tree_flatten(p_cpu)])
    tokens = torch.randint(0, cfg.vocab_size, (2, 44), generator=gen,
                           dtype=torch.int32)
    n_attn = sum(t in ("attn", "swa") for t in cfg.layer_types())
    outs = {}
    for dev in ("cpu", "cuda"):
        model = LanguageModel(cfg, device=dev)
        params = tree_map(lambda t: t.to(dev), p_cpu)
        toks = tokens.to(dev)
        cache = model.init_cache(2, 64, dtype=torch.float32)
        before = fa.launches
        logits, cache = model.prefill(params, {"tokens": toks[:, :40]}, cache)
        assert fa.launches - before == (n_attn if dev == "cuda" else 0)
        steps = [logits]
        for t in range(40, 44):
            logits, cache = model.decode_step(
                params, toks[:, t:t + 1], cache,
                torch.full((2,), t, dtype=torch.int32, device=dev))
            steps.append(logits)
        outs[dev] = torch.stack(steps).cpu()
    torch.testing.assert_close(outs["cuda"], outs["cpu"], rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
def test_flash_bodies_run_where_they_should():
    """Which body each GPU case runs, and that the short gemma prompt
    splits: every body and the split path are covered above."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernel has no CPU mode")
    bodies = {fa.select_body(c[-1], c[5], c[6], c[5] ** -0.5) for c in GPU_CASES}
    assert bodies == {"fma", "mma", "wgmma"}
    assert fa.split_plan(1, 97, 97, 8, True, 0, 0).merges
    with pytest.raises(ValueError):  # no wgmma body at D = 80
        fa.select_body(torch.bfloat16, 80, 80, 0.1, "wgmma")


@pytest.mark.gpu
def test_flash_wgmma_body_gives_identical_bits_twice():
    """The split path merges its parts in a fixed order, without atomics:
    two calls at gemma-2b's prefill shape give the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernel has no CPU mode")
    q, k, v, kw = _flash_inputs(GPU_CASES[0])
    assert fa.select_body(q.dtype, 256, 256, 256 ** -0.5) == "wgmma"
    assert fa.split_plan(1, 1000, 1000, 8, True, 0, 0).merges
    first = fa.flash_attention(q, k, v, **kw)
    second = fa.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.gpu
def test_flash_new_shape_adds_no_stream_sync():
    """A shape's first call uploads its split plan without synchronising the
    stream (pinned rows, non-blocking copy), and still agrees (2e-2)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernel has no CPU mode")
    case = (1, 333, 333, 8, 1, 256, 256, True, 0, 0, 1.0, torch.bfloat16)
    q, k, v, kw = _flash_inputs(case)
    assert fa.select_body(q.dtype, 256, 256, 256 ** -0.5) == "wgmma"
    assert fa.split_plan(1, 333, 333, 8, True, 0, 0).merges
    torch.cuda.synchronize()
    fa._device_plan.cache_clear()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = fa.flash_attention(q, k, v, **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    ref = fa.flash_attention_plain(q, k, v, **kw)
    torch.testing.assert_close(out.float(), ref.float(), rtol=2e-2, atol=2e-2)


@pytest.mark.gpu
def test_flash_mma_body_on_request_matches_plain():
    """The mma.sync body, asked for through ``_body`` at the gemma-2b
    shape where wgmma runs by default, still agrees (2e-2)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernel has no CPU mode")
    q, k, v, kw = _flash_inputs(GPU_CASES[0])
    out = fa.flash_attention(q, k, v, _body="mma", **kw)
    ref = fa.flash_attention_plain(q, k, v, **kw)
    torch.testing.assert_close(out.float(), ref.float(), rtol=2e-2, atol=2e-2)


WKV_GPU_CASES = [
    # (B, S, H, N): tests/test_kernels.py's WKV cases, its padded S = 100,
    # the rwkv6-1.6b prefill, a paged chunk round, an odd length
    (1, 64, 2, 16), (2, 128, 2, 32), (1, 128, 4, 64), (2, 96, 2, 16),
    (2, 100, 2, 32), (1, 1000, 32, 64), (8, 64, 32, 64), (1, 97, 32, 64),
]


def _wkv_inputs(B, S, H, N, seed=0, w_hi=0.0):
    """Realistic decays log_w = -exp(w_raw), w_raw in [-6, w_hi] (0 unless
    asked); nonzero s0."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda")

    w_raw = (torch.rand((B, S, H, N), generator=g, device="cuda")
             * (w_hi + 6.0) - 6.0)
    return (randn(B, S, H, N), randn(B, S, H, N), randn(B, S, H, N),
            -torch.exp(w_raw), randn(H, N) * 0.1, randn(B, H, N, N) * 0.5)


@pytest.mark.gpu
@pytest.mark.parametrize("case", WKV_GPU_CASES,
                         ids=lambda c: "x".join(map(str, c)))
def test_wkv_kernel_matches_plain_on_gpu(case):
    """The CUDA scan's default (chunked) body against the chunked plain
    version: 1e-4 relative to max(1, max |plain|) -- the two sum in
    different orders, the kernel with 3xTF32 products."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernel has no CPU mode")
    _assert_wkv_matches_plain(_wkv_inputs(*case))


def _assert_wkv_matches_plain(args, body="chunked"):
    """One launch of ``body`` against the plain version: y and s_fin within
    1e-4 x max(1, max |plain|), finite."""
    before = ls.launches
    y, s_fin = ls.linear_scan(*args, _body=body)
    torch.cuda.synchronize()
    assert ls.launches == before + 1
    y_ref, s_ref = ls.linear_scan_plain(*args)
    assert y.shape == y_ref.shape and s_fin.shape == s_ref.shape
    for out, ref in ((y, y_ref), (s_fin, s_ref)):
        assert bool(torch.isfinite(out).all())
        scale = max(1.0, float(ref.abs().max()))
        assert float((out - ref).abs().max()) <= 1e-4 * scale


@pytest.mark.gpu
@pytest.mark.parametrize("case", WKV_GPU_CASES,
                         ids=lambda c: "x".join(map(str, c)))
def test_wkv_step_body_on_request_matches_plain(case):
    """The per-step body, asked for through ``_body``, at every case the
    chunked body (the default) runs above (1e-4 relative)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernel has no CPU mode")
    _assert_wkv_matches_plain(_wkv_inputs(*case), body="step")


@pytest.mark.gpu
@pytest.mark.parametrize("body", ["chunked", "step"])
def test_wkv_strong_decay_matches_plain_on_gpu(body):
    """Strong decays (w_raw up to 3, log_w down to about -20) at the
    rwkv6-1.6b prefill shape: both bodies stay finite and within 1e-4."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernel has no CPU mode")
    _assert_wkv_matches_plain(_wkv_inputs(1, 1000, 32, 64, seed=1, w_hi=3.0),
                              body=body)


@pytest.mark.gpu
def test_wkv_chunked_new_shape_adds_no_stream_sync():
    """The chunked body's first call at a shape no test ran before (a ragged
    last chunk, two batches) allocates its scratch and launches its three
    kernels without synchronising the stream, and still agrees (1e-4)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernel has no CPU mode")
    args = _wkv_inputs(2, 333, 4, 64, seed=2)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        y, s_fin = ls.linear_scan(*args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    y_ref, s_ref = ls.linear_scan_plain(*args)
    for out, ref in ((y, y_ref), (s_fin, s_ref)):
        scale = max(1.0, float(ref.abs().max()))
        assert float((out - ref).abs().max()) <= 1e-4 * scale


def _train(device, cfg, params, steps=3):
    """``steps`` train steps on ``device``: (losses, params after)."""
    opt = AdamW(OptConfig(peak_lr=3e-3, warmup_steps=2, decay_steps=10))
    step = make_train_step(LanguageModel(cfg, device=device), opt)
    state = opt.init(params)
    data = TokenDataset(vocab_size=cfg.vocab_size, seq_len=64, global_batch=2)
    losses = []
    for i in range(steps):
        batch = {k: torch.from_numpy(v).to(device)
                 for k, v in data.batch(i).items()}
        params, state, m = step(params, state, batch)
        losses.append(float(m["loss"]))
    return losses, params


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["gemma-2b", "rwkv6-1.6b", "minicpm3-4b",
                                  "granite-moe-1b-a400m", "deepseek-v2-236b"])
def test_train_steps_on_card_match_cpu(arch):
    """Three train steps on the card against the same steps on the CPU
    (the path the CPU tests hold against JAX), smoke size, f32 compute:
    losses within 1e-4 relative, every parameter after them within
    1e-4 x max(1, max |p|)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cfg = smoke_config(arch).scaled(compute_dtype="float32")
    p_cpu = LanguageModel(cfg, device="cpu").init(0)
    p_gpu = tree_map(lambda t: t.to("cuda", copy=True), p_cpu)
    l_cpu, p_cpu = _train("cpu", cfg, p_cpu)
    l_gpu, p_gpu = _train("cuda", cfg, p_gpu)
    for a, b in zip(l_gpu, l_cpu):
        assert abs(a - b) <= 1e-4 * abs(b)
    for a, b in zip(tree_leaves(p_gpu), tree_leaves(p_cpu)):
        a, b = a.detach().cpu(), b.detach()
        assert float((a - b).abs().max()) <= 1e-4 * max(1.0, float(b.abs().max()))


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["gemma-2b", "rwkv6-1.6b",
                                  "granite-moe-1b-a400m"])
def test_train_step_on_card_launches_no_kernel(arch):
    """A train step (bf16 compute, remat full) on the card reaches neither
    hand-written kernel: neither has a backward, in JAX or here."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cfg = smoke_config(arch).scaled(remat="full")
    params = LanguageModel(cfg, device="cuda").init(0)
    before = fa.launches, ls.launches
    losses, _ = _train("cuda", cfg, params, steps=2)
    torch.cuda.synchronize()
    assert (fa.launches, ls.launches) == before
    assert all(math.isfinite(x) for x in losses)
