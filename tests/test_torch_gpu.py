"""The port's CUDA kernels (flash attention, the RWKV-6 WKV scan, each of
its bodies) against their plain versions, on the card, the flash kernel
also at the sliding-window models' full prefill shapes and at the MLA and
MoE models' (minicpm3-4b's D 96 / Dv 64, granite-moe-1b-a400m's D 64),
the wgmma body at the padded head dims 80 and 96 beside the mma.sync body
on the same inputs; the sliding-window, MLA and MoE smoke models' prefill
and decode on the card
against the CPU; the encoder-decoder path's non-causal shapes (whisper's
encoder and cross-attention, 1500 keys: a ragged last key tile) and
qwen2-vl's GQA 64/8 at D 128; whisper's smoke prefill then decode on the
card against a full prefill and against the CPU; train steps on the
card against the same steps on the CPU, which launch neither kernel; the
paged decode-attention kernel against the gather path at the served
shapes, in a CUDA graph, and counted by the paged engine; and the Common
Crawl assets on the card, byte for byte against the CPU and across runs,
alone and materialized through the orchestrator.

Run on a machine with an NVIDIA card (no JAX needed there):

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py

Without a card every test skips: the kernel has no CPU mode.  The second
tiles (the flash kernel's 128-key tiles, the WKV scan's 32-step chunks) and
the tuned dispatch run here too.
"""
import math

import pytest

torch = pytest.importorskip("torch")

from repro_torch.data import TokenDataset  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import linear_scan as ls  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402
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
    # the wgmma body at head dims padded to whole 64-column boxes: D 96 /
    # Dv 64 with an Sq that is not a multiple of 64; D 80 with the residual
    # epilogue at out_scale 0.5; both split (merge kernel at Dv 64 and 80)
    (2, 150, 150, 8, 8, 96, 64, True, 0, 0, 1.0, torch.bfloat16),
    (2, 130, 130, 4, 2, 80, 80, True, 0, 0, 0.5, torch.bfloat16),
    # the mma.sync body: the smoke configs' D 32
    (1, 100, 100, 2, 2, 32, 32, True, 0, 0, 1.0, torch.bfloat16),
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
# than both windows: h2o-danube-1.8b (GQA 32/8, D 80: the wgmma body at a
# padded head dim, window 4096) and recurrentgemma-9b (MQA 16/1, D 256: the
# wgmma body and its window-limited split plan, window 2048)
SWA_PREFILL_CASES = [
    ((1, 4500, 4500, 32, 8, 80, 80, True, 4096, 0, 1.0, torch.bfloat16),
     "wgmma"),
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
# MLA heads (MHA 40/40, D = nope + rope = 96, Dv 64) and
# granite-moe-1b-a400m's (GQA 16/8, D = Dv = 64), both on the wgmma body
MLA_MOE_PREFILL_CASES = [
    ((1, 1000, 1000, 40, 40, 96, 64, True, 0, 0, 1.0, torch.bfloat16),
     "wgmma"),
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


# the two served widths the wgmma body took over from the mma.sync body:
# danube's windowed prefill (D 80) and minicpm3's MLA prefill (D 96 / Dv 64)
PADDED_PREFILL_CASES = [SWA_PREFILL_CASES[0][0], MLA_MOE_PREFILL_CASES[0][0]]


@pytest.mark.gpu
@pytest.mark.parametrize("case", PADDED_PREFILL_CASES,
                         ids=["danube", "minicpm3_mla"])
def test_flash_padded_wgmma_and_mma_bodies_match_plain(case):
    """At the padded widths the wgmma body runs by default and the
    mma.sync body on request (``_body="mma"``), on the same inputs, one
    launch each: both within 2e-2 of the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernel has no CPU mode")
    q, k, v, kw = _flash_inputs(case)
    kw = dict(kw, residual=None)
    D, Dv = case[5], case[6]
    assert fa.select_body(q.dtype, D, Dv, D ** -0.5) == "wgmma"
    assert fa.select_body(q.dtype, D, Dv, D ** -0.5, "mma") == "mma"
    ref = fa.flash_attention_plain(q, k, v, **kw)
    for body in (None, "mma"):
        before = fa.launches
        out = fa.flash_attention(q, k, v, _body=body, **kw)
        torch.cuda.synchronize()
        assert fa.launches == before + 1
        torch.testing.assert_close(out.float(), ref.float(), rtol=2e-2,
                                   atol=2e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("Sq", [4500, 97], ids=["prefill", "split"])
def test_flash_padded_wgmma_gives_identical_bits_twice(Sq):
    """At danube's heads, head dim and window: the full 4500-token prefill
    and a 97-token prompt, whose plan splits (the merge kernel at Dv 80),
    give the same bits on two calls."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernel has no CPU mode")
    case = (1, Sq, Sq, 32, 8, 80, 80, True, 4096, 0, 1.0, torch.bfloat16)
    q, k, v, kw = _flash_inputs(case)
    kw = dict(kw, residual=None)
    assert fa.select_body(q.dtype, 80, 80, 80 ** -0.5) == "wgmma"
    assert bool(fa.split_plan(1, Sq, Sq, 32, True, 4096, 0).merges) == (Sq == 97)
    first = fa.flash_attention(q, k, v, **kw)
    second = fa.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


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
    for c in GPU_CASES:  # the C entry and the host's mirror agree
        assert fa.select_body(c[-1], c[5], c[6], c[5] ** -0.5) == \
            fa.body_of(c[-1], c[5], c[6])
    assert fa.split_plan(1, 97, 97, 8, True, 0, 0).merges
    with pytest.raises(ValueError):  # no wgmma body at D = 32
        fa.select_body(torch.bfloat16, 32, 32, 0.1, "wgmma")
    with pytest.raises(ValueError):  # nor at D 80 with Dv 64
        fa.select_body(torch.bfloat16, 80, 64, 0.1, "wgmma")


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


@pytest.mark.gpu
@pytest.mark.parametrize("case", [c for c in GPU_CASES if c[6] <= 128 and
                                  fa.body_of(c[-1], c[5], c[6]) == "wgmma"])
def test_flash_128_key_tiles_match_plain_on_gpu(case):
    """The wgmma body's 128-key tiles (``block_k=128``) on every GPU case
    that body takes at Dv <= 128, against the plain version (2e-2 bf16),
    with its split plan at 128 keys."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernel has no CPU mode")
    q, k, v, kw = _flash_inputs(case)
    assert fa.select_body(q.dtype, case[5], case[6], case[5] ** -0.5) == "wgmma"
    before = fa.launches
    out = fa.flash_attention(q, k, v, block_k=128, **kw)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    ref = fa.flash_attention_plain(q, k, v, **kw)
    torch.testing.assert_close(out.float(), ref.float(), rtol=2e-2, atol=2e-2)


@pytest.mark.gpu
def test_flash_refuses_a_tile_its_body_lacks():
    """A tile the chosen body is not built for raises on the card; nothing
    runs 64 instead."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernel has no CPU mode")
    q, k, v, kw = _flash_inputs(GPU_CASES[0])  # D = Dv = 256: 64 keys only
    before = fa.launches
    for tile in (dict(block_k=128), dict(block_k=32), dict(block_q=128)):
        with pytest.raises(ValueError):
            fa.flash_attention(q, k, v, **tile, **kw)
    q, k, v, kw = _flash_inputs(GPU_CASES[-1])  # D 32: the mma.sync body
    with pytest.raises(ValueError):
        fa.flash_attention(q, k, v, block_k=128, **kw)
    assert fa.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("case", WKV_GPU_CASES,
                         ids=lambda c: "x".join(map(str, c)))
def test_wkv_32_step_chunks_match_plain_on_gpu(case):
    """The chunked body at 32-step chunks against the plain version (1e-4
    relative), at every case the 64-step chunks run above."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernel has no CPU mode")
    args = _wkv_inputs(*case, seed=3)
    before = ls.launches
    y, s_fin = ls.linear_scan(*args, chunk=32)
    torch.cuda.synchronize()
    assert ls.launches == before + 1
    y_ref, s_ref = ls.linear_scan_plain(*args)
    for out, ref in ((y, y_ref), (s_fin, s_ref)):
        assert bool(torch.isfinite(out).all())
        scale = max(1.0, float(ref.abs().max()))
        assert float((out - ref).abs().max()) <= 1e-4 * scale
    with pytest.raises(ValueError):
        ls.linear_scan(*args, chunk=16)


@pytest.mark.gpu
def test_tuned_dispatch_times_once_then_hits(tmp_path, monkeypatch):
    """``ops`` with ``tuned=True`` on the card: a miss times each candidate
    once and persists the winner; the next call times nothing."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernel has no CPU mode")
    from repro_torch.kernels import autotune as at
    from repro_torch.kernels import ops

    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(tmp_path / "c.json"))
    monkeypatch.setattr(at, "BASELINE_CACHE_PATH", str(tmp_path / "none.json"))
    at.reset_tuner()
    try:
        q, k, v, kw = _flash_inputs(GPU_CASES[4])  # D = Dv = 128: two tiles
        kw = dict(kw, residual=None, out_scale=1.0)
        ops.flash_attention(q, k, v, tuned=True, **kw)
        assert at.get_tuner().timing_calls == 2
        out = ops.flash_attention(q, k, v, tuned=True, **kw)
        assert at.get_tuner().timing_calls == 2
        assert (tmp_path / "c.json").exists()
        ref = fa.flash_attention_plain(q, k, v, **kw)
        torch.testing.assert_close(out.float(), ref.float(), rtol=2e-2,
                                   atol=2e-2)
    finally:
        at.reset_tuner()


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


# the Common Crawl configs whose bytes the card must reproduce: the
# reference's default (T 128), 33 tokens a page (weights in 33rds), and 33
# with a 16-token vocabulary (overlap counts where sum / 33 and
# sum * (1/33) part in the last bit)
CC_GPU_CASES = [{}, {"tokens_per_page": 33},
                {"tokens_per_page": 33, "vocab": 16}]


def _cc_outputs(cfg, device):
    from repro_torch.data import commoncrawl as cc

    out = {}
    for crawl, shard in (("2023-10", "shard-0"), ("2023-11", "shard-1")):
        nodes = cc.nodes_asset(crawl, shard, cfg)
        edges = cc.edges_asset(crawl, shard, nodes, cfg, device=device)
        aggr = cc.graph_aggr_asset(cc.graph_asset(nodes, edges), cfg,
                                   device=device)
        out[crawl, shard] = (edges, aggr)
    return out


def _cc_bytes(outputs):
    from repro_torch.core import MaterializationStore

    return {k: [MaterializationStore.data_fingerprint(v)[1] for v in vals]
            for k, vals in outputs.items()}


@pytest.mark.gpu
@pytest.mark.parametrize("kw", CC_GPU_CASES, ids=lambda kw: str(kw or "T128"))
def test_commoncrawl_on_card_matches_cpu_bytes(kw):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the assets run their tensors there")
    from repro_torch.data import commoncrawl as cc

    cfg = cc.CrawlConfig(**kw)
    cc.device_calls.clear()
    first = _cc_bytes(_cc_outputs(cfg, "cuda"))
    assert cc.device_calls == {("edges", "cuda"): 2, ("graph_aggr", "cuda"): 2}
    assert _cc_bytes(_cc_outputs(cfg, "cuda")) == first
    assert _cc_bytes(_cc_outputs(cfg, "cpu")) == first


@pytest.mark.gpu
def test_segment_sum_on_card_is_ordered():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.data import commoncrawl as cc

    g = torch.Generator().manual_seed(0)
    data = torch.randn(200_000, generator=g)
    ids = torch.randint(0, 1000, (200_000,), generator=g)
    cpu = cc.segment_sum(data, ids, 1024)
    for _ in range(2):
        assert torch.equal(cc.segment_sum(data.cuda(), ids.cuda(), 1024).cpu(),
                           cpu)


@pytest.mark.gpu
def test_commoncrawl_materializes_through_the_coordinator_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from benchmarks.torch_cc_pipeline import SMALL, run_policy
    from repro_torch.data import commoncrawl as cc

    cc.device_calls.clear()
    report, reader = run_policy("orchestrated", seed=4, partitions=SMALL,
                                device="cuda")
    assert report.ok and reader.events(kind="MATERIALIZE")
    assert {d for _, d in cc.device_calls} == {"cuda"}
    costs = report.by_asset_cost()
    assert costs["edges"] > 5 * (costs["nodes"] + costs["graph_aggr"])


def _recording_engine(model, params, eager):
    """A ``PagedServingEngine`` that keeps, at every drain, a copy of the
    slot state, the block table and every cache leaf but the pools' last
    page (the write-only trash page, which padded and inactive rows write
    in no fixed order and nothing reads); ``eager`` runs the decode block
    with ``_decode_ticks`` instead of the CUDA graph."""
    from repro_torch.launch.paged_kv import _pages_dim
    from repro_torch.launch.serve import PagedServingEngine

    class Engine(PagedServingEngine):
        def _tick_block(self):
            if eager:
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

    eng = Engine(model, params, n_slots=3, max_len=128, page_size=16,
                 chunk_max=32, drain_every=8, prefill_chunks_per_tick=4)
    eng.snaps = []
    return eng


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["gemma-2b", "rwkv6-1.6b", "h2o-danube-1.8b",
                                  "recurrentgemma-9b", "minicpm3-4b",
                                  "granite-moe-1b-a400m", "qwen2-vl-72b",
                                  "deepseek-v2-236b"])
def test_paged_graph_decode_matches_eager_bitwise(arch):
    """The paged engine's decode block replayed as a CUDA graph against the
    same block run eagerly, smoke size, bf16: nine requests on three slots,
    arriving every 4 ticks, so slots and pages are freed and admitted again
    after the capture (the second block).  Every drain's slot state, block
    table and cache leaves (but the trash page), and every request's
    tokens, are equal bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the graph is captured only there")
    import numpy as np

    from repro_torch.launch.serve import Request

    cfg = smoke_config(arch)
    model = LanguageModel(cfg, device="cuda")
    params = model.init(0)
    rng = np.random.RandomState(1)
    trace = [(rng.randint(0, cfg.vocab_size, rng.randint(5, 60)).tolist(),
              int(rng.randint(4, 24)), 4 * i) for i in range(9)]
    runs = []
    for eager in (False, True):
        eng = _recording_engine(model, params, eager)
        reqs = [Request(rid=i, prompt=p, max_new=n, arrival=a)
                for i, (p, n, a) in enumerate(trace)]
        eng.run(reqs)
        torch.cuda.synchronize()
        assert (eng._graph is None) == eager
        runs.append((eng.snaps, reqs))
    (g_snaps, g_reqs), (e_snaps, e_reqs) = runs
    assert any(r.admit_tick > 16 for r in g_reqs)
    assert len(g_snaps) == len(e_snaps) >= 4
    for a, b in zip(g_snaps, e_snaps):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert [r.out for r in g_reqs] == [r.out for r in e_reqs]
    assert all(len(r.out) == r.max_new for r in g_reqs)


BF16, F32 = torch.bfloat16, torch.float32
PAGED_GPU_CASES = [
    # (B, Hkv, G, D, max_pages, page_size, window, q dtype, pool dtype):
    # granite-moe-1b-a400m's serve cells (16 ranges of 16 pages; 8 of 8),
    # also in f32; gemma-2b (MQA, G 8 at D 256), qwen2-vl-72b (G 8 at D
    # 128), deepseek-7b (G 1 at D 128); the smoke configs' D 16 and 32
    # (one range), in bf16, f32 and mixed; a window over 32-token pages; a
    # group of 3 (chunks of 1) over 24-token pages (no shift)
    (64, 8, 2, 64, 256, 16, 0, BF16, BF16),
    (64, 8, 2, 64, 64, 16, 0, BF16, BF16),
    (64, 8, 2, 64, 64, 16, 0, F32, F32),
    (8, 1, 8, 256, 64, 16, 0, BF16, BF16),
    (8, 8, 8, 128, 64, 16, 0, BF16, BF16),
    (8, 32, 1, 128, 64, 16, 0, BF16, BF16),
    (3, 2, 2, 16, 8, 16, 0, BF16, BF16),
    (3, 2, 2, 16, 8, 16, 0, F32, F32),
    (3, 1, 4, 32, 8, 16, 0, BF16, BF16),
    (3, 1, 4, 32, 8, 16, 0, F32, BF16),
    (3, 4, 1, 16, 8, 16, 0, BF16, F32),
    (5, 2, 2, 64, 40, 32, 100, BF16, BF16),
    (4, 2, 3, 64, 20, 24, 0, BF16, BF16),
]


def _paged_gpu_inputs(case, seed=0):
    """A pool as the paged engine leaves it, on the card: every slot's
    pages drawn from a shuffled pool, positions -1 past the query's own
    (the allocation-time reset) with stale K/V there, a spare page past the
    query's page, the rest of the row unallocated; the first slot inactive
    (pos_q -1), the second ending on a page edge, the others ragged (at
    max_pages 256 log-uniform over 1,024-3,968 + 32-127, as serve.long);
    the trash page holds NaN and positions the mask would pass."""
    import numpy as np

    B, Hkv, G, D, P, ps, window, qdt, kvdt = case
    rng = np.random.RandomState(seed)
    cap = P * ps - 1
    if P >= 256:
        lens = np.exp(rng.uniform(np.log(1024), np.log(3968), B)).astype(int)
        lens += rng.randint(32, 128, B)
    else:
        lens = rng.randint(1, cap + 1, B)
    pos_q = np.minimum(lens - 1, cap)
    pos_q[0], pos_q[1 % B] = -1, min(3 * ps - 1, cap)
    n_pages = B * P
    g = torch.Generator(device="cuda").manual_seed(seed)
    kp = torch.randn((n_pages + 1, ps, Hkv, D), generator=g, device="cuda")
    vp = torch.randn((n_pages + 1, ps, Hkv, D), generator=g, device="cuda")
    kp[n_pages], vp[n_pages] = math.nan, math.nan
    posp = torch.full((n_pages + 1, ps), -1, dtype=torch.int32)
    posp[n_pages] = torch.arange(ps, dtype=torch.int32)
    table = torch.full((B, P), n_pages, dtype=torch.int32)
    free = rng.permutation(n_pages).tolist()
    for b, pq in enumerate(pos_q.tolist()):
        for lp in range(min(P, max(pq, 0) // ps + 2)):
            page = free.pop()
            table[b, lp] = page
            t = lp * ps + torch.arange(ps)
            posp[page] = torch.where(t <= pq, t, -1).int()
    q = torch.randn((B, 1, Hkv * G, D), generator=g, device="cuda")
    return (q.to(qdt), kp.to(kvdt), vp.to(kvdt), posp.cuda(), table.cuda(),
            torch.tensor(pos_q, dtype=torch.int32, device="cuda")[:, None],
            dict(window=window))


def _paged_tol(case):
    """bf16 anywhere: 2e-2 (the gather path rounds P to bf16 before P V,
    the kernel keeps f32 to the end); f32 throughout: 2e-5."""
    return 2e-2 if BF16 in case[-2:] else 2e-5


#: beside ``_paged_tol``, by q's dtype: ||out - ref|| / ||ref|| over the
#: active rows against the gather path in f32 over the same pools.  At
#: serve.long's ~2,200 live keys an output is of order 0.035, where the
#: absolute term alone would pass a kernel that drops the query's own key
#: or sums P V in bf16; limits as chip_smoke.py's PAGED_REL_TOL, set from
#: sound readings and those controls (PERF.md)
PAGED_REL_TOL = {BF16: 5e-3, F32: 1e-5}


def _assert_paged_close(out, args, kw, tol):
    """The active rows of ``out`` against the gather path: elementwise to
    ``tol`` in q's dtype, and to PAGED_REL_TOL over the whole in f32."""
    q, kp, vp, posp, table, pos_q = args
    active = pos_q[:, 0] >= 0
    ref = ops.paged_attention_gather(*args, **kw)
    torch.testing.assert_close(out[active].float(), ref[active].float(),
                               rtol=tol, atol=tol)
    ref32 = ops.paged_attention_gather(q.float(), kp.float(), vp.float(),
                                       posp, table, pos_q, **kw)[active]
    rel = float((out[active].float() - ref32).norm() / ref32.norm())
    assert rel <= PAGED_REL_TOL[q.dtype], rel


@pytest.mark.gpu
@pytest.mark.parametrize("case", PAGED_GPU_CASES,
                         ids=lambda c: "x".join(map(str, c[:7])) + "-"
                         + "-".join(str(t).split(".")[-1] for t in c[7:]))
def test_paged_kernel_matches_plain_on_gpu(case):
    """The kernel against the gather path (``ops.paged_attention_gather``,
    the port's path before the kernel) on the active rows, at the stated
    tolerances; zeros on the inactive row; one launch a call; the trash
    page's NaN never reaches an output."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernel has no CPU mode")
    *args, kw = _paged_gpu_inputs(case)
    before = pa.launches
    out = ops.paged_attention(*args, **kw)
    torch.cuda.synchronize()
    assert pa.launches == before + 1
    active = args[-1][:, 0] >= 0
    assert out.dtype == args[0].dtype and out.shape == args[0].shape
    assert bool(torch.isfinite(out).all())
    _assert_paged_close(out, args, kw, _paged_tol(case))
    assert not bool(out[~active].any())


@pytest.mark.gpu
def test_paged_kernel_split_is_bitwise_stable_and_matches_twin():
    """At granite's serve.long shape (16 ranges): two calls give the same
    bits (the merge runs in range order, no atomics), and the kernel
    matches its plain twin, ``paged_attention_split_plain``, run on the CPU
    copy of the inputs (f32 pools: 2e-5)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernel has no CPU mode")
    case = (64, 8, 2, 64, 256, 16, 0, F32, F32)
    *args, kw = _paged_gpu_inputs(case, seed=3)
    assert pa.page_split(64, 8, 2, 256, 16) == (16, 16)
    first = ops.paged_attention(*args, **kw)
    second = ops.paged_attention(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    twin = pa.paged_attention_split_plain(*(t.cpu() for t in args), **kw)
    torch.testing.assert_close(first.cpu(), twin, rtol=2e-5, atol=2e-5)


@pytest.mark.gpu
def test_paged_kernel_replays_in_a_cuda_graph():
    """The kernel captured in a CUDA graph at granite's serve.short shape,
    then replayed after the block table, the query positions, q and the
    pools change in place (slots freed and pages recycled, as the engine
    does): each replay equals an eager call on the same tensors, bit for
    bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernel has no CPU mode")
    case = (64, 8, 2, 64, 64, 16, 0, BF16, BF16)
    *args, kw = _paged_gpu_inputs(case, seed=4)
    q, kp, vp, posp, table, pos_q = args
    ops.paged_attention(*args, **kw)  # load the library before capture
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        out = ops.paged_attention(*args, **kw)
    for seed in (5, 6):
        *new, _ = _paged_gpu_inputs(case, seed=seed)
        for t, n in zip(args, new):
            t.copy_(n)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, ops.paged_attention(*args, **kw))


@pytest.mark.gpu
def test_paged_kernel_new_shape_adds_no_stream_sync():
    """A shape's first call (a new range split, scratch from torch.empty)
    launches without synchronising the stream, and still agrees (2e-2 and
    PAGED_REL_TOL)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernel has no CPU mode")
    case = (7, 2, 2, 64, 96, 16, 0, BF16, BF16)
    *args, kw = _paged_gpu_inputs(case, seed=7)
    ops.paged_attention(*_paged_gpu_inputs(PAGED_GPU_CASES[6])[:-1])
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = ops.paged_attention(*args, **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    _assert_paged_close(out, args, kw, 2e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "gemma-2b",
                                  "h2o-danube-1.8b"])
def test_paged_engine_counts_attention_launches(arch):
    """Over a served trace (nine requests on three slots, the decode block
    replayed as a CUDA graph) the engine's ``paged_attention_launches`` is
    the model's full-attention layers x its decode ticks: every tick of
    every block, eager, captured or replayed, runs the kernel once a layer
    (none for h2o-danube-1.8b, whose sliding-window layers keep rings)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the graph is captured only there")
    import numpy as np

    from repro_torch.launch.serve import Request

    cfg = smoke_config(arch)
    model = LanguageModel(cfg, device="cuda")
    eng = _recording_engine(model, model.init(0), eager=False)
    rng = np.random.RandomState(2)
    reqs = [Request(rid=i, prompt=rng.randint(0, cfg.vocab_size,
                                              rng.randint(5, 60)).tolist(),
                    max_new=int(rng.randint(4, 24)), arrival=4 * i)
            for i in range(9)]
    stats = eng.run(reqs)
    torch.cuda.synchronize()
    assert eng._graph is not None and stats["decode_ticks"] > 16
    layers = sum(t == "attn" for t in cfg.layer_types())
    assert stats["paged_attention_launches"] == layers * stats["decode_ticks"]
