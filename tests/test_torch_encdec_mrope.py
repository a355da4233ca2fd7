"""The port's encoder-decoder (whisper-medium) and M-RoPE (qwen2-vl-72b)
paths against the JAX package in f32, on the same numpy-seeded inputs and
weights.

Pieces: ``sinusoidal_positions`` (exactly), M-RoPE ``apply_rope`` with
three distinct coordinate streams, cross-attention (``apply_attention``
with ``cross=True``) in train, prefill (cross cache persisted), decode
(read from that cache) and chunked prefill, one ``xattn`` layer, and the
encoder.  Whole models at smoke width: whisper's ``train_loss`` (with its
gradients), ``prefill`` with ``frames`` and 8 ``decode_step``s; qwen2-vl's
``train_loss`` and ``prefill`` with ``embeds`` over a patch grid and
3-stream positions, then decode; qwen2-vl through both serving engines
against JAX's engines.  Neither package's engines pass encoder frames:
whisper through an engine fails, in JAX with a ``KeyError``, in the port
with a ``ValueError`` naming ``batch["frames"]``.

Bounds: the decode-parity suite's 2e-4 (train, prefill) and 3e-4 (decode,
chunked prefill), 1e-6 on rotary outputs of magnitude ~1; the train tests'
1e-5 relative on the loss and ``GRAD_TOL`` 2e-4 x max(1, max |g|) on the
gradients.  The flash dispatch runs the kernel's plain version here.
"""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.launch import serve as jserve  # noqa: E402
from repro.models import LanguageModel as JaxLM  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.models.layers import split  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch.train import train  # noqa: E402
from repro_torch.models import LanguageModel  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import transformer as ttfm  # noqa: E402
from repro_torch.utils import tree_flatten, tree_leaves, tree_map  # noqa: E402

PREFILL_TOL = dict(rtol=2e-4, atol=2e-4)
DECODE_TOL = dict(rtol=3e-4, atol=3e-4)
GRAD_TOL = 2e-4
B, S, S_ENC = 2, 12, 10


def _configs(arch, **kw):
    name = arch.replace("-", "_").replace(".", "_")
    kw.setdefault("compute_dtype", "float32")
    return tuple(importlib.import_module(f"{pkg}.configs.{name}").smoke()
                 .scaled(**kw) for pkg in ("repro", "repro_torch"))


def _moved(vals, seed=0):
    """Numpy copies of ``vals``, each moved by 0.05 x a seeded normal (norm
    scales and biases sit off their init values)."""
    rng = np.random.RandomState(seed)
    return jax.tree.map(lambda a: (np.asarray(a) + 0.05 * rng.standard_normal(
        a.shape)).astype(np.float32), vals)


def _rand(*shape, seed=0, scale=1.0):
    return (scale * np.random.RandomState(seed).standard_normal(shape)
            ).astype(np.float32)


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _t(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _assert_tree(ttree, jtree, tol, what):
    for (path, t), j in zip(tree_flatten(ttree), jax.tree.leaves(jtree)):
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                                   err_msg=f"{what} {path}", **tol)


def _mrope_positions(n_text=3, grid=3, n_after=3, batch=B):
    """(3, B, S) int32 M-RoPE coordinates of ``n_text`` text tokens, a
    ``grid`` x ``grid`` patch grid, then ``n_after`` text tokens.  The
    temporal stream is each token's index (the reference's masks and cache
    slots read it, so it stays unique); height and width carry the patch
    grid's rows and columns from where the text left off, and equal the
    temporal stream on text."""
    S_ = n_text + grid * grid + n_after
    t = np.arange(S_)
    h, w = t.copy(), t.copy()
    r, c = np.divmod(np.arange(grid * grid), grid)
    h[n_text:n_text + grid * grid] = n_text + r
    w[n_text:n_text + grid * grid] = n_text + c
    pos = np.stack([t, h, w]).astype(np.int32)
    return np.broadcast_to(pos[:, None], (3, batch, S_)).copy()


# ------------------------------------------------------------------ layers


@pytest.mark.parametrize("seq,d", [(1500, 1024), (24, 64), (7, 16)])
def test_sinusoidal_positions_match_jax_exactly(seq, d):
    """whisper-medium's 1500 frames at d 1024, and the smoke widths: equal
    bits in f32, and in bf16 (both round the float64 table once)."""
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        ref = np.asarray(jlayers.sinusoidal_positions(seq, d, jdt)
                         .astype(jnp.float32))
        got = tlayers.sinusoidal_positions(seq, d, tdt).float().numpy()
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("arch_kw", [{}, {"d_model": 256, "n_heads": 2,
                                          "n_kv_heads": 1, "head_dim": 128,
                                          "mrope_sections": (16, 24, 24)}],
                         ids=["smoke", "full_head"])
def test_mrope_apply_rope_matches_jax(arch_kw):
    """Three distinct coordinate streams over a patch grid: each section of
    frequency pairs (smoke 2/3/3 of 8; qwen2-vl-72b's 16/24/24 of its
    128-dim head) takes its own stream, at 1e-6."""
    jcfg, tcfg = _configs("qwen2-vl-72b", **arch_kw)
    pos = _mrope_positions(n_text=5, grid=4, n_after=3)
    x = _rand(B, pos.shape[-1], 3, jcfg.head_dim, seed=2)
    ref = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), jcfg)
    got = tlayers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)
    with pytest.raises(ValueError, match="M-RoPE"):
        tlayers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos[0]), tcfg)


def test_mrope_equal_streams_are_plain_rope():
    """Equal streams (what ``_positions`` builds) rotate as 1-D RoPE does."""
    _, tcfg = _configs("qwen2-vl-72b")
    pos = torch.arange(S, dtype=torch.int32).expand(B, S)
    x = torch.from_numpy(_rand(B, S, 3, tcfg.head_dim, seed=3))
    got = tlayers.apply_rope(x, pos.expand(3, B, S), tcfg)
    ref = tlayers.apply_rope(x, pos, tcfg.scaled(pos_type="rope"))
    torch.testing.assert_close(got, ref, rtol=0, atol=0)


def _cross_setup(seed=0):
    jcfg, tcfg = _configs("whisper-medium")
    vals = _moved(split(jattn.init_attention(jax.random.PRNGKey(seed), jcfg,
                                             cross=True))[0], seed)
    enc = _rand(B, S_ENC, jcfg.d_model, seed=seed + 1)
    enc_pos = np.broadcast_to(np.arange(S_ENC, dtype=np.int32),
                              (B, S_ENC)).copy()
    return jcfg, tcfg, vals, enc, enc_pos


def _kv_cache(jcfg, size, seed=5, filled=0):
    """A (B, size) KV cache as numpy: positions 0..filled-1 hold random
    keys and values, the rest is empty (pos -1, zeros)."""
    shape = (B, size, jcfg.n_kv_heads, jcfg.head_dim)
    k, v = _rand(*shape, seed=seed), _rand(*shape, seed=seed + 1)
    pos = np.full((B, size), -1, np.int32)
    pos[:, :filled] = np.arange(filled)
    k[pos < 0] = 0.0
    v[pos < 0] = 0.0
    return {"k": k, "v": v, "pos": pos}


@pytest.mark.parametrize("mode", ["train", "prefill", "prefill_flash",
                                  "chunk_prefill", "decode"])
def test_cross_attention_matches_jax(mode, monkeypatch):
    """Cross-attention over the encoder output: train (no cache), prefill
    (K and V persisted in the cross cache; through the flash dispatch when
    the positions are contiguous, once, non-causal, over all S_ENC frames),
    chunked prefill (K and V recomputed and persisted again) and decode (K
    and V read from a persisted cache, one slot inactive).  Outputs and
    caches against JAX."""
    jcfg, tcfg, vals, enc, enc_pos = _cross_setup()
    calls = []
    real = kops.flash_attention
    monkeypatch.setattr(kops, "flash_attention", lambda *a, **kw: (
        calls.append((a[0].shape, a[1].shape, kw)), real(*a, **kw))[1])
    Sq = 1 if mode == "decode" else S
    x = _rand(B, Sq, jcfg.d_model, seed=3)
    pos = (np.full((B, 1), 7, np.int32) if mode == "decode"
           else np.broadcast_to(np.arange(Sq, dtype=np.int32), (B, Sq)).copy())
    jmode = "prefill" if mode == "prefill_flash" else mode
    cache = None
    if mode == "decode":  # a cross cache a prefill persisted, frames 0..9
        cache = _kv_cache(jcfg, 16, filled=S_ENC)
    elif mode != "train":
        cache = _kv_cache(jcfg, 16)
    cache_pos = np.array([7, -1], np.int32)
    jctx = jattn.ModelCtx(mode=jmode, positions=jnp.asarray(pos),
                          cache_pos=jnp.asarray(cache_pos),
                          enc_out=jnp.asarray(enc),
                          enc_positions=jnp.asarray(enc_pos))
    ref, jcache = jattn.apply_attention(
        _j(vals), jcfg, jnp.asarray(x), jctx,
        None if cache is None else _j(cache), cross=True)
    tctx = tattn.ModelCtx(mode=jmode, positions=torch.from_numpy(pos),
                          cache_pos=torch.from_numpy(cache_pos),
                          enc_out=torch.from_numpy(enc),
                          enc_positions=torch.from_numpy(enc_pos),
                          contiguous=mode == "prefill_flash")
    out, tcache = tattn.apply_attention(
        _t(vals), tcfg, torch.from_numpy(x), tctx,
        None if cache is None else _t(cache), cross=True)
    tol = DECODE_TOL if mode in ("decode", "chunk_prefill") else PREFILL_TOL
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **tol)
    if cache is not None:
        _assert_tree(tcache, jcache, tol, "cross cache")
    if mode == "prefill_flash":
        (qs, ks, kw), = calls
        assert qs[1] == S and ks[1] == S_ENC and kw["causal"] is False
    else:
        assert not calls


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_xattn_layer_matches_jax(mode):
    """One decoder layer (self-attention, cross-attention, MLP, three
    layernorms) with both caches: train, prefill (self and cross caches
    written) and a decode step on the prefilled caches."""
    jcfg, tcfg = _configs("whisper-medium")
    kind = ("xattn", False)
    vals = _moved(split(jtfm.init_layer(jax.random.PRNGKey(2), jcfg, kind))[0])
    assert set(vals) == {"norm1", "core", "norm_x", "cross", "norm2", "mlp"}
    enc = _rand(B, S_ENC, jcfg.d_model, seed=4)
    enc_pos = np.broadcast_to(np.arange(S_ENC, dtype=np.int32),
                              (B, S_ENC)).copy()
    x = _rand(B, S, jcfg.d_model, seed=5)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()

    def ctxs(m, p, cache_pos=None):
        """The same context for both packages, from numpy arrays."""
        arrays = dict(positions=p, enc_out=enc, enc_positions=enc_pos)
        if cache_pos is not None:
            arrays["cache_pos"] = cache_pos
        return (jattn.ModelCtx(mode=m, **{k: jnp.asarray(v)
                                          for k, v in arrays.items()}),
                tattn.ModelCtx(mode=m, **{k: torch.from_numpy(v)
                                          for k, v in arrays.items()}))

    cache = None
    if mode != "train":
        cache = {"self": _kv_cache(jcfg, 16), "cross": _kv_cache(jcfg, 16)}
    jctx, tctx = ctxs("train" if mode == "train" else "prefill", pos)
    ref, jcache, _ = jtfm.apply_layer(_j(vals), jcfg, kind, jnp.asarray(x),
                                      None if cache is None else _j(cache),
                                      jctx)
    tp = _t(vals)
    out, tcache, aux = ttfm.apply_layer(tp, tcfg, kind, torch.from_numpy(x),
                                        None if cache is None else _t(cache),
                                        tctx)
    assert aux == 0.0
    if mode != "decode":
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), **PREFILL_TOL)
        if cache is not None:
            _assert_tree(tcache, jcache, PREFILL_TOL, "xattn cache")
        return
    x1 = _rand(B, 1, jcfg.d_model, seed=6)
    cache_pos = np.array([S, S], np.int32)
    jctx, tctx = ctxs("decode", cache_pos[:, None].copy(), cache_pos=cache_pos)
    ref, jcache, _ = jtfm.apply_layer(_j(vals), jcfg, kind, jnp.asarray(x1),
                                      jcache, jctx)
    out, tcache, _ = ttfm.apply_layer(tp, tcfg, kind, torch.from_numpy(x1),
                                      tcache, tctx)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **DECODE_TOL)
    _assert_tree(tcache, jcache, DECODE_TOL, "xattn cache")


# ------------------------------------------------------------ whole models


def _models(arch, seed=0):
    """(JAX model, JAX params, port model, port params): the JAX init moved
    by 0.05 x a seeded normal, bridged."""
    jcfg, tcfg = _configs(arch)
    jm = JaxLM(jcfg)
    tree = _moved(jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(seed))),
                  seed)
    tm = LanguageModel(tcfg, device="cpu")
    return jm, _j(tree), tm, params_from_numpy(tree, tcfg, "cpu"), tree


def _extra(arch, n=S, batch=B, seed=7):
    """The inputs beside the tokens: whisper's frames (B, S_ENC, d);
    qwen2-vl's embeds (B, n, d) and the patch grid's 3-stream positions."""
    jcfg, _ = _configs(arch)
    if jcfg.enc_dec:
        return {"frames": _rand(batch, S_ENC, jcfg.d_model, seed=seed)}
    pos = _mrope_positions(n_text=3, grid=3, n_after=n - 12, batch=batch)
    return {"embeds": _rand(batch, n, jcfg.d_model, seed=seed, scale=0.02),
            "positions": pos}


@pytest.mark.parametrize("arch", ["whisper-medium", "qwen2-vl-72b"])
def test_encoder_decoder_and_mrope_train_loss_match_jax(arch):
    """``train_loss`` with frames (whisper) or with embeds and 3-stream
    positions (qwen2-vl), a few zero weights: the loss within 1e-5
    relative, every gradient leaf (the encoder's, ``pos_embed``'s) within
    GRAD_TOL x max(1, max |g|)."""
    jm, jp, tm, tp, _ = _models(arch)
    rng = np.random.RandomState(1)
    tokens = rng.randint(0, jm.cfg.vocab_size, (B, S)).astype(np.int32)
    weights = np.ones((B, S), np.float32)
    weights[0, :3] = 0.0
    batch = dict(tokens=tokens, targets=np.roll(tokens, -1, 1),
                 weights=weights, **_extra(arch))
    fn = jax.value_and_grad(jm.train_loss, has_aux=True)
    (_, jmetrics), jgrads = fn(jp, _j(batch))
    params = tree_map(lambda t: t.requires_grad_(True), tp)
    total, metrics = tm.train_loss(params, _t(batch))
    np.testing.assert_allclose(metrics["loss"].item(),
                               float(jmetrics["loss"]), rtol=1e-5)
    np.testing.assert_allclose(total.item(), float(jmetrics["total_loss"]),
                               rtol=1e-5)
    # with embeds the token table is unused: JAX's gradient there is 0
    grads = torch.autograd.grad(total, tree_leaves(params), allow_unused=True,
                                materialize_grads=True)
    ref = jax.tree.leaves(jgrads)
    assert len(grads) == len(ref)
    for (path, _), g, r in zip(tree_flatten(params), grads, ref):
        r = np.asarray(r)
        tol = GRAD_TOL * max(1.0, float(np.abs(r).max()))
        np.testing.assert_allclose(g.numpy(), r, rtol=0, atol=tol,
                                   err_msg=f"{arch}: grad {path}")


@pytest.mark.parametrize("arch", ["whisper-medium", "qwen2-vl-72b"])
def test_train_steps_with_frames_or_embeds_match_jax(arch):
    """Three steps of the port's ``make_train_step`` against JAX's jitted
    step on batches that carry frames (whisper) or embeds and 3-stream
    positions (qwen2-vl, whose token table then gets a zero gradient and
    only the weight decay): loss within 1e-4 each step, as
    tests/test_torch_train.py bounds five plain steps."""
    from repro.launch.train import make_train_step as jax_make_train_step
    from repro.optim import AdamW as JaxAdamW
    from repro.optim import OptConfig as JaxOptConfig
    from repro_torch.launch.train import make_train_step
    from repro_torch.optim import AdamW, OptConfig

    jm, jp, tm, tp, _ = _models(arch)
    kw = dict(peak_lr=3e-3, warmup_steps=2, decay_steps=10)
    jstep = jax_make_train_step(jm, JaxAdamW(JaxOptConfig(**kw)))
    jstate = JaxAdamW(JaxOptConfig(**kw)).init(jp)
    opt = AdamW(OptConfig(**kw))
    step, state = make_train_step(tm, opt), opt.init(tp)
    rng = np.random.RandomState(5)
    for i in range(3):
        tokens = rng.randint(0, jm.cfg.vocab_size, (B, S)).astype(np.int32)
        batch = dict(tokens=tokens, targets=np.roll(tokens, -1, 1),
                     **_extra(arch, seed=i))
        jp, jstate, jmetrics = jstep(jp, jstate, _j(batch))
        tp, state, metrics = step(tp, state, _t(batch))
        assert abs(float(metrics["loss"]) - float(jmetrics["loss"])) < 1e-4, i
    _assert_tree(tp, jp, dict(rtol=0, atol=1e-4), f"{arch} params")


@pytest.mark.parametrize("arch", ["whisper-medium", "qwen2-vl-72b"])
def test_prefill_then_decode_matches_jax(arch):
    """``prefill`` (with frames; with embeds and 3-stream positions), then
    8 ``decode_step``s fed JAX's greedy tokens: logits at 2e-4 and 3e-4,
    and the final caches."""
    jm, jp, tm, tp, _ = _models(arch)
    rng = np.random.RandomState(2)
    tokens = rng.randint(0, jm.cfg.vocab_size, (B, S)).astype(np.int32)
    batch = dict(tokens=tokens, **_extra(arch))
    max_len = S + 8
    jcache = jm.init_cache(B, max_len, enc_len=S_ENC, dtype=jnp.float32)
    ref, jcache = jax.jit(jm.prefill)(jp, _j(batch), jcache)
    tcache = tm.init_cache(B, max_len, enc_len=S_ENC, dtype=torch.float32)
    out, tcache = tm.prefill(tp, _t(batch), tcache)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **PREFILL_TOL)
    step = jax.jit(jm.decode_step)
    for t in range(S, S + 8):
        tok = np.array(jnp.argmax(ref, -1), np.int32)[:, None]
        pos = np.full((B,), t, np.int32)
        ref, jcache = step(jp, jnp.asarray(tok), jcache, jnp.asarray(pos))
        out, tcache = tm.decode_step(tp, torch.from_numpy(tok), tcache,
                                     torch.from_numpy(pos))
        np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                                   err_msg=f"{arch}: decode step {t}",
                                   **DECODE_TOL)
    _assert_tree(tcache, jcache, DECODE_TOL, f"{arch} cache")


def test_encoder_matches_jax_on_both_paths():
    """``_encode`` through the flash dispatch (``contiguous``, a full
    prefill's) and plain (training's, chunked prefill's): both equal JAX's
    encoder output at 2e-4, and only the first calls the dispatch, once a
    layer, non-causal."""
    jm, jp, tm, tp, _ = _models("whisper-medium")
    frames = _rand(B, S_ENC, jm.cfg.d_model, seed=8)
    ref, ref_pos = jm._encode(jp, jnp.asarray(frames))
    calls = []
    real = kops.flash_attention

    def counting(*a, **kw):
        calls.append(kw["causal"])
        return real(*a, **kw)

    kops.flash_attention, saved = counting, kops.flash_attention
    try:
        for contiguous in (True, False):
            out, pos = tm._encode(tp, torch.from_numpy(frames), contiguous)
            np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                                       **PREFILL_TOL)
            np.testing.assert_array_equal(pos.numpy(), np.asarray(ref_pos))
    finally:
        kops.flash_attention = saved
    assert calls == [False] * tm.cfg.n_enc_layers


def test_flash_dispatch_counts(monkeypatch):
    """whisper's full prefill calls the flash dispatch three times a layer
    (encoder, self, cross); with positions given, in chunked prefill, in
    decode and in ``train_loss`` never.  qwen2-vl's full prefill calls it
    once a layer; with 3-stream positions given never."""
    calls = []
    real = kops.flash_attention
    monkeypatch.setattr(kops, "flash_attention",
                        lambda *a, **kw: (calls.append(1), real(*a, **kw))[1])
    for arch, per_prefill in (("whisper-medium", 3), ("qwen2-vl-72b", 1)):
        _, _, tm, tp, _ = _models(arch)
        L = tm.cfg.n_layers
        tokens = torch.from_numpy(np.random.RandomState(3).randint(
            0, tm.cfg.vocab_size, (B, S)).astype(np.int32))
        extra = _t(_extra(arch))
        plain = dict(extra)
        given = plain.pop("positions", None)
        calls.clear()
        cache = tm.init_cache(B, S + 2, enc_len=S_ENC, dtype=torch.float32)
        tm.prefill(tp, {"tokens": tokens, **plain}, cache)
        assert len(calls) == per_prefill * L
        if given is None:
            given = tm._positions(B, S, None)
        cache = tm.init_cache(B, S + 2, enc_len=S_ENC, dtype=torch.float32)
        tm.prefill(tp, {"tokens": tokens, **plain, "positions": given}, cache)
        frames = {k: v for k, v in plain.items() if k == "frames"}
        tm.prefill_chunk(tp, {"tokens": tokens[:, :4], **frames}, cache,
                         torch.zeros((B,), dtype=torch.int32))
        tm.decode_step(tp, tokens[:, :1], cache,
                       torch.full((B,), S, dtype=torch.int32))
        tm.train_loss(tp, {"tokens": tokens, "targets": tokens, **extra})
        assert len(calls) == per_prefill * L, arch


def test_paged_chunked_prefill_with_frames_matches_jax():
    """whisper through the paged cache's slot view: chunked prefill with
    frames (the cross cache rewritten each chunk), then paged decode with
    slot 0 inactive, against JAX on the same pool (enc_len S_ENC)."""
    from repro.launch.paged_kv import PagedKVCache as JaxKV
    from repro_torch.launch.paged_kv import PagedKVCache, decompose

    jm, jp, tm, tp, _ = _models("whisper-medium")
    rng = np.random.RandomState(4)
    tokens = rng.randint(0, jm.cfg.vocab_size, (1, 20)).astype(np.int32)
    frames = _rand(1, S_ENC, jm.cfg.d_model, seed=9)
    jkv = JaxKV(jm, n_slots=2, n_pages=8, page_size=8, max_pages=4,
                enc_len=S_ENC, dtype=jnp.float32)
    tkv = PagedKVCache(tm, n_slots=2, n_pages=8, page_size=8, max_pages=4,
                       enc_len=S_ENC, dtype=torch.float32)
    for kv in (jkv, tkv):
        assert kv.alloc(0, 10) and kv.alloc(1, 22)
    start = 0
    for c in decompose(12, 8):
        chunk = {"tokens": tokens[:, start:start + c], "frames": frames}
        view = jkv.gather_slot(1)
        ref, view = jm.prefill_chunk(jp, _j(chunk), view,
                                     jnp.full((1,), start, jnp.int32))
        jkv.scatter_slot(1, view)
        view = tkv.gather_slot(1)
        out, view = tm.prefill_chunk(tp, _t(chunk), view,
                                     torch.full((1,), start, dtype=torch.int32))
        tkv.scatter_slot(1, view)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), **DECODE_TOL)
        start += c
    for t in range(12, 20):
        toks = np.zeros((2, 1), np.int32)
        toks[1, 0] = tokens[0, t]
        pos = np.array([-1, t], np.int32)
        ref, jkv.cache = jm.decode_step(jp, jnp.asarray(toks), jkv.cache,
                                        jnp.asarray(pos), table=jkv.table)
        out, tkv.cache = tm.decode_step(tp, torch.from_numpy(toks), tkv.cache,
                                        torch.from_numpy(pos), table=tkv.table)
        np.testing.assert_allclose(out[1:].numpy(), np.asarray(ref[1:]),
                                   err_msg=f"paged decode step {t}",
                                   **DECODE_TOL)


def test_multimodal_prefill_past_the_grid_then_decode_is_finite():
    """A prompt that is all patches (a 4 x 4 grid of embeds, distinct
    streams) then 8 decode steps at smoke width: logits against JAX and
    finite; the cache holds the 16 patch positions (temporal stream)."""
    jm, jp, tm, tp, _ = _models("qwen2-vl-72b")
    pos = _mrope_positions(n_text=0, grid=4, n_after=0, batch=1)
    n = pos.shape[-1]
    batch = {"tokens": np.zeros((1, n), np.int32),
             "embeds": _rand(1, n, jm.cfg.d_model, seed=10, scale=0.02),
             "positions": pos}
    jcache = jm.init_cache(1, n + 8, dtype=jnp.float32)
    ref, jcache = jm.prefill(jp, _j(batch), jcache)
    tcache = tm.init_cache(1, n + 8, dtype=torch.float32)
    out, tcache = tm.prefill(tp, _t(batch), tcache)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **PREFILL_TOL)
    assert sorted(tcache["seg0"]["sub0"]["pos"][0, 0].tolist())[-n:] == \
        list(range(n))
    for t in range(n, n + 8):
        tok = np.array(jnp.argmax(ref, -1), np.int32)[:, None]
        ref, jcache = jm.decode_step(jp, jnp.asarray(tok), jcache,
                                     jnp.full((1,), t, jnp.int32))
        out, tcache = tm.decode_step(tp, torch.from_numpy(tok), tcache,
                                     torch.full((1,), t, dtype=torch.int32))
        assert bool(torch.isfinite(out).all())
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), **DECODE_TOL)


# ----------------------------------------------------------------- engines

PAGED = dict(n_slots=3, max_len=64, page_size=8, chunk_max=8, drain_every=4)
LENS = [3, 9, 5, 13, 4, 11, 6]


def _trace(mk, vocab, seed=3):
    """tests/test_serving.py's ragged trace: mixed prompt lengths,
    staggered arrivals, ragged max_new."""
    rng = np.random.RandomState(seed)
    return [mk(rid=i, prompt=rng.randint(0, vocab, LENS[i]).tolist(),
               max_new=3 + (i % 4) * 2, arrival=2 * i)
            for i in range(len(LENS))]


def test_qwen2_vl_engines_match_jax_engines():
    """qwen2-vl smoke through both engines (positions broadcast to three
    equal streams inside the model): the same greedy tokens as JAX's
    engines, and the same counters."""
    jm, _, tm, tp, tree = _models("qwen2-vl-72b")
    jp = _j(tree)
    vocab = jm.cfg.vocab_size
    jreqs = _trace(jserve.Request, vocab)
    jstats = jserve.PagedServingEngine(jm, jp, dtype=jnp.float32,
                                       **PAGED).run(jreqs)
    reqs = _trace(tserve.Request, vocab)
    eng = tserve.PagedServingEngine(tm, tp, dtype=torch.float32, **PAGED)
    stats = eng.run(reqs)
    assert [r.out for r in reqs] == [r.out for r in jreqs]
    assert all(r.done and not r.rejected for r in reqs)
    assert eng.kv.stats().pages_in_use == 0
    for key in ("host_syncs", "decode_ticks", "drains", "prefill_chunks",
                "ticks"):
        assert stats[key] == jstats[key], key
    jreqs = _trace(jserve.Request, vocab)
    jstats = jserve.ContinuousBatcher(jm, jp, n_slots=3, max_len=64,
                                      enc_len=0).run(jreqs)
    dreqs = _trace(tserve.Request, vocab)
    stats = tserve.ContinuousBatcher(tm, tp, n_slots=3, max_len=64,
                                     enc_len=0).run(dreqs)
    assert [r.out for r in dreqs] == [r.out for r in jreqs] == \
        [r.out for r in reqs]
    for key in ("tokens", "ticks", "host_syncs"):
        assert stats[key] == jstats[key], key


@pytest.mark.parametrize("engine", ["paged", "dense"])
def test_whisper_through_an_engine_fails_clearly(engine):
    """Neither package's engines pass frames: JAX's fail with a KeyError
    on ``batch["frames"]``, the port's with a ValueError that names it;
    so does the port's ``train``, at start."""
    jm, jp, tm, tp, _ = _models("whisper-medium")
    req = dict(rid=0, prompt=[1, 2, 3], max_new=2)
    if engine == "paged":
        jeng = jserve.PagedServingEngine(jm, jp, dtype=jnp.float32,
                                         enc_len=S_ENC, **PAGED)
        teng = tserve.PagedServingEngine(tm, tp, dtype=torch.float32,
                                         enc_len=S_ENC, **PAGED)
    else:
        jeng = jserve.ContinuousBatcher(jm, jp, n_slots=2, max_len=32,
                                        enc_len=S_ENC)
        teng = tserve.ContinuousBatcher(tm, tp, n_slots=2, max_len=32,
                                        enc_len=S_ENC)
    with pytest.raises(KeyError, match="frames"):
        jeng.run([jserve.Request(**req)])
    with pytest.raises(ValueError, match=r"batch\['frames'\]"):
        teng.run([tserve.Request(**req)])
    with pytest.raises(ValueError, match="frames"):
        train(arch="whisper-medium", steps=1, global_batch=2, seq_len=8,
              device="cpu")
