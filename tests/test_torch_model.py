"""The port's LanguageModel against the JAX package on the same weights.

gemma-2b (MQA, head_dim 32 at smoke size), deepseek-7b (MHA),
h2o-danube-1.8b (GQA with a 16-token sliding window: ring caches that wrap,
slot-dense leaves in the paged cache), rwkv6-1.6b (pure recurrence: the
WKV scan in prefill, per-slot states in the paged cache) and
recurrentgemma-9b (RG-LRU, RG-LRU, local attention: the 4-layer smoke, all
unrolled, and a 7-layer one whose first 6 layers form a scanned segment of
stacked RG-LRU leaves), minicpm3-4b (MLA: latent caches, slot-dense in the
paged cache), granite-moe-1b-a400m (MoE, 4 experts top-2 at smoke width)
deepseek-v2-236b (MLA + MoE + a shared expert after a dense first
layer), whisper-medium (encoder-decoder: frames through a sinusoidal
encoder, learned decoder positions, cross caches) and qwen2-vl-72b (M-RoPE,
its three streams equal here) smoke configs in f32 compute, JAX weights
carried across with ``repro_torch.bridge``.  Each case reproduces a
``tests/test_decode_parity.py`` test against the JAX full forward, at that
file's bounds: 2e-4 on prefill logits, 3e-4 on decode logits.  The banded
sliding-window path (prompts longer than window + q-chunk) is held against
JAX at danube's smoke width.
"""
import functools
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import LanguageModel as JaxLM  # noqa: E402
from repro.models.attention import ModelCtx as JaxCtx  # noqa: E402
from repro_torch.bridge import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.launch.paged_kv import PagedKVCache, decompose  # noqa: E402
from repro_torch.models import LanguageModel  # noqa: E402
from repro_torch.models.attention import ModelCtx  # noqa: E402
from repro_torch.utils import tree_map  # noqa: E402

ATTN_ARCHS = ["gemma-2b", "deepseek-7b", "h2o-danube-1.8b"]
#: "arch@L": the arch's smoke config at L layers
RG_ARCHS = ["recurrentgemma-9b", "recurrentgemma-9b@7"]
MLA_MOE_ARCHS = ["minicpm3-4b", "granite-moe-1b-a400m", "deepseek-v2-236b"]
ENCDEC_MROPE_ARCHS = ["whisper-medium", "qwen2-vl-72b"]
ARCHS = (ATTN_ARCHS + ["rwkv6-1.6b"] + RG_ARCHS + MLA_MOE_ARCHS
         + ENCDEC_MROPE_ARCHS)
B, S = 2, 24


def _smoke(pkg, arch):
    arch, _, layers = arch.partition("@")
    name = arch.replace("-", "_").replace(".", "_")
    cfg = importlib.import_module(f"{pkg}.configs.{name}").smoke()
    return cfg.scaled(n_layers=int(layers)) if layers else cfg


def _configs(arch):
    return (_smoke("repro", arch).scaled(compute_dtype="float32"),
            _smoke("repro_torch", arch).scaled(compute_dtype="float32"))


def _moved_rglru(tree, seed=0):
    """Every leaf moved by 0.05 x a seeded normal, ``conv_w`` drawn at
    0.5 x a normal: JAX inits the RG-LRU conv to zeros, which zeros every
    RG-LRU output and would let the block pass untested."""
    rng = np.random.RandomState(seed)

    def move(path, a):
        if path[-1].key == "conv_w":
            return (0.5 * rng.standard_normal(a.shape)).astype(a.dtype)
        return (a + 0.05 * rng.standard_normal(a.shape)).astype(a.dtype)

    return jax.tree_util.tree_map_with_path(move, tree)


@functools.lru_cache(maxsize=None)
def _frames(arch):
    """An encoder-decoder arch's frames (B, S, d), as
    test_decode_parity.py draws them; {} for the others."""
    cfg = _smoke("repro", arch)
    if not cfg.enc_dec:
        return {}
    rng = np.random.RandomState(1)
    return {"frames": rng.randn(B, S, cfg.d_model).astype(np.float32)}


def _extra(arch, rows=B):
    """The port's batch entries beside the tokens (whisper's frames)."""
    return {k: torch.from_numpy(v[:rows]) for k, v in _frames(arch).items()}


@functools.lru_cache(maxsize=None)
def _setup(arch):
    """(port model, bridged params, tokens, JAX full-forward logits)."""
    jcfg, tcfg = _configs(arch)
    jmodel = JaxLM(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    if arch in RG_ARCHS:
        jparams = jax.tree.map(jnp.asarray, _moved_rglru(
            jax.tree.map(np.asarray, jparams)))
    rng = np.random.RandomState(0)
    tokens = rng.randint(0, jcfg.vocab_size, (B, S)).astype(np.int32)

    def full_logits(p):
        pos = jmodel._positions(B, S, None)
        ctx = JaxCtx(mode="train", positions=pos)
        if jcfg.enc_dec:
            enc_out, enc_pos = jmodel._encode(
                p, jnp.asarray(_frames(arch)["frames"]))
            ctx = JaxCtx(mode="train", positions=pos, enc_out=enc_out,
                         enc_positions=enc_pos)
        x = jmodel._embed(p, jnp.asarray(tokens))
        if jcfg.pos_type == "learned":
            x = x + jnp.take(p["pos_embed"], pos, axis=0).astype(x.dtype)
        x, _, _ = jmodel._backbone(p, x, None, ctx)
        return jmodel._head(p, x)

    ref = np.asarray(jax.jit(full_logits)(jparams))  # (B, S, V)
    model = LanguageModel(tcfg, device="cpu")
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg, "cpu")
    return model, params, tokens, ref


@pytest.mark.parametrize("arch", ARCHS)
def test_full_forward_matches_jax(arch):
    """The port's train-mode backbone (plain attention) is the JAX one."""
    model, params, tokens, ref = _setup(arch)
    t = torch.from_numpy(tokens)
    pos = model._positions(B, S, None)
    ctx = model._ctx(params, {"tokens": t, **_extra(arch)}, False,
                     mode="train", positions=pos)
    x = model._add_positions(params, model._embed(params, t), pos)
    x, _, _ = model._backbone(params, x, None, ctx)
    np.testing.assert_allclose(model._head(params, x).numpy(), ref,
                               rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_full_forward(arch):
    """test_decode_parity.py::test_decode_matches_full_forward on the port:
    prefill the first half (flash path), decode the rest token by token."""
    model, params, tokens, ref = _setup(arch)
    t = torch.from_numpy(tokens)
    S0 = S // 2
    cache = model.init_cache(B, max_len=S, enc_len=S, dtype=torch.float32)
    logits, cache = model.prefill(params, {"tokens": t[:, :S0],
                                           **_extra(arch)}, cache)
    np.testing.assert_allclose(logits.numpy(), ref[:, S0 - 1], rtol=2e-4,
                               atol=2e-4)
    for step in range(S0, S):
        pos = torch.full((B,), step, dtype=torch.int32)
        logits, cache = model.decode_step(params, t[:, step:step + 1], cache, pos)
        np.testing.assert_allclose(
            logits.numpy(), ref[:, step], rtol=3e-4, atol=3e-4,
            err_msg=f"{arch}: decode step {step} diverged from full forward")


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_chunked_decode_matches_full_forward(arch):
    """test_decode_parity.py::test_paged_chunked_decode_matches_full_forward
    on the port: chunked prefill through slot 1's view of a 2-slot pool
    (slot 0 pre-allocated, so logical pages != physical pages), then paged
    decode through the block table with slot 0 inactive."""
    model, params, tokens, ref = _setup(arch)
    t = torch.from_numpy(tokens[:1])
    kv = PagedKVCache(model, n_slots=2, n_pages=8, page_size=8, max_pages=4,
                      enc_len=S if model.cfg.enc_dec else 0,
                      dtype=torch.float32)
    assert kv.alloc(0, 10) and kv.alloc(1, S + 2)
    S0 = S // 2
    start = 0
    logits = None
    for c in decompose(S0, 8):
        view = kv.gather_slot(1)
        logits, view = model.prefill_chunk(
            params, {"tokens": t[:, start:start + c], **_extra(arch, 1)}, view,
            torch.full((1,), start, dtype=torch.int32))
        kv.scatter_slot(1, view)
        start += c
    np.testing.assert_allclose(logits.numpy(), ref[:1, S0 - 1], rtol=2e-4,
                               atol=2e-4, err_msg=f"{arch}: chunked prefill")
    for step in range(S0, S):
        toks = torch.zeros((2, 1), dtype=torch.int32)
        toks[1, 0] = t[0, step]
        pos = torch.tensor([-1, step], dtype=torch.int32)  # slot 0 inactive
        logits, kv.cache = model.decode_step(params, toks, kv.cache, pos,
                                             table=kv.table)
        np.testing.assert_allclose(
            logits[1:].numpy(), ref[:1, step], rtol=3e-4, atol=3e-4,
            err_msg=f"{arch}: paged decode step {step} diverged")


@pytest.mark.parametrize("arch", ATTN_ARCHS + RG_ARCHS[:1] + MLA_MOE_ARCHS[:2]
                         + ["qwen2-vl-72b"])
def test_prefill_takes_flash_path(arch, monkeypatch):
    """Full prefill with implicit positions calls the flash dispatch once per
    attention layer; explicit positions and chunked prefill never do."""
    model, params, tokens, _ = _setup(arch)
    calls = []
    real = kops.flash_attention

    def counting(*a, **kw):
        calls.append(a[0].shape)
        return real(*a, **kw)

    monkeypatch.setattr(kops, "flash_attention", counting)
    t = torch.from_numpy(tokens)
    cache = model.init_cache(B, max_len=S, dtype=torch.float32)
    model.prefill(params, {"tokens": t}, cache)
    n_attn = sum(k in ("attn", "swa") for k in model.cfg.layer_types())
    assert len(calls) == n_attn > 0
    pos = model._positions(B, S, None)
    cache = model.init_cache(B, max_len=S, dtype=torch.float32)
    model.prefill(params, {"tokens": t, "positions": pos}, cache)
    model.prefill_chunk(params, {"tokens": t[:, :4]}, cache,
                        torch.zeros((B,), dtype=torch.int32))
    assert len(calls) == n_attn


def test_prefill_takes_wkv_kernel_path(monkeypatch):
    """Full and chunked prefill call the WKV scan dispatch once per rwkv
    layer; decode steps never do (they run the per-step recurrence)."""
    model, params, tokens, _ = _setup("rwkv6-1.6b")
    calls = []
    real = kops.linear_scan

    def counting(*a, **kw):
        calls.append(a[0].shape)
        return real(*a, **kw)

    monkeypatch.setattr(kops, "linear_scan", counting)
    t = torch.from_numpy(tokens)
    L = model.cfg.n_layers
    cache = model.init_cache(B, max_len=S, dtype=torch.float32)
    model.prefill(params, {"tokens": t[:, :8]}, cache)
    assert len(calls) == L
    model.prefill_chunk(params, {"tokens": t[:, 8:12]}, cache,
                        torch.full((B,), 8, dtype=torch.int32))
    assert len(calls) == 2 * L and calls[-1][:2] == (B, 4)
    for step in range(12, 14):
        model.decode_step(params, t[:, step:step + 1], cache,
                          torch.full((B,), step, dtype=torch.int32))
    assert len(calls) == 2 * L


@pytest.mark.parametrize("arch", ["gemma-2b", "rwkv6-1.6b"] + RG_ARCHS
                         + ["granite-moe-1b-a400m"] + ENCDEC_MROPE_ARCHS)
def test_cast_for_compute_changes_no_number(arch):
    """In bf16 compute, serving on ``cast_for_compute(params)`` equals
    serving on the f32 masters bit for bit: the load-time copy casts exactly
    the weights that every use casts.  Every leaf is moved off its init
    value first (norm scales, w0, u, RG-LRU's zero-init conv ...) so a
    weight rounded to bf16 where the model reads it in f32 would show
    (RG-LRU's ``conv_w``, scanned or not; the MoE ``router``; whisper's
    encoder, a scanned segment whose stacked layernorm scales and biases
    are vectors per layer)."""
    cfg = _smoke("repro_torch", arch)
    assert cfg.compute_dtype == "bfloat16"
    model = LanguageModel(cfg, device="cpu")
    gen = torch.Generator().manual_seed(0)
    masters = tree_map(
        lambda w: w + 0.05 * torch.randn(w.shape, generator=gen),
        model.init(0))
    cast = model.cast_for_compute(masters)
    t = torch.from_numpy(
        np.random.RandomState(1).randint(0, cfg.vocab_size, (B, S)))
    runs = []
    for p in (masters, cast):
        cache = model.init_cache(B, max_len=S, enc_len=S)
        logits, cache = model.prefill(p, {"tokens": t[:, :S - 2],
                                          **_extra(arch)}, cache)
        outs = [logits]
        for step in range(S - 2, S):
            logits, cache = model.decode_step(
                p, t[:, step:step + 1], cache,
                torch.full((B,), step, dtype=torch.int32))
            outs.append(logits)
        runs.append((outs, cache))
    (a, cache_a), (b, cache_b) = runs
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    tree_map(lambda x, y: None if torch.equal(x, y) else pytest.fail("cache"),
             cache_a, cache_b)


@pytest.mark.parametrize("arch", ARCHS)
def test_bridge_round_trip_is_exact(arch):
    jcfg, tcfg = _configs(arch)
    jparams = JaxLM(jcfg).init(jax.random.PRNGKey(1))
    tree = jax.tree.map(np.asarray, jparams)
    back = params_to_numpy(params_from_numpy(tree, tcfg, "cpu"))
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(back)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_bridge_rejects_missing_extra_and_misshaped_leaves():
    jcfg, tcfg = _configs("gemma-2b")
    tree = jax.tree.map(np.asarray, JaxLM(jcfg).init(jax.random.PRNGKey(0)))
    extra = dict(tree, out=np.zeros((64, 512), np.float32))
    with pytest.raises(KeyError):
        params_from_numpy(extra, tcfg, "cpu")
    missing = {k: v for k, v in tree.items() if k != "final_norm"}
    with pytest.raises(KeyError):
        params_from_numpy(missing, tcfg, "cpu")
    bad = dict(tree, embed=tree["embed"][:-1])
    with pytest.raises(ValueError):
        params_from_numpy(bad, tcfg, "cpu")


def test_init_matches_jax_tree_shapes():
    """The port's own seeded init draws exactly the JAX tree (keys, shapes,
    dtypes, stacked layers axis) -- what bridging the other way relies on."""
    for arch in ("gemma-2b", "rwkv6-1.6b", *RG_ARCHS, *MLA_MOE_ARCHS,
                 *ENCDEC_MROPE_ARCHS):
        jcfg, tcfg = _configs(arch)
        jtree = jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)),
                             JaxLM(jcfg).abstract_params())
        tparams = LanguageModel(tcfg, device="cpu").init(0)
        ttree = jax.tree.map(
            lambda t: (tuple(t.shape), str(t.dtype).replace("torch.", "")),
            tparams)
        assert ttree == jtree, arch


@pytest.mark.parametrize("seq", [1056, 2112])
def test_banded_swa_prefill_matches_jax(seq):
    """Prompts longer than window + q-chunk take the banded path of
    ``_attention_expanded`` (a KV band sliced per q-chunk) and wrap the SWA
    ring in ``prefill_cache``: danube smoke (window 16) in f32 against JAX,
    the train-mode logits at every position and the last logits of both
    prefills (flash dispatch, explicit positions), 2e-4."""
    jcfg, tcfg = _configs("h2o-danube-1.8b")
    jmodel = JaxLM(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tokens = np.random.RandomState(seq).randint(
        0, jcfg.vocab_size, (1, seq)).astype(np.int32)

    def full_logits(p):
        pos = jmodel._positions(1, seq, None)
        x = jmodel._embed(p, jnp.asarray(tokens))
        x, _, _ = jmodel._backbone(p, x, None, JaxCtx(mode="train", positions=pos))
        return jmodel._head(p, x)

    ref = np.asarray(jax.jit(full_logits)(jparams))
    model = LanguageModel(tcfg, device="cpu")
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg, "cpu")
    t = torch.from_numpy(tokens)
    pos = model._positions(1, seq, None)
    x = model._embed(params, t)
    x, _, _ = model._backbone(params, x, None, ModelCtx(mode="train", positions=pos))
    np.testing.assert_allclose(model._head(params, x).numpy(), ref, rtol=2e-4,
                               atol=2e-4)
    for given in (None, pos):
        batch = {"tokens": t} if given is None else {"tokens": t,
                                                     "positions": given}
        cache = model.init_cache(1, max_len=seq, dtype=torch.float32)
        logits, cache = model.prefill(params, batch, cache)
        np.testing.assert_allclose(logits.numpy(), ref[:, -1], rtol=2e-4,
                                   atol=2e-4)
        ring = cache["seg0"]["sub0"]["pos"][0, 0]  # layer 0's ring, slot 0
        assert sorted(ring.tolist()) == list(range(seq - jcfg.window, seq))
