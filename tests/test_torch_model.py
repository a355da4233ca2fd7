"""The port's LanguageModel against the JAX package on the same weights.

gemma-2b (MQA, head_dim 32 at smoke size), deepseek-7b (MHA),
h2o-danube-1.8b (GQA with a 16-token sliding window: ring caches that wrap,
slot-dense leaves in the paged cache) and rwkv6-1.6b (pure recurrence: the
WKV scan in prefill, per-slot states in the paged cache) smoke configs in
f32 compute, JAX weights carried across with ``repro_torch.bridge``.  Each case reproduces a ``tests/test_decode_parity.py``
test against the JAX full forward, at that file's bounds: 2e-4 on prefill
logits, 3e-4 on decode logits.
"""
import dataclasses
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
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.launch.paged_kv import PagedKVCache, decompose  # noqa: E402
from repro_torch.models import LanguageModel  # noqa: E402
from repro_torch.models.attention import ModelCtx  # noqa: E402
from repro_torch.utils import tree_map  # noqa: E402

ATTN_ARCHS = ["gemma-2b", "deepseek-7b", "h2o-danube-1.8b"]
ARCHS = ATTN_ARCHS + ["rwkv6-1.6b"]
B, S = 2, 24


def _configs(arch):
    name = arch.replace("-", "_").replace(".", "_")
    jcfg = importlib.import_module(f"repro.configs.{name}").smoke()
    if arch == "h2o-danube-1.8b":
        # no port config yet (it is served in a later slice); the same
        # fields make the port's ModelConfig
        tcfg = ModelConfig(**dataclasses.asdict(jcfg))
    else:
        tcfg = importlib.import_module(f"repro_torch.configs.{name}").smoke()
    return (jcfg.scaled(compute_dtype="float32"),
            tcfg.scaled(compute_dtype="float32"))


@functools.lru_cache(maxsize=None)
def _setup(arch):
    """(port model, bridged params, tokens, JAX full-forward logits)."""
    jcfg, tcfg = _configs(arch)
    jmodel = JaxLM(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    rng = np.random.RandomState(0)
    tokens = rng.randint(0, jcfg.vocab_size, (B, S)).astype(np.int32)

    def full_logits(p):
        pos = jmodel._positions(B, S, None)
        x = jmodel._embed(p, jnp.asarray(tokens))
        x, _, _ = jmodel._backbone(p, x, None, JaxCtx(mode="train", positions=pos))
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
    x = model._embed(params, t)
    x, _ = model._backbone(params, x, None, ModelCtx(mode="train", positions=pos))
    np.testing.assert_allclose(model._head(params, x).numpy(), ref,
                               rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_full_forward(arch):
    """test_decode_parity.py::test_decode_matches_full_forward on the port:
    prefill the first half (flash path), decode the rest token by token."""
    model, params, tokens, ref = _setup(arch)
    t = torch.from_numpy(tokens)
    S0 = S // 2
    cache = model.init_cache(B, max_len=S, dtype=torch.float32)
    logits, cache = model.prefill(params, {"tokens": t[:, :S0]}, cache)
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
                      dtype=torch.float32)
    assert kv.alloc(0, 10) and kv.alloc(1, S + 2)
    S0 = S // 2
    start = 0
    logits = None
    for c in decompose(S0, 8):
        view = kv.gather_slot(1)
        logits, view = model.prefill_chunk(
            params, {"tokens": t[:, start:start + c]}, view,
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


@pytest.mark.parametrize("arch", ATTN_ARCHS)
def test_prefill_takes_flash_path(arch, monkeypatch):
    """Full prefill with implicit positions calls the flash dispatch once per
    layer; explicit positions and chunked prefill never do."""
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
    assert len(calls) == model.cfg.n_layers
    pos = model._positions(B, S, None)
    cache = model.init_cache(B, max_len=S, dtype=torch.float32)
    model.prefill(params, {"tokens": t, "positions": pos}, cache)
    model.prefill_chunk(params, {"tokens": t[:, :4]}, cache,
                        torch.zeros((B,), dtype=torch.int32))
    assert len(calls) == model.cfg.n_layers


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


@pytest.mark.parametrize("arch", ["gemma-2b", "rwkv6-1.6b"])
def test_cast_for_compute_changes_no_number(arch):
    """In bf16 compute, serving on ``cast_for_compute(params)`` equals
    serving on the f32 masters bit for bit: the load-time copy casts exactly
    the weights that every use casts.  Every leaf is moved off its init
    value first (norm scales, w0, u ...) so a weight rounded to bf16 where
    the model reads it in f32 would show."""
    name = arch.replace("-", "_").replace(".", "_")
    cfg = importlib.import_module(f"repro_torch.configs.{name}").smoke()
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
        cache = model.init_cache(B, max_len=S)
        logits, cache = model.prefill(p, {"tokens": t[:, :S - 2]}, cache)
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
    for arch in ("gemma-2b", "rwkv6-1.6b"):
        jcfg, tcfg = _configs(arch)
        jtree = jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)),
                             JaxLM(jcfg).abstract_params())
        tparams = LanguageModel(tcfg, device="cpu").init(0)
        ttree = jax.tree.map(
            lambda t: (tuple(t.shape), str(t.dtype).replace("torch.", "")),
            tparams)
        assert ttree == jtree, arch
