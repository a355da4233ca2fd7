"""The port's MLA and MoE modules against ``repro.models.mla`` and
``repro.models.moe`` in f32, on the same numpy-seeded inputs and weights.

MLA (minicpm3-4b and deepseek-v2-236b smoke widths, and a variant without
the query down-projection): the expanded path in train and in prefill
(plain, and the flash dispatch, whose CPU path is the kernel's plain
version), a prefill longer than the cache, the absorbed path in decode
(with an inactive slot) and in chunked prefill over a half-filled cache;
outputs and cache contents.  MoE (granite-moe-1b-a400m and
deepseek-v2-236b smoke widths): the router's gates, indices and aux loss,
``_moe_dense`` and ``apply_moe``.  Gradients of both modules against
``jax.grad``.  Bounds: the decode-parity suite's 2e-4 (train, prefill),
3e-4 (decode, chunked prefill) and ``GRAD_TOL`` 2e-4 x max(1, max |g|).
"""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import mla as jmla  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models.attention import ModelCtx as JaxCtx  # noqa: E402
from repro.models.layers import split  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.models import mla as tmla  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.attention import ModelCtx  # noqa: E402
from repro_torch.utils import (tree_flatten, tree_leaves, tree_map,  # noqa: E402
                               tree_unflatten)

PREFILL_TOL = dict(rtol=2e-4, atol=2e-4)
DECODE_TOL = dict(rtol=3e-4, atol=3e-4)
GRAD_TOL = 2e-4
#: "arch" or "arch/noq": the arch's smoke config, the latter without the
#: query down-projection (q_lora_rank 0: w_uq straight from d_model)
MLA_ARCHS = ["minicpm3-4b", "deepseek-v2-236b", "minicpm3-4b/noq"]
MOE_ARCHS = ["granite-moe-1b-a400m", "deepseek-v2-236b"]
B, S = 3, 12


def _configs(arch):
    arch, _, variant = arch.partition("/")
    name = arch.replace("-", "_").replace(".", "_")
    kw = dict(compute_dtype="float32")
    if variant == "noq":
        kw["q_lora_rank"] = 0
    return tuple(importlib.import_module(f"{pkg}.configs.{name}").smoke()
                 .scaled(**kw) for pkg in ("repro", "repro_torch"))


def _weights(init, jcfg, seed=0):
    """JAX's init values, each moved by 0.05 x a seeded normal (the norm
    scales sit off 1), as numpy."""
    vals, _ = split(init(jax.random.PRNGKey(seed), jcfg))
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


def _cache(jcfg, size, filled, seed=1):
    """A latent cache whose row b holds positions 0 .. filled[b] - 1 (random
    latents) and -1 elsewhere, as numpy."""
    ckv = _rand(B, size, jcfg.kv_lora_rank, seed=seed)
    kr = _rand(B, size, jcfg.qk_rope_head_dim, seed=seed + 1)
    pos = np.full((B, size), -1, np.int32)
    for b, n in enumerate(filled):
        pos[b, :n] = np.arange(n)
    ckv[pos < 0] = 0.0
    kr[pos < 0] = 0.0
    return {"ckv": ckv, "kr": kr, "pos": pos}


def _assert_cache(tcache, jcache, tol):
    for k in ("ckv", "kr", "pos"):
        np.testing.assert_allclose(tcache[k].numpy(), np.asarray(jcache[k]),
                                   err_msg=k, **tol)


@pytest.mark.parametrize("mode", ["train", "prefill", "prefill_flash",
                                  "prefill_past_cache"])
@pytest.mark.parametrize("arch", MLA_ARCHS)
def test_apply_mla_expanded_path_matches_jax(arch, mode, monkeypatch):
    """Train (no cache) and prefill (latents persisted): ``prefill`` with
    explicit positions runs ``attention_core``, ``prefill_flash`` with the
    contiguous flag runs the flash dispatch (counted), and
    ``prefill_past_cache`` writes a 12-token prompt into an 8-slot cache,
    which keeps the last 8 tokens."""
    jcfg, tcfg = _configs(arch)
    w = _weights(jmla.init_mla, jcfg)
    x = _rand(B, S, jcfg.d_model, seed=2)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    size = 8 if mode == "prefill_past_cache" else S
    cache = None if mode == "train" else _cache(jcfg, size, [0] * B)
    jmode = "train" if mode == "train" else "prefill"
    ref, jcache = jmla.apply_mla(
        _j(w), jcfg, jnp.asarray(x), JaxCtx(mode=jmode, positions=jnp.asarray(pos)),
        None if cache is None else _j(cache))
    calls = []
    real = kops.flash_attention
    monkeypatch.setattr(kops, "flash_attention",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    ctx = ModelCtx(mode=jmode, positions=torch.from_numpy(pos),
                   contiguous=mode == "prefill_flash")
    tcache = None if cache is None else _t(cache)
    out, tcache = tmla.apply_mla(_t(w), tcfg, torch.from_numpy(x), ctx, tcache)
    assert len(calls) == (mode == "prefill_flash")
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **PREFILL_TOL)
    if cache is not None:
        _assert_cache(tcache, jcache, PREFILL_TOL)
    if mode == "prefill_past_cache":
        assert sorted(tcache["pos"][0].tolist()) == list(range(S - size, S))


@pytest.mark.parametrize("arch", MLA_ARCHS)
def test_apply_mla_decode_matches_jax(arch):
    """One absorbed decode step over caches filled to 5, 9 and 7 tokens;
    slot 1 is inactive (pos -1): JAX drops its write, the port rewrites
    what the slot holds, and both leave its cache row as it was."""
    jcfg, tcfg = _configs(arch)
    w = _weights(jmla.init_mla, jcfg)
    size = 16
    cache = _cache(jcfg, size, [5, 9, 7])
    x = _rand(B, 1, jcfg.d_model, seed=3)
    cache_pos = np.array([5, -1, 7], np.int32)
    ref, jcache = jmla.apply_mla(
        _j(w), jcfg, jnp.asarray(x),
        JaxCtx(mode="decode", positions=jnp.asarray(cache_pos[:, None]),
               cache_pos=jnp.asarray(cache_pos)), _j(cache))
    ctx = ModelCtx(mode="decode", positions=torch.from_numpy(cache_pos[:, None]),
                   cache_pos=torch.from_numpy(cache_pos))
    out, tcache = tmla.apply_mla(_t(w), tcfg, torch.from_numpy(x), ctx,
                                 _t(cache))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **DECODE_TOL)
    _assert_cache(tcache, jcache, DECODE_TOL)
    np.testing.assert_array_equal(tcache["pos"][1].numpy(), cache["pos"][1])
    np.testing.assert_array_equal(tcache["ckv"][1].numpy(), cache["ckv"][1])


@pytest.mark.parametrize("arch", MLA_ARCHS)
def test_apply_mla_chunk_prefill_matches_jax(arch):
    """A 4-token chunk continuing prefixes of 6, 3 and 8 tokens in a 16-slot
    cache (half filled): attention over the old contents plus the chunk,
    taken before the chunk is written, then the chunk persisted."""
    jcfg, tcfg = _configs(arch)
    w = _weights(jmla.init_mla, jcfg)
    filled = [6, 3, 8]
    cache = _cache(jcfg, 16, filled)
    C = 4
    x = _rand(B, C, jcfg.d_model, seed=4)
    pos = (np.array(filled, np.int32)[:, None]
           + np.arange(C, dtype=np.int32)).astype(np.int32)
    ref, jcache = jmla.apply_mla(
        _j(w), jcfg, jnp.asarray(x),
        JaxCtx(mode="chunk_prefill", positions=jnp.asarray(pos)), _j(cache))
    ctx = ModelCtx(mode="chunk_prefill", positions=torch.from_numpy(pos))
    out, tcache = tmla.apply_mla(_t(w), tcfg, torch.from_numpy(x), ctx,
                                 _t(cache))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **DECODE_TOL)
    _assert_cache(tcache, jcache, DECODE_TOL)


def test_mla_flash_pads_head_dims_off_the_kernel_grid():
    """The smoke configs' 16 + 8 = 24-dim heads reach the flash dispatch
    zero-padded to 32 at the scale 24^-0.5; at minicpm3-4b's full width
    (64 + 32 = 96) the heads pass as they are.  Either way the output is
    ``attention_core``'s."""
    g = torch.Generator().manual_seed(0)
    for D, Dv in ((24, 16), (96, 64)):
        q, k = (torch.randn(1, 40, 2, D, generator=g) for _ in range(2))
        v = torch.randn(1, 40, 2, Dv, generator=g)
        seen = []
        real = kops.flash_attention
        kops.flash_attention = lambda *a, **kw: seen.append(
            (a[0].shape[-1], kw["scale"])) or real(*a, **kw)
        try:
            out = tmla._flash(q, k, v, True)
        finally:
            kops.flash_attention = real
        assert seen == [(-(-D // 16) * 16, D ** -0.5)]
        pos = torch.arange(40, dtype=torch.int32)[None]
        ref = tmla.attention_core(q, k, v, pos, pos, causal=True)
        torch.testing.assert_close(out, ref, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_route_matches_jax(arch):
    """Gates (renormalised top-k of an f32 softmax), expert indices (equal:
    no tied probabilities with seeded weights) and the Switch aux loss."""
    jcfg, tcfg = _configs(arch)
    w = _weights(jmoe.init_moe, jcfg)
    x2d = _rand(B * S, jcfg.d_model, seed=5)
    gates, idx, aux = jmoe._route(jnp.asarray(w["router"]), jnp.asarray(x2d),
                                  jcfg)
    tg, ti, ta = tmoe._route(torch.from_numpy(w["router"]),
                             torch.from_numpy(x2d), tcfg)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(idx))
    np.testing.assert_allclose(tg.numpy(), np.asarray(gates), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(float(ta), float(aux), rtol=1e-5)
    assert float(ta) > 0


@pytest.mark.parametrize("fn", ["_moe_dense", "apply_moe"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_matches_jax(arch, fn):
    """Every expert over every token, combined by the gates: the layer's
    output and its aux loss."""
    jcfg, tcfg = _configs(arch)
    w = _weights(jmoe.init_moe, jcfg)
    x = _rand(B, S, jcfg.d_model, seed=6)
    ref, aux = getattr(jmoe, fn)(_j(w), jcfg, jnp.asarray(x))
    out, taux = getattr(tmoe, fn)(_t(w), tcfg, torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **PREFILL_TOL)
    np.testing.assert_allclose(float(taux), float(aux), rtol=1e-5)


def _assert_grads(tgrads, jgrads, what):
    for (path, g), r in zip(tree_flatten(tgrads), jax.tree.leaves(jgrads)):
        r = np.asarray(r)
        tol = GRAD_TOL * max(1.0, float(np.abs(r).max()))
        np.testing.assert_allclose(g.numpy(), r, rtol=0, atol=tol,
                                   err_msg=f"{what}: {path}")


@pytest.mark.parametrize("arch", MLA_ARCHS[:2])
def test_apply_mla_gradients_match_jax(arch):
    """d/d(weights, x) of <apply_mla(x), r> in train mode."""
    jcfg, tcfg = _configs(arch)
    w = _weights(jmla.init_mla, jcfg)
    x = _rand(B, S, jcfg.d_model, seed=7)
    r = _rand(B, S, jcfg.d_model, seed=8)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()

    def jloss(w_, x_):
        out, _ = jmla.apply_mla(w_, jcfg, x_, JaxCtx(
            mode="train", positions=jnp.asarray(pos)), None)
        return jnp.sum(out * r)

    jgrads = jax.grad(jloss, argnums=(0, 1))(_j(w), jnp.asarray(x))
    tw = tree_map(lambda t: t.requires_grad_(True), _t(w))
    tx = torch.from_numpy(x).requires_grad_(True)
    out, _ = tmla.apply_mla(tw, tcfg, tx, ModelCtx(
        mode="train", positions=torch.from_numpy(pos)), None)
    grads = torch.autograd.grad((out * torch.from_numpy(r)).sum(),
                                tree_leaves(tw) + [tx])
    _assert_grads({"w": tree_unflatten(tw, list(grads[:-1])), "x": grads[-1]},
                  {"w": jgrads[0], "x": jgrads[1]}, arch)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_apply_moe_gradients_match_jax(arch):
    """d/d(weights, x) of <apply_moe(x), r> + aux: the router's gradient
    comes through the gates and through the aux loss."""
    jcfg, tcfg = _configs(arch)
    w = _weights(jmoe.init_moe, jcfg)
    x = _rand(B, S, jcfg.d_model, seed=9)
    r = _rand(B, S, jcfg.d_model, seed=10)

    def jloss(w_, x_):
        out, aux = jmoe.apply_moe(w_, jcfg, x_)
        return jnp.sum(out * r) + aux

    jgrads = jax.grad(jloss, argnums=(0, 1))(_j(w), jnp.asarray(x))
    tw = tree_map(lambda t: t.requires_grad_(True), _t(w))
    tx = torch.from_numpy(x).requires_grad_(True)
    out, aux = tmoe.apply_moe(tw, tcfg, tx)
    grads = torch.autograd.grad((out * torch.from_numpy(r)).sum() + aux,
                                tree_leaves(tw) + [tx])
    gw = tree_unflatten(tw, list(grads[:-1]))
    assert float(gw["router"].abs().max()) > 0
    _assert_grads({"w": gw, "x": grads[-1]},
                  {"w": jgrads[0], "x": jgrads[1]}, arch)
