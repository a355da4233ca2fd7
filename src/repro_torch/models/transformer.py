"""Block composition: per-layer kinds -> segments.

Port of ``repro.models.transformer`` for attention layers (``attn``/``swa``,
standard or MLA), encoder-decoder decoder layers (``xattn``: causal
self-attention, then cross-attention over the encoder output) and RG-LRU
layers (``rglru``), each followed by a dense MLP or, in MoE layers, the
routed experts plus any shared experts, and for RWKV-6 layers (``rwkv6``:
time mix, then channel mix).  Every layer returns its router loss (0
outside MoE layers), summed up the stack as in JAX.

Layers are grouped into *segments* as in JAX: a maximal run whose cyclic
super-block repeats >= 2 times is "scanned" -- its weights and caches carry
a leading ``layers`` axis, exactly the JAX pytree -- and here a Python loop
over that axis takes the place of ``lax.scan``.  Per-layer slices are views,
so in-place cache writes land in the stacked tensors.  In training each
layer of a scanned segment may run under activation checkpointing
(``cfg.remat``), as JAX's ``jax.checkpoint`` around the scan body.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import current_mesh_info, use_mesh_info
from repro_torch.models import attention as attn_mod
from repro_torch.models import mla as mla_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import recurrent as rec_mod
from repro_torch.models.attention import ModelCtx
from repro_torch.models.layers import (apply_mlp, apply_norm, init_mlp,
                                       init_norm, split)
from repro_torch.utils import Spec, tree_map

LayerKind = tuple[str, bool]  # (block type, is_moe)


@dataclasses.dataclass(frozen=True)
class Segment:
    kinds: tuple[LayerKind, ...]  # the super-block
    repeats: int
    scanned: bool


def layer_kinds(cfg: ModelConfig, decoder: bool = False) -> list[LayerKind]:
    """The decoder of an encoder-decoder model is all ``xattn`` layers."""
    if decoder:
        return [("xattn", False)] * cfg.n_layers
    kinds = []
    for i, t in enumerate(cfg.layer_types()):
        moe = (cfg.n_experts > 0 and i >= cfg.first_dense_layers
               and t in ("attn", "swa"))
        kinds.append((t, moe))
    return kinds


def plan_segments(cfg: ModelConfig, kinds: list[LayerKind]) -> list[Segment]:
    p = max(1, len(cfg.layer_pattern))
    segs: list[Segment] = []
    i, n = 0, len(kinds)
    while i < n:
        block = tuple(kinds[i: i + p])
        reps = 0
        j = i
        while j + p <= n and tuple(kinds[j: j + p]) == block:
            reps += 1
            j += p
        if reps >= 2:
            segs.append(Segment(block, reps, scanned=True))
            i = j
        else:
            segs.append(Segment((kinds[i],), 1, scanned=False))
            i += 1
    return segs


def _check_kind(kind: LayerKind) -> None:
    if kind[0] not in ("attn", "swa", "xattn", "rglru", "rwkv6"):
        raise ValueError(f"unknown layer kind {kind}")


# ---------------------------------------------------------------------------
# Single layer
# ---------------------------------------------------------------------------


def init_layer(gen: torch.Generator | None, cfg: ModelConfig, kind: LayerKind,
               *, stack: int = 0, device: torch.device | str = "cuda") -> dict:
    """The layer's ``Param`` tree, JAX's ``init_layer`` key for key: an MoE
    layer holds ``moe`` (and ``shared`` with shared experts) where the
    others hold ``mlp``; an ``xattn`` layer holds ``norm_x`` and the
    cross-attention ``cross`` beside its self-attention ``core``."""
    _check_kind(kind)
    t, is_moe = kind
    kw = dict(stack=stack, device=device)
    p = {"norm1": init_norm(cfg, cfg.d_model, **kw)}
    if t == "rwkv6":
        p["core"] = rec_mod.init_rwkv_time_mix(gen, cfg, **kw)
    elif t == "rglru":
        p["core"] = rec_mod.init_rglru(gen, cfg, **kw)
    elif t == "xattn":
        p["core"] = attn_mod.init_attention(gen, cfg, **kw)
        p["norm_x"] = init_norm(cfg, cfg.d_model, **kw)
        p["cross"] = attn_mod.init_attention(gen, cfg, **kw)
    elif cfg.use_mla:
        p["core"] = mla_mod.init_mla(gen, cfg, **kw)
    else:
        p["core"] = attn_mod.init_attention(gen, cfg, **kw)
    p["norm2"] = init_norm(cfg, cfg.d_model, **kw)
    if t == "rwkv6":
        p["mlp"] = rec_mod.init_rwkv_channel_mix(gen, cfg, **kw)
    elif is_moe:
        p["moe"] = moe_mod.init_moe(gen, cfg, **kw)
        if cfg.n_shared_experts:
            p["shared"] = init_mlp(gen, cfg,
                                   cfg.n_shared_experts * cfg.d_ff_expert, **kw)
    else:
        p["mlp"] = init_mlp(gen, cfg, **kw)
    return p


def cache_specs_for_kind(cfg: ModelConfig, kind: LayerKind, batch: int,
                         max_len: int, enc_len: int, dtype,
                         pages: tuple[int, int] | None = None) -> dict:
    """``pages=(n_pages, page_size)`` swaps full-attention KV caches for
    shared page pools; SWA rings, cross caches (``enc_len`` frames), MLA
    latents and recurrent states stay slot-dense (O(window), O(enc_len),
    compressed and O(1) per slot), and so does an ``xattn`` layer's self
    cache, as in JAX."""
    _check_kind(kind)
    t, _ = kind
    if t == "xattn":
        return {name: attn_mod.kv_cache_specs(batch, size, cfg.n_kv_heads,
                                              cfg.head_dim, cfg.head_dim, dtype)
                for name, size in (("self", max_len), ("cross", enc_len))}
    if t == "rwkv6":
        return rec_mod.rwkv_state_specs(batch, cfg)
    if t == "rglru":
        return rec_mod.rglru_state_specs(batch, cfg)
    if t == "swa":
        size = min(cfg.window, max_len) if cfg.window else max_len
        return attn_mod.kv_cache_specs(batch, size, cfg.n_kv_heads,
                                       cfg.head_dim, cfg.head_dim, dtype)
    if cfg.use_mla:
        return mla_mod.mla_cache_specs(batch, max_len, cfg, dtype)
    if pages is not None:
        return attn_mod.paged_kv_cache_specs(pages[0], pages[1], cfg.n_kv_heads,
                                             cfg.head_dim, cfg.head_dim, dtype)
    return attn_mod.kv_cache_specs(batch, max_len, cfg.n_kv_heads,
                                   cfg.head_dim, cfg.head_dim, dtype)


def _active_mask(ctx: ModelCtx) -> torch.Tensor | None:
    """Per-slot liveness for decode: pos < 0 marks a slot whose recurrent
    state must pass through unchanged (it is being chunk-prefilled while the
    rest of the batch decodes)."""
    if ctx.mode == "decode" and ctx.cache_pos is not None:
        return ctx.cache_pos >= 0
    return None


def apply_layer(p: dict, cfg: ModelConfig, kind: LayerKind, x: torch.Tensor,
                cache: Any, ctx: ModelCtx) -> tuple[torch.Tensor, Any, Any]:
    """(x, cache, aux): ``aux`` is the MoE router loss, the float 0.0 in a
    layer without experts (no device op)."""
    t, is_moe = kind
    aux = 0.0
    h = apply_norm(p["norm1"], cfg, x)
    if t == "rwkv6":
        active = _active_mask(ctx)
        y, cache = rec_mod.apply_rwkv_time_mix(p["core"], cfg, h, cache,
                                               ctx.mode, active=active)
        x = x + y
        h = apply_norm(p["norm2"], cfg, x)
        y, cache = rec_mod.apply_rwkv_channel_mix(p["mlp"], cfg, h, cache,
                                                  ctx.mode, active=active)
        return x + y, cache, aux
    if t == "xattn":
        y, _ = attn_mod.apply_attention(
            p["core"], cfg, h, ctx, None if cache is None else cache["self"])
        x = x + y
        hx = apply_norm(p["norm_x"], cfg, x)
        y, _ = attn_mod.apply_attention(
            p["cross"], cfg, hx, ctx, None if cache is None else cache["cross"],
            cross=True)
        new_cache = cache
    elif t == "rglru":
        y, new_cache = rec_mod.apply_rglru(p["core"], cfg, h, cache, ctx.mode,
                                           active=_active_mask(ctx))
    elif cfg.use_mla:  # slot-dense latents, paged engine or not
        y, new_cache = mla_mod.apply_mla(p["core"], cfg, h, ctx, cache)
    else:
        window = cfg.window if t == "swa" else 0
        # only full-attention layers page
        paged = ctx.table is not None and t == "attn" and ctx.mode == "decode"
        y, new_cache = attn_mod.apply_attention(p["core"], cfg, h, ctx, cache,
                                                window=window, paged=paged)
    x = x + y
    h = apply_norm(p["norm2"], cfg, x)
    if is_moe:
        y, aux = moe_mod.apply_moe(p["moe"], cfg, h)
        if cfg.n_shared_experts:
            y = y + apply_mlp(p["shared"], cfg, h)
    else:
        y = apply_mlp(p["mlp"], cfg, h)
    return x + y, new_cache, aux


# ---------------------------------------------------------------------------
# Super-blocks and segments
# ---------------------------------------------------------------------------


def init_segment(gen: torch.Generator | None, cfg: ModelConfig, seg: Segment,
                 *, device: torch.device | str = "cuda") -> dict:
    """(values, axes) of the segment's weight tree; scanned segments draw
    every leaf with a leading ``layers`` axis of ``seg.repeats``, and its
    logical axes gain a leading ``"layers"`` (``transformer.py:232-248``)."""
    stack = seg.repeats if seg.scanned else 0
    vals, axes = split({f"sub{i}": init_layer(gen, cfg, kind, stack=stack,
                                              device=device)
                        for i, kind in enumerate(seg.kinds)})
    if seg.scanned:
        axes = tree_map(lambda a: ("layers",) + a, axes)
    return vals, axes


def segment_cache_specs(cfg: ModelConfig, seg: Segment, batch: int,
                        max_len: int, enc_len: int, dtype,
                        pages: tuple[int, int] | None = None) -> dict:
    per_block = {
        f"sub{i}": cache_specs_for_kind(cfg, kind, batch, max_len, enc_len,
                                        dtype, pages=pages)
        for i, kind in enumerate(seg.kinds)
    }
    if not seg.scanned:
        return per_block
    return tree_map(lambda s: Spec((seg.repeats,) + s.shape, s.dtype,
                                   (None,) + s.axes), per_block)


def apply_superblock(p: dict, cfg: ModelConfig, kinds: tuple[LayerKind, ...],
                     x: torch.Tensor, caches: Any, ctx: ModelCtx):
    """(x, caches, summed router loss)."""
    aux = 0.0
    for i, kind in enumerate(kinds):
        c = None if caches is None else caches[f"sub{i}"]
        x, _, a = apply_layer(p[f"sub{i}"], cfg, kind, x, c, ctx)
        aux = aux + a
    return x, caches, aux


#: matrix products without batch dims, whose outputs ``remat="dots"`` keeps
#: (``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``); an einsum
#: over weights reaches ``bmm`` with a batch of 1
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    if op in _DOTS or (op is torch.ops.aten.bmm.default
                       and args[0].shape[0] == 1):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat(policy: str, fn, x: torch.Tensor):
    """``fn(x)`` under activation checkpointing, as JAX's
    ``repro/models/transformer.py:306-310``:
    ``"full"`` keeps nothing inside the layer and reruns it in the backward,
    ``"dots"`` keeps the outputs of the non-batched matrix products.  The
    numbers are those of ``fn(x)``.  The rerun happens on the autograd
    engine's thread (a CUDA backward has its own), so it is given the mesh
    the forward ran under: the same constraints and the same MoE path."""
    info = current_mesh_info()

    def run(x_):
        with use_mesh_info(info):
            return fn(x_)

    kw = {}
    if policy == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _save_dots)
    elif policy != "full":
        raise ValueError(f"remat policy {policy!r}")
    return checkpoint(run, x, use_reentrant=False, preserve_rng_state=False,
                      **kw)


def apply_segment(p: dict, cfg: ModelConfig, seg: Segment, x: torch.Tensor,
                  caches: Any, ctx: ModelCtx):
    """(x, caches, summed router loss), as ``apply_superblock``."""
    if not seg.scanned:
        return apply_superblock(p, cfg, seg.kinds, x, caches, ctx)
    # one unbind per stacked weight: its backward is one stack of the layers'
    # gradients, where a view t[i] per layer would add a zero tensor the size
    # of the whole stack per layer
    views = tree_map(lambda t: torch.unbind(t, 0), p)
    remat = ctx.mode == "train" and cfg.remat != "none"
    aux = 0.0
    for i in range(seg.repeats):
        p_i = tree_map(lambda v: v[i], views)
        c_i = None if caches is None else tree_map(lambda t: t[i], caches)
        if remat:
            # the router loss leaves the checkpoint beside x, so its
            # gradient reaches the router through the recompute
            x, a = _remat(cfg.remat, lambda x_, p_i=p_i: apply_superblock(
                p_i, cfg, seg.kinds, x_, None, ctx)[::2], x)
        else:
            x, _, a = apply_superblock(p_i, cfg, seg.kinds, x, c_i, ctx)
        aux = aux + a
    return x, caches, aux
