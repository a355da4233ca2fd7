"""Block composition: per-layer kinds -> segments.

Port of ``repro.models.transformer`` for attention layers (``attn``/``swa``)
and RG-LRU layers (``rglru``), each followed by a dense MLP, and for RWKV-6
layers (``rwkv6``: time mix, then channel mix); MoE, MLA and
cross-attention kinds are later slices and raise ``NotImplementedError``.

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
from repro_torch.models import attention as attn_mod
from repro_torch.models import recurrent as rec_mod
from repro_torch.models.attention import ModelCtx
from repro_torch.models.layers import apply_mlp, apply_norm, init_mlp, init_norm
from repro_torch.utils import Spec, tree_map

LayerKind = tuple[str, bool]  # (block type, is_moe)


@dataclasses.dataclass(frozen=True)
class Segment:
    kinds: tuple[LayerKind, ...]  # the super-block
    repeats: int
    scanned: bool


def layer_kinds(cfg: ModelConfig) -> list[LayerKind]:
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


def _check_kind(cfg: ModelConfig, kind: LayerKind) -> None:
    t, is_moe = kind
    if t not in ("attn", "swa", "rglru", "rwkv6") or is_moe or cfg.use_mla:
        raise NotImplementedError(
            f"layer kind {kind} (mla={cfg.use_mla}) is not ported yet")


# ---------------------------------------------------------------------------
# Single layer
# ---------------------------------------------------------------------------


def init_layer(gen: torch.Generator | None, cfg: ModelConfig, kind: LayerKind,
               *, stack: int = 0, device: torch.device | str = "cuda") -> dict:
    _check_kind(cfg, kind)
    kw = dict(stack=stack, device=device)
    if kind[0] == "rwkv6":
        core = rec_mod.init_rwkv_time_mix(gen, cfg, **kw)
        mlp = rec_mod.init_rwkv_channel_mix(gen, cfg, **kw)
    elif kind[0] == "rglru":
        core = rec_mod.init_rglru(gen, cfg, **kw)
        mlp = init_mlp(gen, cfg, **kw)
    else:
        core = attn_mod.init_attention(gen, cfg, **kw)
        mlp = init_mlp(gen, cfg, **kw)
    return {
        "norm1": init_norm(cfg, cfg.d_model, **kw),
        "core": core,
        "norm2": init_norm(cfg, cfg.d_model, **kw),
        "mlp": mlp,
    }


def cache_specs_for_kind(cfg: ModelConfig, kind: LayerKind, batch: int,
                         max_len: int, dtype,
                         pages: tuple[int, int] | None = None) -> dict:
    """``pages=(n_pages, page_size)`` swaps full-attention KV caches for
    shared page pools; SWA rings and recurrent states stay slot-dense
    (O(window) and O(1) per slot)."""
    _check_kind(cfg, kind)
    t, _ = kind
    if t == "rwkv6":
        return rec_mod.rwkv_state_specs(batch, cfg)
    if t == "rglru":
        return rec_mod.rglru_state_specs(batch, cfg)
    if t == "swa":
        size = min(cfg.window, max_len) if cfg.window else max_len
        return attn_mod.kv_cache_specs(batch, size, cfg.n_kv_heads,
                                       cfg.head_dim, cfg.head_dim, dtype)
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
                cache: Any, ctx: ModelCtx) -> tuple[torch.Tensor, Any]:
    t, _ = kind
    h = apply_norm(p["norm1"], cfg, x)
    if t == "rwkv6":
        active = _active_mask(ctx)
        y, cache = rec_mod.apply_rwkv_time_mix(p["core"], cfg, h, cache,
                                               ctx.mode, active=active)
        x = x + y
        h = apply_norm(p["norm2"], cfg, x)
        y, cache = rec_mod.apply_rwkv_channel_mix(p["mlp"], cfg, h, cache,
                                                  ctx.mode, active=active)
        return x + y, cache
    if t == "rglru":
        y, new_cache = rec_mod.apply_rglru(p["core"], cfg, h, cache, ctx.mode,
                                           active=_active_mask(ctx))
    else:
        window = cfg.window if t == "swa" else 0
        # only full-attention layers page
        paged = ctx.table is not None and t == "attn" and ctx.mode == "decode"
        y, new_cache = attn_mod.apply_attention(p["core"], cfg, h, ctx, cache,
                                                window=window, paged=paged)
    x = x + y
    h = apply_norm(p["norm2"], cfg, x)
    x = x + apply_mlp(p["mlp"], cfg, h)
    return x, new_cache


# ---------------------------------------------------------------------------
# Super-blocks and segments
# ---------------------------------------------------------------------------


def init_segment(gen: torch.Generator | None, cfg: ModelConfig, seg: Segment,
                 *, device: torch.device | str = "cuda") -> dict:
    """The segment's weight tree; scanned segments draw every leaf with a
    leading ``layers`` axis of ``seg.repeats`` (``transformer.py:243-248``)."""
    stack = seg.repeats if seg.scanned else 0
    return {f"sub{i}": init_layer(gen, cfg, kind, stack=stack, device=device)
            for i, kind in enumerate(seg.kinds)}


def segment_cache_specs(cfg: ModelConfig, seg: Segment, batch: int,
                        max_len: int, dtype,
                        pages: tuple[int, int] | None = None) -> dict:
    per_block = {
        f"sub{i}": cache_specs_for_kind(cfg, kind, batch, max_len, dtype,
                                        pages=pages)
        for i, kind in enumerate(seg.kinds)
    }
    if not seg.scanned:
        return per_block
    return tree_map(lambda s: Spec((seg.repeats,) + s.shape, s.dtype,
                                   (None,) + s.axes), per_block)


def apply_superblock(p: dict, cfg: ModelConfig, kinds: tuple[LayerKind, ...],
                     x: torch.Tensor, caches: Any, ctx: ModelCtx):
    for i, kind in enumerate(kinds):
        c = None if caches is None else caches[f"sub{i}"]
        x, _ = apply_layer(p[f"sub{i}"], cfg, kind, x, c, ctx)
    return x, caches


#: matrix products without batch dims, whose outputs ``remat="dots"`` keeps
#: (``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``); an einsum
#: over weights reaches ``bmm`` with a batch of 1
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    if op in _DOTS or (op is torch.ops.aten.bmm.default
                       and args[0].shape[0] == 1):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat(policy: str, fn, x: torch.Tensor) -> torch.Tensor:
    """``fn(x)`` under activation checkpointing, as JAX's
    ``repro/models/transformer.py:306-310``:
    ``"full"`` keeps nothing inside the layer and reruns it in the backward,
    ``"dots"`` keeps the outputs of the non-batched matrix products.  The
    numbers are those of ``fn(x)``."""
    kw = {}
    if policy == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _save_dots)
    elif policy != "full":
        raise ValueError(f"remat policy {policy!r}")
    return checkpoint(fn, x, use_reentrant=False, preserve_rng_state=False,
                      **kw)


def apply_segment(p: dict, cfg: ModelConfig, seg: Segment, x: torch.Tensor,
                  caches: Any, ctx: ModelCtx):
    if not seg.scanned:
        return apply_superblock(p, cfg, seg.kinds, x, caches, ctx)
    # one unbind per stacked weight: its backward is one stack of the layers'
    # gradients, where a view t[i] per layer would add a zero tensor the size
    # of the whole stack per layer
    views = tree_map(lambda t: torch.unbind(t, 0), p)
    remat = ctx.mode == "train" and cfg.remat != "none"
    for i in range(seg.repeats):
        p_i = tree_map(lambda v: v[i], views)
        c_i = None if caches is None else tree_map(lambda t: t[i], caches)
        if remat:
            x = _remat(cfg.remat, lambda x_, p_i=p_i: apply_superblock(
                p_i, cfg, seg.kinds, x_, None, ctx)[0], x)
        else:
            x, _ = apply_superblock(p_i, cfg, seg.kinds, x, c_i, ctx)
    return x, caches
