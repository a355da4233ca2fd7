"""Attention: GQA/MQA/MHA, causal + bidirectional + sliding-window, cross.

Port of ``repro.models.attention``, with its sharding constraints
(``constrain``: no-ops without a mesh) and, under a mesh whose model axis
the head count does not divide, the sequence-sharded
``_shard_aligned_attention``.  The plain computation is q-chunked so it
never holds a full (Sq x Skv) score tensor for long prompts; full prefill
with contiguous positions goes through the hand-written flash kernel
instead (``kernels/ops.py``), which computes the
same function: causal self-attention, and non-causal over the encoder's
frames for the encoder's own layers and the decoder's cross-attention.

KV caches carry an explicit per-slot ``pos`` array (-1 = empty), so full
caches, ring buffers (SWA), cross caches and page pools are uniform: masks
always come from true token positions (M-RoPE's temporal stream).  Caches
are updated in place (eager PyTorch has no donation; the in-place write is
what donation bought in JAX), and every write that JAX would drop as out
of bounds is made explicit here: a masked write for dense caches, a trash
page for page pools.

Score precision: the JAX einsums take compute-dtype inputs with
``preferred_element_type=float32``; here the operands are upcast before the
product, softmax runs in f32, and the probabilities are cast back to v's
dtype for the PV product, as ``attention.py:145, 168`` do.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import (constrain, current_mesh_info,
                                              einsum, shard_map)
from repro_torch.kernels import ops as kops
from repro_torch.models.layers import (Param, apply_rope, dense_init,
                                       torch_dtype)
from repro_torch.utils import Spec

NEG_INF = -0.7 * torch.finfo(torch.float32).max


# ---------------------------------------------------------------------------
# Context threading through the model
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ModelCtx:
    mode: str  # train | prefill | chunk_prefill | decode | encode
    positions: torch.Tensor  # (B, S) int32; or (3, B, S) for mrope
    cache_pos: torch.Tensor | None = None  # (B,) int32 write position (decode)
    enc_out: torch.Tensor | None = None  # (B, S_enc, d) encoder output
    enc_positions: torch.Tensor | None = None  # (B, S_enc)
    causal: bool = True
    #: (B, max_pages) int32 block table for paged KV pools (decode only);
    #: entries == n_pages mark unallocated logical pages.
    table: torch.Tensor | None = None
    #: positions are the ``arange`` that ``LanguageModel._positions`` built
    #: (pos_q = pos_k = 0..S-1 in every row, and the encoder's frames
    #: 0..S_enc-1), the case the flash kernel takes
    contiguous: bool = False

    @property
    def pos2d(self) -> torch.Tensor:
        """(B, S) positions regardless of mrope (temporal component)."""
        return self.positions[0] if self.positions.ndim == 3 else self.positions


def kv_heads_shardable(n_kv_heads: int) -> bool:
    info = current_mesh_info()
    if info is None:
        return True
    return n_kv_heads % max(1, info.axis_size("model")) == 0


def cache_axes(n_kv_heads: int) -> tuple:
    """(B, S, H_kv, D) cache axes; shard heads if divisible, else the seq dim
    (SP-decode: long KV caches spread over the model axis)."""
    if kv_heads_shardable(n_kv_heads):
        return ("batch", None, "kv_heads", None)
    return ("batch", "kv_seq", None, None)


# ---------------------------------------------------------------------------
# Streaming attention core
# ---------------------------------------------------------------------------


def _pick_chunk(sq: int) -> int:
    if sq <= 1024:
        return sq
    c = max(128, min(1024, sq // 32))
    while sq % c:
        c //= 2
    return max(c, 1)


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def _mask(pq: torch.Tensor, pk: torch.Tensor, causal: bool,
          window: int) -> torch.Tensor:
    """pq: (B, ..., Sq, 1) and pk: (B, ..., 1, Skv) positions -> valid mask."""
    mask = pk >= 0
    if causal:
        mask = mask & (pk <= pq)
    if window > 0:
        mask = mask & ((pq - pk) < window)
    return mask


def attention_core(
    q: torch.Tensor,  # (B, Sq, Hq, Dk)
    k: torch.Tensor,  # (B, Skv, Hkv, Dk)
    v: torch.Tensor,  # (B, Skv, Hkv, Dv)
    pos_q: torch.Tensor,  # (B, Sq) int
    pos_k: torch.Tensor,  # (B, Skv) int, -1 marks empty slots
    *,
    causal: bool = True,
    window: int = 0,
    scale: float | None = None,
) -> torch.Tensor:
    B, Sq, Hq, Dk = q.shape
    Hkv = k.shape[2]
    Dv = v.shape[-1]
    G = Hq // Hkv
    scale = scale if scale is not None else Dk ** -0.5

    # Under a mesh whose model axis the head count does not divide, q is
    # sequence-sharded: fold the sharded dim out of the q-chunk loop so each
    # chunk is device-local (``attention.py:113-127``)
    tp_out = _shard_aligned_attention(q, pos_q, k, v, pos_k, causal=causal,
                                      window=window, scale=scale)
    if tp_out is not None:
        return tp_out

    if Sq > 1:
        # GQA: expand K/V to the q-head count (head h reads kv head h // G)
        if G > 1:
            k = k.repeat_interleave(G, dim=2)
            v = v.repeat_interleave(G, dim=2)
            if kv_heads_shardable(Hq):
                k = constrain(k, "batch", None, "heads", None)
                v = constrain(v, "batch", None, "heads", None)
        return _attention_expanded(q, k, v, pos_q, pos_k, causal=causal,
                                   window=window, scale=scale)

    # decode (Sq == 1): grouped product against the cache -- no repeat, so
    # cache reads stay 1/G of the expanded cost
    qg = q.reshape(B, Sq, Hkv, G, Dk)
    s = einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()) * scale
    mask = _mask(pos_q[:, None, None, :, None], pos_k[:, None, None, None, :],
                 causal, window)
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = einsum("bhgqk,bkhd->bqhgd", p.to(v.dtype), v)
    return o.reshape(B, Sq, Hq, Dv)


def _attention_expanded(q, k, v, pos_q, pos_k, *, causal, window, scale):
    """Plain q-chunked attention with per-head K/V (no grouping)."""
    B, Sq, Hq, Dk = q.shape
    Skv = k.shape[1]
    kf = k.float()

    def block(q_blk, pq, k_, v_, pk):
        s = einsum("bqhd,bkhd->bhqk", q_blk.float(), k_) * scale
        mask = _mask(pq[:, None, :, None], pk[:, None, None, :], causal,
                     window)
        s = torch.where(mask, s, NEG_INF)
        p = torch.softmax(s, dim=-1)
        return einsum("bhqk,bkhd->bqhd", p.to(v_.dtype), v_)

    chunk = _pick_chunk(Sq)
    if Sq == chunk:
        return block(q, pos_q, kf, v, pos_k)

    # Banded path for sliding-window prefill: slice the KV band per q-chunk
    # so the work is O(S * window).  Valid because prefill cache slots are
    # position-ordered (pos_k == arange over the computed sequence).
    banded = window > 0 and Skv > window + chunk
    band = min(_round_up(window + chunk, 128), Skv)
    outs = []
    for start in range(0, Sq, chunk):
        sl = slice(start, start + chunk)
        if banded:
            # lax.dynamic_slice clamps the start so the band fits
            lo = min(max(start + chunk - band, 0), Skv - band)
            kb = slice(lo, lo + band)
            outs.append(block(q[:, sl], pos_q[:, sl], kf[:, kb], v[:, kb],
                              pos_k[:, kb]))
        else:
            outs.append(block(q[:, sl], pos_q[:, sl], kf, v, pos_k))
    return torch.cat(outs, dim=1)


_SCORE_BYTES_BUDGET = 700e6  # per-device f32 score-block budget


def _attn_block_tp(q_blk, pq, k, v, pk, causal, window, scale):
    """q_blk: (B, tp, c, Hkv, G, D) with tp sharded; k/v replicated."""
    B = q_blk.shape[0]
    hq = q_blk.shape[3] * q_blk.shape[4]
    dv = v.shape[-1]
    s = torch.einsum("btqhgd,bkhd->bhgtqk", q_blk.float(), k.float()) * scale
    mask = _mask(pq[:, None, None, :, :, None],
                 pk[:, None, None, None, None, :], causal, window)
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgtqk,bkhd->btqhgd", p.to(v.dtype), v)
    return o.reshape(B, q_blk.shape[1], q_blk.shape[2], hq, dv)


def _shard_aligned_attention(q, pos_q, k, v, pos_k, *, causal, window,
                             scale):
    """Returns the attention output for the seq-sharded-q regime, or None if
    the plain path applies (no mesh / heads shardable / tiny seq)
    (``attention.py:225-261``).  S is split as (tp, L) with tp over the
    model axis; each device runs its own L rows in chunks of ``c2`` rows
    (the f32 score block of a chunk within ``_SCORE_BYTES_BUDGET``) against
    the whole K/V, inside a ``local_map``.  Masks come from explicit
    positions, so the non-contiguous row blocks stay exact."""
    info = current_mesh_info()
    if info is None:
        return None
    tp = info.axis_size("model")
    B, Sq, Hq, Dk = q.shape
    Skv, Hkv, Dv = k.shape[1], k.shape[2], v.shape[-1]
    G = Hq // Hkv
    if (tp <= 1 or Sq <= 1 or kv_heads_shardable(Hq) or Sq % tp
            or Sq <= _pick_chunk(Sq)):
        return None
    dp = info.axis_size("data") * info.axis_size("pod")
    b_loc = max(1, B // max(dp, 1))
    ll = Sq // tp
    row_bytes = b_loc * Hq * Skv * 4
    c2 = max(16, int(_SCORE_BYTES_BUDGET // max(row_bytes, 1)))
    c2 = min(c2, ll)
    while ll % c2:
        c2 -= 1
    # split the heads into (Hkv, G) only here, where they are not sharded
    qs = constrain(q.reshape(B, tp, ll, Hkv, G, Dk),
                   "batch", "seq_act", None, None, None, None)
    ps = pos_q.reshape(B, tp, ll)

    def local(q_l, p_l, k_l, v_l, pk_l):
        if c2 == ll:  # one device-local block, no loop
            return _attn_block_tp(q_l, p_l, k_l, v_l, pk_l, causal, window,
                                  scale)
        return torch.cat([
            _attn_block_tp(q_l[:, :, c:c + c2], p_l[:, :, c:c + c2], k_l, v_l,
                           pk_l, causal, window, scale)
            for c in range(0, ll, c2)], dim=2)

    spec = info.spec
    out = shard_map(local, in_specs=(
        spec(qs.shape, ("batch", "seq_act", None, None, None, None)),
        spec(ps.shape, ("batch", "seq_act", None)),
        spec(k.shape, ("batch", None, None, None)),
        spec(v.shape, ("batch", None, None, None)),
        spec(pos_k.shape, ("batch", None))),
        out_specs=spec((B, tp, ll, Hq, Dv), ("batch", "seq_act", None, None,
                                             None)))(qs, ps, k, v, pos_k)
    return out.reshape(B, Sq, Hq, Dv)


# ---------------------------------------------------------------------------
# Cache plumbing (full + ring buffers, explicit slot positions)
# ---------------------------------------------------------------------------


def kv_cache_specs(batch: int, size: int, n_kv: int, dk: int, dv: int,
                   dtype) -> dict:
    ax = cache_axes(n_kv)
    return {
        "k": Spec((batch, size, n_kv, dk), dtype, ax),
        "v": Spec((batch, size, n_kv, dv), dtype, ax),
        "pos": Spec((batch, size), torch.int32, ("batch", ax[1])),
    }


def prefill_cache(cache: dict, new: dict[str, torch.Tensor],
                  pos: torch.Tensor) -> dict:
    """Write a full prefix into a (possibly ring) cache, in place: each leaf
    of ``new`` ((B, S, ...), e.g. ``k`` and ``v``, or MLA's ``ckv`` and
    ``kr``) and ``pos`` (B, S) at slots ``pos % size``.  For ring caches
    only the last ``size`` tokens are written (unique slots)."""
    size = cache["pos"].shape[1]
    if pos.shape[1] > size:
        new = {name: t[:, -size:] for name, t in new.items()}
        pos = pos[:, -size:]
    slots = (pos % size).long()  # floor-mod: padded rows carry pos < 0
    b_idx = torch.arange(pos.shape[0], device=pos.device)[:, None]
    for name, t in {**new, "pos": pos}.items():
        cache[name][b_idx, slots] = t.to(cache[name].dtype)
    return cache


def append_cache(cache: dict, new: dict[str, torch.Tensor],
                 pos: torch.Tensor) -> dict:
    """Append one token (decode), in place: each leaf of ``new`` ((B, 1,
    ...)) and ``pos`` (B,).

    pos < 0 marks an inactive slot (e.g. mid-chunk-prefill in the paged
    engine); JAX sends its write out of bounds, where it is dropped.  Here
    the row rewrites what its slot 0 already holds: each batch row writes
    only its own row, so no two writes collide."""
    size = cache["pos"].shape[1]
    B = pos.shape[0]
    valid = pos >= 0
    slots = torch.where(valid, pos % size, 0).long()
    b_idx = torch.arange(B, device=pos.device)
    rows = {name: t[:, 0] for name, t in new.items()}
    for name, t in {**rows, "pos": pos}.items():
        leaf = cache[name]
        cur = leaf[b_idx, slots]
        keep = valid.view((B,) + (1,) * (cur.ndim - 1))
        leaf[b_idx, slots] = torch.where(keep, t.to(leaf.dtype), cur)
    return cache


# ---------------------------------------------------------------------------
# Paged KV pools (block-table indirection, shared across decode slots)
# ---------------------------------------------------------------------------


def paged_kv_cache_specs(n_pages: int, page_size: int, n_kv: int, dk: int,
                         dv: int, dtype) -> dict:
    """Specs for a page *pool*: no batch dim -- physical pages are allocated
    to slots through a block table (see launch/paged_kv.py).

    The pool holds ``n_pages + 1`` pages.  The last one is a write-only trash
    page: every scatter that JAX drops as out of bounds (a dead slot's
    decode write, an unallocated table entry == n_pages) lands there
    instead, and every gather reads entries >= n_pages as the fill value, so
    nothing ever reads it."""
    ax = ("pages", None, "kv_heads", None)
    rows = n_pages + 1
    return {
        "k": Spec((rows, page_size, n_kv, dk), dtype, ax),
        "v": Spec((rows, page_size, n_kv, dv), dtype, ax),
        "pos": Spec((rows, page_size), torch.int32, ("pages", None)),
    }


def paged_append(cache: dict, k_t: torch.Tensor, v_t: torch.Tensor,
                 pos: torch.Tensor, table: torch.Tensor) -> dict:
    """Append one token per slot into the page pool (decode), in place.

    k_t: (B, 1, H, D); pos: (B,) absolute positions; table: (B, P).
    Slots with pos < 0 (inactive), positions past the slot's capacity and
    unallocated logical pages all write the trash page, so a dead slot can
    never corrupt pages that have been recycled to another request."""
    n_pages = cache["pos"].shape[0] - 1
    ps = cache["pos"].shape[1]
    P = table.shape[1]
    valid = (pos >= 0) & (pos < P * ps)
    lpage = (pos // ps).clamp(0, P - 1).long()
    page = table.gather(1, lpage[:, None])[:, 0]
    page = torch.where(valid, page, n_pages).long()
    off = (pos % ps).long()
    cache["k"][page, off] = k_t[:, 0].to(cache["k"].dtype)
    cache["v"][page, off] = v_t[:, 0].to(cache["v"].dtype)
    cache["pos"][page, off] = pos.to(cache["pos"].dtype)
    return cache


# ---------------------------------------------------------------------------
# Standard (GQA) attention layer
# ---------------------------------------------------------------------------


def init_attention(gen: torch.Generator | None, cfg: ModelConfig, *,
                   stack: int = 0, device: torch.device | str = "cuda") -> dict:
    d, h, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dt = cfg.param_dtype
    kw = dict(stack=stack, device=device)
    return {
        "w_q": Param(dense_init(gen, (d, h, hd), 1, dt, **kw),
                     ("embed_fsdp", "heads", None)),
        "w_k": Param(dense_init(gen, (d, hkv, hd), 1, dt, **kw),
                     ("embed_fsdp", "kv_heads", None)),
        "w_v": Param(dense_init(gen, (d, hkv, hd), 1, dt, **kw),
                     ("embed_fsdp", "kv_heads", None)),
        "w_o": Param(dense_init(gen, (h, hd, d), 2, dt, **kw),
                     ("heads", None, "embed_fsdp")),
    }


def _flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
           causal: bool, window: int = 0) -> torch.Tensor:
    return kops.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                                causal=causal, window=window)


def apply_attention(
    p: dict,
    cfg: ModelConfig,
    x: torch.Tensor,  # (B, S, d)
    ctx: ModelCtx,
    cache: dict | None,
    *,
    window: int = 0,
    cross: bool = False,
    paged: bool = False,
) -> tuple[torch.Tensor, dict | None]:
    cdt = torch_dtype(cfg.compute_dtype)
    S = x.shape[1]
    heads_tp = kv_heads_shardable(cfg.n_heads)
    # Megatron-style SP->TP boundary: un-shard the sequence once so the
    # q/k/v projections and attention run TP-local (``attention.py:395-399``)
    if heads_tp and S > 1:
        x = constrain(x, "batch", None, None)
    q = einsum("bsd,dhk->bshk", x, p["w_q"].to(cdt))
    q = constrain(q, "batch", None if heads_tp else "seq_act",
                  "heads" if heads_tp else None, None)
    if cross:
        o, new_cache = _cross(p, cdt, q, ctx, cache)
        return _out(p, cdt, o, heads_tp), new_cache
    pos_q = ctx.pos2d
    k = einsum("bsd,dhk->bshk", x, p["w_k"].to(cdt))
    v = einsum("bsd,dhk->bshk", x, p["w_v"].to(cdt))
    if cfg.pos_type in ("rope", "mrope"):
        q = apply_rope(q, ctx.positions, cfg)
        k = apply_rope(k, ctx.positions, cfg)
    new_cache = None
    if cache is None:  # train / encode: attend within the computed seq
        if ctx.contiguous:  # the encoder of a full prefill
            o = _flash(q, k, v, causal=ctx.causal, window=window)
        else:
            o = attention_core(q, k, v, pos_q, pos_q, causal=ctx.causal,
                               window=window)
    elif ctx.mode == "decode" and paged:
        # page-pool cache: scatter the new token through the block table,
        # then attend over the slot's gathered pages
        new_cache = paged_append(cache, k, v, ctx.cache_pos, ctx.table)
        o = kops.paged_attention(
            q, new_cache["k"].to(cdt), new_cache["v"].to(cdt),
            new_cache["pos"], ctx.table, pos_q, causal=ctx.causal,
            window=window)
    elif ctx.mode == "decode":
        new_cache = append_cache(cache, {"k": k, "v": v}, ctx.cache_pos)
        kv_ax = cache_axes(cfg.n_kv_heads)
        o = attention_core(q, constrain(new_cache["k"], *kv_ax).to(cdt),
                           constrain(new_cache["v"], *kv_ax).to(cdt),
                           pos_q, new_cache["pos"], causal=ctx.causal,
                           window=window)
    elif ctx.mode == "chunk_prefill":
        # continue a prefix already in the cache: attend over (cache
        # contents + this chunk), then persist the chunk
        k_att = torch.cat([cache["k"].to(cdt), k], dim=1)
        v_att = torch.cat([cache["v"].to(cdt), v], dim=1)
        pos_k = torch.cat([cache["pos"], pos_q.to(cache["pos"].dtype)], dim=1)
        new_cache = prefill_cache(cache, {"k": k, "v": v}, pos_q)
        o = attention_core(q, k_att, v_att, pos_q, pos_k, causal=ctx.causal,
                           window=window)
    else:  # prefill: attend over the computed seq, persist into the cache
        new_cache = prefill_cache(cache, {"k": k, "v": v}, pos_q)
        if ctx.contiguous:
            o = _flash(q, k, v, causal=ctx.causal, window=window)
        else:
            o = attention_core(q, k, v, pos_q, pos_q, causal=ctx.causal,
                               window=window)
    return _out(p, cdt, o, heads_tp), new_cache


def _out(p: dict, cdt: torch.dtype, o: torch.Tensor,
         heads_tp: bool) -> torch.Tensor:
    """The output projection, heads-sharded in and sequence-sharded out."""
    o = constrain(o, "batch", None if heads_tp else "seq_act",
                  "heads" if heads_tp else None, None)
    out = einsum("bshk,hkd->bsd", o, p["w_o"].to(cdt))
    return constrain(out, "batch", "seq_act", None)


def _cross(p: dict, cdt: torch.dtype, q: torch.Tensor, ctx: ModelCtx,
           cache: dict | None) -> tuple[torch.Tensor, dict | None]:
    """Cross-attention (``attention.py:405-420``): K and V come from the
    encoder output in train, prefill and chunked prefill, and prefill
    persists them in the cross cache; decode reads them from that cache.
    Non-causal, no window: only ``pos_k >= 0`` masks.  A full prefill's
    encoder frames are 0..S_enc-1, all valid, so there the flash kernel
    computes the same function (``q_offset`` 0); decode and chunked prefill
    stay on the plain path, as in JAX."""
    if cache is not None and ctx.mode == "decode":
        k, v, pos_k = cache["k"], cache["v"], cache["pos"]
        new_cache = cache
    else:
        src = ctx.enc_out
        k = einsum("bsd,dhk->bshk", src, p["w_k"].to(cdt))
        v = einsum("bsd,dhk->bshk", src, p["w_v"].to(cdt))
        pos_k = ctx.enc_positions
        new_cache = None
        if cache is not None:  # prefill: persist cross K/V
            new_cache = prefill_cache(cache, {"k": k, "v": v}, pos_k)
    if ctx.mode == "prefill" and ctx.contiguous:
        return _flash(q, k, v, causal=False), new_cache
    return attention_core(q, k.to(cdt), v.to(cdt), ctx.pos2d, pos_k,
                          causal=False, window=0), new_cache
