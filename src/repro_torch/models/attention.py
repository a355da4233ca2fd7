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
import torch.distributed._functional_collectives as funcol
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import (constrain, current_mesh_info,
                                              einsum, is_dtensor,
                                              replicate_like, shard_map)
from repro_torch.kernels import ops as kops
from repro_torch.models.layers import (Param, dense_init, rope_dim,
                                       rope_sin_cos, rotate, torch_dtype)
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
    #: decode: RoPE's (sin, cos) at ``positions`` for the attention layers'
    #: heads (``layers.rope_sin_cos``), computed once a step by
    #: ``LanguageModel.decode_step`` rather than again in every layer
    rope: tuple[torch.Tensor, torch.Tensor] | None = None
    #: paged decode: the (page, offset) pool row each slot's new token is
    #: written to (``paged_rows``), computed once a step likewise
    page_rows: tuple[torch.Tensor, torch.Tensor] | None = None

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
    Sq, Hq, Dk = q.shape[1:]
    G = Hq // k.shape[2]
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
    if is_dtensor(k):
        return _decode_on_shards(q, k, v, pos_q, pos_k, causal=causal,
                                 window=window, scale=scale)
    return _decode(q, k, v, pos_q, pos_k, causal=causal, window=window,
                   scale=scale)


def _decode(q, k, v, pos_q, pos_k, *, causal, window, scale, group=None):
    """Decode attention on plain tensors.  ``group``: the ranks whose blocks
    of slots split the keys (a ``kv_seq`` cache on local shards); the
    softmax then runs over the blocks and the partial products are summed
    in f32, one rounding to v's dtype, as without them."""
    B, Sq, Hq, Dk = q.shape
    Hkv, Dv = k.shape[2], v.shape[-1]
    qg = q.reshape(B, Sq, Hkv, Hq // Hkv, Dk)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()) * scale
    mask = _mask(pos_q[:, None, None, :, None], pos_k[:, None, None, None, :],
                 causal, window)
    s = torch.where(mask, s, NEG_INF)
    if group is None:
        o = torch.einsum("bhgqk,bkhd->bqhgd",
                         torch.softmax(s, dim=-1).to(v.dtype), v)
    else:
        p = blockwise_softmax(s, group).to(v.dtype)
        o = funcol.all_reduce(torch.einsum("bhgqk,bkhd->bqhgd", p.float(),
                                           v.float()), "sum", group).to(v.dtype)
    return o.reshape(B, Sq, Hq, Dv)


def blockwise_softmax(s: torch.Tensor, group) -> torch.Tensor:
    """``torch.softmax(s, -1)`` of scores whose last dim is split in blocks
    over ``group``'s ranks (each holds its own keys' scores): the global
    max and sum come from two all-reduces of one number a row."""
    m = funcol.all_reduce(s.amax(-1, keepdim=True), "max", group)
    p = torch.exp(s - m)
    return p / funcol.all_reduce(p.sum(-1, keepdim=True), "sum", group)


def _split(spec: tuple, dim: int) -> bool:
    return len(spec) > dim and spec[dim] is not None


def _model_rank(info) -> int:
    return info.mesh.get_local_rank("model") if info.axis_size("model") > 1 \
        else 0


def _kv_of_local_heads(k, v, first: int, hq: int, group: int):
    """The KV heads that q heads ``first .. first + hq - 1`` read, ``group``
    q heads a KV head, from K/V holding every KV head."""
    if hq % group and group % hq:
        raise ValueError(f"{hq} local q heads straddle GQA groups of {group}")
    lo, hi = first // group, (first + hq - 1) // group + 1
    return k[:, :, lo:hi], v[:, :, lo:hi]


def _decode_on_shards(q, k, v, pos_q, pos_k, *, causal, window, scale):
    """``_decode`` over a mesh's cache, on each rank's local shards
    (``shard_map``).  A cache split on ``kv_heads`` meets q split on
    ``heads``: each rank attends its own heads.  A cache split on
    ``kv_seq`` holds a block of slots a rank: q is whole there and the
    blocks are combined across the ranks that split them.  A cache whose
    slots do not divide the model axis is whole on every rank: q is split
    on ``heads`` where they divide it, each rank reading the KV heads of
    its own q heads.  The cache is never gathered."""
    info = current_mesh_info()
    B, Sq, Hq, _ = q.shape
    G = Hq // k.shape[2]
    kv_ax = cache_axes(k.shape[2])
    k_spec = info.spec(k.shape, kv_ax)
    by_seq = _split(k_spec, 1)
    q_ax = ("batch", None, None if by_seq else "heads", None)
    spec = info.spec
    q_spec = spec(q.shape, q_ax)
    group = info.mesh.get_group(k_spec[1]) if by_seq else None
    m = _model_rank(info)

    def local(q_l, k_l, v_l, pq, pk):
        if _split(q_spec, 2) and not _split(k_spec, 2):
            k_l, v_l = _kv_of_local_heads(k_l, v_l, m * q_l.shape[2],
                                          q_l.shape[2], G)
        return _decode(q_l, k_l, v_l, pq, pk, causal=causal, window=window,
                       scale=scale, group=group)

    return shard_map(local, in_specs=(
        q_spec, k_spec, spec(v.shape, kv_ax),
        spec(pos_q.shape, ("batch", None)),
        spec(pos_k.shape, ("batch", kv_ax[1]))),
        out_specs=spec((B, Sq, Hq, v.shape[-1]), q_ax))(q, k, v, pos_q, pos_k)


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


def _slot_block(leaf: torch.Tensor) -> int:
    """The first global slot of this rank's block of a DTensor cache leaf's
    slot dim (dim 1): 0 unless a mesh dim splits it (a ``kv_seq`` cache),
    each splitting mesh dim taking its blocks in order, outer first."""
    from torch.distributed.tensor import Shard

    mesh, coord = leaf.device_mesh, leaf.device_mesh.get_coordinate()
    block, lo = leaf.shape[1], 0
    for i, p in enumerate(leaf.placements):
        if isinstance(p, Shard) and p.dim % leaf.ndim == 1:
            block //= mesh.size(i)
            lo += coord[i] * block
    return lo


def _local_write(cache: dict, new: dict[str, torch.Tensor],
                 pos: torch.Tensor, write) -> dict:
    """``write(leaves, new, pos, lo, size)`` on plain tensors: off the mesh
    the cache itself (``lo`` 0); on it each rank's local shards, written in
    place.  There ``new`` and ``pos`` are laid out as their cache leaves
    with the slot dim whole (the cache, the new rows and the positions
    share the batch split; a ``kv_seq`` cache's rank receives every new
    row and keeps those of its own slots ``[lo, lo + its block)``).  The
    cache is never gathered."""
    size = cache["pos"].shape[1]
    if not is_dtensor(cache["pos"]):
        write(cache, new, pos, 0, size)
        return cache
    from torch.distributed.tensor import Replicate, Shard

    ref = cache["pos"]

    def whole_slots(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        pl = [Replicate() if isinstance(p, Shard) and p.dim % like.ndim == 1
              else p for p in like.placements]
        return replicate_like(t, ref).redistribute(ref.device_mesh,
                                                   pl).to_local()

    leaves = {name: cache[name].to_local() for name in [*new, "pos"]}
    write(leaves, {name: whole_slots(t, cache[name]) for name, t in new.items()},
          whole_slots(pos, ref), _slot_block(ref), size)
    return cache


def _prefill_write(leaves: dict, new: dict, pos: torch.Tensor, lo: int,
                   size: int) -> None:
    n = leaves["pos"].shape[1]
    if pos.shape[1] > size:
        new = {name: t[:, -size:] for name, t in new.items()}
        pos = pos[:, -size:]
    slots = (pos % size).long()  # floor-mod: padded rows carry pos < 0
    B, S = pos.shape
    b_idx = torch.arange(B, device=pos.device)[:, None]
    rows = {**new, "pos": pos}
    if n == size:  # every slot is here
        for name, t in rows.items():
            leaves[name][b_idx, slots] = t.to(leaves[name].dtype)
        return
    # a block of a kv_seq cache: a row whose slot lies elsewhere writes
    # local slot 0 with the value slot 0 receives anyway (its own new row,
    # or what it holds), so no two writes of a slot differ
    here = (slots >= lo) & (slots < lo + n)
    tok = torch.arange(S, device=pos.device).expand(B, S)
    writer = torch.full((B, n + 1), -1, dtype=torch.long, device=pos.device)
    writer.scatter_(1, torch.where(here, slots - lo, n), tok)
    src = torch.where(here, tok, writer[:, :1])
    dest = torch.where(here, slots - lo, 0)
    for name, t in rows.items():
        leaf = leaves[name]
        shape = (B, S) + t.shape[2:]
        idx = src.clamp(min=0).reshape((B, S) + (1,) * (t.ndim - 2))
        val = t.gather(1, idx.expand(shape)).to(leaf.dtype)
        keep = (src >= 0).reshape(idx.shape)
        leaf[b_idx, dest] = torch.where(keep, val, leaf[:, :1].expand(shape))


def prefill_cache(cache: dict, new: dict[str, torch.Tensor],
                  pos: torch.Tensor) -> dict:
    """Write a full prefix into a (possibly ring) cache, in place: each leaf
    of ``new`` ((B, S, ...), e.g. ``k`` and ``v``, or MLA's ``ckv`` and
    ``kr``) and ``pos`` (B, S) at slots ``pos % size``.  For ring caches
    only the last ``size`` tokens are written (unique slots).  Under a mesh
    each rank writes its own shards (``_local_write``)."""
    return _local_write(cache, new, pos, _prefill_write)


def _append_write(leaves: dict, new: dict, pos: torch.Tensor, lo: int,
                  size: int) -> None:
    n = leaves["pos"].shape[1]
    B = pos.shape[0]
    valid = pos >= 0
    slots = pos % size
    if n < size:  # a block of a kv_seq cache: only its own slots
        valid = valid & (slots >= lo) & (slots < lo + n)
        slots = slots - lo
    slots = torch.where(valid, slots, 0).long()
    b_idx = torch.arange(B, device=pos.device)
    rows = {name: t[:, 0] for name, t in new.items()}
    for name, t in {**rows, "pos": pos}.items():
        leaf = leaves[name]
        cur = leaf[b_idx, slots]
        keep = valid.view((B,) + (1,) * (cur.ndim - 1))
        leaf[b_idx, slots] = torch.where(keep, t.to(leaf.dtype), cur)


def append_cache(cache: dict, new: dict[str, torch.Tensor],
                 pos: torch.Tensor) -> dict:
    """Append one token (decode), in place: each leaf of ``new`` ((B, 1,
    ...)) and ``pos`` (B,).

    pos < 0 marks an inactive slot (e.g. mid-chunk-prefill in the paged
    engine); JAX sends its write out of bounds, where it is dropped.  Here
    the row rewrites what its slot 0 already holds: each batch row writes
    only its own row, so no two writes collide.  Under a mesh each rank
    writes its own shards, and a ``kv_seq`` block treats a row whose slot
    lies in another rank's block as inactive."""
    return _local_write(cache, new, pos, _append_write)


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


def paged_rows(pos: torch.Tensor, table: torch.Tensor, n_pages: int,
               page_size: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(page, offset) of the pool row each slot's token at ``pos`` (B,)
    goes to through ``table`` (B, P).  Slots with pos < 0 (inactive),
    positions past the slot's capacity and unallocated logical pages all
    get the trash page ``n_pages``, so a dead slot can never corrupt pages
    that have been recycled to another request."""
    P = table.shape[1]
    valid = (pos >= 0) & (pos < P * page_size)
    lpage = (pos // page_size).clamp(0, P - 1).long()
    page = table.gather(1, lpage[:, None])[:, 0]
    page = torch.where(valid, page, n_pages).long()
    return page, (pos % page_size).long()


def paged_append(cache: dict, k_t: torch.Tensor, v_t: torch.Tensor,
                 pos: torch.Tensor,
                 rows: tuple[torch.Tensor, torch.Tensor]) -> dict:
    """Append one token per slot into the page pool (decode), in place.

    k_t: (B, 1, H, D); pos: (B,) absolute positions; rows: ``paged_rows``
    of ``pos`` through the step's block table."""
    page, off = rows
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


def flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
          causal: bool, window: int = 0) -> torch.Tensor:
    """Attention through the flash kernel at contiguous positions, at the
    scale D^-0.5.  A head dim that is not a multiple of 16 (MLA's smoke
    configs: 16 + 8) is zero-padded in q and k for the bf16 bodies'
    16-element row loads: the padded dims add exact zeros to every score.

    Under a mesh the kernel runs in ``shard_map`` on each rank's local
    (batch, heads) shard, plain tensors: q split on ``heads`` where the
    model axis divides them, K/V on ``kv_heads`` where it divides those,
    else whole on every rank, each rank then reading the KV heads of its
    own q heads (MQA: the one KV head).  Where the heads do not divide the
    model axis q is split on ``seq_act`` instead, K/V are whole, and each
    rank's rows start at ``q_offset`` = its block's first position, which
    the causal and window masks read."""
    scale = q.shape[-1] ** -0.5

    def call(q, k, v, q_offset=0):
        pad = -q.shape[-1] % 16
        if pad:
            q, k = F.pad(q, (0, pad)), F.pad(k, (0, pad))
        return kops.flash_attention(q.contiguous(), k.contiguous(),
                                    v.contiguous(), causal=causal,
                                    window=window, scale=scale,
                                    q_offset=q_offset)

    info = current_mesh_info()
    if info is None or not is_dtensor(q):
        return call(q, k, v)
    B, Sq, Hq, _ = q.shape
    Hkv, Dv = k.shape[2], v.shape[-1]
    G = Hq // Hkv
    heads = kv_heads_shardable(Hq)
    q_ax = ("batch", None, "heads", None) if heads else \
        ("batch", "seq_act", None, None)
    kv_ax = ("batch", None, "kv_heads" if heads and kv_heads_shardable(Hkv)
             else None, None)
    q_spec, k_spec, v_spec = (info.spec(t.shape, ax) for t, ax in
                              ((q, q_ax), (k, kv_ax), (v, kv_ax)))
    m = _model_rank(info)

    def local(q_l, k_l, v_l):
        if _split(q_spec, 2) and not _split(k_spec, 2):
            k_l, v_l = _kv_of_local_heads(k_l, v_l, m * q_l.shape[2],
                                          q_l.shape[2], G)
        return call(q_l, k_l, v_l, m * q_l.shape[1] if _split(q_spec, 1)
                    else 0)

    return shard_map(local, in_specs=(q_spec, k_spec, v_spec),
                     out_specs=info.spec((B, Sq, Hq, Dv), q_ax))(q, k, v)


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
        sin, cos = ctx.rope or rope_sin_cos(
            ctx.positions, cfg, rope_dim(cfg, q.shape[-1]), x.device)
        q, k = rotate(q, sin, cos), rotate(k, sin, cos)
    new_cache = None
    if cache is None:  # train / encode: attend within the computed seq
        if ctx.contiguous:  # the encoder of a full prefill
            o = flash(q, k, v, causal=ctx.causal, window=window)
        else:
            o = attention_core(q, k, v, pos_q, pos_q, causal=ctx.causal,
                               window=window)
    elif ctx.mode == "decode" and paged:
        # page-pool cache: scatter the new token through the block table,
        # then attend over the slot's pages in the pools' own dtype
        new_cache = paged_append(cache, k, v, ctx.cache_pos, ctx.page_rows)
        o = kops.paged_attention(
            q, new_cache["k"], new_cache["v"], new_cache["pos"], ctx.table,
            pos_q, causal=ctx.causal, window=window)
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
            o = flash(q, k, v, causal=ctx.causal, window=window)
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
        return flash(q, k, v, causal=False), new_cache
    return attention_core(q, k.to(cdt), v.to(cdt), ctx.pos2d, pos_k,
                          causal=False, window=0), new_cache
