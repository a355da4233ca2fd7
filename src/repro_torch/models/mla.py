"""Multi-head Latent Attention (DeepSeek-V2 [arXiv:2405.04434], MiniCPM3).

Port of ``repro.models.mla``, with its sharding constraints
(``constrain``: no-ops without a mesh).
Train and prefill use the expanded path: the latent ``c_kv`` is expanded to
per-head keys and values, and a full prefill with contiguous positions runs
the flash kernel at D = nope + rope, Dv = v_head_dim, as the other
attention layers do (``attention.py``); train and a prefill with explicit
positions run the plain ``attention_core``.  Decode and chunked prefill use
the weight-absorbed path: scores and outputs are computed in the latent
space, so the cache holds only ``kv_lora_rank + qk_rope_head_dim`` numbers
per token.

The latent cache is slot-dense (``"batch"`` axis) in both engines, and is
written in place by the attention layers' ``prefill_cache`` (a prompt
longer than the cache keeps its last tokens, ``mla.py:198``) and
``append_cache`` (the decode write that JAX drops for an inactive slot,
``mla.py:133``, made explicit).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import constrain
from repro_torch.kernels import ops as kops
from repro_torch.models.attention import (NEG_INF, ModelCtx, append_cache,
                                          attention_core, kv_heads_shardable,
                                          prefill_cache)
from repro_torch.models.layers import (Param, apply_norm, apply_rope,
                                       dense_init, torch_dtype)
from repro_torch.utils import Spec

#: the bf16 flash bodies load head dims in 16-element rows
_FLASH_D_MULTIPLE = 16


def init_mla(gen: torch.Generator | None, cfg: ModelConfig, *, stack: int = 0,
             device: torch.device | str = "cuda") -> dict:
    d, h = cfg.d_model, cfg.n_heads
    nope, rope, vdim = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    qk = nope + rope
    dt = cfg.param_dtype
    kw = dict(stack=stack, device=device)

    def ones(n: int) -> dict:
        shape = ((stack,) if stack else ()) + (n,)
        return {"scale": Param(torch.ones(shape, dtype=torch_dtype(dt),
                                          device=device), (None,))}

    p: dict = {}
    if cfg.q_lora_rank:
        p["w_dq"] = Param(dense_init(gen, (d, cfg.q_lora_rank), 1, dt, **kw),
                          ("embed_fsdp", "lora"))
        p["q_norm"] = ones(cfg.q_lora_rank)
        p["w_uq"] = Param(dense_init(gen, (cfg.q_lora_rank, h, qk), 1, dt,
                                     **kw), ("lora", "heads", None))
    else:
        p["w_uq"] = Param(dense_init(gen, (d, h, qk), 1, dt, **kw),
                          ("embed_fsdp", "heads", None))
    p["w_dkv"] = Param(dense_init(gen, (d, cfg.kv_lora_rank), 1, dt, **kw),
                       ("embed_fsdp", "lora"))
    p["kv_norm"] = ones(cfg.kv_lora_rank)
    p["w_kr"] = Param(dense_init(gen, (d, rope), 1, dt, **kw),
                      ("embed_fsdp", None))
    p["w_uk"] = Param(dense_init(gen, (cfg.kv_lora_rank, h, nope), 1, dt,
                                 **kw), ("lora", "heads", None))
    p["w_uv"] = Param(dense_init(gen, (cfg.kv_lora_rank, h, vdim), 1, dt,
                                 **kw), ("lora", "heads", None))
    p["w_o"] = Param(dense_init(gen, (h, vdim, d), 2, dt, **kw),
                     ("heads", None, "embed_fsdp"))
    return p


def _rms(scale: torch.Tensor, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """The latents' RMSNorm: plain ``x_hat * scale`` whatever the model's
    norm type."""
    return apply_norm({"scale": scale}, cfg.scaled(norm_type="rmsnorm",
                                                   gemma_norm=False), x)


def _queries(p: dict, cfg: ModelConfig, x: torch.Tensor, ctx: ModelCtx):
    """Under a mesh the down-projection runs sequence-sharded and only the
    q_lora_rank latent crosses the SP->TP boundary (``mla.py:54-81``)."""
    cdt = torch_dtype(cfg.compute_dtype)
    nope, rope = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    gather = kv_heads_shardable(cfg.n_heads) and x.shape[1] > 1
    if cfg.q_lora_rank:
        cq = _rms(p["q_norm"]["scale"], cfg, x @ p["w_dq"].to(cdt))
        if gather:
            cq = constrain(cq, "batch", None, None)  # SP->TP on the latent
        q = torch.einsum("bsl,lhk->bshk", cq, p["w_uq"].to(cdt))
    else:
        if gather:
            x = constrain(x, "batch", None, None)
        q = torch.einsum("bsd,dhk->bshk", x, p["w_uq"].to(cdt))
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    return q_nope, apply_rope(q_rope, ctx.positions, cfg, rot_dim=rope)


def _latents(p: dict, cfg: ModelConfig, x: torch.Tensor, ctx: ModelCtx):
    """Compressed per-token cache content: normed c_kv and the roped shared
    k_rope, (B, S, kv_lora) and (B, S, rope)."""
    cdt = torch_dtype(cfg.compute_dtype)
    ckv = _rms(p["kv_norm"]["scale"], cfg, x @ p["w_dkv"].to(cdt))
    kr = (x @ p["w_kr"].to(cdt))[:, :, None, :]
    kr = apply_rope(kr, ctx.positions, cfg, rot_dim=cfg.qk_rope_head_dim)[:, :, 0]
    return ckv, kr


def mla_cache_specs(batch: int, size: int, cfg: ModelConfig, dtype) -> dict:
    ax = ("batch", None, None)
    return {
        "ckv": Spec((batch, size, cfg.kv_lora_rank), dtype, ax),
        "kr": Spec((batch, size, cfg.qk_rope_head_dim), dtype, ax),
        "pos": Spec((batch, size), torch.int32, ("batch", None)),
    }


def _flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           causal: bool) -> torch.Tensor:
    """Full prefill through the flash kernel at the softmax scale
    (nope + rope)^-0.5.  A head dim that is not a multiple of 16 (the smoke
    configs' 16 + 8) is zero-padded for the bf16 bodies' row loads: the
    padded dims add exact zeros to every score."""
    D = q.shape[-1]
    pad = -D % _FLASH_D_MULTIPLE
    if pad:
        q, k = F.pad(q, (0, pad)), F.pad(k, (0, pad))
    return kops.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                                causal=causal, scale=D ** -0.5)


def _absorbed(p: dict, cfg: ModelConfig, q_nope: torch.Tensor,
              q_rope: torch.Tensor, ckv: torch.Tensor, kr: torch.Tensor,
              pos_q: torch.Tensor, pos_k: torch.Tensor) -> torch.Tensor:
    """Latent-space attention (``mla.py:158-169``): W_uk absorbed into q,
    scores with f32 products and sums, masked with the finite NEG_INF,
    softmax in f32, weights cast to the compute dtype for the c_kv product,
    then W_uv.  q: (B, Q, H, .); ckv, kr: (B, S, .); pos_q (B, Q), pos_k
    (B, S) -> (B, Q, H, v_head_dim)."""
    cdt = torch_dtype(cfg.compute_dtype)
    q_lat = torch.einsum("bqhn,lhn->bqhl", q_nope, p["w_uk"].to(cdt))
    s = torch.einsum("bqhl,bsl->bhqs", q_lat.float(), ckv.float())
    s = s + torch.einsum("bqhr,bsr->bhqs", q_rope.float(), kr.float())
    s = s * (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim) ** -0.5
    mask = (pos_k[:, None, :] >= 0) & (pos_k[:, None, :] <= pos_q[:, :, None])
    s = torch.where(mask[:, None], s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    o_lat = torch.einsum("bhqs,bsl->bqhl", w.to(cdt), ckv)
    return torch.einsum("bqhl,lhv->bqhv", o_lat, p["w_uv"].to(cdt))


def apply_mla(p: dict, cfg: ModelConfig, x: torch.Tensor, ctx: ModelCtx,
              cache: dict | None) -> tuple[torch.Tensor, dict | None]:
    cdt = torch_dtype(cfg.compute_dtype)
    B, S, _ = x.shape
    heads_tp = kv_heads_shardable(cfg.n_heads)
    q_nope, q_rope = _queries(p, cfg, x, ctx)
    ckv_t, kr_t = _latents(p, cfg, x, ctx)
    pos_q = ctx.pos2d

    if ctx.mode == "decode":
        assert cache is not None
        append_cache(cache, {"ckv": ckv_t, "kr": kr_t}, ctx.cache_pos)
        ckv = constrain(cache["ckv"], "batch", "kv_seq", None).to(cdt)
        kr = constrain(cache["kr"], "batch", "kv_seq", None).to(cdt)
        o = _absorbed(p, cfg, q_nope, q_rope, ckv, kr, ctx.cache_pos[:, None],
                      cache["pos"])
    elif ctx.mode == "chunk_prefill":
        assert cache is not None
        # attend over (old cache contents + this chunk), taken before the
        # chunk is written: empty slots carry pos -1 and drop out of the mask
        ckv = torch.cat([cache["ckv"].to(cdt), ckv_t], dim=1)
        kr = torch.cat([cache["kr"].to(cdt), kr_t], dim=1)
        pos_k = torch.cat([cache["pos"], pos_q.to(cache["pos"].dtype)], dim=1)
        prefill_cache(cache, {"ckv": ckv_t, "kr": kr_t}, pos_q)
        o = _absorbed(p, cfg, q_nope, q_rope, ckv, kr, pos_q, pos_k)
    else:  # train, prefill: the expanded path
        # the latents are computed sequence-sharded; only (kv_lora + rope)
        # dims cross the SP->TP boundary (``mla.py:171-192``)
        h, rope = cfg.n_heads, cfg.qk_rope_head_dim
        ax = ("batch", None if heads_tp else "seq_act",
              "heads" if heads_tp else None, None)
        ckv, kr = ckv_t, kr_t
        if heads_tp and S > 1:
            ckv = constrain(ckv, "batch", None, None)
            kr = constrain(kr, "batch", None, None)
        k_nope = constrain(torch.einsum("bsl,lhn->bshn", ckv, p["w_uk"].to(cdt)),
                           *ax)
        v = constrain(torch.einsum("bsl,lhv->bshv", ckv, p["w_uv"].to(cdt)), *ax)
        kr_b = constrain(kr[:, :, None, :].expand(B, S, h, rope), *ax)
        k = constrain(torch.cat([k_nope, kr_b], dim=-1), *ax)
        q = constrain(torch.cat([q_nope, q_rope], dim=-1), *ax)
        if cache is not None:  # prefill: persist the compressed latents
            prefill_cache(cache, {"ckv": ckv_t, "kr": kr_t}, pos_q)
        if ctx.mode == "prefill" and ctx.contiguous:
            o = _flash(q, k, v, ctx.causal)
        else:
            o = attention_core(q, k, v, pos_q, pos_q, causal=ctx.causal)
    o = constrain(o, "batch", None if heads_tp else "seq_act",
                  "heads" if heads_tp else None, None)
    out = torch.einsum("bshv,hvd->bsd", o, p["w_o"].to(cdt))
    return constrain(out, "batch", "seq_act", None), cache
