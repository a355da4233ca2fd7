"""Analytic per-step FLOPs and HBM-byte models for the roofline (the port's
copy of ``repro.launch.flops``, same formulas and numbers).

The dry run (``launch/dryrun.py``) takes its compute and memory terms from
here, not from a trace: it runs on fake tensors and a fake process group,
where nothing executes.  Its collective term is counted from the
collectives DTensor issues in that run.

Conventions:
  * matmul (m,k)x(k,n): 2mkn flops.
  * causal attention effective kv length: S/2 (the port's flash kernel
    skips the key tiles above the diagonal in a full prefill); sliding
    window: min(window, S/2-ish) -> window.  Training runs the plain
    ``attention_core`` over the full (Sq x Skv) square and masks it, so a
    train step executes up to twice the attention-core FLOPs counted here
    (the flash kernel has no backward, in the JAX package or the port).
  * train = fwd * (3 + 1 if full remat): bwd = 2x fwd, remat adds one fwd.
  * HBM bytes: local weight shards (f32 train state traffic, bf16 compute
    reads), FSDP-gathered per-layer weights (1/TP per device), activation
    residual/intermediate traffic, KV-cache reads for decode.
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig, ShapeSpec

_ACT_RT_COEFF_TRAIN = 30.0  # residual+norm+proj intermediates, rw, remat
_ACT_RT_COEFF_FWD = 12.0


def _attn_flops(cfg: ModelConfig, t: float, kv_eff: float,
                decode: bool = False) -> float:
    d, hq, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    proj = 2 * t * d * (2 * hq * dh + 2 * hkv * dh)  # q,o + k,v
    core = 2 * t * kv_eff * hq * dh * 2  # qk^T + pv
    return proj + core


def _mla_flops(cfg: ModelConfig, t: float, kv_eff: float,
               decode: bool = False) -> float:
    d, h = cfg.d_model, cfg.n_heads
    nope, rope, vd = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    ql, kl = cfg.q_lora_rank, cfg.kv_lora_rank
    f = 0.0
    if ql:
        f += 2 * t * d * ql + 2 * t * ql * h * (nope + rope)
    else:
        f += 2 * t * d * h * (nope + rope)
    f += 2 * t * d * (kl + rope)  # kv down-projection + shared rope key
    if decode:
        # absorbed path: scores/outputs live in latent space
        f += 2 * t * h * nope * kl  # q absorb
        f += 2 * t * kv_eff * h * (kl + rope)  # scores vs latent cache
        f += 2 * t * kv_eff * h * kl  # attention-weighted latents
        f += 2 * t * h * kl * vd  # output absorb
    else:
        f += 2 * t * kl * h * (nope + vd)  # expand k_nope, v
        f += 2 * t * kv_eff * h * (nope + rope) + 2 * t * kv_eff * h * vd
    f += 2 * t * h * vd * d  # o-proj
    return f


def _mlp_flops(cfg: ModelConfig, t: float) -> float:
    mult = 3 if cfg.mlp_type == "glu" else 2
    return 2 * t * cfg.d_model * cfg.d_ff * mult


def _moe_flops(cfg: ModelConfig, t: float) -> float:
    d, ffe = cfg.d_model, cfg.d_ff_expert
    f = 2 * t * d * cfg.n_experts  # router
    f += 2 * t * cfg.top_k * d * ffe * 3  # routed experts (glu)
    f += 2 * t * d * (cfg.n_shared_experts * ffe) * 3  # shared experts
    return f


def _rglru_flops(cfg: ModelConfig, t: float) -> float:
    d, w = cfg.d_model, cfg.lru_width or cfg.d_model
    f = 2 * t * d * w * 2  # two input branches
    f += 2 * t * w * w * 2  # recurrence + input gates
    f += 2 * t * w * cfg.conv_width  # depthwise conv
    f += 10 * t * w  # scan update arithmetic
    f += 2 * t * w * d  # out proj
    return f


def _rwkv_flops(cfg: ModelConfig, t: float) -> float:
    d = cfg.d_model
    n = cfg.rwkv_head_size
    h = d // n
    f = 2 * t * d * d * 4  # r,k,v,g projections
    f += 2 * t * d * cfg.rwkv_decay_lora * 2  # decay lora
    f += 2 * t * d * 5 * cfg.rwkv_mix_lora * 2  # ddlerp loras
    f += t * h * n * n * 6  # wkv state update + readout per token
    f += 2 * t * d * cfg.d_ff * 2 + 2 * t * d * d  # channel mix
    f += 2 * t * d * d  # o-proj
    return f


def fwd_flops(cfg: ModelConfig, tokens: float, kv_len: float,
              decode: bool = False) -> float:
    """Forward FLOPs for `tokens` processed tokens against kv_len context."""
    total = 0.0
    kinds = cfg.layer_types()
    if cfg.enc_dec:
        kinds = ["attn"] * cfg.n_enc_layers + ["xattn"] * cfg.n_layers
    for i, kind in enumerate(kinds):
        if kind in ("attn", "xattn"):
            kv_eff = kv_len if decode else kv_len / 2
            if cfg.use_mla:
                total += _mla_flops(cfg, tokens, kv_eff, decode)
            else:
                total += _attn_flops(cfg, tokens, kv_eff, decode)
            if kind == "xattn":  # cross-attention (bidirectional)
                total += _attn_flops(cfg, tokens, kv_len, decode)
        elif kind == "swa":
            kv_eff = min(cfg.window, kv_len) if cfg.window else kv_len
            if not decode:
                kv_eff = min(kv_eff, kv_len / 2)
            total += _attn_flops(cfg, tokens, kv_eff, decode)
        elif kind == "rglru":
            total += _rglru_flops(cfg, tokens)
        elif kind == "rwkv6":
            total += _rwkv_flops(cfg, tokens)
            continue  # rwkv block includes its channel mix
        # mlp / moe
        is_moe = (cfg.n_experts > 0 and i >= cfg.first_dense_layers
                  and kind in ("attn", "swa"))
        if is_moe:
            total += _moe_flops(cfg, tokens)
        else:
            total += _mlp_flops(cfg, tokens)
    total += 2 * tokens * cfg.d_model * cfg.vocab_size  # lm head
    return total


def step_flops(cfg: ModelConfig, shape: ShapeSpec) -> float:
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        mult = 4.0 if cfg.remat == "full" else 3.0
        return mult * fwd_flops(cfg, b * s, s)
    if shape.kind == "prefill":
        return fwd_flops(cfg, b * s, s)
    return fwd_flops(cfg, float(b), float(s), decode=True)


# ---------------------------------------------------------------------------
# HBM byte model (per device)
# ---------------------------------------------------------------------------


def _cache_bytes_total(cfg: ModelConfig, shape: ShapeSpec) -> float:
    """Total KV-cache / state bytes across the whole job (bf16 cache)."""
    b, s = shape.global_batch, shape.seq_len
    total = 0.0
    kinds = cfg.layer_types()
    if cfg.enc_dec:
        kinds = ["xattn"] * cfg.n_layers
    for kind in kinds:
        if kind in ("attn", "xattn"):
            if cfg.use_mla:
                per_tok = cfg.kv_lora_rank + cfg.qk_rope_head_dim
            else:
                per_tok = 2 * cfg.n_kv_heads * cfg.head_dim
            total += b * s * per_tok * 2
            if kind == "xattn":  # cross K/V cache
                total += b * s * 2 * cfg.n_kv_heads * cfg.head_dim * 2
        elif kind == "swa":
            w = min(cfg.window or s, s)
            total += b * w * 2 * cfg.n_kv_heads * cfg.head_dim * 2
        elif kind == "rglru":
            total += b * (cfg.lru_width or cfg.d_model) * 4
        elif kind == "rwkv6":
            n = cfg.rwkv_head_size
            total += b * (cfg.d_model // n) * n * n * 4
    return total


def step_hbm_bytes(cfg: ModelConfig, shape: ShapeSpec, n_chips: int,
                   tp: int) -> float:
    """Per-device HBM traffic per step (documented estimate, DESIGN.md §5)."""
    p = cfg.param_count()
    b, s = shape.global_batch, shape.seq_len
    layers = cfg.n_layers + (cfg.n_enc_layers if cfg.enc_dec else 0)
    if shape.kind == "train":
        local_state = p / n_chips * (12 + 8 + 16 + 4)  # f32 reads, grads, opt
        gathered = p / max(tp, 1) * 2 * 3 * 2  # bf16 layer gathers, 3 passes
        acts = (b * s / n_chips) * cfg.d_model * layers * \
            _ACT_RT_COEFF_TRAIN * 2
        return local_state + gathered + acts
    if shape.kind == "prefill":
        weights = p / max(tp, 1) * 2
        acts = (b * s / n_chips) * cfg.d_model * layers * _ACT_RT_COEFF_FWD * 2
        cache_w = _cache_bytes_total(cfg, shape) / n_chips
        return weights + acts + cache_w
    # decode: weights + full cache read per step
    weights = p / max(tp, 1) * 2
    cache_r = _cache_bytes_total(cfg, shape) / n_chips
    return weights + cache_r
