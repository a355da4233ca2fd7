"""Model configuration and registry (the port's own copy of
``repro.configs.base``: the port imports nothing of the JAX package).

Every architecture is a frozen ``ModelConfig``; arch modules register a
factory under their public name and expose ``smoke()``, a narrow two-layer
twin of the same shape family used by the CPU tests.
"""
from __future__ import annotations

import dataclasses
from typing import Callable


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | hybrid | ssm | vlm | audio
    source: str  # public citation for the config
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # block composition --------------------------------------------------
    # layer_pattern cycles over layers; entries: attn | swa | rglru | rwkv6
    layer_pattern: tuple[str, ...] = ("attn",)
    window: int = 0  # sliding/local attention window (swa layers)
    mlp_type: str = "glu"  # glu | dense
    act: str = "silu"  # silu | gelu
    norm_type: str = "rmsnorm"  # rmsnorm | layernorm
    norm_eps: float = 1e-6
    gemma_norm: bool = False  # RMSNorm computes (1 + w) * x_hat

    # positions -----------------------------------------------------------
    pos_type: str = "rope"  # rope | mrope | sinusoidal | learned | none
    rope_theta: float = 10000.0
    rope_fraction: float = 1.0  # fraction of head_dim that is rotated
    mrope_sections: tuple[int, ...] = ()  # in freq pairs; sums to rotated/2

    # MLA (DeepSeek-V2 / MiniCPM3) -----------------------------------------
    use_mla: bool = False
    q_lora_rank: int = 0  # 0 => no q compression
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0

    # MoE -------------------------------------------------------------------
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    d_ff_expert: int = 0
    first_dense_layers: int = 0  # leading dense layers before MoE layers
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.001

    # encoder-decoder --------------------------------------------------------
    enc_dec: bool = False
    n_enc_layers: int = 0

    # recurrent (Griffin RG-LRU) ---------------------------------------------
    lru_width: int = 0
    conv_width: int = 4

    # RWKV-6 ------------------------------------------------------------------
    rwkv_head_size: int = 64
    rwkv_decay_lora: int = 64
    rwkv_mix_lora: int = 32

    # modality frontend (input_specs provides embeddings)
    frontend: str = "none"  # none | audio | vision

    # misc ---------------------------------------------------------------------
    emb_scale: bool = False  # multiply embeddings by sqrt(d_model) (gemma)
    embed_norm: bool = False  # LayerNorm right after embedding (RWKV ln0)
    max_positions: int = 32768  # learned position table size (pos_type=learned)
    tie_embeddings: bool = False
    remat: str = "full"  # full | dots | none
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"

    # -------------------------------------------------------------------------
    def layer_types(self) -> tuple[str, ...]:
        pat = self.layer_pattern
        return tuple(pat[i % len(pat)] for i in range(self.n_layers))

    @property
    def q_dim(self) -> int:
        if self.use_mla:
            return self.n_heads * (self.qk_nope_head_dim + self.qk_rope_head_dim)
        return self.n_heads * self.head_dim

    def scaled(self, **overrides) -> "ModelConfig":
        return dataclasses.replace(self, **overrides)

    # parameter count (analytic) ---------------------------------------------
    def param_count(self) -> int:
        d = self.d_model
        n = 0
        n += self.vocab_size * d  # embed
        if not self.tie_embeddings:
            n += self.vocab_size * d
        layers = list(self.layer_types())
        if self.enc_dec:
            layers = ["attn"] * self.n_enc_layers + ["xattn"] * self.n_layers
        for i, t in enumerate(layers):
            if t in ("attn", "swa", "xattn"):
                n += self._attn_params()
                if t == "xattn":
                    n += self._attn_params()  # cross-attention
            elif t == "rglru":
                w = self.lru_width or d
                n += 2 * d * w + self.conv_width * w + 4 * w + w * d
            elif t == "rwkv6":
                h = d // self.rwkv_head_size
                n += 4 * d * d + d * self.rwkv_decay_lora * 2 + 5 * self.rwkv_mix_lora * d * 2
                n += 2 * h * self.rwkv_head_size  # u, per-head ln
            # mlp
            is_moe = self.n_experts > 0 and i >= self.first_dense_layers and t not in ("rwkv6",)
            if t == "rwkv6":
                n += 2 * d * self.d_ff + d * d  # channel mix: k, v, r
            elif is_moe:
                ff = self.d_ff_expert
                n += self.n_experts * 3 * d * ff
                n += self.n_shared_experts * 3 * d * ff
                n += d * self.n_experts  # router
            else:
                mult = 3 if self.mlp_type == "glu" else 2
                n += mult * d * self.d_ff
            n += 2 * d  # norms
        n += d  # final norm
        return n

    def _attn_params(self) -> int:
        d = self.d_model
        if self.use_mla:
            n = 0
            if self.q_lora_rank:
                n += d * self.q_lora_rank + self.q_lora_rank * self.q_dim
            else:
                n += d * self.q_dim
            n += d * (self.kv_lora_rank + self.qk_rope_head_dim)
            n += self.kv_lora_rank * self.n_heads * (self.qk_nope_head_dim + self.v_head_dim)
            n += self.n_heads * self.v_head_dim * d
            return n
        hd = self.head_dim
        return d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd + self.n_heads * hd * d


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: dict[str, Callable[[], ModelConfig]] = {}


def register(name: str):
    def deco(fn: Callable[[], ModelConfig]):
        _REGISTRY[name] = fn
        return fn

    return deco


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]()


def list_configs() -> list[str]:
    return sorted(_REGISTRY)
