"""minicpm3-4b [hf:openbmb/MiniCPM3-4B].

62L, d_model=2560, 40 heads, d_ff=6400, vocab=73448, **MLA**
(q_lora_rank=768, kv_lora_rank=256, qk_nope=64, qk_rope=32, v_head=64).
MiniCPM's muP-style scale factors (scale_emb/scale_depth) are omitted, as
in the JAX package's config.
"""
from repro_torch.configs.base import ModelConfig, register


@register("minicpm3-4b")
def config() -> ModelConfig:
    return ModelConfig(
        name="minicpm3-4b",
        family="dense",
        source="hf:openbmb/MiniCPM3-4B",
        n_layers=62,
        d_model=2560,
        n_heads=40,
        n_kv_heads=40,
        head_dim=64,
        d_ff=6400,
        vocab_size=73448,
        mlp_type="glu",
        act="silu",
        pos_type="rope",
        use_mla=True,
        q_lora_rank=768,
        kv_lora_rank=256,
        qk_nope_head_dim=64,
        qk_rope_head_dim=32,
        v_head_dim=64,
        tie_embeddings=True,
    )


def smoke() -> ModelConfig:
    return config().scaled(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab_size=256, q_lora_rank=32, kv_lora_rank=16,
        qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16, remat="none",
    )
