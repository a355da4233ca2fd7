"""granite-moe-1b-a400m [hf:ibm-granite/granite-3.0-1b-a400m-base].

24L, d_model=1024, 16 heads / 8 KV (GQA), MoE with 32 experts top-8,
expert d_ff=512, vocab=49155, SwiGLU, RoPE.  Small-MoE contrast point to
deepseek-v2 in the roofline table.
"""
from repro_torch.configs.base import ModelConfig, register


@register("granite-moe-1b-a400m")
def config() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-1b-a400m",
        family="moe",
        source="hf:ibm-granite/granite-3.0-1b-a400m-base",
        n_layers=24,
        d_model=1024,
        n_heads=16,
        n_kv_heads=8,
        head_dim=64,
        d_ff=512,
        vocab_size=49155,
        mlp_type="glu",
        act="silu",
        pos_type="rope",
        n_experts=32,
        top_k=8,
        n_shared_experts=0,
        d_ff_expert=512,
        tie_embeddings=True,
    )


def smoke() -> ModelConfig:
    return config().scaled(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=64, vocab_size=256, n_experts=4, top_k=2, d_ff_expert=64,
        remat="none",
    )
