"""gemma-2b [arXiv:2403.08295; hf:google/gemma-2b].

18L, d_model=2048, 8 heads with head_dim=256, MQA (1 KV head), GeGLU with
d_ff=16384, vocab=256000, sqrt(d)-scaled embeddings, (1+w) RMSNorm, tied
embeddings.
"""
from repro_torch.configs.base import ModelConfig, register


@register("gemma-2b")
def config() -> ModelConfig:
    return ModelConfig(
        name="gemma-2b",
        family="dense",
        source="arXiv:2403.08295",
        n_layers=18,
        d_model=2048,
        n_heads=8,
        n_kv_heads=1,
        head_dim=256,
        d_ff=16384,
        vocab_size=256000,
        mlp_type="glu",
        act="gelu",  # GeGLU
        pos_type="rope",
        gemma_norm=True,
        emb_scale=True,
        tie_embeddings=True,
    )


def smoke() -> ModelConfig:
    return config().scaled(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=1, head_dim=32,
        d_ff=256, vocab_size=512, remat="none",
    )
