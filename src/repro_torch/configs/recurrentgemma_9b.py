"""recurrentgemma-9b [arXiv:2402.19427 (Griffin); hf:google/recurrentgemma-9b].

Hybrid: Griffin pattern (RG-LRU, RG-LRU, local-attn) cycling over 38 layers,
d_model=4096, 16 heads head_dim=256, MQA (kv=1) local attention with window
2048, GeGLU d_ff=12288, vocab=256000, lru_width=4096, conv1d width 4.
Sub-quadratic: a bounded window plus an O(1) recurrent state per layer.
"""
from repro_torch.configs.base import ModelConfig, register


@register("recurrentgemma-9b")
def config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-9b",
        family="hybrid",
        source="arXiv:2402.19427",
        n_layers=38,
        d_model=4096,
        n_heads=16,
        n_kv_heads=1,
        head_dim=256,
        d_ff=12288,
        vocab_size=256000,
        layer_pattern=("rglru", "rglru", "swa"),
        window=2048,
        mlp_type="glu",
        act="gelu",  # GeGLU
        pos_type="rope",
        gemma_norm=True,
        emb_scale=True,
        tie_embeddings=True,
        lru_width=4096,
        conv_width=4,
    )


def smoke() -> ModelConfig:
    return config().scaled(
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=1, head_dim=16,
        d_ff=128, vocab_size=256, window=16, lru_width=64, remat="none",
    )
