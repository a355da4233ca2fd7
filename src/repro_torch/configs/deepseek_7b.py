"""deepseek-7b [arXiv:2401.02954; hf:deepseek-ai/deepseek-llm-7b-base].

Llama-architecture dense baseline: 30L, d_model=4096, 32 heads (MHA, kv=32),
d_ff=11008, vocab=102400, SwiGLU, RoPE.
"""
from repro_torch.configs.base import ModelConfig, register


@register("deepseek-7b")
def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-7b",
        family="dense",
        source="arXiv:2401.02954",
        n_layers=30,
        d_model=4096,
        n_heads=32,
        n_kv_heads=32,
        head_dim=128,
        d_ff=11008,
        vocab_size=102400,
        mlp_type="glu",
        act="silu",
        pos_type="rope",
    )


def smoke() -> ModelConfig:
    return config().scaled(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=192, vocab_size=256, remat="none",
    )
