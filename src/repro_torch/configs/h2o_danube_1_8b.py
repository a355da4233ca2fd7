"""h2o-danube-1.8b [arXiv:2401.16818; hf:h2oai/h2o-danube-1.8b-base].

Llama+Mistral mix: 24L, d_model=2560, 32 heads / 8 KV (GQA), d_ff=6912,
vocab=32000, SwiGLU, RoPE, sliding-window attention (Mistral-style, w=4096).
SWA bounds each layer's KV cache to a 4096-token ring.
"""
from repro_torch.configs.base import ModelConfig, register


@register("h2o-danube-1.8b")
def config() -> ModelConfig:
    return ModelConfig(
        name="h2o-danube-1.8b",
        family="dense",
        source="arXiv:2401.16818",
        n_layers=24,
        d_model=2560,
        n_heads=32,
        n_kv_heads=8,
        head_dim=80,
        d_ff=6912,
        vocab_size=32000,
        layer_pattern=("swa",),
        window=4096,
        mlp_type="glu",
        act="silu",
        pos_type="rope",
        rope_theta=10000.0,
    )


def smoke() -> ModelConfig:
    return config().scaled(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=160, vocab_size=256, window=16, remat="none",
    )
