"""qwen2-vl-72b [arXiv:2409.12191; hf:Qwen/Qwen2-VL-72B].

80L, d_model=8192, 64 heads / 8 KV (GQA), d_ff=29568, vocab=152064, SwiGLU,
**M-RoPE** (multimodal rotary: temporal/height/width sections 16/24/24 freq
pairs of the 128-dim head).  The vision frontend (dynamic-resolution ViT) is
a stub: callers pass precomputed patch embeddings as ``batch["embeds"]``,
and ``batch["positions"]`` carries the 3-component M-RoPE coordinates.
"""
from repro_torch.configs.base import ModelConfig, register


@register("qwen2-vl-72b")
def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-72b",
        family="vlm",
        source="arXiv:2409.12191",
        n_layers=80,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        head_dim=128,
        d_ff=29568,
        vocab_size=152064,
        mlp_type="glu",
        act="silu",
        pos_type="mrope",
        rope_theta=1_000_000.0,
        mrope_sections=(16, 24, 24),
        frontend="vision",
    )


def smoke() -> ModelConfig:
    return config().scaled(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=192, vocab_size=256, mrope_sections=(2, 3, 3), remat="none",
    )
