"""rwkv6-1.6b (Finch) [arXiv:2404.05892; hf:RWKV/rwkv-6-world-1b6].

Attention-free: 24L, d_model=2048 (32 heads of size 64), channel-mix
d_ff=7168 (3.5x), vocab=65536, LayerNorm with an extra norm after the
embedding (RWKV ln0), untied head.  Data-dependent decay via LoRA-projected
token-shift mixes (the Finch contribution); prefill runs the WKV scan kernel
(kernels/linear_scan.py), decode the per-step recurrence.
"""
from repro_torch.configs.base import ModelConfig, register


@register("rwkv6-1.6b")
def config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-1.6b",
        family="ssm",
        source="arXiv:2404.05892",
        n_layers=24,
        d_model=2048,
        n_heads=32,  # d_model / rwkv_head_size
        n_kv_heads=32,
        head_dim=64,
        d_ff=7168,
        vocab_size=65536,
        layer_pattern=("rwkv6",),
        mlp_type="dense",  # channel-mix handled by the rwkv block itself
        norm_type="layernorm",
        norm_eps=1e-5,
        pos_type="none",
        embed_norm=True,  # RWKV ln0
        rwkv_head_size=64,
        rwkv_decay_lora=64,
        rwkv_mix_lora=32,
    )


def smoke() -> ModelConfig:
    return config().scaled(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=224, vocab_size=256, rwkv_head_size=16, rwkv_decay_lora=16,
        rwkv_mix_lora=8, remat="none",
    )
