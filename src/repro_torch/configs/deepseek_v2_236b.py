"""deepseek-v2-236b [arXiv:2405.04434; hf:deepseek-ai/DeepSeek-V2].

60L, d_model=5120, 128 heads with **MLA** (q_lora=1536, kv_lora=512,
qk_nope=128, qk_rope=64, v_head=128); MoE with 160 routed experts top-6 +
2 shared experts, expert d_ff=1536, first layer dense (d_ff=12288);
vocab=102400.  The MoE all-to-all makes this the paper-representative
collective-bound hillclimb cell.
"""
from repro_torch.configs.base import ModelConfig, register


@register("deepseek-v2-236b")
def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-236b",
        family="moe",
        source="arXiv:2405.04434",
        n_layers=60,
        d_model=5120,
        n_heads=128,
        n_kv_heads=128,
        head_dim=128,
        d_ff=12288,  # dense first layer
        vocab_size=102400,
        mlp_type="glu",
        act="silu",
        pos_type="rope",
        use_mla=True,
        q_lora_rank=1536,
        kv_lora_rank=512,
        qk_nope_head_dim=128,
        qk_rope_head_dim=64,
        v_head_dim=128,
        n_experts=160,
        top_k=6,
        n_shared_experts=2,
        d_ff_expert=1536,
        first_dense_layers=1,
    )


def smoke() -> ModelConfig:
    return config().scaled(
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=192, vocab_size=256, q_lora_rank=32, kv_lora_rank=16,
        qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
        n_experts=8, top_k=2, n_shared_experts=1, d_ff_expert=48,
        first_dense_layers=1, remat="none",
    )
