"""whisper-medium [arXiv:2212.04356] -- encoder-decoder, audio frontend stub.

24L decoder (+24L encoder), d_model=1024, 16 heads (MHA), d_ff=4096,
vocab=51865.  The conv frontend is a stub: callers pass precomputed frame
embeddings of shape (batch, frames, d_model) as ``batch["frames"]``.
"""
from repro_torch.configs.base import ModelConfig, register


@register("whisper-medium")
def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-medium",
        family="audio",
        source="arXiv:2212.04356",
        n_layers=24,
        n_enc_layers=24,
        enc_dec=True,
        d_model=1024,
        n_heads=16,
        n_kv_heads=16,
        head_dim=64,
        d_ff=4096,
        vocab_size=51865,
        mlp_type="dense",
        act="gelu",
        norm_type="layernorm",
        norm_eps=1e-5,
        pos_type="learned",  # decoder learned positions; encoder sinusoidal
        frontend="audio",
        tie_embeddings=True,
    )


def smoke() -> ModelConfig:
    return config().scaled(
        n_layers=2, n_enc_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        head_dim=16, d_ff=128, vocab_size=256, remat="none",
    )
