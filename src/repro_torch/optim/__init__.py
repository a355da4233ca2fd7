from repro_torch.optim.adamw import AdamW, OptConfig, cosine_schedule  # noqa: F401
