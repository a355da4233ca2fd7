from repro_torch.data.synthetic import TokenDataset  # noqa: F401
