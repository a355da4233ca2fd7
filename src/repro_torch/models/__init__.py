from repro_torch.models.model import LanguageModel  # noqa: F401
