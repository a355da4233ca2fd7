from repro_torch.data.synthetic import TokenDataset  # noqa: F401
from repro_torch.data import commoncrawl  # noqa: F401
