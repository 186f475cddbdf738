"""repro_torch.data — the deterministic synthetic pipeline."""
from repro_torch.data.synthetic import (  # noqa: F401
    DataConfig,
    SyntheticDataset,
    batch_at_step,
)
