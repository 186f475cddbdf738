"""repro_torch.core — ABFP numerics (packing subset), the threefry key
chain, the ADC energy model and device selection."""

from repro_torch.core import energy  # noqa: F401
