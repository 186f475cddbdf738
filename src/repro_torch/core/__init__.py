"""repro_torch.core — ABFP numerics (packing subset), the threefry key
chain and device selection."""
