"""Mesh construction for tensor-parallel serving.

``make_host_mesh(data, model, device)`` is the port's counterpart of the
JAX package's ``make_host_mesh``: a (data, model) grid whose every
position is ``device``.  In this port a mesh is virtual: one card (or the
CPU) holds every shard, each dense call runs one launch per model shard
(``kernels.ops.dense_tp``).  Spreading the positions over several cards
is the multi-card slice's work.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.device import DeviceLike, resolve_device
from repro_torch.distributed.sharding import Mesh


def make_host_mesh(data: int = 1, model: int = 1,
                   device: DeviceLike = None) -> Mesh:
    """A (data, model) mesh with every position on ``device`` (default:
    the card; the CPU only when asked for)."""
    if data < 1 or model < 1:
        raise ValueError(f"mesh axes must be >= 1, got ({data}, {model})")
    dev = resolve_device(device)
    devices = np.empty((data, model), dtype=object)
    devices.fill(dev)
    return Mesh(devices, ("data", "model"))
