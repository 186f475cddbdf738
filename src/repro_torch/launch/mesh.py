"""Mesh construction and the card's roofline constants.

``make_host_mesh(data, model, device)`` is the port's counterpart of the
JAX package's ``make_host_mesh``: a (data, model) grid whose every
position is ``device``.  ``make_production_mesh`` is the dry run's mesh,
the JAX package's production shapes and axes with every position on
``meta`` (``launch.dryrun``).  In this port a mesh is virtual: one card (or the
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


def make_production_mesh(*, multi_pod: bool = False,
                         device: DeviceLike = "meta") -> Mesh:
    """The JAX package's production mesh: (16, 16) over ("data",
    "model"), or (2, 16, 16) over ("pod", "data", "model") with
    ``multi_pod``; every position is ``device`` (``meta`` for the dry run,
    whose artifacts then compare cell for cell with JAX's)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    devices = np.empty(shape, dtype=object)
    devices.fill(resolve_device(device))
    return Mesh(devices, axes)


# NVIDIA H100 SXM5 80GB datasheet figures, the roofline's constants (the
# JAX package's names; its TPU v5e values stay with it).
PEAK_FLOPS_BF16 = 989e12          # dense bf16 tensor-core FLOP/s per GPU
HBM_BW = 3.35e12                  # HBM3 bytes/s per GPU
HBM_PER_CHIP = 80e9               # bytes of HBM per GPU
# NVLink 4: 900 GB/s per GPU in both directions, 450e9 B/s each way.  A
# (16, 16) mesh spans 32 eight-GPU nodes, so its model axis also crosses
# InfiniBand (400 Gb/s NDR, 50e9 B/s per GPU): this is the within-node
# figure, a lower bound on the collective term.
ICI_BW = 450e9
