"""Parameters of the JAX package, as numpy arrays, into the port's layout.

The JAX package stacks the layers of each block-pattern position on a
leading axis under ``params["groups"][j]``; for the dense pattern
``("attention",)`` that is ``groups[0]``, which ``from_jax_params`` unstacks
into the port's per-layer list.  bfloat16 leaves arrive as numpy arrays
whose ``dtype.name`` is ``"bfloat16"``; they are reinterpreted bit for bit
through uint16, without importing any bfloat16 numpy extension.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.device import DeviceLike, resolve_device
from repro_torch.models.lm import check_supported


def to_tensor(a, device) -> torch.Tensor:
    """One numpy leaf -> a tensor on ``device``, bf16 kept bit for bit."""
    a = np.array(a)     # a writable, contiguous copy
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def _tree(node, device):
    if isinstance(node, dict):
        return {k: _tree(v, device) for k, v in node.items()}
    return to_tensor(node, device)


def from_jax_params(tree: dict, mcfg: ModelConfig,
                    device: DeviceLike = None) -> dict:
    """JAX params (a tree of numpy arrays) -> the port's params dict."""
    check_supported(mcfg)
    dev = resolve_device(device)
    groups = tree["groups"]
    if len(groups) != 1 or tree.get("extra"):
        raise ValueError("expected the dense layout: one scanned group")
    stacked = groups[0]

    def layer(i, node):
        if isinstance(node, dict):
            return {k: layer(i, v) for k, v in node.items()}
        return to_tensor(np.asarray(node)[i], dev)

    n = mcfg.num_layers
    out = {"embed": to_tensor(tree["embed"], dev),
           "final_norm": _tree(tree["final_norm"], dev),
           "layers": [layer(i, stacked) for i in range(n)]}
    if "lm_head" in tree:
        out["lm_head"] = to_tensor(tree["lm_head"], dev)
    return out
