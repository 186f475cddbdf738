"""Parameters of the JAX package, as numpy arrays, into the port's layout.

The JAX package stacks the layers of block-pattern position ``j`` on a
leading axis under ``params["groups"][j]`` and keeps the remainder layers
(a pattern that does not divide ``num_layers``) unstacked under
``params["extra"]``; ``from_jax_params`` unstacks them into the port's
flat per-layer list: ``groups[j][g]`` is layer ``g * len(pattern) + j``
and ``extra[r]`` layer ``n_groups * len(pattern) + r``; an
encoder-decoder's stacked ``encoder["layers"]`` (E, ...) become a list of
E layers.  bfloat16 leaves
arrive as numpy arrays whose ``dtype.name`` is ``"bfloat16"``; they are
reinterpreted bit for bit through uint16, without importing any bfloat16
numpy extension.
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
    check_supported(mcfg, serving=True)
    dev = resolve_device(device)
    glen = len(mcfg.block_pattern or ("attention",))
    n_groups = mcfg.num_layers // glen

    def layer(node, g=None):
        if isinstance(node, dict):
            return {k: layer(v, g) for k, v in node.items()}
        return to_tensor(node if g is None else np.asarray(node)[g], dev)

    layers = [None] * mcfg.num_layers
    for j, stacked in enumerate(tree["groups"]):
        for g in range(n_groups):
            layers[g * glen + j] = layer(stacked, g)
    for r, node in enumerate(tree.get("extra", ())):
        layers[n_groups * glen + r] = layer(node)
    out = {"embed": to_tensor(tree["embed"], dev),
           "final_norm": _tree(tree["final_norm"], dev),
           "layers": layers}
    if "lm_head" in tree:
        out["lm_head"] = to_tensor(tree["lm_head"], dev)
    if "encoder" in tree:
        enc = tree["encoder"]
        out["encoder"] = {
            "layers": [layer(enc["layers"], g)
                       for g in range(mcfg.num_encoder_layers)],
            "final_norm": _tree(enc["final_norm"], dev)}
    return out
