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

``to_jax_layout`` stacks a port parameter tree (tensors) back into the
JAX package's layout, and ``from_jax_layout`` unstacks such a tree of
tensors: the checkpoint's model files (``checkpoint.save_params``) use
them, so the JAX package restores what the port wrote and back.
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
    if isinstance(node, list):
        return [_tree(v, device) for v in node]
    return to_tensor(node, device)


def _groups(mcfg: ModelConfig):
    glen = len(mcfg.block_pattern or ("attention",))
    return glen, mcfg.num_layers // glen


def _stack(nodes: list):
    if isinstance(nodes[0], dict):
        return {k: _stack([n[k] for n in nodes]) for k in nodes[0]}
    return torch.stack(nodes)


def _unstack(node, i: int):
    if isinstance(node, dict):
        return {k: _unstack(v, i) for k, v in node.items()}
    return node[i]


def to_jax_layout(params: dict, mcfg: ModelConfig) -> dict:
    """The port's params (or any tree shaped like them) in the JAX
    package's layout, as tensors: ``groups`` a tuple of per-position
    trees stacked over the groups, ``extra`` a tuple of the remainder
    layers, an encoder's layers stacked."""
    glen, n_groups = _groups(mcfg)
    layers = params["layers"]
    out = {k: v for k, v in params.items() if k not in ("layers", "encoder")}
    out["groups"] = tuple(
        _stack([layers[g * glen + j] for g in range(n_groups)])
        for j in range(glen))
    out["extra"] = tuple(layers[n_groups * glen:])
    if "encoder" in params:
        enc = params["encoder"]
        out["encoder"] = {"layers": _stack(enc["layers"]),
                          "final_norm": enc["final_norm"]}
    return out


def from_jax_layout(tree: dict, mcfg: ModelConfig) -> dict:
    """The inverse of ``to_jax_layout``: a tree in the JAX package's layout
    (tensors, or numpy arrays) -> the port's per-layer list, each layer's
    leaves views of the stacked ones."""
    glen, n_groups = _groups(mcfg)
    layers = [None] * mcfg.num_layers
    for j, stacked in enumerate(tree["groups"]):
        for g in range(n_groups):
            layers[g * glen + j] = _unstack(stacked, g)
    for r, node in enumerate(tree.get("extra", ())):
        layers[n_groups * glen + r] = node
    out = {k: v for k, v in tree.items()
           if k not in ("groups", "extra", "encoder")}
    out["layers"] = layers
    if "encoder" in tree:
        enc = tree["encoder"]
        out["encoder"] = {
            "layers": [_unstack(enc["layers"], g)
                       for g in range(mcfg.num_encoder_layers)],
            "final_norm": enc["final_norm"]}
    return out


def from_jax_params(tree: dict, mcfg: ModelConfig,
                    device: DeviceLike = None) -> dict:
    """JAX params (a tree of numpy arrays) -> the port's params dict, one
    tensor copy per layer."""
    check_supported(mcfg, serving=True)
    return _tree(from_jax_layout(tree, mcfg), resolve_device(device))
