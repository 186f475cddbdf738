"""Fault-tolerant checkpointing, in the JAX package's on-disk format.

  * **Atomic**: written to ``step_XXXXXXXXXX.tmp/``, the manifest synced,
    then renamed, so a crash mid-write never corrupts the newest valid
    checkpoint.
  * **Self-describing**: ``manifest.json`` (step, leaf names, dtypes,
    shapes, ``extra``, and the sha256 hash of the rest of the manifest)
    beside one ``.npy`` file per leaf; bf16 leaves are stored as their
    uint16 bit patterns with the dtype tag ``bfloat16``.
  * ``keep_last_k`` garbage collection, ``latest_step`` discovery and
    ``validate`` for restart after a failure.

The JAX package's ``repro.checkpoint.validate`` accepts a directory this
module wrote and this module's accepts one the JAX package wrote.  The
leaves are named and ordered as there (``core.tree``); a restore fills
the structure, dtypes and devices of a ``like`` tree.  ``save_params`` and
``restore_params`` write and read a model's parameters in the JAX
package's layout (layers stacked under ``groups/j``, the remainder layers
under ``extra/r``; ``models.convert.to_jax_layout``), so the JAX package
restores the port's model checkpoint into its own ``init_params`` tree
and the port restores the JAX package's.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.tree import flatten_with_names, unflatten_like

Pytree = Any

_MANIFEST = "manifest.json"

# torch dtype <-> the numpy dtype name the JAX package writes as the tag.
_TAGS = {torch.float32: "float32", torch.float64: "float64",
         torch.bfloat16: "bfloat16", torch.float16: "float16",
         torch.int32: "int32", torch.int64: "int64", torch.int8: "int8",
         torch.uint8: "uint8", torch.bool: "bool"}


def _to_numpy(leaf) -> Tuple[np.ndarray, str]:
    t = torch.as_tensor(leaf).detach().cpu()
    tag = _TAGS[t.dtype]
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), tag
    return t.numpy(), tag


def _from_numpy(arr: np.ndarray, tag: str) -> torch.Tensor:
    arr = np.array(arr, copy=True)          # writable, contiguous, any rank
    if tag == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def save(directory: str, step: int, tree: Pytree, *, keep_last_k: int = 3,
         extra: Optional[dict] = None) -> str:
    """Atomically save ``tree`` as checkpoint ``step``; returns its path."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:010d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    names, leaves = flatten_with_names(tree)
    manifest = {"step": step, "leaves": [], "extra": extra or {}}
    for i, (name, leaf) in enumerate(zip(names, leaves)):
        arr, tag = _to_numpy(leaf)
        fname = f"leaf_{i:05d}.npy"
        np.save(os.path.join(tmp, fname), arr)
        manifest["leaves"].append({"name": name, "file": fname, "dtype": tag,
                                   "shape": list(arr.shape)})
    blob = json.dumps(manifest, sort_keys=True).encode()
    manifest["hash"] = hashlib.sha256(blob).hexdigest()
    with open(os.path.join(tmp, _MANIFEST), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)                          # atomic publish
    _gc(directory, keep_last_k)
    return final


def _gc(directory: str, keep_last_k: int) -> None:
    steps = all_steps(directory)
    for s in steps[:-keep_last_k] if keep_last_k > 0 else []:
        shutil.rmtree(os.path.join(directory, f"step_{s:010d}"),
                      ignore_errors=True)


def all_steps(directory: str) -> list:
    """Sorted steps of the published checkpoints in ``directory``."""
    if not os.path.isdir(directory):
        return []
    out = []
    for d in os.listdir(directory):
        if d.startswith("step_") and not d.endswith(".tmp") and \
                os.path.exists(os.path.join(directory, d, _MANIFEST)):
            out.append(int(d.split("_")[1]))
    return sorted(out)


def latest_step(directory: str) -> Optional[int]:
    steps = all_steps(directory)
    return steps[-1] if steps else None


def validate(path: str) -> bool:
    """Integrity check: the manifest reads and every leaf file exists."""
    try:
        with open(os.path.join(path, _MANIFEST)) as f:
            manifest = json.load(f)
        return all(os.path.exists(os.path.join(path, leaf["file"]))
                   for leaf in manifest["leaves"])
    except (OSError, json.JSONDecodeError, KeyError, TypeError):
        return False


def restore(directory: str, like: Pytree, step: Optional[int] = None,
            ) -> Tuple[Pytree, int, dict]:
    """Restore into the structure of ``like``; returns (tree, step, extra).
    Falls back to the newest *valid* checkpoint if the latest is corrupt."""
    steps = all_steps(directory)
    if step is not None:
        steps = [s for s in steps if s == step]
    if not steps:
        raise FileNotFoundError(f"no checkpoint in {directory}")
    for s in reversed(steps):
        path = os.path.join(directory, f"step_{s:010d}")
        if validate(path):
            with open(os.path.join(path, _MANIFEST)) as f:
                manifest = json.load(f)
            return _load(path, manifest, like), s, manifest.get("extra", {})
    raise IOError(f"all checkpoints in {directory} are corrupt")


def save_params(directory: str, step: int, params: dict, mcfg, *,
                keep_last_k: int = 3, extra: Optional[dict] = None) -> str:
    """``save`` of the port's ``params`` of ``mcfg`` in the JAX package's
    layout (the leaves the JAX package's ``init_params`` tree has)."""
    from repro_torch.models.convert import to_jax_layout
    return save(directory, step, to_jax_layout(params, mcfg),
                keep_last_k=keep_last_k, extra=extra)


def restore_params(directory: str, like: dict, mcfg,
                   step: Optional[int] = None) -> Tuple[dict, int, dict]:
    """``restore`` of a model checkpoint in the JAX package's layout (the
    port's ``save_params`` or the JAX package's ``save`` of its params)
    into the port's layout of ``like``; returns (params, step, extra)."""
    from repro_torch.models.convert import from_jax_layout, to_jax_layout
    tree, s, ex = restore(directory, to_jax_layout(like, mcfg), step)
    return from_jax_layout(tree, mcfg), s, ex


def _load(path: str, manifest: dict, like: Pytree) -> Pytree:
    _, leaves = flatten_with_names(like)
    if len(leaves) != len(manifest["leaves"]):
        raise ValueError(f"checkpoint has {len(manifest['leaves'])} leaves, "
                         f"the tree expects {len(leaves)}")
    out = []
    for leaf_like, meta in zip(leaves, manifest["leaves"]):
        t = _from_numpy(np.load(os.path.join(path, meta["file"])),
                        meta["dtype"])
        want = torch.as_tensor(leaf_like)
        if tuple(t.shape) != tuple(want.shape):
            raise ValueError(f"{meta['name']}: shape {tuple(t.shape)} in the "
                             f"checkpoint, {tuple(want.shape)} expected")
        out.append(t.to(device=want.device, dtype=want.dtype))
    return unflatten_like(like, out)
