"""Unified dense-matmul dispatch: the single entry point models use.

``dense(x, w, cfg, key)`` routes by ``cfg.mode``:
  * ``"float"``       — plain matmul in the operand dtype
  * ``"abfp_kernel"`` — the unpacked ABFP kernel, which quantizes ``w``
    itself on every call (the cacheless evaluation forward's mode)
  * ``"abfp_packed"`` — packs ``w`` on the fly, then the packed kernel
  * ``"abfp_fused"``  — the same with per-tile adaptive ADC gains
``dense_packed(x, pw, cfg, key)`` takes an already packed weight: the
quantize-once serving path.  Forward only.

``key`` is the call's noise seed: a PRNG key (``core.prng``;
``key_to_seed`` turns it into the kernel's int32 seed), an int, a
one-element int32 tensor (a slot of a pass's seed table, read by the
kernel from device memory) or None.  ``plain=True`` calls the kernel's
plain PyTorch version instead of the wrapper, on any device: it is how a
whole model pass is compared against its kernels on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.abfp import PackedWeight, QuantConfig, pack_abfp_weight
from repro_torch.core.prng import key_to_seed
from repro_torch.kernels.abfp_decode_fused import (
    fused_qkv_packed,
    fused_quantized_decode_attention,
)
from repro_torch.kernels.abfp_matmul import (
    abfp_matmul,
    abfp_matmul_packed,
    abfp_matmul_packed_ref,
    abfp_matmul_ref,
)
from repro_torch.kernels.flash_attention import flash_attention

Tensor = torch.Tensor


def as_seed(key):
    """A call's seed from ``key``: ints, tensors and None as they are, a
    PRNG key through ``key_to_seed``."""
    if key is None or isinstance(key, (int, np.integer, torch.Tensor)):
        return key
    return key_to_seed(key)


def dense_packed(x: Tensor, pw: PackedWeight, cfg: QuantConfig,
                 key=None, plain: bool = False) -> Tensor:
    """x (..., K) @ packed weight (K, N) -> (..., N) via the packed kernel."""
    fn = abfp_matmul_packed_ref if plain else abfp_matmul_packed
    return fn(x, pw, cfg, as_seed(key))


def dense(x: Tensor, w, cfg: QuantConfig, key=None,
          plain: bool = False) -> Tensor:
    """x (..., K) @ w (K, N) -> (..., N) under the QuantConfig's mode."""
    if isinstance(w, PackedWeight):
        return dense_packed(x, w, cfg, key, plain)
    if cfg.mode == "float":
        return torch.matmul(x, w.to(x.dtype))
    if cfg.mode == "abfp_kernel":
        fn = abfp_matmul_ref if plain else abfp_matmul
        return fn(x, w, cfg, as_seed(key))
    if cfg.mode in ("abfp_packed", "abfp_fused"):
        pw = pack_abfp_weight(w, cfg, adaptive_gain=cfg.mode == "abfp_fused")
        return dense_packed(x, pw, cfg, key, plain)
    raise ValueError(f"unknown or unported quant mode: {cfg.mode!r}")


# Every kernel wrapper; each counts its launches in ``.launches``.
WRAPPERS = (abfp_matmul_packed, fused_qkv_packed,
            fused_quantized_decode_attention, abfp_matmul, flash_attention)


def launch_counts() -> dict:
    """Current launch counts of every kernel wrapper, by wrapper name."""
    return {f.__name__: f.launches for f in WRAPPERS}


def reset_launch_counts() -> None:
    """Set every kernel wrapper's launch count to 0."""
    for f in WRAPPERS:
        f.launches = 0


def add_launch_counts(delta: dict, times: int = 1) -> None:
    """Add ``times`` x ``delta`` (by wrapper name) to the launch counts: a
    CUDA graph replay launches the kernels its capture recorded."""
    for f in WRAPPERS:
        f.launches += times * delta.get(f.__name__, 0)
