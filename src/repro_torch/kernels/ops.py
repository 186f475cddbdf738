"""Unified dense-matmul dispatch: the single entry point models use.

``dense(x, w, cfg, key)`` routes by ``cfg.mode``:
  * ``"float"``       — plain matmul in the operand dtype
  * ``"abfp_ref"``    — the tile scan ``core.abfp.abfp_matmul`` (plain
    PyTorch; the noise drawn from ``key``, split per tile): the QAT mode
  * ``"abfp_kernel"`` — the unpacked ABFP kernel, which quantizes ``w``
    itself on every call (the cacheless evaluation forward's mode)
  * ``"abfp_packed"`` — packs ``w`` on the fly, then the packed kernel
  * ``"abfp_fused"``  — the same with per-tile adaptive ADC gains
``dense_packed(x, pw, cfg, key)`` takes an already packed weight: the
quantize-once serving path.

Every mode carries the straight-through estimator (paper Eq. 8): under
autograd, ``dense`` is a ``torch.autograd.Function`` whose backward is
that of the plain matmul in f32 (``dx = g w^T`` in x's dtype, ``dw = x^T
g`` in w's dtype), float mode included, as the JAX package's custom VJP.
``dense_packed``'s backward runs against the dequantized lattice and
gives the packed weight no gradient (packed weights are frozen).  The
backward is ``torch.matmul``, not a kernel: it counts no launch.  Without
a gradient to record the Functions are skipped.

``key`` is the call's noise key: a PRNG key (``core.prng``), an int, a
one-element int32 tensor (a slot of a pass's seed table, read by the
kernel from device memory) or None.  The kernel modes take its seed
(``key_to_seed``); ``abfp_ref`` needs the key itself and refuses a seed.
``plain=True`` calls the kernel's plain PyTorch version instead of the
wrapper, on any device: it is how a whole model pass is compared against
its kernels on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import abfp as core_abfp
from repro_torch.core.abfp import (
    PackedWeight,
    QuantConfig,
    dequantize_packed,
    pack_abfp_weight,
    ste_grads,
)
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


def _packed_forward(x, pw, cfg, key, plain):
    fn = abfp_matmul_packed_ref if plain else abfp_matmul_packed
    return fn(x, pw, cfg, as_seed(key))


def _forward(x, w, cfg, key, plain):
    if cfg.mode == "float":
        return torch.matmul(x, w.to(x.dtype))
    if cfg.mode == "abfp_ref":
        return core_abfp.abfp_matmul(x, w, cfg, key)
    if cfg.mode == "abfp_kernel":
        fn = abfp_matmul_ref if plain else abfp_matmul
        return fn(x, w, cfg, as_seed(key))
    if cfg.mode in ("abfp_packed", "abfp_fused"):
        pw = pack_abfp_weight(w, cfg, adaptive_gain=cfg.mode == "abfp_fused")
        return _packed_forward(x, pw, cfg, key, plain)
    raise ValueError(f"unknown or unported quant mode: {cfg.mode!r}")


class _DenseSTE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, cfg, key, plain):
        ctx.save_for_backward(x, w)
        return _forward(x, w, cfg, key, plain)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx, dw = ste_grads(g, x, w, *ctx.needs_input_grad[:2])
        return dx, dw, None, None, None


class _DensePackedSTE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, pw, cfg, key, plain):
        ctx.pw, ctx.x_dtype = pw, x.dtype
        return _packed_forward(x, pw, cfg, key, plain)

    @staticmethod
    def backward(ctx, g):
        dx = torch.matmul(g.float(), dequantize_packed(ctx.pw).t())
        return dx.to(ctx.x_dtype), None, None, None, None


def _recording(*ts) -> bool:
    return torch.is_grad_enabled() and any(
        isinstance(t, Tensor) and t.requires_grad for t in ts)


def dense_packed(x: Tensor, pw: PackedWeight, cfg: QuantConfig,
                 key=None, plain: bool = False) -> Tensor:
    """x (..., K) @ packed weight (K, N) -> (..., N) via the packed kernel."""
    if _recording(x):
        return _DensePackedSTE.apply(x, pw, cfg, key, plain)
    return _packed_forward(x, pw, cfg, key, plain)


def dense(x: Tensor, w, cfg: QuantConfig, key=None,
          plain: bool = False) -> Tensor:
    """x (..., K) @ w (K, N) -> (..., N) under the QuantConfig's mode."""
    if isinstance(w, PackedWeight):
        return dense_packed(x, w, cfg, key, plain)
    if _recording(x, w):
        return _DenseSTE.apply(x, w, cfg, key, plain)
    return _forward(x, w, cfg, key, plain)


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
