"""Gradient compression for the data-parallel boundary.

  * ``bf16`` — the gradients cross at half width (cast and back).
  * ``int8`` — per-tensor scale and error feedback: the quantization
    residual is carried into the next step, so the compression is
    unbiased over time (EF-SGD).

Single-process, as the JAX package runs them in one process: the helpers
are pure transforms of a gradient tree around the optimizer, the
(compress, decompress) pair an all-reduce would sit between.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from repro_torch.core.tree import leaves, tree_map, unflatten_like

Pytree = Any


class ErrorFeedbackState(NamedTuple):
    residual: Pytree     # f32 compression residuals (the grads' structure)


def init_error_feedback(params: Pytree) -> ErrorFeedbackState:
    return ErrorFeedbackState(tree_map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
        params))


def compress_bf16(grads: Pytree) -> Pytree:
    """Cast-compress: the all-reduce runs at half width."""
    return tree_map(lambda g: g.to(torch.bfloat16), grads)


def decompress_bf16(grads: Pytree) -> Pytree:
    return tree_map(lambda g: g.float(), grads)


def compress_int8_ef(grads: Pytree, ef: ErrorFeedbackState):
    """int8 + per-tensor scale + error feedback.  Returns (int8 grads,
    f32 scales, new error feedback): the residual (g + r) - dequant(q)
    goes to the next step."""
    qs, scales, residuals = [], [], []
    for g, r in zip(leaves(grads), leaves(ef.residual)):
        g = g.float() + r
        scale = torch.clamp(g.abs().max(), min=1e-12) / 127.0
        q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
        qs.append(q)
        scales.append(scale)
        residuals.append(g - q.float() * scale)
    return (unflatten_like(grads, qs), unflatten_like(grads, scales),
            ErrorFeedbackState(unflatten_like(grads, residuals)))


def decompress_int8(q_grads: Pytree, scales: Pytree) -> Pytree:
    return tree_map(lambda q, s: q.float() * s, q_grads, scales)


def apply_compression(grads: Pytree, method: Optional[str],
                      ef: Optional[ErrorFeedbackState] = None):
    """The train step's one call: returns (grads, new error feedback)."""
    if method is None or method == "none":
        return grads, ef
    if method == "bf16":
        return decompress_bf16(compress_bf16(grads)), ef
    if method == "int8":
        if ef is None:
            raise ValueError("int8 compression needs an error-feedback state")
        q, s, new_ef = compress_int8_ef(grads, ef)
        return decompress_int8(q, s), new_ef
    raise ValueError(f"unknown compression {method!r}")
