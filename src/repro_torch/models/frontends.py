"""Modality frontend stubs: correctly shaped stand-ins for the frontends
the configs name (the transformer backbone is the model).

  * audio (whisper): (B, frames, d_model) frame embeddings, what the conv
    subsampler of a real frontend would produce;
  * vision (phi-3-vision): (B, seq, d_model) patch and token embeddings,
    what the CLIP projector spliced into the text stream would produce.

Both are the JAX package's draws, ``0.02 * jax.random.normal(key, shape)``
cast to ``dtype``, from a ``core.prng`` key: the uniform bits are JAX's,
the normal's ``erfinv`` may differ in its last f32 bit (``prng.normal``).
"""

from __future__ import annotations

import torch

from repro_torch.core import prng
from repro_torch.core.device import DeviceLike, resolve_device


def _stub(key, shape, dtype, device) -> torch.Tensor:
    return (prng.normal(key, shape, resolve_device(device)) * 0.02).to(dtype)


def audio_stub_features(key, batch: int, frames: int, d_model: int,
                        dtype=torch.bfloat16,
                        device: DeviceLike = None) -> torch.Tensor:
    """(batch, frames, d_model) stub frame embeddings of the key."""
    return _stub(key, (batch, frames, d_model), dtype, device)


def vision_stub_embeddings(key, batch: int, seq: int, d_model: int,
                           dtype=torch.bfloat16,
                           device: DeviceLike = None) -> torch.Tensor:
    """(batch, seq, d_model) stub patch / token embeddings of the key."""
    return _stub(key, (batch, seq, d_model), dtype, device)
