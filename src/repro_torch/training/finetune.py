"""Finetuning recipes, paper Sec. IV: the evaluation and capture steps.

``evaluate_abfp`` is the paper's quality metric: mean next-token accuracy
of the teacher-forced forward under ABFP numerics (its ratio to the FLOAT
accuracy is the "% of FLOAT32 quality").  ``capture_histograms`` is step 1
of DNF: per-layer ABFP-minus-FLOAT noise histograms from one batch.

Both run the cacheless ``models.lm.forward`` path on the device the
parameters lie on.  The DNF train step (step 2) belongs to the training
slice of the port.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.abfp import QuantConfig
from repro_torch.core.dnf import NoiseHistogram
from repro_torch.core.prng import fold_in
from repro_torch.models.layers import Numerics
from repro_torch.models.lm import forward, forward_capture


def _tokens(tokens, params) -> torch.Tensor:
    """Token ids (numpy or tensor) on the parameters' device, as int64."""
    dev = params["embed"].device
    if isinstance(tokens, torch.Tensor):
        return tokens.to(device=dev, dtype=torch.int64)
    return torch.as_tensor(np.asarray(tokens), dtype=torch.int64, device=dev)


def capture_histograms(params: dict, tokens, mcfg: ModelConfig,
                       quant: QuantConfig, *, key,
                       num_bins: int = 100) -> tuple:
    """Fit per-layer differential-noise histograms from one batch.

    ``tokens``: (B, S) ids.  Layer ``li``'s ABFP pass runs under
    ``Numerics(quant, fold_in(key, li + 1)).fold(li)`` (a fresh key per
    layer, counter from 1, as the JAX package's factory).  Returns
    (stacked ``NoiseHistogram``, per-layer std list)."""
    nx_float = Numerics(QuantConfig(mode="float"))
    counter = [0]

    def abfp_factory():
        counter[0] += 1
        return Numerics(quant, fold_in(key, counter[0]))

    with torch.no_grad():
        _, deltas = forward_capture(params, _tokens(tokens, params), mcfg,
                                    nx_float, abfp_factory)
    hists = [NoiseHistogram.fit(d, num_bins=num_bins) for d in deltas]
    stds = [float(h.std) for h in hists]
    return NoiseHistogram.stack(hists), stds


def evaluate_abfp(params: dict, batches, mcfg: ModelConfig,
                  quant: QuantConfig, *, key) -> float:
    """Mean next-token accuracy over ``batches`` of ``{"tokens": (B,
    S + 1)}``: batch ``i`` runs under ``Numerics(quant, fold_in(key,
    i))``, inputs ``tokens[:, :-1]``, labels ``tokens[:, 1:]``."""
    correct = total = 0
    with torch.no_grad():
        for i, batch in enumerate(batches):
            nx = Numerics(quant, fold_in(key, i))
            tokens = _tokens(batch["tokens"], params)
            inputs, labels = tokens[:, :-1], tokens[:, 1:]
            logits, _ = forward(params, inputs, mcfg, nx)
            pred = torch.argmax(logits, dim=-1)
            correct += int((pred == labels).sum())
            total += labels.numel()
    return correct / max(total, 1)
