"""Finetuning recipes, paper Sec. IV: QAT and Differential Noise
Finetuning, and the ABFP evaluation.

QAT is the normal train step (``train_lib.make_train_step``) with an ABFP
quant mode: the forward runs the ABFP simulation (tiling, scaling,
quantization, gain, ADC noise) and the backward the straight-through
gradients (Eq. 8).

DNF (the paper's Fig. 3):
  1. ``capture_histograms``: one batch through the paired FLOAT/ABFP
     forward (``models.lm.forward_capture``); per-layer dy histograms (100
     bins, +0.5 smoothing) fitted once.
  2. ``make_dnf_train_step``: the FLOAT forward plus per-layer noise drawn
     from the histograms (Eq. 9); the backward is plain f32.  No tiling or
     quantization in the loop: the speed-up the paper reports.
  3. ``core.dnf.select_layers_by_std`` restricts the noise to the most
     susceptible layers (``layer_mask``).

``evaluate_abfp`` is the paper's quality metric: mean next-token accuracy
of the teacher-forced forward under ABFP numerics (its ratio to the FLOAT
accuracy is the "% of FLOAT32 quality").  It and ``capture_histograms``
run on the device the parameters lie on.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.abfp import QuantConfig
from repro_torch.core.device import DeviceLike, resolve_device
from repro_torch.core.dnf import NoiseHistogram
from repro_torch.core.prng import fold_in
from repro_torch.models.layers import Numerics
from repro_torch.models.lm import forward, forward_capture
from repro_torch.training.train_lib import (
    TrainState,
    chunked_cross_entropy,
    tokens_on,
    value_and_grad,
)


def _tokens(tokens, params) -> torch.Tensor:
    """Token ids (numpy or tensor) on the parameters' device, as int64."""
    dev = params["embed"].device
    if isinstance(tokens, torch.Tensor):
        return tokens.to(device=dev, dtype=torch.int64)
    return torch.as_tensor(np.asarray(tokens), dtype=torch.int64, device=dev)


def _features(encoder_features, params):
    """An encoder-decoder's features on the parameters' device (None
    stays None)."""
    if encoder_features is None:
        return None
    from repro_torch.models.convert import to_tensor
    t = (encoder_features if isinstance(encoder_features, torch.Tensor)
         else to_tensor(encoder_features, "cpu"))
    return t.to(params["embed"].device)


def capture_histograms(params: dict, tokens, mcfg: ModelConfig,
                       quant: QuantConfig, *, key, num_bins: int = 100,
                       encoder_features=None) -> tuple:
    """Fit per-layer differential-noise histograms from one batch.

    ``tokens``: (B, S) ids; an encoder-decoder's ``encoder_features`` (B,
    S_enc, d).  Layer ``li``'s ABFP pass runs under
    ``Numerics(quant, fold_in(key, li + 1)).fold(li)`` (a fresh key per
    layer, counter from 1, as the JAX package's factory).  Returns
    (stacked ``NoiseHistogram`` on the parameters' device, per-layer std
    list)."""
    nx_float = Numerics(QuantConfig(mode="float"))
    counter = [0]

    def abfp_factory():
        counter[0] += 1
        return Numerics(quant, fold_in(key, counter[0]))

    with torch.no_grad():
        _, deltas = forward_capture(
            params, _tokens(tokens, params), mcfg, nx_float, abfp_factory,
            encoder_features=_features(encoder_features, params))
    hists = [NoiseHistogram.fit(d, num_bins=num_bins) for d in deltas]
    stds = [float(h.std) for h in hists]
    return NoiseHistogram.stack(hists).to(params["embed"].device), stds


def make_dnf_train_step(mcfg: ModelConfig, optimizer, hists: NoiseHistogram,
                        layer_mask: Optional[list] = None,
                        device: DeviceLike = None):
    """DNF train step: the FLOAT forward plus histogram noise at every
    layer output (key ``fold_in(key, layer)`` of the step's ``key``).
    Returns (init_state, train_step) as ``make_train_step``; metrics
    ``loss``.

    ``layer_mask``: per-layer bools, True for layers that get noise (the
    high-std tailoring); a masked layer's histogram collapses to edges 0
    (its draws are exactly 0), as in the JAX package."""
    dev = resolve_device(device)
    if layer_mask is not None:
        mask = torch.tensor(layer_mask, dtype=torch.float32,
                            device=hists.edges.device)
        hists = NoiseHistogram(edges=hists.edges * mask[:, None],
                               cum=hists.cum, mean=hists.mean * mask,
                               std=hists.std * mask)
    hists = hists.to(dev)
    float_quant = QuantConfig(mode="float")

    def loss_fn(params, tokens, key):
        nx = Numerics(float_quant)
        inputs, labels = tokens[:, :-1], tokens[:, 1:]
        hidden, aux = forward(params, inputs, mcfg, nx, dnf=hists,
                              dnf_key=key, return_hidden=True)
        loss = chunked_cross_entropy(params, hidden, labels, mcfg, nx)
        return loss, loss, aux

    def init_state(params) -> TrainState:
        return TrainState(params, optimizer.init(params), None,
                          torch.zeros((), dtype=torch.int32))

    def train_step(state: TrainState, batch: dict, key):
        loss, _, grads = value_and_grad(loss_fn, state.params,
                                        tokens_on(batch, dev), key)
        params, opt_state = optimizer.update(grads, state.opt_state,
                                             state.params)
        return (TrainState(params, opt_state, None, state.step + 1),
                {"loss": loss})

    return init_state, train_step


def evaluate_abfp(params: dict, batches, mcfg: ModelConfig,
                  quant: QuantConfig, *, key,
                  encoder_features=None) -> float:
    """Mean next-token accuracy over ``batches`` of ``{"tokens": (B,
    S + 1)}``: batch ``i`` runs under ``Numerics(quant, fold_in(key,
    i))``, inputs ``tokens[:, :-1]``, labels ``tokens[:, 1:]``; an
    encoder-decoder's batches take ``encoder_features`` (B, S_enc, d)."""
    feats = _features(encoder_features, params)
    correct = total = 0
    with torch.no_grad():
        for i, batch in enumerate(batches):
            nx = Numerics(quant, fold_in(key, i))
            tokens = _tokens(batch["tokens"], params)
            inputs, labels = tokens[:, :-1], tokens[:, 1:]
            logits, _ = forward(params, inputs, mcfg, nx,
                                encoder_features=feats)
            pred = torch.argmax(logits, dim=-1)
            correct += int((pred == labels).sum())
            total += labels.numel()
    return correct / max(total, 1)
