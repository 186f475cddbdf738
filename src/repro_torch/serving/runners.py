"""DecoderRunner: the seam between ``ServingEngine`` and
``repro_torch.models``.

A runner owns what the engine must know about one model family: how to
allocate the batched decode state (``init_state``), the decode-tick and
chunk-pass functions the engine calls (``make_step`` / ``make_prefill``,
in their sampled form) and the per-slot state reset (``make_reset``).
Only the dense decoder-only family with unpaged KV caches is ported.  The
functions update the decode state in place and return it.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.device import DeviceLike
from repro_torch.models.layers import Numerics
from repro_torch.models.lm import (
    decode_step,
    init_decode_state,
    prefill,
    sample_tokens,
)


class DecoderRunner:
    """Decoder-only full-attention LM with unpaged per-slot KV caches."""

    def __init__(self, mcfg: ModelConfig):
        self.mcfg = mcfg

    def init_state(self, capacity: int, max_len: int,
                   device: DeviceLike = None) -> dict:
        return init_decode_state(self.mcfg, capacity, max_len, device)

    def make_step(self, quant, seed: int):
        """The decode-tick function ``(params, state, token, ov_vals,
        ov_mask, key, temps, uids, idxs) -> (logits, sampled, state)``.

        ``token``/``ov_vals``/``ov_mask`` are (B,) host arrays: rows with
        ``ov_mask`` take ``ov_vals`` as input instead of ``token``.  The
        next token is sampled on the device (``models.sample_tokens``)."""
        def _step(params, state, token, ov_vals, ov_mask, key, temps, uids,
                  idxs):
            dev = state["position"].device
            tok = torch.as_tensor(
                [v if m else t for t, v, m in zip(token, ov_vals, ov_mask)],
                dtype=torch.int32).to(dev)
            logits, state = decode_step(params, state, tok, self.mcfg,
                                        Numerics(quant, key))
            nxt = sample_tokens(logits, temps, uids, idxs, seed)
            return logits, nxt, state

        return _step

    def make_prefill(self, quant, seed: int):
        """The chunk-pass function ``(params, state, tokens, n_tokens,
        riders, rider_mask, key, temps, uids, idxs) -> (logits, sampled,
        state)``.  Rows with ``rider_mask`` take ``riders`` as their single
        input token (a decode slot riding along)."""
        def _prefill(params, state, tokens, n_tokens, riders, rider_mask,
                     key, temps, uids, idxs):
            dev = state["position"].device
            toks = torch.tensor(tokens, dtype=torch.int32)
            mask = torch.as_tensor(rider_mask, dtype=torch.bool)
            toks[:, 0] = torch.where(
                mask, torch.as_tensor(riders, dtype=torch.int32), toks[:, 0])
            logits, state = prefill(
                params, state, toks.to(dev),
                torch.as_tensor(n_tokens, dtype=torch.int32).to(dev),
                self.mcfg, Numerics(quant, key))
            nxt = sample_tokens(logits, temps, uids, idxs, seed)
            return logits, nxt, state

        return _prefill

    def make_reset(self):
        """The slot reset ``(state, i) -> state``: zero every per-slot
        entry of row i (caches, lengths, position), in place."""
        def _reset(state, i):
            for layer in state["layers"]:
                for t in layer["kv"].values():
                    t[i] = 0
            state["position"][i] = 0
            return state

        return _reset


def runner_for(mcfg: ModelConfig) -> DecoderRunner:
    """The runner of a config: ``DecoderRunner`` for the dense decoders
    this slice ports; anything else raises."""
    from repro_torch.models.lm import check_supported
    check_supported(mcfg)
    return DecoderRunner(mcfg)
