"""The decoder LM: parameters, the teacher-forced forward, decode state,
decode tick, chunked prefill, token sampling and the paired FLOAT/ABFP
capture of DNF.

Params and decode state are plain dicts and lists of tensors, one list
entry per layer (the JAX package stacks the layers of each block-pattern
position on a leading axis and scans; the port loops).  Layer ``i`` is of
kind ``mcfg.layer_kind(i)``: ``attention`` (local attention over a
ring-buffer cache of ``window_size`` slots in a hybrid pattern),
``recurrent`` (RG-LRU), ``mlstm`` or ``slstm`` (``models.recurrent``);
an attention layer of a config with ``num_experts`` holds a ``"moe"``
block (``models.moe``) in place of its ``"mlp"``.
The layer index folded into the noise key is the flat index ``i``, which
is the JAX package's ``g * len(pattern) + j`` in its scanned groups and
``n_groups * len(pattern) + r`` in its remainder layers.

``forward`` runs a whole teacher-forced sequence without a cache: the
evaluation path (``training.finetune.evaluate_abfp``) and, under autograd
with the straight-through gradients of ``kernels.ops``, the training path
(``training.train_lib``; DNF's noise with ``dnf``, per-layer
rematerialization with ``mcfg.remat``), for every layer kind (the
recurrent blocks' parallel forms).  ``decode_step`` (one token per row)
and ``prefill`` (a prompt chunk per row) update the decode state in place
(see ``models.layers`` and ``models.recurrent``) and return it, for every
kind; ``forward_capture`` is DNF's paired per-layer pass.

An encoder-decoder (whisper) adds ``params["encoder"]`` (full-attention
layers, non-causal) and, per decoder layer, a cross-attention block
``"cross"`` with its norm ``"norm3"``: ``encode`` runs the encoder over
frame features, ``encode_cross_kv`` projects its output to every decoder
layer's cross K/V, and the passes take them as ``encoder_features``
(``forward``) or ``enc_kv`` (``decode_step``, ``prefill``).  A stub
frontend (phi-3-vision) hands ``forward`` float embeddings in place of
token ids.  Noise folds: decoder layer ``i`` under ``fold(i)``, encoder
layer ``g`` under ``fold(ENCODER_FOLD + g)``, every layer's cross K/V under
the pass's root key at calls 0 (wk) and 1 (wv): the JAX package traces its
per-layer cross projection once under ``vmap``, so the counter advances
twice in all.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core import prng
from repro_torch.core.abfp import QuantConfig
from repro_torch.core.device import DeviceLike, resolve_device
from repro_torch.core.dnf import inject
from repro_torch.models import moe as moe_lib
from repro_torch.models import recurrent as rec
from repro_torch.models.layers import (
    LM_HEAD_FOLD,
    Numerics,
    attention_block,
    init_attention,
    init_mlp,
    mlp_block,
    norm,
    sinusoidal_positions,
    table_numerics,
)

Tensor = torch.Tensor


_KINDS = ("attention", "recurrent", "mlstm", "slstm")

# Encoder layer g's noise fold is ENCODER_FOLD + g (the JAX package's).
ENCODER_FOLD = 1000


def check_supported(mcfg: ModelConfig, serving: bool = False) -> None:
    """Raise unless the port runs ``mcfg``.  Every path (serving: decode
    state, decode tick, chunked prefill; the cacheless ``forward``, DNF's
    capture and training) takes decoders whose layers are attention
    (windowed in a hybrid pattern), RG-LRU, mLSTM or sLSTM, with or
    without experts, and full-attention encoder-decoders; rope or
    absolute positions, and the audio and vision stub frontends.
    ``serving`` names the path and refuses nothing more."""
    kinds = set(mcfg.block_pattern or ("attention",))
    if (mcfg.frontend not in ("none", "audio_stub", "vision_stub")
            or mcfg.pos_type not in ("rope", "absolute")
            or not kinds <= set(_KINDS)
            or (mcfg.is_encoder_decoder and kinds != {"attention"})):
        raise NotImplementedError(
            f"repro_torch does not run {mcfg.name} (family="
            f"{mcfg.family!r}, frontend={mcfg.frontend!r}, pos_type="
            f"{mcfg.pos_type!r}, pattern={sorted(kinds)})")


def _window(mcfg: ModelConfig) -> int:
    """The attention window of the JAX package: ``window_size`` in a
    hybrid pattern, else 0 (full attention)."""
    return mcfg.window_size if mcfg.attention_type == "hybrid" else 0


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def _norm_params(mcfg, device) -> dict:
    if mcfg.norm_type == "layernorm":
        return {"scale": torch.ones(mcfg.d_model, device=device),
                "bias": torch.zeros(mcfg.d_model, device=device)}
    return {"scale": torch.zeros(mcfg.d_model, device=device)}


def _init_attention_layer(gen, mcfg: ModelConfig, dev,
                          cross: bool) -> dict:
    layer = {"norm1": _norm_params(mcfg, dev),
             "attn": init_attention(gen, mcfg, dev),
             "norm2": _norm_params(mcfg, dev)}
    if mcfg.num_experts:
        layer["moe"] = moe_lib.init_moe(gen, mcfg, dev)
    elif mcfg.d_ff:
        layer["mlp"] = init_mlp(gen, mcfg, dev)
    if cross:
        layer["cross"] = init_attention(gen, mcfg, dev)
        layer["norm3"] = _norm_params(mcfg, dev)
    return layer


def init_params(seed: int, mcfg: ModelConfig,
                device: DeviceLike = None) -> dict:
    """Random parameters from ``seed``: the JAX package's leaves per layer
    kind, shapes, dtypes and standard deviations (not its values: the
    generators differ).  An encoder-decoder's decoder layers carry
    ``"cross"`` and ``"norm3"``, and ``params["encoder"]`` holds its
    ``"layers"`` and ``"final_norm"``."""
    check_supported(mcfg, serving=True)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    d = mcfg.d_model
    params = {
        "embed": (torch.randn(mcfg.vocab_size, d, generator=gen, device=dev)
                  * d ** -0.5).to(mcfg.param_dtype),
        "final_norm": _norm_params(mcfg, dev),
        "layers": [],
    }
    for i in range(mcfg.num_layers):
        kind = mcfg.layer_kind(i)
        if kind == "attention":
            params["layers"].append(_init_attention_layer(
                gen, mcfg, dev, mcfg.is_encoder_decoder))
            continue
        layer = {"norm1": _norm_params(mcfg, dev)}
        if kind == "recurrent":
            layer["rglru"] = rec.init_rglru_block(gen, mcfg, dev)
            layer["norm2"] = _norm_params(mcfg, dev)
            layer["mlp"] = init_mlp(gen, mcfg, dev)
        elif kind == "mlstm":
            layer["mlstm"] = rec.init_mlstm_block(gen, mcfg, dev)
        else:
            layer["slstm"] = rec.init_slstm_block(gen, mcfg, dev)
        params["layers"].append(layer)
    if not mcfg.tie_embeddings:
        params["lm_head"] = (torch.randn(d, mcfg.vocab_size, generator=gen,
                                         device=dev)
                             * d ** -0.5).to(mcfg.param_dtype)
    if mcfg.is_encoder_decoder:
        params["encoder"] = {
            "layers": [_init_attention_layer(gen, mcfg, dev, False)
                       for _ in range(mcfg.num_encoder_layers)],
            "final_norm": _norm_params(mcfg, dev)}
    return params


def param_count(params) -> int:
    """Number of scalar parameters in an (unpacked) param tree."""
    if isinstance(params, dict):
        return sum(param_count(v) for v in params.values())
    if isinstance(params, (list, tuple)):
        return sum(param_count(v) for v in params)
    return params.numel() if isinstance(params, torch.Tensor) else 0


# ---------------------------------------------------------------------------
# Layers, embedding, head
# ---------------------------------------------------------------------------


def _apply_layer(lp: dict, x: Tensor, mcfg: ModelConfig, nx: Numerics, *,
                 kind: str, positions: Tensor,
                 state: Optional[dict] = None,
                 n_tokens: Optional[Tensor] = None,
                 page_table: Optional[Tensor] = None, enc_kv=None,
                 mesh=None):
    """One pre-norm residual layer of ``kind``; returns (x, state, aux),
    ``aux`` the MoE block's f32 load-balance loss (None without one).
    Without a state (the teacher-forced forward) attention is cacheless
    and the returned state is None.  ``page_table`` (B, MP) routes a paged
    KV cache.  ``enc_kv`` (k, v) adds cross-attention over the encoder's
    frames between the self-attention and the MLP.  With ``mesh`` an MoE
    block takes the expert-parallel route (``moe.moe_block_sharded``)."""
    aux = None
    h = norm(x, lp["norm1"], mcfg.norm_type)
    if kind != "attention":
        block = {"recurrent": rec.rglru_block, "mlstm": rec.mlstm_block,
                 "slstm": rec.slstm_block}[kind]
        name = {"recurrent": "rglru"}.get(kind, kind)
        y, st = block(lp[name], h, mcfg, nx,
                      state=None if state is None else state["rec"],
                      n_tokens=n_tokens)
        x = x + y
        if kind == "recurrent":
            h = norm(x, lp["norm2"], mcfg.norm_type)
            x = x + mlp_block(lp["mlp"], h, mcfg, nx)
        return x, {"rec": st}, aux
    attn_out, kv = attention_block(
        lp["attn"], h, mcfg, nx, positions=positions, window=_window(mcfg),
        kv_cache=None if state is None else state["kv"], n_tokens=n_tokens,
        train_mode=mcfg.remat, page_table=page_table)
    x = x + attn_out
    if enc_kv is not None:
        h = norm(x, lp["norm3"], mcfg.norm_type)
        cross_out, _ = attention_block(lp["cross"], h, mcfg, nx,
                                       positions=positions, cross_kv=enc_kv,
                                       train_mode=mcfg.remat)
        x = x + cross_out
    h = norm(x, lp["norm2"], mcfg.norm_type)
    if mcfg.num_experts:
        if mesh is not None:
            y, aux = moe_lib.moe_block_sharded(lp["moe"], h, mcfg, nx, mesh)
        else:
            y, aux = moe_lib.moe_block(lp["moe"], h, mcfg, nx)
        x = x + y
    elif mcfg.d_ff:
        x = x + mlp_block(lp["mlp"], h, mcfg, nx)
    return x, None if state is None else {"kv": kv}, aux


def _embed(params, tokens: Tensor, mcfg: ModelConfig,
           positions: Tensor) -> Tensor:
    """Token ids (B, S), or a stub frontend's float embeddings (B, S, d)
    (cast to ``param_dtype`` first, as the JAX package casts them), in the
    activation dtype; absolute positions add their sinusoidal embedding."""
    if tokens.is_floating_point():
        x = tokens.to(mcfg.param_dtype)
    else:
        x = params["embed"][tokens.long()]
    x = x.to(mcfg.activation_dtype)
    if mcfg.embed_scale:
        x = x * torch.tensor(mcfg.d_model ** 0.5, dtype=x.dtype)
    if mcfg.pos_type == "absolute":
        x = x + sinusoidal_positions(positions, mcfg.d_model).to(x.dtype)
    return x


def _lm_head(params, x: Tensor, mcfg: ModelConfig, nx: Numerics) -> Tensor:
    # An explicit "lm_head" wins even for tied embeddings: packing inserts
    # the pre-quantized embed.T there.
    w = params["lm_head"] if "lm_head" in params else params["embed"].T
    return nx.dense(x, w).float()


def calls_per_layer(mcfg: ModelConfig) -> int:
    """Noise-keyed dense calls of the busiest layer kind of the pattern
    (its call counters 0..n-1), so one seed-table row fits every layer:
    attention wq, wk, wv, wo, then an encoder-decoder's cross wq and wo,
    then the MLP's wi (and wg) and wo, or each expert's wi, wg and wo in
    expert order; RG-LRU's five projections and its MLP; mLSTM's seven;
    sLSTM's three.  An encoder layer (wq, wk, wv, wo and the MLP) and the
    root's cross K/V (two) fit the same row."""
    mlp = 0 if not mcfg.d_ff else (
        3 if mcfg.mlp_type in ("swiglu", "geglu") else 2)
    ffn = 3 * mcfg.num_experts if mcfg.num_experts else mlp
    cross = 2 if mcfg.is_encoder_decoder else 0
    per_kind = {"attention": 4 + cross + ffn, "recurrent": 5 + mlp,
                "mlstm": 7, "slstm": 3}
    return max(per_kind[k] for k in set(mcfg.block_pattern or ("attention",)))


def _seed_folds(mcfg: ModelConfig):
    """(folds past the decoder's layers, root row) of a pass's seed table:
    an encoder-decoder's encoder layers and its root cross K/V calls."""
    if not mcfg.is_encoder_decoder:
        return (), False
    return tuple(ENCODER_FOLD + g
                 for g in range(mcfg.num_encoder_layers)), True


def pass_seed_table(mcfg: ModelConfig, key) -> np.ndarray:
    """Every noise seed of one pass of ``mcfg`` under the root ``key``
    (``core.prng.seed_table``; the encoder's rows and the root's for an
    encoder-decoder), the table ``pass_numerics`` reads."""
    extra, root = _seed_folds(mcfg)
    return prng.seed_table(key, mcfg.num_layers, calls_per_layer(mcfg),
                           LM_HEAD_FOLD, extra, root)


def pass_key_table(mcfg: ModelConfig, key) -> np.ndarray:
    """Every dense call's key of one pass of ``mcfg`` under the root
    ``key``, the ``abfp_ref`` scan's table: ``core.prng.key_table`` with
    ``pass_seed_table``'s folds, (n_pass_seeds(mcfg), 2) uint32."""
    extra, root = _seed_folds(mcfg)
    return prng.key_table(key, mcfg.num_layers, calls_per_layer(mcfg),
                          LM_HEAD_FOLD, extra, root)


def n_pass_seeds(mcfg: ModelConfig) -> int:
    """Entries of ``pass_seed_table`` (rows of ``pass_key_table``)."""
    extra, root = _seed_folds(mcfg)
    return (mcfg.num_layers + len(extra) + root) * calls_per_layer(mcfg) + 1


def n_pass_words(mcfg: ModelConfig, quant: QuantConfig) -> int:
    """The int32 words of a pass's noise table: ``n_pass_seeds`` seeds,
    or two words per key of the ``abfp_ref`` key table."""
    return n_pass_seeds(mcfg) * (2 if quant.mode == "abfp_ref" else 1)


def pass_words(mcfg: ModelConfig, quant: QuantConfig, key) -> np.ndarray:
    """A pass's noise table under the root ``key`` as the int32 words
    ``pass_numerics`` reads: the seed table, or in ``abfp_ref`` mode the
    key table's words (row-major, by their bits)."""
    if quant.mode == "abfp_ref":
        return pass_key_table(mcfg, key).view(np.int32).reshape(-1)
    return pass_seed_table(mcfg, key)


def pass_numerics(quant: QuantConfig, seeds: Tensor, mcfg: ModelConfig,
                  plain: bool = False, mesh=None) -> Numerics:
    """The root ``Numerics`` of a pass reading ``seeds``, the int32 words
    of ``pass_words`` on the pass's device (in ``abfp_ref`` mode turned
    into the (n, 2) int64 key table there, no host copy), dispatching
    tensor-parallel on ``mesh``."""
    extra, root = _seed_folds(mcfg)
    if quant.mode == "abfp_ref":
        seeds = seeds.view(-1, 2).to(torch.int64) & 0xFFFFFFFF
    return table_numerics(quant, seeds, mcfg.num_layers,
                          calls_per_layer(mcfg), extra, root, plain=plain,
                          mesh=mesh)


def _pass_numerics(nx: Optional[Numerics], mcfg: ModelConfig,
                   device) -> Numerics:
    """A pass's root Numerics in table mode (a key table in ``abfp_ref``
    mode; float without one): ``Numerics.as_table``."""
    nx = nx or Numerics(QuantConfig(mode="float"))
    extra, root = _seed_folds(mcfg)
    return nx.as_table(mcfg.num_layers, calls_per_layer(mcfg), device,
                       extra, root)


def _run_layers(params, state, x, mcfg, nx, positions, n_tokens=None,
                enc_kv=None):
    pt = state.get("page_table")
    for li, (lp, ls) in enumerate(zip(params["layers"], state["layers"])):
        x, state["layers"][li], _ = _apply_layer(
            lp, x, mcfg, nx.fold(li), kind=mcfg.layer_kind(li),
            positions=positions, state=ls, n_tokens=n_tokens, page_table=pt,
            enc_kv=None if enc_kv is None else enc_kv[li])
    return norm(x, params["final_norm"], mcfg.norm_type)


# ---------------------------------------------------------------------------
# Encoder (encoder-decoders)
# ---------------------------------------------------------------------------


def encode(params: dict, features: Tensor, mcfg: ModelConfig,
           nx: Numerics) -> Tensor:
    """The whisper-style encoder over stub frame embeddings (B, S_enc, d):
    the features in the activation dtype plus sinusoidal positions, then
    each encoder layer ``g`` (non-causal self-attention and the MLP, pre-
    norm) under ``nx.fold(ENCODER_FOLD + g)``, then the encoder's final
    norm.  Returns (B, S_enc, d)."""
    b, s = features.shape[:2]
    positions = torch.arange(s, device=features.device)[None, :].expand(b, s)
    x = features.to(mcfg.activation_dtype)
    x = x + sinusoidal_positions(positions, mcfg.d_model).to(x.dtype)
    enc = params["encoder"]
    for g, lp in enumerate(enc["layers"]):
        nxg = nx.fold(ENCODER_FOLD + g)
        h = norm(x, lp["norm1"], mcfg.norm_type)
        attn_out, _ = attention_block(lp["attn"], h, mcfg, nxg,
                                      positions=positions, causal=False,
                                      train_mode=mcfg.remat)
        x = x + attn_out
        h = norm(x, lp["norm2"], mcfg.norm_type)
        x = x + mlp_block(lp["mlp"], h, mcfg, nxg)
    return norm(x, enc["final_norm"], mcfg.norm_type)


def encode_cross_kv(params: dict, enc_out: Tensor, mcfg: ModelConfig,
                    nx: Numerics) -> list:
    """Every decoder layer's cross-attention (k, v), each (B, S_enc, KH,
    D), from an encoder output: the per-slot encoder cache of
    ``serving.runners.EncDecRunner``.  All layers take the root ``nx``'s
    calls 0 (wk) and 1 (wv), as the JAX package's ``vmap`` over its
    stacked layers does."""
    b, s, _ = enc_out.shape
    kh, hd = mcfg.num_kv_heads, mcfg.resolved_head_dim
    sk, sv = nx.next_seeds(2)
    out = []
    for lp in params["layers"]:
        w = lp["cross"]
        out.append(tuple(nx.dense_seeded(enc_out, w[n], sd).reshape(
            b, s, kh, hd) for n, sd in (("wk", sk), ("wv", sv))))
    return out


def _encoder_kv(params, encoder_features, mcfg, nx):
    """The cross K/V of a cacheless pass: None without an encoder."""
    if not mcfg.is_encoder_decoder:
        return None
    if encoder_features is None:
        raise ValueError(f"{mcfg.name} needs encoder_features")
    return encode_cross_kv(params, encode(params, encoder_features, mcfg,
                                          nx), mcfg, nx)


# ---------------------------------------------------------------------------
# Teacher-forced forward (evaluation) and DNF's paired capture
# ---------------------------------------------------------------------------


def _positions(tokens: Tensor) -> Tensor:
    b, s = tokens.shape[:2]
    return torch.arange(s, device=tokens.device)[None, :].expand(b, s)


def _forward_layer(lp: dict, x: Tensor, mcfg: ModelConfig, nx: Numerics,
                   li: int, positions: Tensor, dnf, dnf_key, enc_kv=None,
                   mesh=None):
    """Layer ``li`` of the teacher-forced forward under ``nx.fold(li)``,
    then DNF's noise ``dnf.layer(li).sample(fold_in(dnf_key, li))``;
    returns (x, aux).  Each call folds afresh, so a rematerialized layer
    draws what its first run drew."""
    x, _, aux = _apply_layer(lp, x, mcfg, nx.fold(li),
                             kind=mcfg.layer_kind(li), positions=positions,
                             enc_kv=enc_kv, mesh=mesh)
    if dnf is None:
        return x, aux
    return inject(x, dnf.layer(li), prng.fold_in(dnf_key, li)), aux


def forward(params: dict, tokens: Tensor, mcfg: ModelConfig,
            nx: Optional[Numerics] = None, *, encoder_features=None,
            dnf=None, dnf_key=None, mesh=None,
            return_hidden: bool = False):
    """Teacher-forced forward over whole sequences, without a cache.

    tokens: (B, S) int ids, or (B, S, d) float stub-frontend embeddings.
    An encoder-decoder needs ``encoder_features`` (B, S_enc, d): the
    encoder runs first (``encode``, then ``encode_cross_kv`` under the
    root key), and every decoder layer attends its cross K/V.  Returns (logits (B, S, V) f32, aux), or
    (hidden (B, S, d), aux) with ``return_hidden``; ``aux`` is the f32
    auxiliary loss, the sum of the MoE layers' load-balance losses (0
    without experts), added layer by layer as the JAX package's scan
    adds it.  Layer ``li`` runs under
    ``nx.fold(li)`` and the head under ``nx.fold(999_983)``, as the JAX
    package's scan folds them.

    ``dnf`` (a stacked ``core.dnf.NoiseHistogram``) adds to layer ``li``'s
    output noise drawn from its histogram with key ``fold_in(dnf_key,
    li)`` (Eq. 9).  With ``mcfg.remat``, each layer (its DNF noise
    included) runs under ``torch.utils.checkpoint`` when autograd records,
    and its attention is ``train_attention``.

    ``mesh`` (a ``distributed.sharding.Mesh``): every MoE layer takes the
    expert-parallel route (``moe.moe_block_sharded``); everything else
    runs as without a mesh (``nx`` carries its own mesh, if any), as in
    the JAX package."""
    check_supported(mcfg)
    if dnf is not None and dnf_key is None:
        raise ValueError("dnf needs a dnf_key")
    nx = _pass_numerics(nx, mcfg, tokens.device)
    positions = _positions(tokens)
    x = _embed(params, tokens, mcfg, positions)
    enc_kv = _encoder_kv(params, encoder_features, mcfg, nx)
    remat = mcfg.remat and torch.is_grad_enabled()
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for li, lp in enumerate(params["layers"]):
        args = (lp, x, mcfg, nx, li, positions, dnf, dnf_key,
                None if enc_kv is None else enc_kv[li], mesh)
        x, a = (checkpoint(_forward_layer, *args, use_reentrant=False)
                if remat else _forward_layer(*args))
        if a is not None:
            aux = aux + a
    x = norm(x, params["final_norm"], mcfg.norm_type)
    if return_hidden:
        return x, aux
    return _lm_head(params, x, mcfg, nx.fold(LM_HEAD_FOLD)), aux


def lm_head_logits(params: dict, hidden: Tensor, mcfg: ModelConfig,
                   nx: Optional[Numerics] = None) -> Tensor:
    """Project (B, S, d) hidden states to f32 logits (fold 999_983)."""
    nx = nx or Numerics(QuantConfig(mode="float"))
    return _lm_head(params, hidden, mcfg, nx.fold(LM_HEAD_FOLD))


def forward_capture(params: dict, tokens: Tensor, mcfg: ModelConfig,
                    nx_float: Numerics, nx_abfp_factory, *,
                    encoder_features=None):
    """DNF's paired pass (paper Fig. 3): every layer runs in FLOAT on the
    FLOAT stream and, on the same input, in ABFP; ``dy = ABFP - FLOAT``
    per layer.  ``nx_abfp_factory()`` returns a fresh ABFP ``Numerics``
    for each layer, which is then folded with the layer index.  An
    encoder-decoder's encoder and cross K/V run once, in FLOAT.

    Returns (logits of the FLOAT stream, [dy_0, ..., dy_{L-1}] in f32)."""
    check_supported(mcfg)
    positions = _positions(tokens)
    x = _embed(params, tokens, mcfg, positions)
    enc_kv = _encoder_kv(params, encoder_features, mcfg, nx_float)
    deltas = []
    for li, lp in enumerate(params["layers"]):
        ek = None if enc_kv is None else enc_kv[li]
        kind = mcfg.layer_kind(li)
        x_f, _, _ = _apply_layer(lp, x, mcfg, nx_float.fold(li), kind=kind,
                                 positions=positions, enc_kv=ek)
        x_q, _, _ = _apply_layer(lp, x, mcfg, nx_abfp_factory().fold(li),
                                 kind=kind, positions=positions, enc_kv=ek)
        deltas.append(x_q.float() - x_f.float())
        x = x_f
    x = norm(x, params["final_norm"], mcfg.norm_type)
    return _lm_head(params, x, mcfg, nx_float.fold(LM_HEAD_FOLD)), deltas


# ---------------------------------------------------------------------------
# Decode state, decode tick, chunked prefill
# ---------------------------------------------------------------------------


def init_decode_state(mcfg: ModelConfig, batch: int, max_len: int,
                      device: DeviceLike = None, *,
                      page_size: Optional[int] = None,
                      pool_pages: Optional[int] = None) -> dict:
    """Per-layer decode state for ``batch`` rows.  An attention layer
    holds a KV cache of ``max_len`` slots (a ring of ``window_size`` slots
    in a hybrid pattern, whatever ``max_len`` is): int8 codes plus bf16
    per-(token, head) scales with ``mcfg.kv_quant``, else the activation
    dtype.  A recurrent layer holds ``{"rec": ...}``: RG-LRU's conv tail
    and h, mLSTM's C, n and m, sLSTM's h, c, n and m (m at -1e30), as the
    JAX package allocates them.

    With ``page_size``/``pool_pages`` the caches are PAGED: each layer
    holds pools ``k_pages``/``v_pages`` (pool_pages + 1, page_size, KH, D)
    (and ``k_scale_pages``/``v_scale_pages`` (pool_pages + 1, page_size,
    KH) bf16 under ``kv_quant``) shared by all rows, the last page the
    scratch page that takes dropped writes; the state gains ``page_table``
    (batch, ceil(max_len / page_size)) int32, filled with the sentinel
    ``pool_pages``.  Every cache tensor starts at zero, so no gathered page
    holds a NaN."""
    check_supported(mcfg, serving=True)
    dev = resolve_device(device)
    kh, hd = mcfg.num_kv_heads, mcfg.resolved_head_dim
    paged = page_size is not None
    if paged and (pool_pages is None or pool_pages < 1):
        raise ValueError("a paged decode state needs pool_pages >= 1")
    window = _window(mcfg)
    if paged and mcfg.attention_type != "full":
        raise ValueError("only full-attention KV caches page; "
                         f"{mcfg.name} is {mcfg.attention_type!r}")

    def zeros(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=dev)

    def one(kind):
        if kind != "attention":
            return {"rec": _recurrent_state(kind, mcfg, batch, dev)}
        kv = {"length": zeros(batch, torch.int32)}
        if paged:
            shape, sfx = (pool_pages + 1, page_size, kh, hd), "_pages"
        else:
            shape, sfx = (batch, window or max_len, kh, hd), ""
        dtype = torch.int8 if mcfg.kv_quant else mcfg.activation_dtype
        kv["k" + sfx] = zeros(shape, dtype)
        kv["v" + sfx] = zeros(shape, dtype)
        if mcfg.kv_quant:
            kv["k_scale" + sfx] = zeros(shape[:3], torch.bfloat16)
            kv["v_scale" + sfx] = zeros(shape[:3], torch.bfloat16)
        return {"kv": kv}

    state = {"layers": [one(mcfg.layer_kind(i))
                        for i in range(mcfg.num_layers)],
             "position": zeros(batch, torch.int32)}
    if paged:
        state["page_table"] = torch.full(
            (batch, -(-max_len // page_size)), pool_pages, dtype=torch.int32,
            device=dev)
    return state


def _recurrent_state(kind: str, mcfg: ModelConfig, batch: int, dev) -> dict:
    def zeros(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    if kind == "recurrent":
        r = mcfg.lru_width or mcfg.d_model
        return {"conv": zeros(batch, mcfg.conv_width - 1, r,
                              dtype=mcfg.activation_dtype),
                "h": zeros(batch, r)}
    nh = mcfg.num_heads
    if kind == "mlstm":
        dh = 2 * mcfg.d_model // nh
        return {"C": zeros(batch, nh, dh, dh), "n": zeros(batch, nh, dh),
                "m": zeros(batch, nh)}
    dh = mcfg.d_model // nh
    return {"h": zeros(batch, nh, dh), "c": zeros(batch, nh, dh),
            "n": zeros(batch, nh, dh),
            "m": torch.full((batch, nh, dh), -1e30, device=dev)}


def clone_state(state):
    """A deep copy of a decode state (the passes update it in place)."""
    if isinstance(state, dict):
        return {k: clone_state(v) for k, v in state.items()}
    if isinstance(state, list):
        return [clone_state(v) for v in state]
    return state.clone()


def decode_step(params: dict, state: dict, token: Tensor, mcfg: ModelConfig,
                nx: Optional[Numerics] = None, *, enc_kv=None):
    """One decode tick.  token: (B,) int (or (B, d) embeddings).  Returns
    (logits (B, V) f32, state), the state updated in place.  ``enc_kv``:
    an encoder-decoder's cross (k, v) per decoder layer, each (B, S_enc,
    KH, D).

    In ``abfp_fused`` numerics every layer runs the fused QKV and int8-KV
    attention kernels (``models.layers._fused_decode_attention_block``)."""
    nx = _pass_numerics(nx, mcfg, token.device)
    positions = state["position"][:, None]                      # (B, 1)
    x = _embed(params, token[:, None], mcfg, positions)
    x = _run_layers(params, state, x, mcfg, nx, positions, enc_kv=enc_kv)
    logits = _lm_head(params, x, mcfg, nx.fold(LM_HEAD_FOLD))[:, 0]
    state["position"].add_(1)
    return logits, state


def prefill(params: dict, state: dict, tokens: Tensor, n_tokens: Tensor,
            mcfg: ModelConfig, nx: Optional[Numerics] = None, *,
            enc_kv=None):
    """Advance every row by a prompt chunk in one pass.

    tokens: (B, S) int (padding values arbitrary); ``n_tokens``: (B,) —
    tokens[b, :n_tokens[b]] are real.  A row with n_tokens == 0 is left
    unchanged.  Returns (logits (B, V) f32 at each row's LAST real token,
    state), the state updated in place.  ``enc_kv`` as ``decode_step``'s."""
    b, s = tokens.shape[:2]
    dev = tokens.device
    nx = _pass_numerics(nx, mcfg, dev)
    positions = state["position"][:, None] \
        + torch.arange(s, dtype=torch.int32, device=dev)[None, :]
    n_tokens = n_tokens.to(device=dev, dtype=torch.int32)
    x = _embed(params, tokens, mcfg, positions)
    x = _run_layers(params, state, x, mcfg, nx, positions, n_tokens, enc_kv)
    last = torch.clamp(n_tokens.long() - 1, 0, s - 1)
    x_last = x[torch.arange(b, device=dev), last][:, None]     # (B, 1, d)
    logits = _lm_head(params, x_last, mcfg, nx.fold(LM_HEAD_FOLD))[:, 0]
    state["position"].add_(n_tokens)
    return logits, state


# ---------------------------------------------------------------------------
# Sampling
# ---------------------------------------------------------------------------


def sample_tokens(logits: Tensor, temperatures, uids, token_idxs,
                  seed: int) -> Tensor:
    """One next token per row, on the logits' device, as JAX's
    ``sample_tokens`` draws it.  Rows with temperature 0 take the argmax
    (first occurrence on ties, as ``np.argmax``); rows with temperature t >
    0 take ``argmax(logits / t + gumbel)`` in f32 (``jax.random
    .categorical``), the Gumbel noise from the key ``fold_in(fold_in(
    PRNGKey(seed), uid), token_idx)`` of each row (``core.prng``), so a
    draw does not depend on how requests share a batch.  ``temperatures``
    (f32), ``uids`` and ``token_idxs`` (int32) are (B,) tensors or host
    arrays; no value goes to the host, so the function runs inside a CUDA
    graph.  Returns (B,) int32."""
    dev = logits.device
    temps = torch.as_tensor(temperatures, dtype=torch.float32).to(dev)
    uids = torch.as_tensor(uids, dtype=torch.int32).to(dev)
    idxs = torch.as_tensor(token_idxs, dtype=torch.int32).to(dev)
    logits = logits.float()
    greedy = torch.argmax(logits, dim=-1)
    k0, k1 = prng.row_keys(seed, uids, idxs)
    g = prng.gumbel(prng.random_bits(k0, k1, logits.shape[-1]))
    safe_t = torch.where(temps > 0, temps, torch.ones_like(temps))
    drawn = torch.argmax(g + logits / safe_t[:, None], dim=-1)
    return torch.where(temps > 0, drawn, greedy).to(torch.int32)
