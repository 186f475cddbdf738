"""Whole-model ABFP weight packing: quantize once, serve forever.

``pack_model_params`` walks a param tree and replaces every dense weight
(the operand of ``Numerics.dense``) with a ``PackedWeight`` — int8 tile
codes plus bf16 per-(tile, column) scales — so serving never re-derives
weight scales or codes.  In ``abfp_fused`` mode the packs also carry the
per-tile ADC gains, and the attention block of each full-attention
layer gains a ``"qkv"`` entry: wq, wk and wv concatenated once for the
fused QKV kernel (``kernels.abfp_decode_fused.concat_qkv``), the only
layers whose decode tick takes it (``models.layers._use_fused_decode``);
an encoder's attention and a decoder's cross-attention run no decode
tick and get none.  An MoE block's (E, K, N) expert weights pack expert by expert into a list
of E ``PackedWeight``s (kernel 1 takes one 2-D weight per launch); expert
``ex``'s codes, scales and gains are the ``[ex]`` slice of the JAX
package's pack of the stacked leaf.

Embedding tables, norm scales and biases, and the MoE router (routing
stays digital) stay in their original dtype.

With a ``mesh`` (tensor-parallel serving) the packed tree is placed by
``distributed.sharding.shard_serving_params``: every packed weight whose
columns split over the mesh's 'model' axis becomes a
``kernels.ops.ColumnShards`` (codes, kernel codes and scales split
together), and each attention block's QKV concatenation is built per
shard.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.core.abfp import PackedWeight, QuantConfig, pack_abfp_weight
from repro_torch.kernels.abfp_decode_fused import PackedQKV, concat_qkv
from repro_torch.kernels.ops import ColumnShards

# Leaf names that feed Numerics.dense as the weight operand.
DENSE_WEIGHT_NAMES = frozenset({
    "wq", "wk", "wv", "wo", "wi", "wg",
    "w_gate", "w_in", "w_rg", "w_ig", "w_out",
    "w_up", "w_down", "w_if", "w_x",
    "lm_head",
})


def pack_model_params(params: dict, cfg: QuantConfig,
                      mcfg: Any = None, mesh: Any = None) -> dict:
    """A copy of ``params`` with every dense weight packed at ``cfg``'s
    tile width and bit widths.  ``mcfg`` (optional) enables packing the
    tied LM head (``embed.T`` under ``"lm_head"``); ``mesh`` places the
    packed tree over its 'model' axis."""
    adaptive = cfg.mode == "abfp_fused"
    # Windowed (hybrid) attention and mLSTM blocks never take the fused
    # decode, so they carry no QKV concatenation.
    full = getattr(mcfg, "attention_type", "full") == "full"

    def walk(node, name=None, decoder=True):
        if isinstance(node, dict):
            out = {k: walk(v, k, decoder and k != "encoder")
                   for k, v in node.items()}
            if adaptive and full and decoder and name == "attn" and all(
                    isinstance(out.get(w), PackedWeight)
                    for w in ("wq", "wk", "wv")):
                out["qkv"] = concat_qkv(
                    (out["wq"], out["wk"], out["wv"]), cfg)
            return out
        if isinstance(node, list):
            return [walk(v, name, decoder) for v in node]
        if name in DENSE_WEIGHT_NAMES and isinstance(node, torch.Tensor):
            if node.ndim == 2:
                return pack_abfp_weight(node, cfg, adaptive_gain=adaptive)
            if node.ndim == 3:
                return [pack_abfp_weight(w, cfg, adaptive_gain=adaptive)
                        for w in node]
        return node

    packed = walk(params)
    if getattr(mcfg, "tie_embeddings", False) and "lm_head" not in params:
        packed["lm_head"] = pack_abfp_weight(params["embed"].T, cfg,
                                             adaptive_gain=adaptive)
    if mesh is not None:
        from repro_torch.distributed.sharding import shard_serving_params
        packed = shard_serving_params(packed, mesh, cfg)
    return packed


def packed_param_bytes(params) -> int:
    """Device bytes of a (possibly partly) packed param tree, counting each
    PackedWeight's canonical form (codes, scales, gains) as the JAX package
    does; the kernel-layout copies are not counted."""
    if isinstance(params, dict):
        return sum(packed_param_bytes(v) for v in params.values())
    if isinstance(params, (list, tuple)):
        return sum(packed_param_bytes(v) for v in params)
    if isinstance(params, PackedWeight):
        return params.nbytes()
    if isinstance(params, PackedQKV):
        return 0
    if isinstance(params, ColumnShards):
        return params.nbytes()
    return params.numel() * params.element_size()
