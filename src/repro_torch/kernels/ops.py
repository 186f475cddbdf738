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

``dense_tp`` is the tensor-parallel form over a mesh's ``"model"`` axis
(``distributed.sharding.Mesh``): column-parallel, one call per column
shard, each on its local columns with its global column-block offset
(the noise salts of the whole weight's grid), the outputs concatenated in
shard order (the all-gather); ``fused_qkv_dense`` is the fused QKV
projection's dispatch, with or without a mesh.  It is bit-identical to the one-device call
at any shard count.  In this port every shard of a mesh runs on the one
device that holds the mesh; the activations stay whole.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import abfp as core_abfp
from repro_torch.core.abfp import (
    PackedWeight,
    QuantConfig,
    ceil_to,
    dequantize_packed,
    kernel_layout,
    pack_abfp_weight,
    ste_grads,
)
from repro_torch.core.prng import key_to_seed
from repro_torch.kernels.abfp_decode_fused import (
    fused_qkv_packed,
    fused_qkv_packed_ref,
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


# ---------------------------------------------------------------------------
# Tensor-parallel dispatch over the 'model' axis of a mesh
# ---------------------------------------------------------------------------
#
# Serving shards a dense matmul COLUMN-parallel: each shard runs the kernel
# on its slice of the weight's columns and the outputs are concatenated in
# shard order.  A column split never breaks an ABFP K-tile (tiles lie along
# the contracting dim), every output element's f32 contraction is the one
# the whole call computes, and each shard passes its global column-block
# offset and the whole weight's block count, so it draws the noise the
# whole call draws for its columns: bit-identical at any shard count.
#
# ``dense_tp_row`` is the ROW-parallel (contracting-dim) float form: the
# partials of each shard's rows summed in shard order.  It reorders the f32
# reduction, so it is reproducible but not bit-identical, and serving never
# routes through it.

MODEL_AXIS = "model"
DATA_AXES = ("pod", "data")
_LANE = 128                 # packed-weight lane alignment (core.abfp)


def tp_size(mesh) -> int:
    """Size of the 'model' axis of ``mesh`` (1 when absent / no mesh)."""
    if mesh is None or MODEL_AXIS not in mesh.axis_names:
        return 1
    return mesh.shape[MODEL_AXIS]


def tp_col_quantum(cfg: QuantConfig, packed: bool,
                   tp: int) -> Optional[int]:
    """Column-count divisor a weight needs for column-sharding over ``tp``
    shards, or None when the mode never shards: the single source of the
    rule, read by placement (``distributed.sharding``) and by dispatch
    (``tp_shardable``).

    * float weights: any even column split (``tp``);
    * kernel modes with noise: whole 128-lane column blocks per shard
      (``tp * 128``), so each shard's blocks are blocks of the whole grid
      and their salts line up;
    * kernel modes without noise: any even split (``tp``);
    * ``abfp_ref``: its noise comes from shape-dependent key streams that
      cannot be column-globalized: never sharded."""
    if packed or cfg.mode in ("abfp_kernel", "abfp_packed", "abfp_fused"):
        return tp * _LANE if cfg.noise_lsb > 0.0 else tp
    if cfg.mode == "float":
        return tp
    return None


@dataclasses.dataclass(frozen=True)
class ColumnShards:
    """A dense weight split column-parallel into ``len(shards)`` local
    weights (``PackedWeight``s, or float (K, N / tp) tensors), shard ``t``
    holding columns ``t * N / tp ..`` of the whole weight's ``n_padded``
    stored columns (``n_cols`` logical).  A packed shard whose columns are
    not whole 128-lane blocks (only without noise) is padded with zero
    columns, which its output drops.  Made once, at pack or placement
    time (``distributed.sharding.shard_serving_params``)."""

    shards: Tuple[Any, ...]
    n_cols: int
    n_padded: int

    @property
    def packed(self) -> bool:
        return isinstance(self.shards[0], PackedWeight)

    @property
    def shard_cols(self) -> int:
        return self.n_padded // len(self.shards)

    def grid(self, t: int) -> Tuple[int, Optional[int]]:
        """(col_block_offset, num_col_blocks) of shard ``t``: its first
        block's index in the whole weight's grid and that grid's block
        count; its own grid (0, None) where the shards do not split on
        block boundaries (no noise: the salts are not drawn)."""
        nl = self.shard_cols
        if nl % _LANE:
            return 0, None
        return t * nl // _LANE, -(-self.n_padded // _LANE)

    def nbytes(self) -> int:
        return sum(w.nbytes() if isinstance(w, PackedWeight)
                   else w.numel() * w.element_size() for w in self.shards)


def _local_packed(pw: PackedWeight, a: int, e: int) -> PackedWeight:
    """Columns ``a:e`` of a packed weight as a weight of their own (codes,
    kernel-layout codes and scales split together; the per-tile gains
    index K and stay whole), padded with zero columns to whole lanes."""
    pad = ceil_to(e - a, _LANE) - (e - a)

    def cols(t):
        t = t[:, a:e]
        if pad:
            t = torch.nn.functional.pad(t, (0, pad))
        return t.contiguous()

    codes = cols(pw.codes)
    return PackedWeight(
        codes, cols(pw.scales), pw.k, e - a, pw.tile_width, pw.bits_w,
        gains=pw.gains,
        kcodes=None if pw.kcodes is None else kernel_layout(codes))


def shard_columns(w, tp: int) -> ColumnShards:
    """Split a 2-D weight (a ``PackedWeight`` or a float tensor) into
    ``tp`` column shards."""
    if isinstance(w, PackedWeight):
        n, n_cols = w.n_padded, w.n_cols
    else:
        n = n_cols = int(w.shape[-1])
    if n % tp:
        raise ValueError(f"{n} columns do not split over {tp} shards")
    c = n // tp
    if isinstance(w, PackedWeight):
        shards = tuple(_local_packed(w, t * c, (t + 1) * c)
                       for t in range(tp))
    else:
        shards = tuple(w[:, t * c:(t + 1) * c].contiguous()
                       for t in range(tp))
    return ColumnShards(shards, n_cols, n)


def tp_shardable(w, cfg: QuantConfig, mesh) -> bool:
    """Can ``w`` be column-sharded over 'model' with bit-identical results?
    Only 2-D weights qualify; the column rule is ``tp_col_quantum``'s.  A
    ``ColumnShards`` of the mesh's shard count is sharded already."""
    tp = tp_size(mesh)
    if tp <= 1:
        return False
    if isinstance(w, ColumnShards):
        return len(w.shards) == tp
    packed = isinstance(w, PackedWeight)
    ndim = w.codes.ndim if packed else getattr(w, "ndim", 0)
    if ndim != 2:
        return False
    quantum = tp_col_quantum(cfg, packed, tp)
    if quantum is None:
        return False
    cols = w.n_padded if packed else w.shape[-1]
    return cols % quantum == 0


def _shard_forward(x, w, cfg, seed, grid, plain):
    """One column shard's call, at its place in the whole weight's grid."""
    off, nj = grid
    kw = dict(col_block_offset=off, num_col_blocks=nj)
    if isinstance(w, PackedWeight):
        fn = abfp_matmul_packed_ref if plain else abfp_matmul_packed
        return fn(x, w, cfg, seed, **kw)
    if cfg.mode == "float":
        return torch.matmul(x, w.to(x.dtype))
    fn = abfp_matmul_ref if plain else abfp_matmul
    return fn(x, w, cfg, seed, **kw)


def dense_tp(x: Tensor, w, cfg: QuantConfig, key=None, mesh=None,
             plain: bool = False) -> Tensor:
    """Column-parallel ``dense`` over the 'model' axis of ``mesh``: one
    call per shard of ``w`` (a ``ColumnShards`` of the mesh's shard count,
    or a whole weight split here), each at its global column-block
    offset, the outputs concatenated in shard order.  Bit-identical to the
    one-device call.  A weight the mesh cannot split (indivisible columns,
    ``abfp_ref``, not 2-D) runs whole, replicated, as the one-device call:
    the JAX package's fallback.  Forward only (serving).

    A float weight in a kernel mode takes the unpacked kernel per shard,
    as the JAX package's shard body does."""
    if not tp_shardable(w, cfg, mesh):
        if isinstance(w, ColumnShards):
            raise ValueError(f"a weight in {len(w.shards)} column shards on "
                             f"a mesh of {tp_size(mesh)}")
        return dense(x, w, cfg, key, plain)
    if not isinstance(w, ColumnShards):
        w = shard_columns(w, tp_size(mesh))
    seed = as_seed(key)
    out = torch.cat([_shard_forward(x, wl, cfg, seed, w.grid(t), plain)
                     for t, wl in enumerate(w.shards)], dim=-1)
    return out[..., :w.n_cols] if w.packed else out


def fused_qkv_dense(x: Tensor, pws, cfg: QuantConfig, seeds, mesh=None,
                    qkv=None, plain: bool = False):
    """The fused QKV projection's dispatch (the JAX package's
    ``fused_qkv_dense``).  ``seeds``: the three calls' seeds, exactly those
    of three consecutive ``Numerics.dense`` calls.  Without a mesh (or at
    tp 1): one fused launch (``qkv`` its pack-time concatenation).  On a
    mesh whose every weight shards: one fused launch per shard over the
    local slices of wq, wk and wv, each segment at its global offset
    (``qkv`` then one concatenation per shard).  Otherwise three
    ``dense_tp`` calls, each sharded or replicated by its own rule.
    ``plain`` runs the plain versions."""
    if tp_size(mesh) > 1:
        if all(tp_shardable(pw, cfg, mesh) for pw in pws):
            return _fused_qkv_tp(x, pws, cfg, seeds, mesh, qkv, plain)
        return tuple(dense_tp(x, pw, cfg, s, mesh, plain)
                     for pw, s in zip(pws, seeds))
    if plain:
        return fused_qkv_packed_ref(x, pws, cfg, seeds)
    return fused_qkv_packed(x, pws, cfg, seeds, qkv=qkv)


def _fused_qkv_tp(x: Tensor, pws, cfg: QuantConfig, seeds, mesh, qkv,
                  plain: bool):
    """Column-parallel fused QKV: the outputs of the shards' launches
    concatenated per weight in shard order, equal to the one-device launch
    bit for bit."""
    tp = tp_size(mesh)
    shards = [pw if isinstance(pw, ColumnShards) else shard_columns(pw, tp)
              for pw in pws]
    outs = ([], [], [])
    for t in range(tp):
        local = tuple(s_.shards[t] for s_ in shards)
        offs, njs = zip(*(s_.grid(t) for s_ in shards))
        kw = dict(col_block_offsets=offs, num_col_blocks=njs)
        if plain:
            ys = fused_qkv_packed_ref(x, local, cfg, seeds, **kw)
        else:
            ys = fused_qkv_packed(x, local, cfg, seeds,
                                  None if qkv is None else qkv[t], **kw)
        for o, y in zip(outs, ys):
            o.append(y)
    return tuple(torch.cat(o, dim=-1)[..., :s_.n_cols]
                 for o, s_ in zip(outs, shards))


def dense_tp_row(x: Tensor, w: Tensor, cfg: QuantConfig,
                 mesh=None) -> Tensor:
    """Row-parallel float matmul: the contracting dim split over 'model',
    each shard's partial product summed in shard order.  Reproducible, but
    not bit-identical to the one-device call (the f32 reduction is
    reordered): float mode only."""
    if cfg.mode != "float":
        raise ValueError(
            "dense_tp_row is float-only: sharding the contracting dim "
            "splits ABFP tile accumulation across devices, breaking the "
            "per-tile ADC semantics (use column-parallel dense_tp)")
    tp = tp_size(mesh)
    if tp <= 1 or w.shape[0] % tp != 0:
        return dense(x, w, cfg, None)
    kl = w.shape[0] // tp
    out = None
    for t in range(tp):
        p = torch.matmul(x[..., t * kl:(t + 1) * kl],
                         w[t * kl:(t + 1) * kl].to(x.dtype))
        out = p if out is None else out + p
    return out


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
