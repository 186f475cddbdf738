"""Fused ABFP decode-step kernels: QKV projections + int8-KV attention.

``fused_qkv_packed``
    The three packed projections wq|wk|wv of one activation in ONE launch
    of the packed-matmul CUDA kernel (``csrc/abfp_matmul.cu``) over their
    concatenated column blocks.  Each segment keeps its own noise seed,
    column-block count and local block index, so every output equals the
    stand-alone ``abfp_matmul_packed`` call for that weight.  Replaces the
    TPU kernel ``fused_qkv_packed_pallas`` (``repro/kernels/
    abfp_decode_fused.py``).  The concatenated codes, scales and the
    (T, 3) gains table are built once, at pack time (``concat_qkv``),
    instead of on every call.  Each segment may be a column shard of its
    weight (``col_block_offsets`` / ``num_col_blocks``: the noise of the
    whole weight's grid, as ``abfp_matmul_packed``).


``fused_quantized_decode_attention``
    Single-query GQA decode attention directly on the int8 KV codes
    (``csrc/decode_attention.cu``; see its header for the bound and the
    design).  Replaces the TPU kernel ``fused_quantized_decode_attention``.

On CPU tensors both wrappers run their plain PyTorch versions
(``fused_qkv_packed_ref``, ``quantized_decode_attention``); on CUDA
tensors they launch their kernel or raise.  Each wrapper counts its
launches in ``.launches``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch

from repro_torch.core.abfp import PackedWeight, QuantConfig
from repro_torch.kernels import _build
from repro_torch.kernels.abfp_matmul import (
    DEFAULT_BN,
    _seed_or_zero,
    abfp_matmul_packed_ref,
    check_packed,
    col_grid,
    launch_segments,
)

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# Fused QKV projection
# ---------------------------------------------------------------------------


def validate_fused(pws: Sequence[PackedWeight], cfg: QuantConfig) -> None:
    """Shared-shape checks for the three fused projection weights."""
    if len(pws) != 3:
        raise ValueError(f"fused QKV takes exactly 3 PackedWeights, got {len(pws)}")
    n_gains = sum(pw.gains is not None for pw in pws)
    if n_gains not in (0, 3):
        raise ValueError("fused QKV weights must all carry gains or none")
    for pw in pws:
        check_packed(pw, cfg)
        if pw.k != pws[0].k:
            raise ValueError(f"fused QKV weights must share K: "
                             f"{pw.k} != {pws[0].k}")
        if pw.n_padded % DEFAULT_BN:
            raise ValueError(f"padded columns {pw.n_padded} are not a "
                             f"multiple of {DEFAULT_BN}")


@dataclasses.dataclass(frozen=True)
class PackedQKV:
    """wq|wk|wv packed weights concatenated along columns for one launch.

      kcodes: int32 (Kp/4, Ntot)  kernel-layout codes of the three weights
      scales: bf16  (T, Ntot)     their scales, side by side
      gains : f32   (T, 3) or None  per-tile gains, one column per weight
      pws   : the three PackedWeights (shapes, plain version)
    """

    kcodes: Tensor
    scales: Tensor
    gains: Optional[Tensor]
    pws: Tuple[PackedWeight, PackedWeight, PackedWeight]

    @property
    def njs(self) -> Tuple[int, ...]:
        return tuple(pw.n_padded // DEFAULT_BN for pw in self.pws)


def concat_qkv(pws: Sequence[PackedWeight], cfg: QuantConfig) -> PackedQKV:
    """Concatenate three packed weights once, for ``fused_qkv_packed``."""
    pws = tuple(pws)
    validate_fused(pws, cfg)
    if any(pw.kcodes is None for pw in pws):
        raise ValueError("PackedWeights need kernel-layout codes (kcodes)")
    gains = (None if pws[0].gains is None
             else torch.stack([pw.gains.float() for pw in pws], 1).contiguous())
    return PackedQKV(
        kcodes=torch.cat([pw.kcodes for pw in pws], 1).contiguous(),
        scales=torch.cat([pw.scales for pw in pws], 1).contiguous(),
        gains=gains, pws=pws)


Grids = Optional[Sequence[int]]


def _grids(pws, col_block_offsets: Grids, num_col_blocks: Grids):
    """Each segment's (global block count, first block)."""
    offs = col_block_offsets or (0, 0, 0)
    njs = num_col_blocks or (None, None, None)
    return [col_grid(pw.n_padded, o, n) for pw, o, n in zip(pws, offs, njs)]


def fused_qkv_packed_ref(x: Tensor, pws: Sequence[PackedWeight],
                         cfg: QuantConfig,
                         seeds: Optional[Sequence[Optional[int]]] = None,
                         *, col_block_offsets: Grids = None,
                         num_col_blocks: Grids = None):
    """Plain version: three packed matmuls with their own seeds (and,
    for column shards, their own places in their weights' grids)."""
    validate_fused(tuple(pws), cfg)
    seeds = seeds if seeds is not None else (None, None, None)
    return tuple(abfp_matmul_packed_ref(x, pw, cfg, s, col_block_offset=o,
                                        num_col_blocks=n)
                 for pw, s, (n, o) in zip(pws, seeds, _grids(
                     pws, col_block_offsets, num_col_blocks)))


def fused_qkv_packed(x: Tensor, pws: Sequence[PackedWeight], cfg: QuantConfig,
                     seeds: Optional[Sequence[Optional[int]]] = None,
                     qkv: Optional[PackedQKV] = None, *,
                     col_block_offsets: Grids = None,
                     num_col_blocks: Grids = None):
    """(x @ wq, x @ wk, x @ wv) in one launch; each output sliced to its
    weight's logical columns.  ``seeds``: three ints (or Nones), or a (3,)
    int32 tensor on x's device that the kernel reads (a seed-table slice).
    ``qkv`` is the pack-time concatenation (built here when not given).
    ``col_block_offsets`` / ``num_col_blocks``: one per segment, each
    segment's place in its whole weight's grid when it is a column
    shard."""
    if not x.is_cuda:
        return fused_qkv_packed_ref(x, pws, cfg, seeds,
                                    col_block_offsets=col_block_offsets,
                                    num_col_blocks=num_col_blocks)
    return _fused_qkv_packed(x, pws, cfg, seeds, qkv, None,
                             col_block_offsets, num_col_blocks)


def _fused_qkv_packed(x: Tensor, pws: Sequence[PackedWeight],
                      cfg: QuantConfig,
                      seeds: Optional[Sequence[Optional[int]]],
                      qkv: Optional[PackedQKV], rows: Optional[int],
                      col_block_offsets: Grids = None,
                      num_col_blocks: Grids = None):
    """The CUDA path of ``fused_qkv_packed``; ``rows`` forces a route of
    ``launch_segments`` (an A/B entry for the card tests and
    ``chip_smoke.py``'s timing; no model path passes it)."""
    pws = tuple(pws)
    grids = _grids(pws, col_block_offsets, num_col_blocks)
    if qkv is None:
        qkv = concat_qkv(pws, cfg)
    seeds = seeds if seeds is not None else (None, None, None)
    k = pws[0].k
    if x.shape[-1] != k:
        raise ValueError(f"x K dim {x.shape[-1]} != packed weight K {k}")
    if not isinstance(seeds, Tensor):
        seeds = [_seed_or_zero(s, cfg) for s in seeds]
    out = launch_segments(x, qkv.kcodes, qkv.scales, qkv.gains, pws[0], cfg,
                          qkv.njs, grids, seeds, rows)
    fused_qkv_packed.launches += 1
    outs, col = [], 0
    for pw, nj in zip(pws, qkv.njs):
        outs.append(out[:, col:col + pw.n_cols]
                    .reshape(*x.shape[:-1], pw.n_cols))
        col += nj * DEFAULT_BN
    return tuple(outs)


fused_qkv_packed.launches = 0


# ---------------------------------------------------------------------------
# Decode attention on the int8 KV cache
# ---------------------------------------------------------------------------


def quantized_decode_attention(q: Tensor, k_codes: Tensor, k_scale: Tensor,
                               v_codes: Tensor, v_scale: Tensor, *,
                               lengths: Tensor) -> Tensor:
    """Plain version: decode attention on int8 KV codes, with the
    per-position scale factored out of both contractions:
    ``q . k_t = (q . codes_t) * s_t / 127``.

    q: (B, 1, H, D); codes: (B, S, KH, D) int8; scales: (B, S, KH) bf16;
    lengths: (B,) filled-slot counts.  Returns (B, 1, H, D) in q's dtype.
    """
    b, _, h, d = q.shape
    s_max, kh = k_codes.shape[1], k_codes.shape[2]
    rep = h // kh
    qg = (q.float() * (d ** -0.5)).reshape(b, kh, rep, d)
    s = torch.einsum("bgrd,bsgd->bgrs", qg, k_codes.float())
    s = s * (k_scale.float().transpose(1, 2)[:, :, None, :] / 127.0)
    pos = torch.arange(s_max, device=q.device)[None, None, None, :]
    s = torch.where(pos < lengths.to(q.device)[:, None, None, None], s,
                    torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    pv = p * (v_scale.float().transpose(1, 2)[:, :, None, :] / 127.0)
    out = torch.einsum("bgrs,bsgd->bgrd", pv, v_codes.float())
    return out.reshape(b, 1, h, d).to(q.dtype)


# The CUDA kernel's head dims (a position's codes in 16-byte chunks, one
# lane each, up to 16 chunks), query heads per block, and its position split: one
# block per (row, KV head, head group) up to SPLIT_POSITIONS cached
# positions; beyond, enough splits to give the card about SPLIT_BLOCKS
# blocks, each split at least SPLIT_POSITIONS long.
DECODE_HEAD_DIMS = (32, 64, 96, 128, 256)
DECODE_MAX_HEADS = 4
SPLIT_POSITIONS = 1024
SPLIT_BLOCKS = 264


def decode_attention_split(b: int, s_max: int, h: int, kh: int):
    """(query heads per block, head groups, position splits) of the CUDA
    kernel's grid for this call."""
    rep = h // kh
    heads = min(rep, DECODE_MAX_HEADS)
    groups = -(-rep // heads)
    blocks = b * kh * groups
    splits = 1
    if s_max > SPLIT_POSITIONS:
        splits = max(1, min(-(-s_max // SPLIT_POSITIONS),
                            SPLIT_BLOCKS // blocks))
    return heads, groups, splits


def fused_quantized_decode_attention(q: Tensor, k_codes: Tensor,
                                     k_scale: Tensor, v_codes: Tensor,
                                     v_scale: Tensor, *,
                                     lengths: Tensor) -> Tensor:
    """Decode attention over the int8 KV cache; same signature and
    semantics as ``quantized_decode_attention``.  CUDA tensors launch
    ``csrc/decode_attention.cu`` (one launch, two past SPLIT_POSITIONS
    cached positions; one count per call) or raise."""
    if not q.is_cuda:
        return quantized_decode_attention(q, k_codes, k_scale, v_codes,
                                          v_scale, lengths=lengths)
    b, one, h, d = q.shape
    s_max, kh = k_codes.shape[1], k_codes.shape[2]
    if one != 1 or h % kh:
        raise ValueError(f"q must be (B, 1, H, D) with H % KH == 0, got "
                         f"{tuple(q.shape)} and KH={kh}")
    if d not in DECODE_HEAD_DIMS:
        raise ValueError(f"the CUDA kernel takes head dims "
                         f"{DECODE_HEAD_DIMS}, got {d}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"q must be float32 or bfloat16, got {q.dtype}")
    want = {"k_codes": (k_codes, torch.int8, (b, s_max, kh, d)),
            "v_codes": (v_codes, torch.int8, (b, s_max, kh, d)),
            "k_scale": (k_scale, torch.bfloat16, (b, s_max, kh)),
            "v_scale": (v_scale, torch.bfloat16, (b, s_max, kh)),
            "lengths": (lengths, torch.int32, (b,))}
    for name, (t, dt, shape) in want.items():
        if t.dtype != dt or tuple(t.shape) != shape or not t.is_contiguous() \
                or t.device != q.device:
            raise ValueError(f"{name}: need contiguous {dt} {shape} on "
                             f"{q.device}, got {t.dtype} {tuple(t.shape)}")
    # The codes are read in 16-byte chunks: a view at an odd offset is copied.
    k_codes, v_codes = (t.clone() if t.data_ptr() % 16 else t
                        for t in (k_codes, v_codes))
    q = q.contiguous()
    out = torch.empty_like(q)
    heads, groups, splits = decode_attention_split(b, s_max, h, kh)
    part = None if splits == 1 else torch.empty(
        b * kh * groups * splits * heads * (d + 2), dtype=torch.float32,
        device=q.device)
    err = _build.lib("decode_attention").decode_attention_launch(
        q.data_ptr(), int(q.dtype == torch.bfloat16), k_codes.data_ptr(),
        k_scale.data_ptr(), v_codes.data_ptr(), v_scale.data_ptr(),
        lengths.data_ptr(), out.data_ptr(),
        None if part is None else part.data_ptr(), b, s_max, h, kh, d,
        splits, float(torch.tensor(d ** -0.5, dtype=torch.float32)),
        _build.stream_ptr(q.device))
    _build.check(err, "decode_attention_launch")
    fused_quantized_decode_attention.launches += 1
    return out


fused_quantized_decode_attention.launches = 0
