"""ABFP matmul, packed and unpacked: the CUDA kernels' wrappers and their
plain versions.

``abfp_matmul_packed(x, pw, cfg, seed)`` computes ``y = ABFP(x @ W)`` from
a ``PackedWeight`` (int8 codes, bf16 per-(tile, column) scales, optional
per-tile ADC gains).  Per (row, K-tile):

    s_x = bf16(max |x_tile|)                  x_q = clamp(rint(x / s_x * L_x))
    p   = x_q . w_q                           (exact integer tile dot)
    y_q = clamp(rint(p * scale [* G_t] + (u - 0.5) * 2 * noise)) * bin_y
    acc += y_q * s_x * s_w [/ G_t]            (f32, bf16 out; / gain after
                                               each K block without gains)

Replaces the TPU kernel ``abfp_matmul_packed_pallas``
(``repro/kernels/abfp_matmul.py``).  The noise ``u`` is the reference's
murmur3-style lattice hash, a function of the reference grid: ``bm =
auto_bm(M)``, ``bn = 128``, ``bk = default_bk(n, K)``; salt
``(i * nj + j) * nk + k``, hash row ``t * bm + r``, hash column the
column within its 128-column block.  Both versions here recompute those
coordinates, whatever their own tiling.

A column shard of a weight (tensor-parallel serving, ``kernels.ops.
dense_tp``) passes ``col_block_offset``, the global index of its first
128-column block, and ``num_col_blocks``, the whole weight's block count
``nj``: its column block ``j`` then draws the noise of global block
``col_block_offset + j``, so the shards' outputs side by side equal the
whole weight's call bit for bit (the TPU kernels' arguments of the same
names).  Both are plain ints: fixed for the life of a shard's pack, a
CUDA graph captures them as launch arguments.

``seed`` is an int or a one-element int32 tensor (a slot of a pass's
seed table, ``models.layers.Numerics``); the CUDA kernel reads every
segment's seed from device memory (``seed_buffer``), so a CUDA graph that
captured a call draws the noise of the table's values at each replay.

On a CPU tensor the wrapper runs ``abfp_matmul_packed_ref``; on a CUDA
tensor it launches ``csrc/abfp_matmul.cu`` (see its header for what bounds
it and how it is built) or raises.  ``abfp_matmul_packed.launches`` counts
kernel launches.  The CUDA source has three routes, chosen here by shape
(``fused_rows``): at decode size (M <= 8), one weight-streaming launch
that quantizes the activations itself and keeps every per-tile term on
chip; above it with n a power of two from 32, one fused launch with the
tile dots on int8 tensor cores and the ADC in registers; otherwise (n =
8 or 16 above M = 8, more than 128 K-tiles, the 2**22 guard) an
activation-quantizer launch, a tile-terms launch and a reduce launch
through an (T, M, N) f32 scratch array (the two-launch route).

``abfp_matmul(x, w, cfg, seed)`` is the same function on a float weight
(the ``abfp_kernel`` mode): it replaces the TPU kernel
``abfp_matmul_pallas``, which derives the bf16 max-abs weight scales and
codes in every grid step.  Its CUDA path quantizes W on the card, straight
into the packed kernel's ``kcodes`` layout, then runs the packed kernel's
launches on that scratch, so it equals ``abfp_matmul_packed`` on
``pack_abfp_weight(w)`` by construction.  Its plain version is that
composition.  ``abfp_matmul.launches`` counts its calls on the card.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.core.abfp import (
    PackedWeight,
    QuantConfig,
    ceil_to,
    f32_const,
    pack_abfp_weight,
    quant_levels,
)
from repro_torch.kernels import _build

Tensor = torch.Tensor

DEFAULT_BM = 128
DEFAULT_BN = 128


def auto_bm(m: int) -> int:
    """Reference row block: smallest multiple of 8 covering m, at most 128."""
    return min(DEFAULT_BM, max(8, ((m + 7) // 8) * 8))


def default_bk(n: int, k: int) -> int:
    """Reference K block: a multiple of the tile width n, capped at 512
    (256 for n <= 8).  Takes the logical K, not the padded Kp."""
    cap = 256 if n <= 8 else 512
    bk = min(cap, max(n, k))
    return max(n, (bk // n) * n)


# The plain version computes at most this many (tile, row, column) terms
# at once (a few GB of temporaries on the card at the LM head's width).
REF_TERM_ELEMENTS = 1 << 25

# The fused route's row blocks (the only ones the CUDA launch takes).  Every
# row block re-reads the weight's codes: a weight that stays in the H100's
# 50 MB L2 cache across row blocks takes the smallest block (the most blocks
# in flight); a larger one (the LM head) takes 32 rows, which halves its
# re-reads from device memory and was the fastest block from M = 32 up
# (``chip_smoke.py``'s route sweep).
FUSED_ROWS = (16, 32, 64)
FUSED_L2_RESIDENT_BYTES = 12 << 20
# The decode route's ``rows`` value (M <= 8 rows, one launch) and the
# two-launch route's.
DECODE_ROWS = 8
TWO_LAUNCH = 0
# The decode launch keeps the activation codes (M x Kp bytes), their scales
# and two rounds of per-tile terms in shared memory: at most the H100's
# 227 KB a block may take.
DECODE_MAX_SMEM = 227 * 1024

_M32 = 0xFFFFFFFF


def _mul32(x: Tensor, c: int) -> Tensor:
    """(x * c) mod 2**32 for int64 x in [0, 2**32) without int64 overflow."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _hash_uniform(rows: Tensor, cols: Tensor, seed, salt) -> Tensor:
    """Uniform [0, 1) lattice: hash(row, col, seed, salt), the reference's
    uint32 arithmetic done in int64 with explicit wrapping.  Arguments
    broadcast; returns float32."""
    seed = torch.as_tensor(seed, dtype=torch.int64) & _M32
    salt = torch.as_tensor(salt, dtype=torch.int64) & _M32
    x = (_mul32(rows.to(torch.int64), 0x9E3779B9)
         + _mul32(cols.to(torch.int64), 0x85EBCA6B)
         + _mul32(seed.to(rows.device), 0xC2B2AE35)
         + _mul32(salt.to(rows.device), 0x27D4EB2F)) & _M32
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    x = x ^ (x >> 16)
    return (x >> 8).to(torch.float32) / float(1 << 24)


def check_packed(pw: PackedWeight, cfg: QuantConfig) -> None:
    """Raise unless ``pw`` is a 2-D pack at this config's geometry."""
    if pw.codes.ndim != 2:
        raise ValueError(f"packed kernel takes a 2-D PackedWeight, got "
                         f"codes {tuple(pw.codes.shape)}")
    if pw.tile_width != cfg.tile_width or pw.bits_w != cfg.bits_w:
        raise ValueError(
            f"PackedWeight(n={pw.tile_width}, bits_w={pw.bits_w}) does not "
            f"match cfg(n={cfg.tile_width}, bits_w={cfg.bits_w})")
    if pw.scales.dtype != cfg.scale_dtype:
        raise ValueError(f"PackedWeight scales are {pw.scales.dtype} but "
                         f"cfg.scale_dtype is {cfg.scale_dtype}")


class Geometry(NamedTuple):
    """K-side shape of a weight as the kernels see it: logical K, K padded
    to whole tiles, and the tile count (a ``PackedWeight`` has the same
    three attributes)."""

    k: int
    kp: int
    num_tiles: int


class Grid:
    """The reference kernel's grid for an (M, K) x (K, N) call; ``pw`` is a
    ``PackedWeight`` or a ``Geometry``."""

    def __init__(self, m: int, pw, cfg: QuantConfig):
        n = cfg.tile_width
        self.n = n
        self.bm = auto_bm(m)
        self.bk = default_bk(n, pw.k)
        self.tk = self.bk // n
        self.nk = ceil_to(pw.kp, self.bk) // self.bk
        self.T = pw.num_tiles


def _seed_or_zero(seed, cfg: QuantConfig):
    """A call's seed for the plain versions: an int, or a one-element
    tensor (a seed-table slot) as a 0-d tensor, read where it lies."""
    if seed is None:
        if cfg.noise_lsb > 0.0:
            raise ValueError("noise_lsb > 0 requires a seed")
        return 0
    if isinstance(seed, Tensor):
        return seed.reshape(())
    return int(seed)


def seed_buffer(seeds, nseg: int, cfg: QuantConfig, dev) -> Optional[Tensor]:
    """The segments' noise seeds as the int32 device array the CUDA kernel
    reads (None without noise: the kernel then reads no seed).  ``seeds``
    is a tensor (a slice of a pass's seed table, used in place) or a
    sequence of ints, copied from pinned memory without a host sync; ints
    cannot be captured into a CUDA graph (the copy would replay stale host
    memory), so they raise there."""
    if cfg.noise_lsb <= 0.0:
        return None
    if isinstance(seeds, Tensor):
        t = seeds.reshape(-1)
        if t.dtype != torch.int32 or t.device != dev or t.numel() < nseg:
            raise ValueError(f"seeds: need {nseg} int32 values on {dev}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
        return t
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError("int seeds inside a CUDA graph capture: pass the "
                           "seeds as a device tensor (a seed table)")
    vals = torch.tensor([_seed_or_zero(v, cfg) for v in seeds],
                        dtype=torch.int32)
    return vals.pin_memory().to(dev, non_blocking=True)


def _tile_terms_ref(x2: Tensor, pw: PackedWeight, cfg: QuantConfig, seed: int,
                    grid: Grid, nj: int, row0: int = 0,
                    off: int = 0) -> Tensor:
    """(T, M, Np) f32 per-tile terms ``y_q * s_x * s_w [/ G_t]`` of the
    rows ``x2``, which start at row ``row0`` of the call (the noise
    lattice is a function of the call's row index); the weight's column
    blocks are blocks ``off ..`` of a grid of ``nj``."""
    dev = x2.device
    n, T = grid.n, grid.T
    m = x2.shape[0]
    npad = pw.n_padded

    def c32(v):
        return torch.tensor(f32_const(v), dtype=torch.float32, device=dev)

    xt = torch.nn.functional.pad(x2, (0, T * n - x2.shape[1])).reshape(m, T, n)
    sx = xt.abs().amax(dim=-1).to(cfg.scale_dtype).float()        # (M, T)
    sx_safe = torch.where(sx == 0.0, torch.ones_like(sx), sx)
    lx = float(2 ** (cfg.bits_x - 1) - 1)
    xq = torch.clamp(torch.round(xt / sx_safe[:, :, None] * c32(lx)), -lx, lx)
    wq = pw.codes.float().reshape(T, n, npad)
    p = torch.einsum("mtn,tnc->tmc", xq, wq)      # exact: |p| < 2**24
    g = None if pw.gains is None else pw.gains.float()[:, None, None]
    if g is None:
        v = p * c32(cfg.adc_code_scale)
    else:
        v = p * c32(cfg.adc_base_scale) * g
    if cfg.noise_lsb > 0.0:
        tau = torch.arange(T, device=dev)
        rows = torch.arange(row0, row0 + m, device=dev)
        cols = torch.arange(npad, device=dev)
        salt = ((rows // grid.bm)[None, :, None] * nj + off
                + (cols // DEFAULT_BN)[None, None, :]) * grid.nk \
            + (tau // grid.tk)[:, None, None]
        hrow = (tau % grid.tk)[:, None, None] * grid.bm \
            + (rows % grid.bm)[None, :, None]
        u = _hash_uniform(hrow, (cols % DEFAULT_BN)[None, None, :], seed, salt)
        v = v + (u - c32(0.5)) * c32(2.0 * cfg.noise_lsb)
    ly = float(2 ** (cfg.bits_y - 1) - 1)
    yq = torch.clamp(torch.round(v), -ly, ly) * c32(cfg.bin_y)
    term = yq * sx.t()[:, :, None] * pw.scales.float()[:, None, :]
    if g is not None:
        term = term / g
    return term


def _reduce_terms_ref(term: Tensor, pw: PackedWeight, cfg: QuantConfig,
                      grid: Grid) -> Tensor:
    """Sum per-tile terms in the reference order; (M, Np) bf16."""
    gain = torch.tensor(f32_const(cfg.gain), dtype=torch.float32,
                        device=term.device)
    acc = torch.zeros(term.shape[1:], dtype=torch.float32, device=term.device)
    for kb in range(grid.nk):
        t0 = kb * grid.tk
        bs = term[t0]
        for t in range(t0 + 1, min(t0 + grid.tk, grid.T)):
            bs = bs + term[t]
        if pw.gains is None:
            bs = bs / gain
        acc = acc + bs
    return acc.to(cfg.out_dtype)


def col_grid(n_padded: int, col_block_offset: int = 0,
             num_col_blocks: Optional[int] = None) -> Tuple[int, int]:
    """(global block count, first block) of a weight of ``n_padded``
    columns: its own grid, or a column shard's place in the whole
    weight's."""
    nj = n_padded // DEFAULT_BN
    nj_g = nj if num_col_blocks is None else int(num_col_blocks)
    off = int(col_block_offset)
    if off < 0 or off + nj > nj_g:
        raise ValueError(f"column blocks {off}..{off + nj} do not lie in a "
                         f"grid of {nj_g}")
    return nj_g, off


def abfp_matmul_packed_ref(x: Tensor, pw: PackedWeight, cfg: QuantConfig,
                           seed: Optional[int] = None, *,
                           col_block_offset: int = 0,
                           num_col_blocks: Optional[int] = None) -> Tensor:
    """Plain PyTorch version of the packed ABFP kernel; x: (..., K) ->
    (..., N) in ``cfg.out_dtype``.  ``col_block_offset`` /
    ``num_col_blocks``: a column shard's place in the whole weight's
    grid (see the module docstring)."""
    check_packed(pw, cfg)
    nj_g, off = col_grid(pw.n_padded, col_block_offset, num_col_blocks)
    if x.shape[-1] != pw.k:
        raise ValueError(f"x K dim {x.shape[-1]} != packed weight K {pw.k}")
    batch = x.shape[:-1]
    x2 = x.reshape(-1, pw.k).float()
    m = x2.shape[0]
    grid = Grid(m, pw, cfg)
    seed = _seed_or_zero(seed, cfg)
    # Row chunks bound the (T, rows, Np) term arrays; every step is per row,
    # so the chunking changes no bit.
    step = max(1, REF_TERM_ELEMENTS // (grid.T * pw.n_padded))
    outs = [_reduce_terms_ref(
        _tile_terms_ref(x2[r:r + step], pw, cfg, seed, grid, nj_g, r, off),
        pw, cfg, grid) for r in range(0, m, step)]
    out = torch.cat(outs) if len(outs) > 1 else outs[0]
    return out[:, :pw.n_cols].reshape(*batch, pw.n_cols)


# The fused block keeps s_x and s_w of every K-tile in shared memory.
FUSED_MAX_TILES = 128


def decode_smem_bytes(m: int, n: int, num_tiles: int) -> int:
    """Shared memory of one decode-route block (``DecodeSmem`` in
    ``csrc/abfp_matmul.cu``)."""
    kp = num_tiles * n
    sx = ceil_to(m * kp, 16)
    terms = ceil_to(sx + m * num_tiles * 4, 16)
    # Two rounds of terms (8 tiles x m rows x 32 columns, f32), then two
    # stages of each of 256 threads' code chunks (8 x 16 bytes), column
    # scales (8 bytes) and gain (4 bytes).
    return terms + 2 * 8 * m * 32 * 4 + 2 * 256 * (8 * 16 + 8 + 4)


def fused_rows(m: int, n: int, n_blocks: int, cfg: QuantConfig,
               num_tiles: int) -> int:
    """The route of an (M, K) x (K, n_blocks * 128) call with ``num_tiles``
    K-tiles of width n: ``DECODE_ROWS`` for the decode route, the fused
    launch's row block (``FUSED_ROWS``), or ``TWO_LAUNCH`` (0) for the
    tile-terms + reduce route.  Every call with M <= 8 (at every tile width)
    takes the decode route: one launch that streams the weight once, unless
    its activation codes overflow a block's shared memory (K above about
    17,500 at M = 8, 36,000 at M = 4).  Above M = 8 the fused route takes tiles that are
    whole 32-deep MMA steps (n a power of two from 32), at most
    FUSED_MAX_TILES K-tiles, and configurations whose tile dot and ADC level
    stay below 2**22 (the fused epilogue's exact conversions need that);
    the rest take the two-launch route."""
    if m <= DECODE_ROWS:
        fits = decode_smem_bytes(m, n, num_tiles) <= DECODE_MAX_SMEM
        return DECODE_ROWS if fits else TWO_LAUNCH
    lx = 2 ** (cfg.bits_x - 1) - 1
    ly = 2 ** (cfg.bits_y - 1) - 1
    if n < 32 or n & (n - 1) or num_tiles > FUSED_MAX_TILES \
            or n * lx * 127 >= 1 << 22 or ly >= 1 << 22:
        return TWO_LAUNCH
    resident = num_tiles * n * n_blocks * DEFAULT_BN <= FUSED_L2_RESIDENT_BYTES
    rows = 16 if resident else 32
    assert rows in FUSED_ROWS
    return rows


def _seeds(seed, cfg: QuantConfig):
    """One call's seed as ``launch_segments`` takes it."""
    if isinstance(seed, Tensor):
        return seed
    return [_seed_or_zero(seed, cfg)]


def launch_segments(x: Tensor, kcodes: Tensor, scales: Tensor,
                    gains: Optional[Tensor], pw0, cfg: QuantConfig,
                    njs: Sequence[int], grids: Sequence[Tuple[int, int]],
                    seeds: Sequence[int], rows: Optional[int] = None
                    ) -> Tensor:
    """One launch of ``csrc/abfp_matmul.cu`` over up to three weights whose
    column blocks are concatenated (``njs`` blocks each); ``pw0`` (a
    ``PackedWeight`` or ``Geometry``) gives their shared K side.  Returns
    the (M, sum(njs) * 128) bf16 output.  ``grids`` gives each segment's
    (global block count, first block) (``col_grid``).  ``rows`` overrides
    the route (``fused_rows``): 0
    for the two-launch route, 8 for the decode route (M <= 8), 16/32/64
    for the fused one; only the A/B entries pass it."""
    if not x.is_cuda:
        raise ValueError("the CUDA kernel takes CUDA tensors")
    if cfg.out_dtype != torch.bfloat16 or cfg.scale_dtype != torch.bfloat16:
        raise ValueError("the CUDA kernel writes bf16 and reads bf16 scales")
    if kcodes is None:
        raise ValueError("PackedWeight has no kernel-layout codes (kcodes)")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"x must be float32 or bfloat16, got {x.dtype}")
    dev = x.device
    for t in (kcodes, scales) + (() if gains is None else (gains,)):
        if t.device != dev or not t.is_contiguous():
            raise ValueError("kernel operands must be contiguous on x's device")
    x2 = x.reshape(-1, pw0.k).contiguous()
    m = x2.shape[0]
    grid = Grid(m, pw0, cfg)
    n, T = grid.n, grid.T
    ntot = kcodes.shape[1]
    nseg = len(njs)
    starts = [0, njs[0], njs[0] + (njs[1] if nseg > 1 else 0)]
    grids = list(grids) + [(0, 0)] * (3 - nseg)
    sd = seed_buffer(seeds, nseg, cfg, dev)
    if rows is None:
        rows = fused_rows(m, n, ntot // DEFAULT_BN, cfg, T)
    if rows and (kcodes.data_ptr() % 16 or scales.data_ptr() % 16):
        raise ValueError("the fused and decode routes need 16-byte aligned "
                         "kcodes and scales")
    # The decode route quantizes x on chip and keeps its terms there; the
    # fused route stages whole row blocks: rows past M are scratch.
    xq = sx = terms = None
    if rows != DECODE_ROWS:
        xq = torch.empty((ceil_to(m, rows) if rows else m, pw0.kp),
                         dtype=torch.int8, device=dev)
        sx = torch.empty((m, T), dtype=torch.float32, device=dev)
    if rows == TWO_LAUNCH:
        terms = torch.empty((T, m, ntot), dtype=torch.float32, device=dev)
    out = torch.empty((m, ntot), dtype=torch.bfloat16, device=dev)
    has_g = gains is not None
    err = _build.lib("abfp_matmul").abfp_matmul_packed_launch(
        x2.data_ptr(), int(x2.dtype == torch.bfloat16), m, pw0.k,
        kcodes.data_ptr(), scales.data_ptr(),
        gains.data_ptr() if has_g else None, pw0.kp, T, n, ntot,
        nseg, starts[1], starts[2], *(g for g, _ in grids),
        *(off for _, off in grids),
        None if sd is None else sd.data_ptr(), grid.bm, grid.tk, grid.nk,
        f32_const(cfg.adc_base_scale if has_g else cfg.adc_code_scale),
        f32_const(2.0 * cfg.noise_lsb), int(cfg.noise_lsb > 0.0),
        float(2 ** (cfg.bits_y - 1) - 1), f32_const(cfg.bin_y),
        f32_const(cfg.gain), float(2 ** (cfg.bits_x - 1) - 1), rows,
        *(None if t is None else t.data_ptr() for t in (xq, sx, terms)),
        out.data_ptr(),
        _build.stream_ptr(dev))
    _build.check(err, "abfp_matmul_packed_launch")
    return out


def abfp_matmul_packed(x: Tensor, pw: PackedWeight, cfg: QuantConfig,
                       seed: Optional[int] = None, *,
                       col_block_offset: int = 0,
                       num_col_blocks: Optional[int] = None) -> Tensor:
    """y = ABFP(x @ W) from a packed weight; x: (..., K) -> (..., N) bf16.
    ``col_block_offset`` / ``num_col_blocks``: a column shard's place in
    the whole weight's grid (see the module docstring).

    CPU tensors run ``abfp_matmul_packed_ref``; CUDA tensors launch the
    CUDA kernel (and count one launch) or raise."""
    if not x.is_cuda:
        return abfp_matmul_packed_ref(x, pw, cfg, seed,
                                      col_block_offset=col_block_offset,
                                      num_col_blocks=num_col_blocks)
    return _abfp_matmul_packed(x, pw, cfg, seed, None, col_block_offset,
                               num_col_blocks)


def _abfp_matmul_packed(x: Tensor, pw: PackedWeight, cfg: QuantConfig,
                        seed: Optional[int], rows: Optional[int],
                        col_block_offset: int = 0,
                        num_col_blocks: Optional[int] = None) -> Tensor:
    """The CUDA path of ``abfp_matmul_packed``; ``rows`` forces a route
    (an A/B entry for the card tests and ``chip_smoke.py``'s timing; no
    model path passes it)."""
    check_packed(pw, cfg)
    if x.shape[-1] != pw.k:
        raise ValueError(f"x K dim {x.shape[-1]} != packed weight K {pw.k}")
    gains = None if pw.gains is None else pw.gains.float().contiguous()
    out = launch_segments(x, pw.kcodes, pw.scales, gains, pw, cfg,
                          [pw.n_padded // DEFAULT_BN],
                          [col_grid(pw.n_padded, col_block_offset,
                                    num_col_blocks)], _seeds(seed, cfg), rows)
    abfp_matmul_packed.launches += 1
    return out[:, :pw.n_cols].reshape(*x.shape[:-1], pw.n_cols)


abfp_matmul_packed.launches = 0


# ---------------------------------------------------------------------------
# Unpacked ABFP matmul (the abfp_kernel mode): weight quantized per call
# ---------------------------------------------------------------------------


def check_unpacked(w: Tensor, cfg: QuantConfig) -> None:
    """Raise unless ``w`` is a 2-D float weight this config can quantize
    to int8 codes with max-abs scales."""
    if w.ndim != 2:
        raise ValueError(f"abfp_matmul takes a 2-D weight, got {tuple(w.shape)}")
    if quant_levels(cfg.bits_w) > 127:
        raise ValueError(f"bits_w={cfg.bits_w} does not fit int8 codes")
    if cfg.scale_percentile is not None:
        raise ValueError("abfp_matmul supports max-abs scales only")


def abfp_matmul_ref(x: Tensor, w: Tensor, cfg: QuantConfig,
                    seed: Optional[int] = None, *, col_block_offset: int = 0,
                    num_col_blocks: Optional[int] = None) -> Tensor:
    """Plain version of the unpacked ABFP kernel: pack ``w`` and run the
    packed plain version (the reference holds packed and unpacked
    bit-identical).  x: (..., K), w: (K, N) -> (..., N) in
    ``cfg.out_dtype``."""
    check_unpacked(w, cfg)
    return abfp_matmul_packed_ref(x, pack_abfp_weight(w, cfg), cfg, seed,
                                  col_block_offset=col_block_offset,
                                  num_col_blocks=num_col_blocks)


def abfp_matmul(x: Tensor, w: Tensor, cfg: QuantConfig,
                seed: Optional[int] = None, *, col_block_offset: int = 0,
                num_col_blocks: Optional[int] = None) -> Tensor:
    """y = ABFP(x @ W) on a float weight; x: (..., K) -> (..., N) bf16.
    ``col_block_offset`` / ``num_col_blocks`` as in
    ``abfp_matmul_packed``: the weight scales are per column, so a column
    shard's quantized weight is the matching slice of the whole one's.

    CPU tensors run ``abfp_matmul_ref``.  CUDA tensors quantize ``w`` on
    the card (``abfp_quantize_w_launch``: bf16 max-abs scales per (K-tile,
    column), round-half-even int8 codes in the ``kcodes`` layout), then
    run the packed kernel's launches on that scratch without gains (the
    scalar ``cfg.gain``); one count per call, or raise."""
    if not x.is_cuda:
        return abfp_matmul_ref(x, w, cfg, seed,
                               col_block_offset=col_block_offset,
                               num_col_blocks=num_col_blocks)
    return _abfp_matmul(x, w, cfg, seed, None, col_block_offset,
                        num_col_blocks)


def quantize_weight(w: Tensor, cfg: QuantConfig):
    """Quantize a float CUDA weight on the card (``abfp_quantize_w_launch``)
    into the packed kernel's layout: returns (geometry, int32 kcodes
    (Kp/4, Np), bf16 scales (T, Np)), byte-equal to ``pack_abfp_weight``'s
    ``kcodes`` and ``scales``.  Part of ``abfp_matmul``'s CUDA path."""
    check_unpacked(w, cfg)
    if w.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"w must be float32 or bfloat16, got {w.dtype}")
    k, n_cols = w.shape
    n = cfg.tile_width
    if n % 4:
        raise ValueError(f"the CUDA kernel needs tile_width % 4 == 0, got {n}")
    geo = Geometry(k, ceil_to(k, n), ceil_to(k, n) // n)
    npad = ceil_to(n_cols, DEFAULT_BN)
    w = w.contiguous()
    kcodes = torch.empty((geo.kp // 4, npad), dtype=torch.int32,
                         device=w.device)
    scales = torch.empty((geo.num_tiles, npad), dtype=torch.bfloat16,
                         device=w.device)
    err = _build.lib("abfp_matmul").abfp_quantize_w_launch(
        w.data_ptr(), int(w.dtype == torch.bfloat16), k, n_cols, npad,
        geo.num_tiles, n, float(quant_levels(cfg.bits_w)), kcodes.data_ptr(),
        scales.data_ptr(), _build.stream_ptr(w.device))
    _build.check(err, "abfp_quantize_w_launch")
    return geo, kcodes, scales


def _abfp_matmul(x: Tensor, w: Tensor, cfg: QuantConfig,
                 seed: Optional[int], rows: Optional[int],
                 col_block_offset: int = 0,
                 num_col_blocks: Optional[int] = None) -> Tensor:
    """The CUDA path of ``abfp_matmul``; ``rows`` forces a route (an A/B
    entry for the card tests and ``chip_smoke.py``'s timing; no model path
    passes it)."""
    check_unpacked(w, cfg)
    k, n_cols = w.shape
    if x.shape[-1] != k:
        raise ValueError(f"x K dim {x.shape[-1]} != weight K {k}")
    if w.device != x.device:
        raise ValueError(f"w is on {w.device}, x on {x.device}")
    geo, kcodes, scales = quantize_weight(w, cfg)
    out = launch_segments(x, kcodes, scales, None, geo, cfg,
                          [kcodes.shape[1] // DEFAULT_BN],
                          [col_grid(kcodes.shape[1], col_block_offset,
                                    num_col_blocks)], _seeds(seed, cfg), rows)
    abfp_matmul.launches += 1
    return out[:, :n_cols].reshape(*x.shape[:-1], n_cols)


abfp_matmul.launches = 0
