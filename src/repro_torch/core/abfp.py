"""Adaptive Block Floating-Point (ABFP) numerics: the quantize-once subset.

The serving path of the port needs the paper's weight side only: the
static ``QuantConfig`` of the simulated AMS device, the max-abs tile scales
rounded to bf16, the round-half-even integer encoding (Eq. 1-2), and the
per-tile adaptive ADC gains (Eq. 5-6).  ``pack_abfp_weight`` runs them once
per weight; the kernels in ``repro_torch.kernels`` stream the result.

Every step keeps the JAX package's float32 operation order, so packed
codes, bf16 scale bits and gains are byte-equal to the reference for the
same weight.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# Configuration
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """Static configuration of the simulated AMS device.

    ``mode`` selects the execution path used by ``repro_torch.kernels.ops``:

      * ``"float"``       — plain matmul in the operand dtype (no ABFP)
      * ``"abfp_kernel"`` — the unpacked ABFP kernel: the weight is
        quantized inside every call (the cacheless evaluation forward)
      * ``"abfp_packed"`` — packed ABFP kernel over pre-quantized weights
      * ``"abfp_fused"``  — the packed path plus per-tile adaptive ADC gains
        baked into the packed weights and, on single-token decode ticks,
        the fused QKV and int8-KV decode-attention kernels.
    """

    tile_width: int = 128          # n — vector length sharing one scale
    bits_w: int = 8                # b_W
    bits_x: int = 8                # b_X
    bits_y: int = 8                # b_Y (ADC output bits)
    gain: float = 1.0              # G >= 1, powers of two in the paper
    noise_lsb: float = 0.0         # ADC noise half-width in output LSBs
    mode: str = "abfp_packed"
    scale_dtype: Any = torch.bfloat16
    out_dtype: Any = torch.bfloat16
    accum_dtype: Any = torch.float32
    quantize_attention: bool = False
    scale_percentile: Optional[float] = None

    def replace(self, **kw) -> "QuantConfig":
        """Return a copy with the given fields replaced."""
        return dataclasses.replace(self, **kw)

    @property
    def delta_w(self) -> float:
        """Weight quantization bin size, delta(bits_w)."""
        return quant_delta(self.bits_w)

    @property
    def delta_x(self) -> float:
        """Activation quantization bin size, delta(bits_x)."""
        return quant_delta(self.bits_x)

    @property
    def delta_y(self) -> float:
        """ADC output quantization bin size, delta(bits_y)."""
        return quant_delta(self.bits_y)

    @property
    def adc_code_scale(self) -> float:
        """G * d_X * d_W / (n * d_Y), computed in float64: every
        implementation multiplies by the same f32 constant, so ADC
        round-half-even ties resolve identically."""
        return float(
            self.gain * self.delta_x * self.delta_w
            / (self.tile_width * self.delta_y)
        )

    @property
    def adc_base_scale(self) -> float:
        """``adc_code_scale`` at G = 1, for the per-tile-gain path."""
        return float(
            self.delta_x * self.delta_w / (self.tile_width * self.delta_y)
        )

    @property
    def bin_y(self) -> float:
        """ADC output bin (one LSB): n * delta_y."""
        return float(self.tile_width * self.delta_y)


def quant_delta(bits: int) -> float:
    """delta_b = 1 / (2**(b-1) - 1): bin size of symmetric signed quantization."""
    return 1.0 / (2 ** (bits - 1) - 1)


def quant_levels(bits: int) -> int:
    """L_b = 2**(b-1) - 1: largest integer code (symmetric signed)."""
    return 2 ** (bits - 1) - 1


def tile_scales(v_tiles: Tensor, scale_dtype=torch.bfloat16) -> Tensor:
    """max|v| over the last axis, rounded to ``scale_dtype``, returned in f32."""
    s = v_tiles.float().abs().amax(dim=-1)
    return s.to(scale_dtype).float()


def safe_scale(s: Tensor) -> Tensor:
    """Replace zero scales with 1.0 so all-zero tiles divide to exact 0."""
    return torch.where(s == 0.0, torch.ones_like(s), s)


def pad_to_tiles(v: Tensor, n: int, axis: int) -> Tensor:
    """Zero-pad ``axis`` of v up to a multiple of the tile width n."""
    axis = axis % v.ndim
    rem = (-v.shape[axis]) % n
    if rem == 0:
        return v
    pad = [0, 0] * (v.ndim - axis - 1) + [0, rem]
    return torch.nn.functional.pad(v, pad)


def encode_codes(v_hat: Tensor, bits: int) -> Tensor:
    """Normalized values -> integer codes in [-L, L] (f32 storage):
    round-half-even of ``v_hat * L``, the DAC encoding of Eq. 2."""
    lvl = float(quant_levels(bits))
    return torch.clamp(torch.round(v_hat * lvl), -lvl, lvl)


# ---------------------------------------------------------------------------
# Packed weights
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PackedWeight:
    """Pre-quantized ABFP weight: quantize once, serve forever.

      codes : int8  (Kp, Np)  integer codes; row ``t*n + i`` is element i of
                              K-tile t.  K is zero-padded to whole tiles and
                              N to the 128-column boundary.
      scales: bf16  (T, Np)   per-(tile, out-column) max-abs scales
      gains : f32   (T,) or None — per-tile ADC gains (``abfp_fused``)
      kcodes: int32 (Kp/4, Np) or None — the same codes in the CUDA kernel's
                              layout: word (q, c) packs codes rows 4q..4q+3
                              of column c, one byte each (little end first),
                              so a warp reads 128 contiguous bytes per
                              four K rows and feeds ``__dp4a`` directly.
                              Made once at pack time; ``codes`` stays the
                              canonical form the tests compare.

    ``k`` / ``n_cols`` are the logical (un-padded) K and N; ``tile_width``
    and ``bits_w`` the geometry the codes were packed for.  The represented
    value lattice is ``codes * delta_w * scales``.
    """

    codes: Tensor
    scales: Tensor
    k: int
    n_cols: int
    tile_width: int
    bits_w: int
    gains: Optional[Tensor] = None
    kcodes: Optional[Tensor] = None

    @property
    def kp(self) -> int:
        """K padded up to whole tiles (the codes' row count)."""
        return self.codes.shape[-2]

    @property
    def n_padded(self) -> int:
        """N padded up to whole 128-column blocks."""
        return self.codes.shape[-1]

    @property
    def num_tiles(self) -> int:
        """Number of K-tiles, T = Kp / tile_width."""
        return self.scales.shape[-2]

    def nbytes(self) -> int:
        """Device bytes of the canonical packed form (codes, scales, gains).
        The kernel-layout copy ``kcodes`` adds ``codes``' size again."""
        total = self.codes.numel() * self.codes.element_size() \
            + self.scales.numel() * self.scales.element_size()
        if self.gains is not None:
            total += self.gains.numel() * self.gains.element_size()
        return total


_LANE = 128  # packed N is padded to whole 128-column blocks at pack time


def kernel_layout(codes: Tensor) -> Tensor:
    """(Kp, Np) int8 codes -> (Kp/4, Np) int32 words of four K rows each."""
    kp, npad = codes.shape
    if kp % 4:
        raise ValueError(f"kernel layout needs Kp % 4 == 0, got Kp={kp}")
    return (codes.reshape(kp // 4, 4, npad).permute(0, 2, 1).contiguous()
            .view(torch.int32).reshape(kp // 4, npad))


def pack_abfp_weight(w: Tensor, cfg: QuantConfig,
                     adaptive_gain: bool = False) -> PackedWeight:
    """Quantize a (K, N) weight to ABFP once, for the packed serving path.

    Same bf16-rounded max-abs tile scales and round-half-even int8 codes as
    the JAX package; N is zero-padded to the 128-column boundary here, once.
    ``adaptive_gain=True`` (the ``abfp_fused`` packing) also derives the
    per-tile ADC gains from the codes (``adaptive_tile_gains``).
    """
    if quant_levels(cfg.bits_w) > 127:
        raise ValueError(
            f"pack_abfp_weight stores int8 codes; bits_w={cfg.bits_w} "
            f"(L_w={quant_levels(cfg.bits_w)}) does not fit")
    if cfg.scale_percentile is not None:
        raise ValueError("pack_abfp_weight supports max-abs scales only")
    if w.ndim != 2:
        raise ValueError(f"pack_abfp_weight takes a 2-D weight, got {tuple(w.shape)}")
    n = cfg.tile_width
    k, n_cols = w.shape
    w = pad_to_tiles(w.float(), n, axis=0)
    w = pad_to_tiles(w, _LANE, axis=1)
    kp, npad = w.shape
    t = kp // n
    wt = w.reshape(t, n, npad)                              # (T, n, Np)
    s_w = tile_scales(wt.transpose(1, 2), cfg.scale_dtype)  # (T, Np)
    w_hat = wt / safe_scale(s_w)[:, None, :]
    codes = encode_codes(w_hat, cfg.bits_w).to(torch.int8).reshape(kp, npad)
    pw = PackedWeight(
        codes=codes, scales=s_w.to(cfg.scale_dtype),
        k=k, n_cols=n_cols, tile_width=n, bits_w=cfg.bits_w,
        kcodes=kernel_layout(codes) if kp % 4 == 0 else None,
    )
    if adaptive_gain:
        pw = dataclasses.replace(pw, gains=adaptive_tile_gains(pw, cfg))
    return pw


def adaptive_tile_gains(pw: PackedWeight, cfg: QuantConfig) -> Tensor:
    """Per-tile power-of-two ADC gains in [1, cfg.gain] — (T,) f32.

    The headroom of tile t is ``n / (4 * sqrt(n) * rms(w_hat_t))`` (a
    4-sigma central-limit bound on the normalized tile dot, RMS over the
    tile's real columns); the gain is the largest power of two below both
    that headroom and the ``cfg.gain`` budget.
    """
    lvl_w = float(quant_levels(cfg.bits_w))
    n = pw.tile_width
    f32 = dict(dtype=torch.float32, device=pw.codes.device)
    w_hat = pw.codes.float().reshape(pw.num_tiles, n, pw.n_padded) / lvl_w
    w_real = w_hat[..., :pw.n_cols]
    rms = torch.sqrt(torch.mean(w_real * w_real, dim=(-2, -1)))    # (T,)
    c = torch.tensor(4.0, **f32) * torch.sqrt(torch.tensor(float(n), **f32))
    expected = c * torch.clamp(rms, min=1e-6) / torch.tensor(float(n), **f32)
    headroom = torch.tensor(1.0, **f32) / expected
    g = torch.exp2(torch.floor(torch.log2(
        torch.clamp(headroom, 1.0, float(cfg.gain)))))
    return g.float()


def dequantize_packed(pw: PackedWeight) -> Tensor:
    """Packed codes + scales -> the quantized-value lattice, (k, N) f32."""
    n = pw.tile_width
    ct = pw.codes.float().reshape(pw.num_tiles, n, pw.n_padded)
    s = pw.scales.float()[:, None, :]                        # (T, 1, Np)
    d = torch.tensor(quant_delta(pw.bits_w), dtype=torch.float32,
                     device=ct.device)
    w = (ct * d * s).reshape(pw.kp, pw.n_padded)
    return w[:pw.k, :pw.n_cols]


def f32_const(v: float) -> float:
    """``v`` rounded to the nearest float32, as a Python float."""
    return float(torch.tensor(v, dtype=torch.float32))


def ceil_to(v: int, m: int) -> int:
    """Round ``v`` up to a multiple of ``m``."""
    return ((v + m - 1) // m) * m
