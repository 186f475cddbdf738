"""Adaptive Block Floating-Point (ABFP) numerics, the paper's core.

  * the symmetric round-half-even quantizer Q(v; delta, tau)        (Eq. 1)
  * per-tile adaptive scales s = max|v| (or a |v| percentile) stored in
    bf16                                                           (Sec. III-A)
  * the tiled ABFP matmul ``abfp_matmul`` (the ``abfp_ref`` mode): per
    K-tile an exact integer tile dot, the ADC with gain and additive
    uniform noise, and the f32 accumulation                        (Eq. 2-7)
  * the straight-through estimator for QAT (``abfp_matmul_ste``,
    ``quantize_ste``)                                              (Eq. 8)
  * the quantize-once packing of the serving path
    (``pack_abfp_weight``, per-tile adaptive ADC gains)

Every step keeps the JAX package's float32 operation order, so packed
codes, bf16 scale bits and gains are byte-equal to the reference for the
same weight, and the ADC noise of ``abfp_matmul`` is JAX's
``jax.random.uniform`` draw bit for bit (``core.prng``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core import prng

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# Configuration
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """Static configuration of the simulated AMS device.

    ``mode`` selects the execution path used by ``repro_torch.kernels.ops``:

      * ``"float"``       — plain matmul in the operand dtype (no ABFP)
      * ``"abfp_ref"``    — the tile scan ``abfp_matmul`` (plain PyTorch,
        noise drawn from the call's PRNG key): the QAT forward
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
    mode: str = "abfp_ref"
    scale_dtype: Any = torch.bfloat16
    out_dtype: Any = torch.bfloat16
    accum_dtype: Any = torch.float32
    quantize_attention: bool = False
    # A |v| percentile in place of max|v| for the adaptive scale (paper
    # Sec. VI future work); the abfp_ref path only.  None: max-abs.
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


FLOAT = QuantConfig(mode="float")


def quant_delta(bits: int) -> float:
    """delta_b = 1 / (2**(b-1) - 1): bin size of symmetric signed quantization."""
    return 1.0 / (2 ** (bits - 1) - 1)


def quant_levels(bits: int) -> int:
    """L_b = 2**(b-1) - 1: largest integer code (symmetric signed)."""
    return 2 ** (bits - 1) - 1


def quantize(v: Tensor, delta, tau) -> Tensor:
    """Q(v; delta, tau) = clamp(round_half_even(v / delta) * delta; +-tau)."""
    return torch.clamp(torch.round(v / delta) * delta, -tau, tau)


def _percentile(a: Tensor, percentile: float) -> Tensor:
    """``jnp.percentile(a, percentile, axis=-1)`` (linear interpolation)
    in its f32 order: q = p / 100 * (n - 1), the values at floor(q) and
    ceil(q) weighted by 1 - frac and frac."""
    n = a.shape[-1]
    srt = torch.sort(a, dim=-1).values
    q = torch.tensor(percentile, dtype=torch.float32) / 100.0
    q = q * float(n - 1)
    low, high = torch.floor(q), torch.ceil(q)
    hw = q - low
    lw = 1.0 - hw
    lo_i = int(min(max(float(low), 0.0), n - 1))
    hi_i = int(min(max(float(high), 0.0), n - 1))
    return (srt[..., lo_i] * lw.to(a.device)
            + srt[..., hi_i] * hw.to(a.device))


def tile_scales(v_tiles: Tensor, scale_dtype=torch.bfloat16,
                percentile: Optional[float] = None) -> Tensor:
    """max|v| (or the ``percentile``-th percentile of |v|) over the last
    axis, rounded to ``scale_dtype``, returned in f32."""
    a = v_tiles.float().abs()
    if percentile is None or percentile >= 100.0:
        s = a.amax(dim=-1)
    else:
        s = _percentile(a, percentile)
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


def scale_storage_eps(scale_dtype=torch.bfloat16) -> float:
    """Relative quantum of the scale storage dtype (bf16: 2^-8, about
    0.39 %): a smaller relative change of a stored tile scale is storage
    noise, a few multiples of it a real change of the programmed array.
    Fault detection (``serving.faults``) derives its drift tolerance from
    it."""
    return float(torch.finfo(scale_dtype).eps) / 2.0


def packed_tile_fingerprint(pw: PackedWeight) -> Tensor:
    """Per-(tile, col) probe response ``R[t, j] = (sum_i |codes[t, i, j]|)
    * delta_w * scales[t, j]`` — (T, Np) f32.

    The digital analogue of a calibration-ramp readout: drive every row of
    tile ``t`` with a full-scale input and read column ``j``'s magnitude.
    The |code| sum is exact (int32, |sum| <= n * L_w < 2^24, so exact in
    f32 too); the two products keep the JAX package's f32 order.  A healthy
    array reads the same fingerprint every time, a drifted scale moves R by
    the drift factor and a dead column reads 0.  The reduction runs on the
    int8 codes, so no f32 copy of the weight is made."""
    n = pw.tile_width
    code_sum = torch.sum(
        pw.codes.view(pw.num_tiles, n, pw.n_padded).abs(), dim=1,
        dtype=torch.int32).float()                          # (T, Np)
    d = torch.tensor(quant_delta(pw.bits_w), dtype=torch.float32,
                     device=code_sum.device)
    return code_sum * d * pw.scales.float()


def packed_output_error_bound(pw: PackedWeight, cfg: QuantConfig) -> Tensor:
    """Worst-case |y[j]| bound per output column for unit-scale inputs,
    (Np,) f32.

    Per tile the exact partial product obeys ``|p| * d_X * d_W <= d_W *
    sum_i |codes[t, i, j]|`` when every ``|x_hat_i| <= 1``: the fingerprint
    is the largest response an admissible input can draw; ADC rounding and
    LSB noise add at most ``(0.5 + noise_lsb) * bin_y / G`` per tile (the
    per-tile gain where the pack has gains).  Summed over tiles this is a
    sound envelope: a reading above it is corruption (a dead column, the
    converse, is caught by the fingerprint's zero test)."""
    fp = packed_tile_fingerprint(pw)                        # (T, Np)
    s = pw.scales.float()
    f32 = dict(dtype=torch.float32, device=fp.device)
    c = torch.tensor((0.5 + cfg.noise_lsb) * cfg.bin_y, **f32)
    if pw.gains is not None:
        adc_err = (c / pw.gains.float())[:, None]
    else:
        adc_err = torch.tensor(
            (0.5 + cfg.noise_lsb) * cfg.bin_y / cfg.gain, **f32)
    return (fp + s * adc_err).sum(dim=-2)


def f32_const(v: float) -> float:
    """``v`` rounded to the nearest float32, as a Python float."""
    return float(torch.tensor(v, dtype=torch.float32))


def ceil_to(v: int, m: int) -> int:
    """Round ``v`` up to a multiple of ``m``."""
    return ((v + m - 1) // m) * m


# ---------------------------------------------------------------------------
# Eq. 2-7: the tiled ABFP matmul (the abfp_ref mode)
# ---------------------------------------------------------------------------


def ams_noise(key, shape, cfg: QuantConfig, device=None) -> Tensor:
    """Additive uniform ADC noise E ~ U(-w, +w), w = noise_lsb * (n *
    delta_y), drawn as ``jax.random.uniform(key, shape)`` (Eq. 7)."""
    half_width = cfg.noise_lsb * cfg.tile_width * cfg.delta_y
    return prng.uniform(key, shape, -half_width, half_width, device)


def quantize_weight_tiles(w: Tensor, cfg: QuantConfig):
    """(K, N) weight -> (w_q (T, n, N) integer codes in f32, s_w (T, N)
    per-(tile, output) scales, bf16-rounded, in f32)."""
    n = cfg.tile_width
    w = pad_to_tiles(w.float(), n, axis=0)
    wt = w.reshape(w.shape[0] // n, n, w.shape[1])          # (T, n, N)
    s_w = tile_scales(wt.transpose(1, 2), cfg.scale_dtype,
                      cfg.scale_percentile)                 # (T, N)
    return encode_codes(wt / safe_scale(s_w)[:, None, :], cfg.bits_w), s_w


def quantize_input_tiles(x: Tensor, cfg: QuantConfig):
    """(..., K) activations -> (x_q (..., T, n) integer codes in f32, s_x
    (..., T) per-(sample, tile) scales)."""
    n = cfg.tile_width
    x = pad_to_tiles(x.float(), n, axis=-1)
    xt = x.reshape(*x.shape[:-1], x.shape[-1] // n, n)     # (..., T, n)
    s_x = tile_scales(xt, cfg.scale_dtype, cfg.scale_percentile)
    return encode_codes(xt / safe_scale(s_x)[..., None], cfg.bits_x), s_x


def adc(p_codes: Tensor, cfg: QuantConfig, noise_lsb_draw=None,
        tile_gain=None) -> Tensor:
    """Eq. 5/7 in code units: clamp(round(p * G d_X d_W / (n d_Y) + E),
    +-L_y) for an exact integer partial product p.  ``tile_gain`` replaces
    the scalar gain by a per-tile G_t: ``p * adc_base_scale * G_t``."""
    if tile_gain is None:
        v = p_codes * f32_const(cfg.adc_code_scale)
    else:
        v = p_codes * f32_const(cfg.adc_base_scale) * tile_gain
    if noise_lsb_draw is not None:
        v = v + noise_lsb_draw
    lvl = float(quant_levels(cfg.bits_y))
    return torch.clamp(torch.round(v), -lvl, lvl)


# (tile, row, column) terms that ``abfp_matmul`` evaluates at once: the
# scan's tiles go in groups of this many elements (the LM head's 512 x
# 49,152 outputs take one tile per group).
REF_GROUP_ELEMENTS = 1 << 25


def _is_key(key) -> bool:
    """A host key (2,) or a device key slot ((2,) int64 tensor)."""
    if isinstance(key, torch.Tensor):
        return key.dtype == torch.int64 and tuple(key.shape) == (2,)
    return not isinstance(key, int) and np.shape(key) == (2,)


def abfp_matmul(x: Tensor, w: Tensor, cfg: QuantConfig, key=None,
                tile_gains: Optional[Tensor] = None) -> Tensor:
    """y = ABFP(x @ w), x: (..., K), w: (K, N) -> (..., N) in
    ``cfg.out_dtype``: the ``abfp_ref`` mode, JAX's tile scan.

    Per K-tile t, in order (Eq. 6-7):

        y_q[t] = clamp(round(G (x_q[t] . w_q[t]) * scale + E_t)) * bin_y
        acc   += y_q[t] * (s_x[t] * s_w[t]) / G

    with the noise E_t = ``uniform(split(key, T)[t], (M, N), -noise_lsb,
    noise_lsb)``, JAX's draw bit for bit.  ``tile_gains`` (T,) swaps G for
    a per-tile G_t.  Tiles run in groups (one batched tile dot, one noise
    draw and the ADC per group) and accumulate one at a time, which gives
    the scan's values.  ``key`` is a host PRNG key, or a device key slot:
    a (2,) int64 tensor of uint32 words (a row of a pass's key table),
    split and drawn from on its device with no host copy; required when
    ``noise_lsb > 0``."""
    noisy = cfg.noise_lsb > 0.0
    if key is None and noisy:
        raise ValueError("noise_lsb > 0 requires a PRNG key")
    if key is not None and not _is_key(key):
        raise ValueError(
            "abfp_ref splits the call's PRNG key per tile: pass a key "
            "(core.prng) or a key-table row, not an int seed or a "
            "seed-table slot")
    batch = x.shape[:-1]
    n_out = w.shape[1]
    x2 = x.reshape(-1, x.shape[-1])
    m = x2.shape[0]
    x_q, s_x = quantize_input_tiles(x2, cfg)                # (M, T, n)
    w_q, s_w = quantize_weight_tiles(w, cfg)                # (T, n, N)
    t = w_q.shape[0]
    keys = prng.split(key, t) if noisy else None
    xq_t = x_q.transpose(0, 1)                              # (T, M, n)
    sx_t = s_x.t()                                          # (T, M)
    bin_y = f32_const(cfg.bin_y)
    gain = f32_const(cfg.gain)
    acc = torch.zeros((m, n_out), dtype=cfg.accum_dtype, device=x.device)
    group = max(1, REF_GROUP_ELEMENTS // max(1, m * n_out))
    for g0 in range(0, t, group):
        sl = slice(g0, min(t, g0 + group))
        p = torch.bmm(xq_t[sl], w_q[sl])            # exact integer dots
        e = (prng.uniform(keys[sl], (m, n_out), -cfg.noise_lsb,
                          cfg.noise_lsb, x.device) if noisy else None)
        s = sx_t[sl][:, :, None] * s_w[sl][:, None, :]
        if tile_gains is None:
            term = adc(p, cfg, e) * bin_y * s / gain
        else:
            g_t = tile_gains[sl].float()[:, None, None]
            term = adc(p, cfg, e, tile_gain=g_t) * bin_y * s / g_t
        for i in range(term.shape[0]):
            acc = acc + term[i]
    return acc.reshape(*batch, n_out).to(cfg.out_dtype)


# ---------------------------------------------------------------------------
# Sec. IV-A: QAT with the straight-through estimator (Eq. 8)
# ---------------------------------------------------------------------------


def ste_grads(g: Tensor, x: Tensor, w: Tensor, need_x: bool = True,
              need_w: bool = True):
    """The straight-through gradients of ``y = x @ w`` (Eq. 8), in f32:
    dx = g w^T in x's dtype and dw = x^T g in w's dtype (w may be None
    for dx alone)."""
    g32 = g.float()
    dx = dw = None
    if need_x:
        dx = torch.matmul(g32, w.float().t()).to(x.dtype)
    if need_w:
        g2 = g32.reshape(-1, g32.shape[-1])
        x2 = x.float().reshape(-1, x.shape[-1])
        dw = torch.matmul(x2.t(), g2).to(w.dtype)
    return dx, dw


class _AbfpMatmulSTE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, cfg, key):
        ctx.save_for_backward(x, w)
        return abfp_matmul(x, w, cfg, key)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx, dw = ste_grads(g, x, w, *ctx.needs_input_grad[:2])
        return dx, dw, None, None


def abfp_matmul_ste(x: Tensor, w: Tensor, cfg: QuantConfig,
                    key=None) -> Tensor:
    """ABFP forward, straight-through backward: the gradients of the plain
    matmul, accumulated in f32 (Eq. 8)."""
    return _AbfpMatmulSTE.apply(x, w, cfg, key)


def quantize_ste(v: Tensor, delta, tau) -> Tensor:
    """Elementwise STE quantizer: forward Q(v), backward identity."""
    q = quantize(v.detach(), delta, tau)
    return v + (q - v).detach()


def digital_bfp_matmul(x: Tensor, w: Tensor, cfg: QuantConfig) -> Tensor:
    """The digital accelerator's order (the paper's aside under Eq. 4):
    the exact tile products are summed across tiles before any output
    quantization, so only the input and weight rounding remain."""
    batch = x.shape[:-1]
    x_q, s_x = quantize_input_tiles(x.reshape(-1, x.shape[-1]), cfg)
    w_q, s_w = quantize_weight_tiles(w, cfg)
    p = torch.einsum("mtn,tno->tmo", x_q, w_q)
    dd = f32_const(cfg.delta_x * cfg.delta_w)
    y = torch.einsum("tmo,mt,to->mo", p * dd, s_x, s_w)
    return y.reshape(*batch, w.shape[1]).to(cfg.out_dtype)
