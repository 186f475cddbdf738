"""Einsum oracle for the ABFP matmul.

Independent of ``core.abfp``'s tile scan: it holds the whole (T, M, N)
partial-product tensor at once, applies the ADC, and contracts against
the scales.  Test-sized shapes only; the production paths are the scan
(``abfp_ref``) and the CUDA kernels.  Its name is also that of kernel 4's
plain version in ``kernels.abfp_matmul``, as in the JAX package; this
one takes a PRNG key and draws JAX's ``uniform`` noise.
"""

from __future__ import annotations

import torch

from repro_torch.core import prng
from repro_torch.core.abfp import (
    QuantConfig,
    adc,
    f32_const,
    quantize_input_tiles,
    quantize_weight_tiles,
)


def abfp_matmul_ref(x: torch.Tensor, w: torch.Tensor, cfg: QuantConfig,
                    key=None) -> torch.Tensor:
    """Oracle ABFP matmul: x (..., K) @ w (K, N) -> (..., N)."""
    if key is None and cfg.noise_lsb > 0.0:
        raise ValueError("noise_lsb > 0 requires a PRNG key")
    batch = x.shape[:-1]
    x_q, s_x = quantize_input_tiles(x.reshape(-1, x.shape[-1]), cfg)
    w_q, s_w = quantize_weight_tiles(w, cfg)
    t, m, n_out = w_q.shape[0], x_q.shape[0], w.shape[1]
    p = torch.einsum("mtn,tno->tmo", x_q, w_q)             # (T, M, N)
    e = None
    if cfg.noise_lsb > 0.0:
        e = prng.uniform(prng.split(key, t), (m, n_out), -cfg.noise_lsb,
                         cfg.noise_lsb, x.device)
    y_q = adc(p, cfg, e) * f32_const(cfg.bin_y)            # ADC (Eq. 7)
    y = torch.einsum("tmo,mt,to->mo", y_q, s_x, s_w) / f32_const(cfg.gain)
    return y.reshape(*batch, n_out).to(cfg.out_dtype)
