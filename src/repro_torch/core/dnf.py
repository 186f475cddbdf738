"""Differential Noise Finetuning (DNF), paper Sec. IV-B.

DNF keeps the forward pass in FLOAT and adds, to each layer output, noise
drawn from a histogram of the *differential noise*

    dy^l = ABFP_layer^l(x^l) - FLOAT_layer^l(x^l)

captured once, on one batch, with both layers fed the same FLOAT input
(``models.lm.forward_capture``).  Histograms follow the paper: 100 bins and
+0.5 smoothing of every bin count, so no bin has probability 0.

Sampling is inverse-CDF (``searchsorted`` on the cumulative
probabilities) plus a uniform position within the bin, from JAX's
``uniform`` draws (``core.prng``): the same key gives JAX's samples bit for
bit.  The fitted histograms are f32 tensors; ``NoiseHistogram.to`` moves
them to the device of the pass that samples them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core import prng

Tensor = torch.Tensor

NUM_BINS_DEFAULT = 100
SMOOTHING_DEFAULT = 0.5


@dataclasses.dataclass
class NoiseHistogram:
    """Smoothed histogram distribution(s) of differential noise, as f32
    tensors (on the CPU as fitted).  A leading layer axis (``edges (L,
    B+1)``, ``cum (L, B)``) holds a stacked capture; ``mean``/``std`` are
    the raw noise's moments (the paper's Fig. 5 layer analysis)."""

    edges: Tensor   # (..., B+1) bin edges
    cum: Tensor     # (..., B)   cumulative probabilities, last value == 1
    mean: Tensor    # (...)      mean of the raw differential noise
    std: Tensor     # (...)      std of the raw differential noise

    @classmethod
    def fit(cls, samples, num_bins: int = NUM_BINS_DEFAULT,
            smoothing: float = SMOOTHING_DEFAULT) -> "NoiseHistogram":
        """Fit one histogram to a sample array (flattened; non-finite
        values dropped)."""
        if isinstance(samples, torch.Tensor):
            samples = samples.detach().float().cpu().numpy()
        s = np.asarray(samples, dtype=np.float32).ravel()
        s = s[np.isfinite(s)]
        if s.size == 0:
            s = np.zeros((1,), np.float32)
        lo, hi = float(s.min()), float(s.max())
        if lo == hi:  # degenerate: widen so sampling returns ~ the constant
            pad = max(1e-6, 1e-4 * abs(lo))
            lo, hi = lo - pad, hi + pad
        counts, edges = np.histogram(s, bins=num_bins, range=(lo, hi))
        probs = (counts + smoothing) / (counts.sum() + smoothing * num_bins)
        cum = np.cumsum(probs)
        cum[-1] = 1.0
        return cls(
            edges=torch.from_numpy(edges.astype(np.float32)),
            cum=torch.from_numpy(cum.astype(np.float32)),
            mean=torch.tensor(s.mean(), dtype=torch.float32),
            std=torch.tensor(s.std(), dtype=torch.float32),
        )

    @classmethod
    def stack(cls, hists: list) -> "NoiseHistogram":
        """Stack per-layer histograms along a leading layer axis."""
        return cls(
            edges=torch.stack([h.edges for h in hists]),
            cum=torch.stack([h.cum for h in hists]),
            mean=torch.stack([h.mean for h in hists]),
            std=torch.stack([h.std for h in hists]),
        )

    def layer(self, idx: int) -> "NoiseHistogram":
        """One layer's histogram of a stacked capture."""
        return NoiseHistogram(edges=self.edges[idx], cum=self.cum[idx],
                              mean=self.mean[idx], std=self.std[idx])

    def to(self, device) -> "NoiseHistogram":
        """The same histogram(s) with every tensor on ``device``."""
        return NoiseHistogram(*(t.to(device) for t in (
            self.edges, self.cum, self.mean, self.std)))

    def sample(self, key, shape) -> Tensor:
        """Eq. 9's xi ~ P_hist, of ``shape``, on the histogram's device:
        ``k1, k2 = split(key)``; the bin is the first whose cumulative
        probability reaches ``uniform(k1)`` (clipped to the last bin), the
        position in it ``uniform(k2)``."""
        k1, k2 = prng.split(key)
        dev = self.cum.device
        u = prng.uniform(k1, shape, device=dev)
        idx = torch.searchsorted(self.cum, u.reshape(-1), side="left")
        idx = torch.clamp(idx, 0, self.cum.shape[-1] - 1).reshape(u.shape)
        lo = self.edges[idx]
        hi = self.edges[idx + 1]
        frac = prng.uniform(k2, shape, device=dev)
        return lo + (hi - lo) * frac


def capture_differential_noise(float_out, abfp_out,
                               num_bins: int = NUM_BINS_DEFAULT,
                               smoothing: float = SMOOTHING_DEFAULT
                               ) -> NoiseHistogram:
    """dy = ABFP(x) - FLOAT(x) of one layer, fitted to a histogram; both
    outputs must come from the same input (the previous FLOAT layer's
    output, as ``models.lm.forward_capture`` gives them)."""
    def f32(a):
        if isinstance(a, torch.Tensor):
            return a.detach().float().cpu().numpy()
        return np.asarray(a, np.float32)
    return NoiseHistogram.fit(f32(abfp_out) - f32(float_out),
                              num_bins=num_bins, smoothing=smoothing)


def inject(y: Tensor, hist: Optional[NoiseHistogram], key) -> Tensor:
    """Eq. 9: y + xi, xi ~ P_hist drawn with ``key`` (y itself without a
    histogram); the gradient passes to y unchanged."""
    if hist is None:
        return y
    return y + hist.sample(key, y.shape).to(y.dtype)


def select_layers_by_std(hists: list, top_fraction: float) -> list:
    """Paper Sec. V-B: inject only into the layers with the highest
    differential-noise std (the most susceptible); True marks them."""
    stds = np.array([float(h.std) for h in hists])
    k = max(1, int(round(top_fraction * len(hists))))
    thresh = np.sort(stds)[-k]
    return [bool(s >= thresh) for s in stds]
