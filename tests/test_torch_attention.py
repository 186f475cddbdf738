"""The port's cacheless attention against the JAX package's, on the CPU.

``flash_attention_ref`` (kernel 5's plain version, which the wrapper runs
on CPU tensors) against ``repro.kernels.flash_attention.flash_attention``
in Pallas interpret mode, at the shapes of ``tests/test_flash_attention.py``
(MHA, GQA 4:1, MQA with Sq != Skv, non-causal, bf16) plus windowed cases;
``chunked_attention`` against the JAX package's.  Inputs are made with
numpy from a seed and handed to both.

Bars: f32 outputs within rtol = atol = 1e-5 (both run the same block
order; only the dot products' f32 sum order differs); bf16 outputs within
one bf16 ULP (rtol 2**-7), since an f32 difference can round either way.

The CUDA kernel's bf16 route runs on tensor cores; its arithmetic is
emulated here (``_tensor_core_flash``) and held to the card's bar (rtol
2**-7, atol 1e-5) against the plain version and the Pallas kernel.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as j_flash
from repro.models.layers import chunked_attention as j_chunked
from repro_torch.kernels.flash_attention import (
    flash_attention,
    flash_attention_ref,
)
from repro_torch.models.layers import chunked_attention

torch.set_num_threads(1)  # small tensors: one intra-op thread per test worker

F32_TOL = dict(rtol=1e-5, atol=1e-5)


def _qkv(b, sq, skv, h, kh, d, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=shape).astype(np.float32)
                 for shape in ((b, sq, h, d), (b, skv, kh, d),
                               (b, skv, kh, d)))


def _both(fn_j, fn_t, arrays, **kw):
    want = np.asarray(fn_j(*(jnp.asarray(a) for a in arrays), **kw))
    got = fn_t(*(torch.from_numpy(a) for a in arrays), **kw).numpy()
    return got, want


@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0),
                                           (True, 96)])
@pytest.mark.parametrize("shape", [
    (2, 256, 256, 4, 4, 64),       # MHA
    (2, 256, 256, 8, 2, 64),       # GQA 4:1
    (1, 384, 640, 5, 1, 128),      # MQA, odd sizes, Sq != Skv
    (1, 200, 200, 6, 2, 32),       # ragged S (padding inside a block)
    (1, 200, 77, 6, 3, 32),        # Sq > Skv + window: rows see no key
])
def test_flash_ref_matches_pallas(shape, causal, window):
    arrays = _qkv(*shape, seed=sum(shape))
    got, want = _both(j_flash, flash_attention_ref, arrays, causal=causal,
                      window=window, bq=128, bk=128)
    np.testing.assert_allclose(got, want, **F32_TOL)


def test_flash_ref_default_blocks_match_pallas():
    """The wrapper's own blocks (bq = bk = min(512, ceil128(S))), windowed
    and non-causal: a window in a non-causal call sees keys ahead too."""
    arrays = _qkv(1, 640, 640, 4, 2, 64, seed=3)
    for causal, window in ((True, 128), (False, 200)):
        got, want = _both(j_flash, flash_attention, arrays, causal=causal,
                          window=window)
        np.testing.assert_allclose(got, want, **F32_TOL)


def test_flash_ref_bf16_matches_pallas():
    q, k, v = _qkv(1, 256, 256, 4, 4, 64, seed=4)
    jb = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    want = np.asarray(j_flash(*jb, causal=True, bq=128, bk=128), np.float32)
    tb = [torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)
          for a in jb]
    got = flash_attention_ref(*tb, causal=True, bq=128, bk=128)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -7,
                               atol=1e-6)


@pytest.mark.parametrize("shape", [
    (1, 160, 160, 32, 2, 128),     # chatglm3-6b: 32 / 2 heads of 128
    (1, 160, 160, 16, 16, 256),    # gemma-7b: 16 / 16 heads of 256
])
def test_flash_ref_at_served_head_dims_matches_pallas(shape):
    """Kernel 5's plain version on bf16 at the head dims and groupings of
    gemma-7b and chatglm3-6b, causal, with the wrapper's own blocks,
    against the Pallas kernel in interpret mode (bf16 bar: one ULP)."""
    q, k, v = _qkv(*shape, seed=shape[3] + shape[5])
    jb = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    want = np.asarray(j_flash(*jb, causal=True), np.float32)
    tb = [torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)
          for a in jb]
    got = flash_attention(*tb, causal=True)
    assert got.dtype == torch.bfloat16 and got.shape == tb[0].shape
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -7,
                               atol=1e-6)


@pytest.mark.parametrize("causal,window,chunk", [(True, 0, 128),
                                                 (False, 0, 64),
                                                 (True, 128, 128),
                                                 (True, 0, 100)])
def test_chunked_attention_matches_jax(causal, window, chunk):
    arrays = _qkv(2, 320, 320, 4, 2, 32, seed=chunk + window)
    got, want = _both(j_chunked, chunked_attention, arrays, causal=causal,
                      window=window, chunk=chunk)
    np.testing.assert_allclose(got, want, **F32_TOL)


def test_chunked_attention_q_offset_matches_jax():
    """A query block placed at position 64 of a longer key sequence."""
    arrays = _qkv(1, 32, 96, 4, 4, 32, seed=9)
    got, want = _both(j_chunked, chunked_attention, arrays, causal=True,
                      q_offset=64, chunk=32)
    np.testing.assert_allclose(got, want, **F32_TOL)


def test_flash_and_chunked_agree():
    """The two cacheless paths of ``attention_block`` compute the same
    attention (f32 sums in another order)."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(2, 300, 300, 6, 3, 64, 11))
    for causal, window in ((True, 0), (True, 50), (False, 0)):
        torch.testing.assert_close(
            flash_attention(q, k, v, causal=causal, window=window),
            chunked_attention(q, k, v, causal=causal, window=window,
                              chunk=64), **F32_TOL)


def _tensor_core_flash(q, k, v, causal, window, bq=64, bk=64):
    """The bf16 tensor-core kernel's arithmetic in PyTorch, on the CPU.

    Per 64-query block, over the 64-key tiles some query of the block can
    see: S = (q * scale) . k with q * scale split into bf16 hi + lo (hi
    alone when the scale is a power of two), summed in f32 over 16-deep
    fragments; masks of -1e30; the online softmax in f32; P . V with
    p_hi = bf16(p) and p_lo = bf16(p - p_hi), each an f32 sum over
    16-key fragments; out = O / max(l, 1e-30) in bf16."""
    b, sq, h, d = q.shape
    skv, kh = k.shape[1], k.shape[2]
    scale = torch.tensor(d ** -0.5, dtype=torch.float32)
    a = q.float().permute(0, 2, 1, 3).reshape(b * h, sq, d) * scale
    qh = a.to(torch.bfloat16).float()
    ql = (a - qh).to(torch.bfloat16).float()
    two_pass = math.frexp(d ** -0.5)[0] != 0.5
    bh = torch.arange(b * h)
    idx = (bh // h) * kh + (bh % h) // (h // kh)

    def heads(t):
        t = t.float().permute(0, 2, 1, 3).reshape(b * kh, skv, d)
        return torch.nn.functional.pad(t, (0, 0, 0, bk))[idx]

    kt, vt = heads(k), heads(v)
    out = torch.empty(b * h, sq, d)
    for q0 in range(0, sq, bq):
        rows = torch.arange(q0, min(q0 + bq, sq))
        m = torch.full((b * h, len(rows)), -1e30)
        den = torch.zeros(b * h, len(rows))
        o = torch.zeros(b * h, len(rows), d)
        k_hi = min(skv, q0 + bq) if causal else skv
        k_lo = max(0, q0 - window + 1) // bk * bk if window > 0 else 0
        for k0 in range(k_lo, k_hi, bk):
            kb, vb = kt[:, k0:k0 + bk], vt[:, k0:k0 + bk]
            s = torch.zeros(b * h, len(rows), bk)
            for c in range(0, d, 16):
                kc = kb[..., c:c + 16].transpose(1, 2)
                s = s + qh[:, rows, c:c + 16] @ kc
                if two_pass:
                    s = s + ql[:, rows, c:c + 16] @ kc
            kpos = k0 + torch.arange(bk)
            valid = (kpos < skv)[None, :].expand(len(rows), bk)
            if causal:
                valid = valid & (kpos[None, :] <= rows[:, None])
            if window > 0:
                valid = valid & (kpos[None, :] > rows[:, None] - window)
            s = torch.where(valid[None], s, torch.full_like(s, -1e30))
            mx = torch.maximum(m, s.amax(-1))
            corr = torch.exp(m - mx)
            p = torch.exp(s - mx[..., None])
            den = den * corr + p.sum(-1)
            ph = p.to(torch.bfloat16).float()
            pl = (p - ph).to(torch.bfloat16).float()
            o = o * corr[..., None]
            for c in range(0, bk, 16):
                o = o + ph[..., c:c + 16] @ vb[:, c:c + 16]
                o = o + pl[..., c:c + 16] @ vb[:, c:c + 16]
            m = mx
        out[:, rows] = o / torch.clamp(den, min=1e-30)[..., None]
    out = out.reshape(b, h, sq, d).permute(0, 2, 1, 3)
    return out.to(torch.bfloat16)


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 96),
                                           (False, 0)])
@pytest.mark.parametrize("d", [32, 64, 128, 256])
def test_tensor_core_arithmetic_matches_plain_and_pallas(d, causal, window):
    """The tensor-core route's rounding (q * scale hi/lo, the p hi/lo
    split, f32 sums over 16-wide fragments) against the plain version and
    the Pallas kernel in interpret mode, on bf16 inputs with GQA and a
    query length that is not a whole 64-row block."""
    arrays = _qkv(1, 200, 200, 4, 2, d, seed=d + window)
    jb = [jnp.asarray(a, jnp.bfloat16) for a in arrays]
    tb = [torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)
          for a in jb]
    got = _tensor_core_flash(*tb, causal=causal, window=window).float()
    want = flash_attention_ref(*tb, causal=causal, window=window).float()
    torch.testing.assert_close(got, want, rtol=2 ** -7, atol=1e-5)
    pallas = np.asarray(j_flash(*jb, causal=causal, window=window),
                        np.float32)
    np.testing.assert_allclose(got.numpy(), pallas, rtol=2 ** -7, atol=1e-5)
