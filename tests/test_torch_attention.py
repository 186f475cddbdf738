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
"""

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
